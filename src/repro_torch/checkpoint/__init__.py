"""Checkpointing of the port: atomic npz + manifest, async writer (the
reference's on-disk format)."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
