"""Optimizer substrate of the port (``repro.optim``): AdamW over the
model's parameters, schedules (MiniCPM's WSD among them), clipping, and
int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    decay_mask,
    global_norm,
)
from repro_torch.optim.compression import (
    CompressionState,
    compress_tree,
    compression_init,
    decompress_tree,
)
from repro_torch.optim.schedules import constant, cosine_schedule, wsd_schedule

__all__ = [
    "AdamWConfig",
    "CompressionState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compress_tree",
    "compression_init",
    "constant",
    "cosine_schedule",
    "decay_mask",
    "decompress_tree",
    "global_norm",
    "wsd_schedule",
]
