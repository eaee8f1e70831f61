"""Architecture registry: the 10 assigned archs × 4 input shapes (40 cells).

A copy of ``repro.configs`` (data only).  The port serves every arch here
(``repro_torch.launch.serve``); mixtral-8x7b at full width needs more
than one card: a mesh (``repro_torch.models.sharding``,
``scripts/mesh_serve_cards.py``).

``get_config(arch)`` returns the full published config; ``reduced`` gives the
CPU smoke-test version.  ``SHAPES`` defines the per-arch input shapes, and
``cell_supported`` encodes the assignment's skip rules (``long_500k`` needs
sub-quadratic attention; see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS: tuple[str, ...] = (
    "hymba-1.5b",
    "llama3.2-3b",
    "qwen3-14b",
    "qwen2-1.5b",
    "minicpm-2b",
    "deepseek-moe-16b",
    "mixtral-8x7b",
    "llama-3.2-vision-11b",
    "mamba2-2.7b",
    "seamless-m4t-medium",
)

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-14b": "qwen3_14b",
    "qwen2-1.5b": "qwen2_1_5b",
    "minicpm-2b": "minicpm_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "mamba2-2.7b": "mamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    return get_config(arch).reduced()


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(supported, reason).  The 40-cell matrix with the assignment's skips."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if shape == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{arch} is pure full-attention (noted in DESIGN.md)"
        )
    return True, ""


def all_cells(include_skipped: bool = False):
    """Iterate (arch, shape[, skip-reason]) over the 40-cell matrix."""
    for arch in ARCHS:
        for shape in SHAPES:
            ok, reason = cell_supported(arch, shape)
            if ok:
                yield (arch, shape, "") if include_skipped else (arch, shape)
            elif include_skipped:
                yield (arch, shape, reason)
