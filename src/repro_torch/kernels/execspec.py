"""One frozen execution spec for the port's kernel entry points.

Same fields as ``repro.kernels.execspec.ExecSpec`` and the same
``coalesce_key`` shape, with one substitution: the reference's
``interpret`` (Pallas interpret mode) gives way to ``device`` — where the
call runs.  ``device=None`` means the card (``"cuda"``); the CPU runs only
when a caller asks for it (``device="cpu"``), and a CUDA request on a
machine without a GPU raises instead of falling back.

The reference's deprecated per-function keyword aliases are not carried
over: the port's entry points take ``spec=`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ExecSpec", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device a call runs on: ``None`` is the card.  A CUDA device on a
    machine without one raises — the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA GPU is available; pass "
            "device='cpu' to run the plain PyTorch reference on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Launch configuration for the SELL kernel family.

    layout:    graph operand layout, ``"ell"`` or ``"sell"`` (graph kernels
               are not ported yet; kept for the reference's field set).
    mode:      SpMM schedule, ``"auto"`` | ``"resident"`` | ``"stream"``.
               ``auto`` and ``resident`` run kernel B1; ``stream`` (kernel
               B2) is not ported yet and raises.
    dispatch:  MoE expert-dispatch path (not ported yet).
    placement: ``None`` or ``1``; multi-GPU placement is ROADMAP A10.
    vl:        SELL slice height C, the effective vector length.
    sigma:     sorting-window height (``None`` -> the packer default 8*C).
    w_block:   width tile of the reference's grid; kept for the shape of
               ``coalesce_key`` and read by nothing in the port (B1 walks a
               bucket's whole width in one thread).
    k_block:   RHS column tile for SpMM (``None`` -> pow2 heuristic).
    col_tile:  streamed-SpMM column window (kernel B2, not ported).
    row_tile:  streamed-SpMM slice-row block (kernel B2, not ported).
    b_block:   FFT butterfly-block tile (kernel B7, not ported).
    device:    where the call runs (``None`` -> ``"cuda"``).
    cache:     a ``TuneCache`` (``None`` -> the process-default cache).
    """

    layout: str = "ell"
    mode: str = "auto"
    dispatch: str = "auto"
    placement: Any = None
    vl: int = 256
    sigma: int | None = None
    w_block: int = 8
    k_block: int | None = None
    col_tile: int | None = None
    row_tile: int | None = None
    b_block: int = 8
    device: str | None = None
    cache: Any = None

    def __post_init__(self) -> None:
        if self.placement not in (None, 1):
            raise NotImplementedError(
                f"placement={self.placement!r}: multi-GPU execution is not "
                "ported yet (ROADMAP A10); use None or 1")

    def n_devices(self) -> int:
        """Device count implied by the placement (always 1 in the port)."""
        return 1

    def coalesce_key(self) -> tuple:
        """Hashable identity for service coalescing groups (excludes the
        process-local ``cache``), shaped like the reference's key."""
        return (
            self.layout, self.mode, self.dispatch, self.n_devices(), self.vl,
            self.sigma, self.w_block, self.k_block, self.col_tile,
            self.row_tile, self.b_block, self.device,
        )
