"""One frozen execution spec for the port's kernel entry points.

Same fields as ``repro.kernels.execspec.ExecSpec`` and the same
``coalesce_key`` shape, with one substitution: the reference's
``interpret`` (Pallas interpret mode) gives way to ``device`` — where the
call runs.  ``device=None`` means the card (``"cuda"``); the CPU runs only
when a caller asks for it (``device="cpu"``), and a CUDA request on a
machine without a GPU raises instead of falling back.

``placement`` spreads a call over a mesh of devices, as the reference's
does: an int ``n`` is the first ``n`` visible CUDA devices (too few
raises when the call resolves it), a device sequence names them and may
repeat one (``("cuda:0",) * 4``, ``("cpu",) * 4``), and a
:class:`~repro_torch.kernels.sell_shard.ShardMesh` is taken as it is.

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
    """Launch configuration for the port's kernel entry points.

    layout:    graph operand layout for ``ops.bfs`` / ``ops.pagerank``:
               ``"ell"`` (kernels B4 / B5) or ``"sell"`` (kernel B3).
    mode:      SpMM schedule, ``"auto"`` | ``"resident"`` | ``"stream"``.
               ``auto`` and ``resident`` run kernel B1 (X gathered through
               L2); ``stream`` runs kernel B2 (X staged through shared
               memory in column tiles).  Both compute the same function.
    dispatch:  MoE expert-dispatch path of ``ops.moe_dispatch``:
               ``"auto"`` | ``"sell"`` (the routing matrix packed to SELL
               slabs, run as ``mode`` says) | ``"dense"`` (materialized,
               one ``torch.matmul``).
    placement: ``None`` (one device), an ``int`` device count, a device
               sequence or a ``ShardMesh``: ``ops`` runs a placement of
               more than one device on the sharded drives
               (:mod:`repro_torch.kernels.sell_shard`), the result on the
               mesh's first device.
    vl:        SELL slice height C, the effective vector length (the
               ELLPACK graph kernels ignore it: blocks are 256 nodes).
    sigma:     sorting-window height (``None`` -> the packer default 8*C).
    w_block:   width tile of the reference's grid; kept for the shape of
               ``coalesce_key``.  B1 and B6 walk a row's whole width in
               one thread, so it never changes a result (``ops`` hands it
               to ``spmv_ell`` as the reference does).
    k_block:   RHS column tile for SpMM (``None`` -> pow2 heuristic).
    col_tile:  X rows one staged tile of kernel B2 holds (``None`` ->
               the largest power of two whose two tiles fit a block's
               shared memory, ``pick_stream_tiles``); coerced to a power of
               two and clamped at ``pow2_ceil(n_cols)``.
    row_tile:  slices one block of kernel B2 holds (``None`` -> as many
               as 256 threads hold); clamped per bucket at its slice
               count.  Neither tile changes a result.
    b_block:   FFT signals a block of kernel B7 holds at most (``ops.fft``
               caps it to the batch, the kernel to the shared memory a
               block may claim; it does not change the result).
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
        p = self.placement
        if p is None or isinstance(p, int) and not isinstance(p, bool):
            return
        from repro_torch.kernels.sell_shard import ShardMesh

        if isinstance(p, ShardMesh):
            return
        if isinstance(p, (str, torch.device)) or not hasattr(p, "__len__"):
            raise TypeError(
                f"placement must be None, an int, a ShardMesh or a sequence "
                f"of devices, got {p!r}")
        object.__setattr__(self, "placement", tuple(p))   # hashable

    def resolved_placement(self):
        """The placement as a :class:`~repro_torch.kernels.sell_shard
        .ShardMesh` (the null mesh for None or one device)."""
        from repro_torch.kernels.sell_shard import ShardMesh, device_mesh

        p = self.placement
        if p is None:
            return ShardMesh()
        if isinstance(p, ShardMesh):
            return p
        if isinstance(p, int):
            return device_mesh(p)
        return device_mesh(len(p), p)

    def n_devices(self) -> int:
        """Device count implied by the placement (1 when unplaced); an int
        placement is not checked against the visible devices here."""
        p = self.placement
        if p is None:
            return 1
        if isinstance(p, int):
            return max(1, p)
        return max(1, len(p))

    def coalesce_key(self) -> tuple:
        """Hashable identity for service coalescing groups (excludes the
        process-local ``cache``), shaped like the reference's key: the
        placement folds to its device count, so equal meshes coalesce."""
        return (
            self.layout, self.mode, self.dispatch, self.n_devices(), self.vl,
            self.sigma, self.w_block, self.k_block, self.col_tile,
            self.row_tile, self.b_block, self.device,
        )
