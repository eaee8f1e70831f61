"""Vector-length configuration — the paper's §2.1 'Variable Vector Length' CSR.

A copy of ``repro.core.vconfig``.  The FPGA-SDV exposes the machine's
maximum vector length in a custom CSR so software can lower it at runtime
and study the interaction between VL and the memory subsystem.
``VectorConfig`` is that knob in the SDV cycle model
(:mod:`repro_torch.core.sdv`, :mod:`repro_torch.core.traffic`), where it
keeps the reference's meaning: elements per vector instruction.

What ``vl`` is on an H100, kernel by kernel, when the study times the
port's kernels at a VL (:func:`repro_torch.core.campaign.measure_cuda`,
``ExecSpec(vl=vl)``).  A CUDA instruction is one 32-thread warp whatever
the VL, so the knob reaches the card only through the data layout:

* **B6** (``ops.spmv`` on an ELLPACK matrix): ``vl`` is the slice height
  C of the ``(S, W, C)`` slab.  It changes how rows interleave and each
  warp's live width (the slots its walk reads); at C = 8 and 16 one warp
  spans several slices.
* **B4 / B5** (``ops.bfs`` / ``ops.pagerank`` on the ELLPACK layout):
  ``vl`` is the reference's node block and does not shape the launch
  (one thread a node, 128 a block), so their timings should be flat in VL.
* **B7** (``ops.fft``): takes no VL, as the reference's measured FFT does;
  its timings are flat too.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

#: VL values studied by the paper (double-precision elements per instruction).
PAPER_VLS: tuple[int, ...] = (8, 16, 32, 64, 128, 256)

#: Sentinel VL used to model the scalar ISA (1 element per instruction).
SCALAR_VL = 1


def series_label(vl: int) -> str:
    """Display label of a sweep series ('scalar' or 'vlN'), shared by the
    figure tables, the campaign records and the CSV emitters."""
    return "scalar" if vl == SCALAR_VL else f"vl{vl}"


@dataclasses.dataclass(frozen=True)
class VectorConfig:
    """Software-visible vector configuration (the paper's VL CSR).

    Attributes:
      vl: maximum vector length in elements per instruction / per kernel block.
      lanes: number of parallel execution lanes in the vector unit (Vitruvius
        has 8; an H100 warp is 32 threads).  Arithmetic on a VL-element
        vector costs ceil(vl / lanes) occupancy cycles.
      elem_bytes: bytes per element (paper uses double precision).
    """

    vl: int = 256
    lanes: int = 8
    elem_bytes: int = 8

    def __post_init__(self) -> None:
        if self.vl < 1:
            raise ValueError(f"vl must be >= 1, got {self.vl}")
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")

    @property
    def is_scalar(self) -> bool:
        return self.vl == SCALAR_VL

    @property
    def register_bits(self) -> int:
        """Vector register width in bits (the paper quotes 16 kbit at VL=256)."""
        return self.vl * self.elem_bytes * 8

    def alu_cycles(self, n_ops: int = 1) -> int:
        """Occupancy cycles for ``n_ops`` vector arithmetic instructions."""
        return n_ops * max(1, -(-self.vl // self.lanes))

    def n_instructions(self, n_elements: int) -> int:
        """Vector instructions needed to touch ``n_elements`` (vsetvl tail)."""
        return -(-n_elements // self.vl)

    def with_vl(self, vl: int) -> "VectorConfig":
        """Lowered/raised-VL copy — the programmatic CSR write of §2.1."""
        return dataclasses.replace(self, vl=vl)


def sweep_configs(vls: Sequence[int] = PAPER_VLS, **kw) -> list[VectorConfig]:
    """The paper's VL sweep: one config per studied vector length."""
    return [VectorConfig(vl=v, **kw) for v in vls]
