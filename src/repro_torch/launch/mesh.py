"""Production mesh construction — port of ``repro.launch.mesh``.

A FUNCTION, not a module-level constant: importing this module never
touches device state.  The geometry is the reference's (pods of 256
devices):

  single-pod: (data=16, model=16)        — 256 devices
  multi-pod:  (pod=2, data=16, model=16) — 512 devices; ``pod`` is pure
    data parallelism across the slow inter-pod links.

Without ``devices`` a mesh takes that many distinct visible CUDA devices
and raises ``ValueError`` on a machine with fewer, as the reference raises
when it lacks the devices; ``devices`` names them (and may repeat one, see
:func:`repro_torch.compat.make_mesh`).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.compat import Mesh, make_mesh

__all__ = ["make_mesh_from_plan", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_mesh_from_plan(shape: tuple[int, ...], axes: tuple[str, ...],
                        devices: Sequence | None = None) -> Mesh:
    """Mesh from an elastic re-mesh plan (:mod:`repro_torch.runtime.elastic`)."""
    return make_mesh(shape, axes, devices)
