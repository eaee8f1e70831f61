"""Explicit mesh threading: :class:`Mesh`, :class:`MeshContext` and the
ambient stack — port of ``repro.compat.meshctx``.

A :class:`Mesh` is one process's handle on an n-d array of
``torch.device``s with named axes: the counterpart of the reference's
one-controller ``jax.sharding.Mesh``.  The port drives every device of a
mesh from one Python process, each device's work on its current stream,
with cross-device ``.to()`` as the only synchronization; no
``torch.distributed`` group is involved (as in
:mod:`repro_torch.kernels.sell_shard`).  A mesh may name one device several
times: ``("cuda:0",) * 4`` runs the whole mesh path on one card, ``("cpu",)
* 4`` on the CPU (the counterpart of the reference's
``--xla_force_host_platform_device_count``).

* A :class:`MeshContext` is an explicit handle on a mesh, or on "no mesh"
  (every query then degrades to the single-device answer).  Model
  construction and the serving layers thread it through directly
  (``param_specs(..., mesh=...)``, ``ServeEngine(..., mesh=...)``).
* :func:`use_mesh` gives the context-manager ergonomics: entering a
  ``MeshContext`` pushes it on a thread-local stack.
* :func:`current_mesh_context` is the single discovery point: the stack's
  top, else the null context.  The stack is the only ambient source (the
  reference's ``jaxshim`` fallback to JAX's own ambient mesh has no
  counterpart here).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "Mesh",
    "MeshContext",
    "NULL_MESH_CONTEXT",
    "concrete_mesh",
    "current_mesh_context",
    "make_mesh",
    "use_mesh",
]


class Mesh:
    """Named axes over an n-d array of devices (``devices.shape`` is the
    mesh's shape, one entry per name of ``axis_names``)."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array cannot take the "
                             f"{len(axis_names)} axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices {devs})"


def _visible(dev: torch.device) -> torch.device:
    """A mesh entry as a checked device; ``cuda`` without an index is the
    current card."""
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"mesh device {dev} named but no CUDA device is "
                             "visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {dev} is not visible "
                             f"({torch.cuda.device_count()} CUDA device(s))")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}: expected cuda or cpu")
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    Without ``devices`` it takes the first ``prod(shape)`` distinct visible
    CUDA devices and raises ``ValueError`` if fewer are visible (no
    fallback).  ``devices`` names ``prod(shape)`` devices in row-major mesh
    order and may repeat one (``("cuda:0",) * 4`` on one card, ``("cpu",) *
    4`` on the CPU); a mesh of mixed device types is refused.
    """
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    n = math.prod(shape)
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise ValueError(
                f"a {shape} mesh needs {n} devices but only {visible} CUDA "
                f"device(s) are visible; name the devices to share one, e.g. "
                f"devices=('cuda:0',) * {n}, or ('cpu',) * {n} on the CPU")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_visible(torch.device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {shape} mesh needs {n} devices, got "
                             f"{len(devs)}")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh runs on one device type, got "
                             f"{sorted({str(d) for d in devs})}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


class MeshContext:
    """Explicit handle on a device mesh, usable as a context manager.

    Wraps a :class:`Mesh` or ``None`` (no mesh: every query degrades to the
    single-device answer).  Axis queries accept the repo's *logical* axis
    convention: ``None`` (unsharded), a name, or a tuple of names (sizes
    multiply).
    """

    __slots__ = ("mesh", "_entered")

    def __init__(self, mesh: Any = None):
        if isinstance(mesh, MeshContext):
            mesh = mesh.mesh
        self.mesh = mesh
        self._entered: list = []

    @classmethod
    def of(cls, mesh: Any) -> "MeshContext":
        """Coerce a Mesh / MeshContext / None into a MeshContext."""
        return mesh if isinstance(mesh, MeshContext) else cls(mesh)

    # -- queries ------------------------------------------------------------

    @property
    def empty(self) -> bool:
        return self.mesh is None or getattr(self.mesh, "empty", False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return () if self.empty else tuple(self.mesh.axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return {} if self.empty else dict(self.mesh.shape)

    def has_axis(self, axis: str) -> bool:
        return not self.empty and axis in tuple(self.mesh.axis_names)

    def axis_size(self, axis) -> int:
        """Size of a logical axis; absent axes and ``None`` count as 1."""
        if axis is None or self.empty:
            return 1
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.axis_size(a)
            return n
        return int(dict(self.mesh.shape).get(axis, 1))

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "MeshContext":
        # "no mesh" enters as a no-op so `mesh=None` defaults inherit
        # whatever scope is already active instead of shadowing it
        self._entered.append(not self.empty)
        if not self.empty:
            _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._entered.pop():
            _stack().pop()
        return False

    def __repr__(self) -> str:
        return f"MeshContext({self.mesh!r})"


NULL_MESH_CONTEXT = MeshContext(None)

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_mesh_context() -> MeshContext:
    """The active MeshContext: the explicit stack's top, else null."""
    stack = _stack()
    return stack[-1] if stack else NULL_MESH_CONTEXT


def concrete_mesh(mesh: Any) -> Mesh | None:
    """The multi-device :class:`Mesh` behind ``mesh`` (a Mesh, MeshContext,
    or None), or ``None`` — the single test for "does explicit device
    placement apply here" (a 1-device mesh does not need it)."""
    m = MeshContext.of(mesh).mesh
    if isinstance(m, Mesh) and m.size > 1:
        return m
    return None


def use_mesh(mesh: Any) -> MeshContext:
    """Context manager activating ``mesh`` (``None`` -> inert scope).

    Always a fresh ``MeshContext`` (the constructor unwraps one), so each
    ``with`` owns its scope state — long-lived handles like
    ``Batcher.mesh`` can be entered from several places without sharing
    bookkeeping.
    """
    return MeshContext(mesh)
