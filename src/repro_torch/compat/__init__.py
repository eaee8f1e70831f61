"""Mesh handles of the port — the device-independent half of
``repro.compat``: :class:`Mesh`, :func:`make_mesh` and the explicit
:class:`MeshContext` threading (:mod:`repro_torch.compat.meshctx`).  The
reference's ``jaxshim`` (JAX-version probing, native mesh scopes,
``with_sharding_constraint``) adapts the JAX runtime and has no
counterpart here."""
from repro_torch.compat.meshctx import (
    NULL_MESH_CONTEXT,
    Mesh,
    MeshContext,
    concrete_mesh,
    current_mesh_context,
    make_mesh,
    use_mesh,
)

__all__ = [
    "Mesh",
    "MeshContext",
    "NULL_MESH_CONTEXT",
    "concrete_mesh",
    "current_mesh_context",
    "make_mesh",
    "use_mesh",
]
