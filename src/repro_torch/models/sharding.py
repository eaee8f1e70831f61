"""Sharding rules: partition specs for every parameter and their placement
on a mesh — port of ``repro.models.sharding``.

Mesh axes (production): ``(pod, data, model)`` multi-pod or ``(data,
model)`` single-pod.  The batch shards over ``(pod, data)``; the
tensor-parallel dims over ``model``.  A spec is a tuple with one entry a
dim: ``None`` (replicated), an axis name or a tuple of axis names (their
sizes multiply).  The rules (:data:`_RULES`, :func:`param_specs`,
:func:`zero1_specs`) are the reference's, matched against each
parameter's reference path (:func:`repro_torch.models.convert
.reference_path`), so ``blocks.3.attn.wq`` takes the rule of
``blocks/attn/wq``.  A rule covers a leaf's trailing dims; the reference's
leading stacked-layer dims are the port's separate layers.

Where the reference constrains a value with GSPMD and lets XLA move it,
the port places it: :func:`shard` / :func:`place` cut a tensor by its
spec into a :class:`Sharded` value, one piece on each device of the mesh
(a piece replicated along the axes its spec does not name), and
:meth:`Sharded.full` gathers the pieces back.  :func:`place_params` places
an LM leaf by leaf (a :class:`PlacedParams`); the model's mesh path
(:mod:`repro_torch.models.model`) then runs each data replica (a
:class:`Row` of the mesh) on its own devices.  Every piece has storage of
its own, also where a mesh repeats a device.

Training on a mesh (where GSPMD inserts the reduce-scatters and
all-gathers, the port calls these): each piece of a trainable
:class:`PlacedParams` is a leaf tensor of its own, so a backward gives
every piece the gradient of the uses it had.  :func:`reduce_grads` sums
the pieces of each block (its replicas over every mesh axis the spec does
not name: the data replicas' copies, and the model devices' copies of a
model-replicated leaf that several of them read) into one tensor on the
block's first device: a *reduced* value, one piece a block, the others
None; cut by a finer spec (ZeRO-1's :func:`zero1_specs`), each data
replica sums only its own rows of the block (the reduce-scatter).
:func:`write_blocks` copies the blocks of a reduced value into every
piece that holds them (the all-gather of the updated parameters), and
:func:`global_norm` sums the squares of each block once.

Parameters split over ``data`` too (``launch.specs.FSDP_PARAMS``: the
ZeRO-1 specs for the parameters themselves) are read through
:meth:`Sharded.local` (:meth:`Row.pieces`): each device joins the data
blocks of its model block before the use, and the backward hands each
block the gradients of every replica's use, so :func:`reduce_grads` sums
one piece a block and the update writes only the pieces that hold it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
import types
from typing import Any

import numpy as np
import torch

from repro_torch.compat import Mesh, MeshContext, current_mesh_context

__all__ = ["DATA", "TP", "PlacedParams", "Row", "Sharded", "canonical",
           "cat_on", "current_axis_names", "cut", "global_norm", "groups",
           "leads", "logical", "model_param_specs", "param_specs", "place",
           "place_batch", "place_params", "recut", "reduce_grads", "refine_slices",
           "replica_plan", "rows", "shard", "sum_on", "tree_leaves",
           "tree_map", "write_blocks", "zeros", "zero1_specs"]

#: logical batch axes (flattened onto whichever of these exist in the mesh)
DATA = ("pod", "data")
#: tensor-parallel axis
TP = "model"

#: The dry run's hook (:mod:`repro_torch.launch.dryrun`): None, or a
#: callable that takes a collective's kind and returns a context manager
#: under which the helper's copies between devices are counted as that
#: kind.  Each helper that moves blocks between a mesh's devices names the
#: collective GSPMD would insert for it: :func:`sum_on` an all-reduce,
#: :func:`cat_on`, :meth:`Sharded.full` and :meth:`Sharded.local` an
#: all-gather, :func:`reduce_grads` a reduce-scatter, :func:`write_blocks`
#: a collective-permute.  While it is None a helper is its plain call.
COLLECTIVE_TAG = None


def _collective(kind: str):
    """The helper's copies counted as ``kind`` while a dry run records."""
    def wrap(fn):
        @functools.wraps(fn)
        def tagged(*args, **kwargs):
            if COLLECTIVE_TAG is None:
                return fn(*args, **kwargs)
            with COLLECTIVE_TAG(kind):
                return fn(*args, **kwargs)
        return tagged
    return wrap


def current_axis_names(ctx: MeshContext | None = None) -> tuple[str, ...]:
    ctx = current_mesh_context() if ctx is None else MeshContext.of(ctx)
    return ctx.axis_names


def _filter(axis, present) -> Any:
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in present)
        return kept if kept else None
    return axis if axis in present else None


def logical(*axes, ctx: MeshContext | None = None) -> tuple:
    """A spec from logical axes, filtered to the active mesh."""
    present = current_axis_names(ctx)
    return canonical(_filter(a, present) for a in axes)


# ---------------------------------------------------------------------------
# Sharded values
# ---------------------------------------------------------------------------


def _names(axis) -> tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _block(mesh: Mesh, coord: tuple[int, ...], axis) -> tuple[int, int]:
    """(block index, block count) of the device at ``coord`` along a spec
    entry: row-major over the entry's axes in the order it names them."""
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    sizes = mesh.devices.shape
    idx, n = 0, 1
    for a in _names(axis):
        idx = idx * sizes[pos[a]] + coord[pos[a]]
        n *= sizes[pos[a]]
    return idx, n


def _slices(shape, spec, mesh: Mesh, coord) -> tuple[slice, ...]:
    out = []
    for dim, axis in zip(shape, spec):
        idx, n = _block(mesh, coord, axis)
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _canon(axis):
    """A spec entry in one form: a one-name tuple is that name (as
    JAX's ``PartitionSpec`` reads it), an empty one None."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


def canonical(spec) -> tuple:
    return tuple(_canon(a) for a in spec)


def _full_spec(spec, ndim: int) -> tuple:
    spec = canonical(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


class Sharded:
    """A value of global ``shape`` placed on ``mesh`` by ``spec``:
    ``pieces[coord]`` is the block the device ``mesh.devices[coord]`` holds
    (an object array of the mesh's shape).  Pieces along axes the spec does
    not name are replicas."""

    __slots__ = ("mesh", "spec", "shape", "pieces")

    def __init__(self, mesh: Mesh, spec: tuple, shape, pieces: np.ndarray):
        self.mesh = mesh
        self.spec = _full_spec(spec, len(shape))
        self.shape = tuple(int(s) for s in shape)
        self.pieces = pieces

    def tp_dim(self) -> int | None:
        """The dim the model axis splits, or None."""
        for i, axis in enumerate(self.spec):
            if TP in _names(axis):
                return i
        return None

    def block(self, coord: tuple[int, ...], dim: int) -> tuple[int, int]:
        """(block index, block count) of the piece at ``coord`` along
        ``dim``."""
        return _block(self.mesh, coord, self.spec[dim])

    @property
    def dtype(self) -> torch.dtype:
        return next(t for t in self.pieces.flat if t is not None).dtype

    @_collective("all-gather")
    def full(self, device=None) -> torch.Tensor:
        """The whole value gathered on ``device`` (default: the mesh's first
        device); each block read from its first coordinate, so a reduced
        value (:func:`reduce_grads`) gathers too.  Differentiable."""
        dev = self.mesh.devices.flat[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for grp in groups(self):
            out[_slices(self.shape, self.spec, self.mesh, grp[0])] = \
                self.pieces[grp[0]].to(dev)
        return out

    @classmethod
    def empty(cls, mesh: Mesh, spec, shape) -> "Sharded":
        """A value with no pieces yet (to be filled block by block)."""
        return cls(mesh, spec, shape, np.empty(mesh.devices.shape, dtype=object))

    def region(self, coord: tuple[int, ...]) -> tuple[slice, ...]:
        """The slices of the whole value the piece at ``coord`` holds."""
        return _slices(self.shape, self.spec, self.mesh, coord)

    @_collective("all-gather")
    def local(self, coord: tuple[int, ...]) -> torch.Tensor:
        """The block the device at ``coord`` computes with: its piece, or,
        where the spec splits a dim over a data axis (a parameter placed
        under ``FSDP_PARAMS``), the pieces of its data blocks that share the
        device's other coordinates joined along that dim on the device (the
        all-gather GSPMD inserts before the use).  Differentiable, as
        :meth:`full` is."""
        dim = _data_dim(self.spec)
        if dim is None:
            return self.pieces[coord]
        dev = self.mesh.devices[coord]
        names, sizes = self.mesh.axis_names, self.mesh.devices.shape
        axes = [names.index(a) for a in _names(self.spec[dim])]
        peers = []
        for vals in np.ndindex(*(sizes[i] for i in axes)):
            c = list(coord)
            for i, v in zip(axes, vals):
                c[i] = v
            peers.append(tuple(c))
        peers.sort(key=lambda c: self.block(c, dim)[0])
        if len(peers) == 1:
            return self.pieces[coord]
        return torch.cat([self.pieces[c].to(dev) for c in peers], dim=dim)

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, spec={self.spec}, {self.mesh!r})"


@functools.lru_cache(maxsize=1024)
def _data_dim(spec: tuple) -> int | None:
    """The dim a spec splits over data axes (:data:`DATA`), or None; a dim
    that names a data axis beside a model one, or two such dims, is not
    a layout the port places parameters in."""
    dims = [i for i, a in enumerate(spec) if set(_names(a)) & set(DATA)]
    if not dims:
        return None
    if len(dims) > 1 or set(_names(spec[dims[0]])) - set(DATA):
        raise ValueError(f"spec {spec}: a parameter splits one dim over data "
                         "axes alone")
    return dims[0]


def _pieces(mesh: Mesh, make) -> np.ndarray:
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for coord in np.ndindex(mesh.devices.shape):
        pieces[coord] = make(coord, mesh.devices[coord])
    return pieces


def place(x: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """``x`` cut by ``spec`` (every named axis must divide its dim), each
    block copied to its device: a fresh contiguous tensor a piece."""
    spec = _full_spec(spec, x.ndim)
    sizes = mesh.shape
    for dim, axis in zip(x.shape, spec):
        n = math.prod(sizes[a] for a in _names(axis))
        if dim % n:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(x.shape)} on {mesh!r}")
    with torch.no_grad():
        pieces = _pieces(mesh, lambda coord, dev: x[
            _slices(x.shape, spec, mesh, coord)].to(dev, copy=True).contiguous())
    return Sharded(mesh, spec, x.shape, pieces)


def zeros(shape, spec, mesh: Mesh, dtype, fill=0) -> Sharded:
    """A value of ``shape`` full of ``fill`` placed by ``spec``, each piece
    made on its device at its own shape (no whole value is made)."""
    spec = _full_spec(spec, len(shape))
    local = tuple(dim // _block(mesh, (0,) * mesh.devices.ndim, axis)[1]
                  for dim, axis in zip(shape, spec))
    return Sharded(mesh, spec, shape, _pieces(
        mesh, lambda coord, dev: torch.full(local, fill, dtype=dtype, device=dev)))


def cut(x: Sharded, spec, dtype=None) -> Sharded:
    """``x`` placed by the finer ``spec`` (each of its blocks inside one of
    ``x``'s), every piece a fresh copy on its device, in ``dtype`` (default
    ``x``'s): ZeRO-1's share of a parameter."""
    out = Sharded.empty(x.mesh, spec, x.shape)
    with torch.no_grad():
        for coord in np.ndindex(x.pieces.shape):
            rel = _relative(out.region(coord), x.region(coord))
            out.pieces[coord] = x.pieces[coord][rel].to(
                dtype=dtype or x.dtype, copy=True).contiguous()
    return out


def _relative(inner: tuple[slice, ...], outer: tuple[slice, ...]) -> tuple[slice, ...]:
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for i, o in zip(inner, outer))


def _inside(inner: tuple[slice, ...], outer: tuple[slice, ...]) -> bool:
    return all(o.start <= i.start and i.stop <= o.stop
               for i, o in zip(inner, outer))


def _used(spec) -> set[str]:
    return {a for axis in spec for a in _names(axis)}


def groups(x: Sharded) -> list[tuple[tuple[int, ...], ...]]:
    """The mesh's coordinates grouped by the block of ``x`` they hold:
    each group in coordinate order (its first is the block's first
    coordinate, zero along every axis the spec does not name), the groups
    in their first coordinates' order."""
    return _groups(x.mesh.axis_names, x.mesh.devices.shape, x.spec)


@functools.lru_cache(maxsize=1024)
def _groups(names, shape, spec):
    used = _used(spec)
    out: dict[tuple, list] = {}
    for coord in np.ndindex(shape):
        key = tuple(c for a, c in zip(names, coord) if a in used)
        out.setdefault(key, []).append(coord)
    return tuple(tuple(g) for g in out.values())


def leads(x: Sharded):
    """(first coordinate, its piece) of each block of ``x``."""
    return ((grp[0], x.pieces[grp[0]]) for grp in groups(x))


@_collective("reduce-scatter")
def reduce_grads(leaf: Sharded, grads: dict, spec=None) -> Sharded:
    """The gradient of ``leaf`` given each piece's (``grads[coord]``, None
    for a piece the loss did not reach): the pieces of a block summed in
    coordinate order (the all-reduce over the axes the spec does not
    name), a zero block where none was reached.  A reduced value in
    ``spec`` (default ``leaf``'s; a finer one, each of its blocks inside
    one of ``leaf``'s, sums each of its blocks from the same rows of the
    pieces, on that block's first device: the reduce-scatter)."""
    spec = leaf.spec if spec is None else spec
    out = Sharded.empty(leaf.mesh, spec, leaf.shape)
    holders = {c: grp for grp in groups(leaf) for c in grp}
    for grp in groups(out):
        c = grp[0]
        rel = refine_slices(out, leaf, c)
        parts = [grads[h][rel] for h in holders[c] if grads.get(h) is not None]
        out.pieces[c] = (sum_on(parts, leaf.mesh.devices[c]) if parts
                         else torch.zeros_like(leaf.pieces[c][rel]))
    return out


def recut(x: Sharded, spec) -> Sharded:
    """The reduced ``x`` (one piece a block, :func:`reduce_grads`) on the
    finer ``spec``: each block the rows of ``x``'s block that holds it, on
    that block's first device; ``x`` itself where the specs agree.  A
    gradient reduced by the parameters' spec meets its ZeRO-1 moments so."""
    out = Sharded.empty(x.mesh, spec, x.shape)
    if out.spec == x.spec:
        return x
    for grp in groups(out):
        if not _inside(out.region(grp[0]), x.region(grp[0])):
            raise ValueError(f"spec {out.spec} does not refine {x.spec} "
                             f"(shape {x.shape})")
    return reduce_grads(x, dict(leads(x)), out.spec)


def refine_slices(fine: Sharded, coarse: Sharded, coord) -> tuple[slice, ...]:
    """The slices of ``coarse``'s piece at ``coord`` that ``fine``'s piece
    there holds (``fine``'s spec refining ``coarse``'s)."""
    return _relative(fine.region(coord), coarse.region(coord))


@functools.lru_cache(maxsize=1024)
def _copy_plan(names, shape, dst_spec, src_spec, value_shape):
    """(coordinate, slices of its piece, the source block's first
    coordinate) of every source block inside every piece of ``dst``."""
    mesh = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))
    plan = []
    src_firsts = [g[0] for g in _groups(names, shape, src_spec)]
    for coord in np.ndindex(shape):
        outer = _slices(value_shape, dst_spec, mesh, coord)
        for first in src_firsts:
            inner = _slices(value_shape, src_spec, mesh, first)
            if _inside(inner, outer):
                plan.append((coord, _relative(inner, outer), first))
    return tuple(plan)


@_collective("collective-permute")
@torch.no_grad()
def write_blocks(dst: Sharded, src: Sharded) -> None:
    """Copy each block of the reduced ``src`` (its spec ``dst``'s or a
    finer one) into every piece of ``dst`` that holds it, in place (the
    all-gather of updated blocks; ``write_blocks(m, m)`` brings the
    replicas of ``m``'s blocks up to their first pieces)."""
    mesh = dst.mesh
    for coord, rel, first in _copy_plan(mesh.axis_names, mesh.devices.shape,
                                        dst.spec, src.spec, dst.shape):
        if dst is src and coord == first:
            continue
        dst.pieces[coord][rel].copy_(src.pieces[first])


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of reduced values (name -> Sharded),
    float32, each block counted once, on the first value's mesh's first
    device."""
    dev = None
    total = []
    for x in tree.values():
        dev = x.mesh.devices.flat[0] if dev is None else dev
        total += [torch.sum(torch.square(t.float())) for _, t in leads(x)]
    return torch.sqrt(sum_on(total, dev))


def shard(x, *axes, ctx: MeshContext | None = None):
    """``x`` placed on the active mesh by logical axes.

    ``x`` unchanged without a mesh; drops any axis absent from the mesh, and
    any whose mesh size does not divide the corresponding dim (e.g. 12
    attention heads on a 16-way model axis): those dims replicate.
    """
    ctx = current_mesh_context() if ctx is None else MeshContext.of(ctx)
    if ctx.empty:
        return x
    present = ctx.axis_names
    spec = []
    for i, axis in enumerate(axes):
        a = _filter(axis, present)
        if a is not None and x.shape[i] % ctx.axis_size(a) != 0:
            a = None
        spec.append(a)
    return place(x, tuple(spec), ctx.mesh)


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------
#
# Rules map a leaf's path (joined with '/') to a spec over its TRAILING dims;
# leading dims are padded with None.  First match wins.

_RULES: list[tuple[str, tuple]] = [
    # embeddings / unembedding: vocab over TP
    (r"tok_embed$", (TP, None)),
    (r"lm_head$", (None, TP)),
    (r"ctx_proj$", (None, TP)),
    # attention: column-parallel QKV, row-parallel output
    (r"(wq|wk|wv)$", (None, TP)),
    (r"(bq|bk|bv)$", (TP,)),
    (r"wo$", (TP, None)),
    # dense / shared-expert MLP: column in, row out
    (r"(w_gate|w_up)$", (None, TP)),
    (r"w_down$", (TP, None)),
    # MoE experts: expert-parallel when E % model == 0, else per-expert
    # tensor parallel
    (r"experts_(gate|up)$", ("EP_OR_TP_IN", None, None)),
    (r"experts_down$", ("EP_OR_TP_OUT", None, None)),
    (r"router$", (None, None)),
    # Mamba/SSD: channel dims over TP
    (r"in_proj$", (None, TP)),
    (r"out_proj$", (TP, None)),
    (r"conv_w$", (TP, None)),
    (r"conv_b$", (TP,)),
    (r"(A_log|dt_bias)$", (None,)),
    (r"(D)$", (None,)),
    # norms, scalars: replicated
    (r".*", ()),
]


def _spec_for(path: str, shape: tuple[int, ...], ep_ok: bool,
              sizes: dict[str, int]) -> tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = tuple(spec)
            if spec and spec[0] == "EP_OR_TP_IN":
                spec = (TP, None, None) if ep_ok else (None, None, TP)
            elif spec and spec[0] == "EP_OR_TP_OUT":
                spec = (TP, None, None) if ep_ok else (None, TP, None)
            full = (None,) * (len(shape) - len(spec)) + spec
            # drop axes that do not divide the dim (e.g. vocab 122753 on a
            # 16-way model axis): those weights replicate instead
            return tuple(
                a if a is None or shape[i] % sizes.get(a, 1) == 0 else None
                for i, a in enumerate(full))
    return ()


def _path(name: str) -> str:
    """The reference path a rule matches for the port's parameter ``name``."""
    from repro_torch.models.convert import reference_path  # convert imports the model

    return "/".join(reference_path(name)[0])


def _named_shapes(params) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every leaf: an :class:`~torch.nn.Module`'s named
    parameters, or a mapping of names to anything with a ``shape``."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return [(n, tuple(p.shape)) for n, p in items]


def param_specs(params, n_experts: int = 0, model_axis_size: int = 1,
                mesh=None) -> dict[str, tuple]:
    """Parameter name -> spec for ``params`` (an LM or a mapping of names
    to shaped values).

    ``n_experts`` / ``model_axis_size`` decide expert-parallel vs in-expert
    tensor-parallel sharding for MoE weights.  ``mesh`` (a Mesh or
    MeshContext; default: the ambient mesh context) provides axis sizes for
    divisibility checks.
    """
    ep_ok = n_experts > 0 and model_axis_size > 0 and n_experts % model_axis_size == 0
    ctx = current_mesh_context() if mesh is None else MeshContext.of(mesh)
    sizes = ctx.shape
    if model_axis_size and TP not in sizes:
        sizes[TP] = model_axis_size
    return {n: _spec_for(_path(n), shape, ep_ok, sizes)
            for n, shape in _named_shapes(params)}


def zero1_specs(params, specs: dict[str, tuple], data_size: int,
                data_axis: str = "data") -> dict[str, tuple]:
    """ZeRO-1: optimizer-state specs with the first replicated, divisible
    dim sharded over the data axis.  Non-divisible or already-sharded dims
    stay put."""
    out = {}
    for name, shape in _named_shapes(params):
        spec = tuple(specs[name])
        if len(shape) == 0:
            out[name] = spec
            continue
        parts = spec if spec else (None,) * len(shape)
        if parts[0] is None and shape[0] % max(data_size, 1) == 0:
            out[name] = (data_axis,) + tuple(parts[1:])
        else:
            out[name] = spec
    return out


def model_param_specs(cfg, params, mesh) -> dict[str, tuple]:
    """The specs of a model's parameters on ``mesh``: :func:`param_specs`
    with the config's expert count and the mesh's model axis."""
    ctx = MeshContext.of(mesh)
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    return param_specs(params, n_experts=n_exp,
                       model_axis_size=ctx.axis_size(TP), mesh=mesh)


class PlacedParams:
    """A model's parameters placed on a mesh: name (an ``LM``
    ``named_parameters()`` name) -> :class:`Sharded`.  :meth:`sub` views a
    submodule (``p.sub("blocks.0").sub("attn")["wq"]``)."""

    def __init__(self, mesh: Mesh, leaves: dict[str, Sharded], prefix: str = "",
                 _groups: frozenset | None = None):
        self.mesh = mesh
        self.leaves = leaves
        self.prefix = prefix
        if _groups is None:
            _groups = frozenset(
                ".".join(n.split(".")[:i]) for n in leaves
                for i in range(1, n.count(".") + 1))
        self._groups = _groups

    @property
    def device(self) -> torch.device:
        """The first device of the mesh: where results land."""
        return self.mesh.devices.flat[0]

    def __getitem__(self, name: str) -> Sharded:
        return self.leaves[self.prefix + name]

    def __contains__(self, name: str) -> bool:
        full = self.prefix + name
        return full in self.leaves or full in self._groups

    def sub(self, name: str) -> "PlacedParams":
        return PlacedParams(self.mesh, self.leaves, f"{self.prefix}{name}.",
                            self._groups)

    def named_leaves(self):
        return ((n[len(self.prefix):], v) for n, v in self.leaves.items()
                if n.startswith(self.prefix))

    def items(self):
        """(name, :class:`Sharded`) of every leaf under the prefix: what
        :func:`param_specs` reads of a mapping."""
        return list(self.named_leaves())

    def pieces(self) -> list[torch.Tensor]:
        """Every piece of every leaf, leaf by leaf in coordinate order."""
        return [t for _, leaf in self.named_leaves() for t in leaf.pieces.flat]

    def requires_grad_(self, flag: bool = True) -> "PlacedParams":
        """Every piece made (or no longer) a leaf that requires grad."""
        for t in self.pieces():
            t.requires_grad_(flag)
        return self

    def to(self, dtype: torch.dtype) -> "PlacedParams":
        """Every piece cast to ``dtype`` in place of the old one (as
        ``nn.Module.to`` swaps a parameter's data), keeping whether it
        requires grad."""
        with torch.no_grad():
            for _, leaf in self.named_leaves():
                for coord in np.ndindex(leaf.pieces.shape):
                    t = leaf.pieces[coord]
                    leaf.pieces[coord] = t.to(dtype).requires_grad_(t.requires_grad)
        return self


def place_params(params, cfg, mesh: Mesh) -> PlacedParams:
    """``params`` (an ``LM``) placed on ``mesh`` by
    :func:`repro_torch.launch.specs.param_shardings` (the partition rules,
    and ZeRO-1's split over ``data`` under its ``FSDP_PARAMS``), leaf by
    leaf; the pieces require grad where the parameters do."""
    from repro_torch.launch.specs import param_shardings  # specs imports this module

    specs = param_shardings(mesh, cfg, params)
    placed = PlacedParams(mesh, {n: place(p, specs[n], mesh)
                                 for n, p in params.named_parameters()})
    return placed.requires_grad_(any(p.requires_grad for p in params.parameters()))


# ---------------------------------------------------------------------------
# Data replicas
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Row:
    """One data replica of a mesh: the devices of its model axis in model
    order (the first is the replica's lead, where its residual stream,
    norms, routing and combines run) and their mesh coordinates."""

    index: int
    coords: tuple[tuple[int, ...], ...]
    devices: tuple[torch.device, ...]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    def pieces(self, leaf: Sharded) -> list[torch.Tensor]:
        """Each model device's block of a placed parameter
        (:meth:`Sharded.local`: gathered over ``data`` where its spec
        splits it so)."""
        return [leaf.local(c) for c in self.coords]


@_collective("all-reduce")
def sum_on(parts: list[torch.Tensor], device) -> torch.Tensor:
    """The partial results of a row's devices summed on ``device``, in
    model order (the all-reduce of a row-parallel product)."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out


@_collective("all-gather")
def cat_on(parts: list[torch.Tensor], device, dim: int) -> torch.Tensor:
    """The blocks of a row's devices joined on ``device`` along ``dim``
    (the all-gather of a column-parallel product)."""
    return torch.cat([part.to(device) for part in parts], dim=dim)


def replica_plan(mesh: Mesh, batch: int,
                 replica: int = 0) -> list[tuple[Row, slice | None]]:
    """The data replicas a batch of ``batch`` rows runs on and each one's
    rows: every replica its equal share where their count divides the
    batch (``batch_shardings``' split), else replica ``replica`` the whole
    batch (``None``: a b = 1 admission, or a batch the reference
    replicates)."""
    replicas = rows(mesh)
    n = len(replicas)
    if batch % n == 0 and n > 1:
        share = batch // n
        return [(row, slice(row.index * share, (row.index + 1) * share))
                for row in replicas]
    return [(replicas[replica if batch % n else 0], None)]


def place_batch(batch: dict, mesh: Mesh) -> list[tuple[Row, dict]]:
    """A train batch (``tokens``, ``labels`` and any ``ctx_embeds``: numpy
    or tensors) split over the data replicas by :func:`replica_plan`: each
    replica's rows, the labels on its lead device, the tokens as given
    (host ids are checked against the vocabulary by the embedding before
    their upload), the context uploaded by the model's forward."""
    out = []
    for row, part in replica_plan(mesh, batch["tokens"].shape[0]):
        share = {k: v if part is None else v[part] for k, v in batch.items()}
        share["labels"] = torch.as_tensor(share["labels"]).to(row.lead)
        out.append((row, share))
    return out


def rows(mesh: Mesh) -> list[Row]:
    """The data replicas of ``mesh``, in the order the batch splits over
    :data:`DATA` (row-major over the data axes present); axes that are
    neither data nor model stay at index 0."""
    names = mesh.axis_names
    sizes = mesh.devices.shape
    dp = [names.index(a) for a in DATA if a in names]
    tp = names.index(TP) if TP in names else None
    out = []
    for r, dcoord in enumerate(np.ndindex(*(sizes[i] for i in dp))):
        coords = []
        for m in range(sizes[tp] if tp is not None else 1):
            c = [0] * len(names)
            for i, v in zip(dp, dcoord):
                c[i] = v
            if tp is not None:
                c[tp] = m
            coords.append(tuple(c))
        out.append(Row(r, tuple(coords),
                       tuple(mesh.devices[c] for c in coords)))
    return out


# ---------------------------------------------------------------------------
# Trees of caches and specs
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts and NamedTuples (``None`` stays
    ``None``); ``rest`` are trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
