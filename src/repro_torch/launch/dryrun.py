"""Multi-pod dry run — port of ``repro.launch.dryrun``: every (arch x shape x
mesh) cell built and run once at the published widths on 256 / 512
placeholder devices, without hardware.

The reference lowers and compiles each cell on placeholder *host* devices
(``--xla_force_host_platform_device_count=512``) and records XLA's memory
and cost analyses and the collectives of the partitioned HLO.  The port
runs eagerly, so its counterpart runs the cell's step once on **fake
tensors** (``torch._subclasses.fake_tensor``) on the placeholder host
devices ``cpu:0 … cpu:n-1``: every parameter, optimizer moment, cache and
batch leaf has its shape, dtype and device and no storage.  No byte is
allocated and nothing is computed on any device, and no card is needed or
touched; this is not a CPU fallback, since a fake tensor has no values.
The placeholders are host devices, not fake cards: a fake CUDA tensor
cannot take a train step in a CPU-only PyTorch, and the ``meta`` device
drops the index that lets each figure be charged to a device.  The port's
placement (:func:`repro_torch.models.sharding.place`) puts each piece on
its coordinate's own index.  A ``torch.device`` index is an int8, so one
process names at most 128 distinct placeholders (:data:`MAX_PLACEHOLDERS`):
a mesh of up to 128 devices gets one a device; the production meshes (256,
512) give each device of their first seven data replicas its own and let
the later replicas share the eighth's (:func:`placeholders`).  The port's
replicas past the first run the same work on the same shapes and exchange
blocks only in the reductions and gathers over every replica, so the
figures of replicas 1–6 are those of every later one; the shared
placeholders' sums are not reported.  The run shows, per placeholder
device:

* ``argument_size_in_bytes``: the pieces of the parameters or train
  state and of the caches the device holds, and its block of the batch
  as ``batch_shardings`` splits it (the port's entry points take the
  batch from the host; each device uploads its replica's rows): every
  device's, counted by mesh coordinate;
* ``output_size_in_bytes``: the storage of the step's results there (the
  train step updates its state in place, so its output aliases it);
* ``peak_bytes_per_device``: the live bytes at the high-water mark of the
  step, arguments included, kernels' scratch included (each kernel's
  abstract form allocates what its card path allocates,
  :mod:`repro_torch.kernels.abstract`); ``temp_size_in_bytes`` = peak −
  arguments;
* ``flops``: the aten operations' (``torch.utils.flop_counter``'s
  formulas) plus kernels B8 / B9's charges, shown apart;
* ``bytes_accessed``: the inputs plus the outputs of every aten operation
  that is not a view or an allocation (unfused, as XLA counts them), plus
  the kernels' least bytes;
* ``collectives``: the bytes the port really copies between distinct
  placeholder devices, each copy under the kind the helper that issued it
  names (:data:`repro_torch.models.sharding.COLLECTIVE_TAG`: ``sum_on``
  all-reduce, ``cat_on`` / ``Sharded.full`` / ``Sharded.local``
  all-gather, ``reduce_grads`` reduce-scatter, ``write_blocks``
  collective-permute), a copy no helper issued under ``"copy"`` (a
  replica's activations handed from its lead to its model devices, a
  replica's new caches copied to the others); the reference's schema,
  ``kinds`` -> ``count`` / ``result_bytes`` / ``wire_bytes`` and totals,
  the bytes the device that receives most takes in.

The port's mesh keeps norms, residuals and sums on each data replica's
lead device (:mod:`repro_torch.models.blocks`), so its devices are not
symmetric as GSPMD's are: each figure is the largest over the devices
(the top-level key), the mesh's first device's (``lead``) and the device
that has the largest (``argmax``).  Every layer runs, so the counts are
at full depth: the reference's two unrolled compiles and their
extrapolation (XLA counts a ``while`` body once) have no counterpart, and
``--opt extrapolate=...`` is accepted and recorded as changing nothing.

Usage (records in ``results/dryrun_torch/*.json``):
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force] [--jobs 4]
  python -m repro_torch.launch.dryrun --arch ... --opt remat=full,zero1=0,mesh=2x2

``--all`` runs each cell in a process of its own, as the reference's does.
A cell keeps one CPU core busy for minutes (a train cell up to 98 min):
the 33 single-pod cells take about 11 core-hours, so ``--jobs N`` (not in
the reference's CLI) runs N of them at once.

This module sets nothing in the environment and imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import weakref
from collections import defaultdict
from typing import Any

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import configs
from repro_torch.compat import MeshContext
from repro_torch.kernels import abstract
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh_from_plan, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as shrd
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["Accounting", "DTYPE", "MAX_PLACEHOLDERS", "NO_COUNTERPART", "RESULTS_DIR",
           "apply_opt_flags", "argument_bytes", "batch_bytes", "build_cell",
           "main", "parse_opts",
           "placeholders", "recording", "result_path", "run_cell", "run_step",
           "step_fn", "train_config", "tree_bytes"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")

#: Record keys of the reference with no counterpart here: the port has no
#: HLO and generates no code.
NO_COUNTERPART = ("hlo_lines", "generated_code_size_in_bytes")

_FIGURES = ("argument_size_in_bytes", "output_size_in_bytes",
            "peak_bytes_per_device", "temp_size_in_bytes", "flops",
            "bytes_accessed")

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}
_COPIES = (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default)
_DEVICE = torch.ops.prim.device.default


# ---------------------------------------------------------------------------
# The accounting
# ---------------------------------------------------------------------------


#: Distinct placeholder host devices one process can name: a
#: ``torch.device`` index is an int8, so ``cpu:0 … cpu:127``.
MAX_PLACEHOLDERS = 128


def placeholders(n: int, model: int = 1) -> list[torch.device]:
    """The placeholder host devices of an n-device mesh whose last axis
    (``model``) has ``model`` devices, in row-major mesh order: ``cpu:0 …
    cpu:n-1`` for n up to :data:`MAX_PLACEHOLDERS`.  A larger mesh gives
    each of its first data replicas (rows of ``model`` devices) a
    placeholder a device and lets every later replica share the last
    row's: the port's replicas past the first run the same work on the
    same shapes and never exchange blocks with one another except to
    reduce or gather over all of them, so the first rows stand for the
    rest (``run_step`` reports only placeholders no other device shares)."""
    if n <= MAX_PLACEHOLDERS:
        return [torch.device("cpu", i) for i in range(n)]
    rows = MAX_PLACEHOLDERS // model
    if rows < 3:
        raise ValueError(f"a {n}-device mesh with a {model}-device model axis "
                         f"needs {model} placeholders a data replica for at "
                         f"least 3 replicas; {MAX_PLACEHOLDERS} exist")
    return [torch.device("cpu", min(f // model, rows - 1) * model + f % model)
            for f in range(n)]


def _exact(mesh) -> list[int]:
    """The placeholder indices that one device of ``mesh`` has to itself,
    in mesh order (one placeholder, index 0, without a mesh)."""
    if mesh is None:
        return [0]
    seen: dict = defaultdict(int)
    for d in mesh.devices.flat:
        seen[d.index] += 1
    return [d.index for d in mesh.devices.flat if seen[d.index] == 1]


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _index(t: torch.Tensor) -> int | None:
    """The placeholder a fake tensor lies on; None for the host."""
    return t.device.index


@functools.cache
def _counted(func) -> bool:
    """Whether an op's inputs and outputs count as bytes accessed: not a
    view (a result aliasing an input it does not write) nor an
    allocation."""
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    return not view and func._overloadpacket.__name__ not in _ALLOCATIONS


class _Tag:
    """The collective kind of the helper being run (the outermost wins)."""

    __slots__ = ("acct", "kind", "outer")

    def __init__(self, acct: "Accounting", kind: str):
        self.acct, self.kind = acct, kind

    def __enter__(self):
        self.outer = self.acct.kind
        if self.outer is None:
            self.acct.kind = self.kind

    def __exit__(self, *exc):
        self.acct.kind = self.outer
        return False


class Accounting(TorchDispatchMode):
    """Per-device bookkeeping of every aten op dispatched under it: live
    and peak storage bytes, flops, bytes accessed, copies between devices
    by collective kind; the kernels' abstract forms charge their work here
    (:func:`repro_torch.kernels.abstract.charge`).  Device None is the
    host."""

    def __init__(self):
        super().__init__()
        self.live: dict = defaultdict(int)
        self.peak: dict = defaultdict(int)
        self._owned: dict = {}
        self.counting = False
        self.kind: str | None = None
        self.reset()

    def reset(self) -> None:
        """Zero the step's counts; the peak starts at the bytes live now."""
        self.peak = defaultdict(int, self.live)
        self.flops: dict = defaultdict(int)
        self.bytes: dict = defaultdict(int)
        self.kernel_flops: dict = defaultdict(int)
        self.kernel_bytes: dict = defaultdict(int)
        self.kernels: dict = defaultdict(lambda: {"launches": 0, "flops": 0,
                                                  "bytes": 0})
        self.received: dict = defaultdict(lambda: defaultdict(int))
        self.copies: dict = defaultdict(int)
        self.host_to_device: dict = defaultdict(int)
        self.device_to_host: dict = defaultdict(int)

    # -- storage ----------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._owned:
            return
        dev, nbytes = _index(t), st.nbytes()

        def free(_, key=key, dev=dev, nbytes=nbytes, owned=self._owned,
                 live=self.live):
            owned.pop(key, None)
            live[dev] -= nbytes
        self._owned[key] = weakref.ref(st, free)
        self.live[dev] += nbytes
        if self.live[dev] > self.peak[dev]:
            self.peak[dev] = self.live[dev]

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _COPIES[1] and all(isinstance(a, FakeTensor) for a in args[:2]):
            out = args[0]            # a fake copy_ computes nothing: its result
        else:                        # is its destination
            out = func(*args, **kwargs)
        if func is _DEVICE:          # a query, half of all ops: nothing to count
            return out
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        for t in outs:
            self._track(t)
        if not self.counting:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        dev = _index(outs[0]) if outs else (_index(ins[0]) if ins else None)
        counter = flop_registry.get(func._overloadpacket)
        if counter is not None:
            self.flops[dev] += int(counter(*args, **kwargs, out_val=out))
        if _counted(func):
            self.bytes[dev] += sum(t.numel() * t.element_size()
                                   for t in ins + outs)
        if func in _COPIES:
            src = ins[1] if func is _COPIES[1] else ins[0]
            dst = outs[0]
            self._moved(_index(src), _index(dst),
                        src.numel() * src.element_size())
        return out

    def _moved(self, src, dst, nbytes: int) -> None:
        if src == dst:
            return
        if src is None:
            self.host_to_device[dst] += nbytes
        elif dst is None:
            self.device_to_host[src] += nbytes
        else:
            kind = self.kind or "copy"
            self.received[kind][dst] += nbytes
            self.copies[kind] += 1

    # -- hooks ----------------------------------------------------------------

    def tag(self, kind: str) -> _Tag:
        return _Tag(self, kind)

    def charge(self, name: str, device: torch.device, flops: int,
               nbytes: int) -> None:
        if not self.counting:
            return
        dev = device.index
        self.kernel_flops[dev] += flops
        self.kernel_bytes[dev] += nbytes
        k = self.kernels[name]
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


class recording:
    """A fake-tensor mode with an :class:`Accounting` over it and the
    helpers' and kernels' hooks pointed at it, for the block.  The
    ``Accounting`` is the context's value.  ``base``: another mode in the
    fake mode's place (the parity tests run a real step so, on tensors
    that report their placeholder)."""

    def __init__(self, base: TorchDispatchMode | None = None):
        self.base = base

    def __enter__(self) -> Accounting:
        from torch._subclasses.fake_tensor import FakeTensorMode

        self._fake = (FakeTensorMode(allow_non_fake_inputs=True)
                      if self.base is None else self.base)
        self._fake.__enter__()
        self.acct = Accounting()
        self.acct.__enter__()
        self._hooks = (shrd.COLLECTIVE_TAG, abstract.CHARGE)
        shrd.COLLECTIVE_TAG = self.acct.tag
        abstract.CHARGE = self.acct.charge
        return self.acct

    def __exit__(self, *exc):
        shrd.COLLECTIVE_TAG, abstract.CHARGE = self._hooks
        self.acct.__exit__(*exc)
        self._fake.__exit__(*exc)
        return False


def tree_bytes(tree, acc: dict | None = None, seen: set | None = None) -> dict:
    """Storage bytes of a tree's tensors by device (None: the host), each
    storage once: dicts, lists, tuples and NamedTuples, modules, placed
    parameters and values and train states.  A loose tensor counts on its
    device's index, a placed value's piece on its mesh coordinate's
    position in row-major order (the index of a placeholder it has to
    itself, :func:`placeholders`)."""
    acc = defaultdict(int) if acc is None else acc
    seen = set() if seen is None else seen

    def one(t, dev):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            acc[dev] += st.nbytes()

    if tree is None:
        return acc
    if isinstance(tree, torch.Tensor):
        one(tree, _index(tree))
    elif isinstance(tree, shrd.Sharded):
        for flat, coord in enumerate(np.ndindex(tree.pieces.shape)):
            if tree.pieces[coord] is not None:
                one(tree.pieces[coord], flat)
    elif isinstance(tree, shrd.PlacedParams):
        for _, leaf in tree.named_leaves():
            tree_bytes(leaf, acc, seen)
    elif isinstance(tree, torch.nn.Module):
        for t in tree.parameters():
            one(t, _index(t))
    elif isinstance(tree, dict):
        for v in tree.values():
            tree_bytes(v, acc, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tree_bytes(v, acc, seen)
    return acc


def batch_bytes(batch: dict, mesh, n: int) -> dict:
    """Each placeholder's block of the batch as ``batch_shardings`` splits
    it (one placeholder without a mesh: the whole batch)."""
    per = 0
    if mesh is None:
        return {0: sum(t.numel() * t.element_size() for t in batch.values())}
    sizes = MeshContext.of(mesh).shape
    specs = S.batch_shardings(mesh, batch, next(iter(batch.values())).shape[0])
    for name, t in batch.items():
        block = 1
        for dim, axis in zip(t.shape, specs[name] + (None,) * t.ndim):
            names = () if axis is None else (axis,) if isinstance(axis, str) \
                else axis
            block *= dim // math.prod(sizes[a] for a in names)
        per += block * t.element_size()
    return {i: per for i in range(n)}


def argument_bytes(args: tuple, batch: dict, mesh) -> dict:
    """A step's argument bytes by device: the pieces of every argument but
    the batch (:func:`tree_bytes`) and each device's block of the batch
    (:func:`batch_bytes`)."""
    n = mesh.size if mesh is not None else 1
    arg = tree_bytes([a for a in args if a is not batch])
    for i, v in batch_bytes(batch, mesh, n).items():
        arg[i] += v
    return arg


def _figure(per_device: dict, devices: list[int]) -> dict:
    """The largest over ``devices``, the first one's and the device with
    the largest."""
    vals = [int(per_device.get(i, 0)) for i in devices]
    top = max(range(len(vals)), key=vals.__getitem__)
    return {"max": vals[top], "lead": vals[0], "argmax": devices[top]}


def run_step(fn, args: tuple, batch: dict, mesh, acct: Accounting
             ) -> tuple[dict, Any]:
    """``fn(*args)`` once under ``acct`` (and a ``FlopCounterMode``): the
    step's figures by placeholder (the record's accounting keys) and its
    output.  Each figure is over the placeholders no other device shares
    (:func:`placeholders`), the argument bytes over every device."""
    n = mesh.size if mesh is not None else 1
    exact = _exact(mesh)
    gc.collect()
    arg = argument_bytes(args, batch, mesh)
    acct.reset()
    acct.counting = True
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    try:
        with counter:
            out = fn(*args)
    finally:
        acct.counting = False
    run_s = time.perf_counter() - t0
    outb = tree_bytes(out)
    figs = {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": outb,
        "peak_bytes_per_device": acct.peak,
        "temp_size_in_bytes": {i: acct.peak.get(i, 0) - arg.get(i, 0)
                               for i in range(n)},
        "flops": {i: acct.flops.get(i, 0) + acct.kernel_flops.get(i, 0)
                  for i in range(n)},
        "bytes_accessed": {i: acct.bytes.get(i, 0) + acct.kernel_bytes.get(i, 0)
                           for i in range(n)},
    }
    rec: dict[str, Any] = {"run_s": round(run_s, 2)}
    per = {k: _figure(v, exact) for k, v in figs.items()}
    for k in _FIGURES:
        rec[k] = per[k]["max"]
    rec["lead"] = {k: per[k]["lead"] for k in _FIGURES}
    rec["argmax"] = {k: per[k]["argmax"] for k in _FIGURES}
    rec["flops_split"] = {
        "aten": int(counter.get_total_flops()),
        "aten_by_device": sum(acct.flops.get(i, 0) for i in range(n)),
        "kernels": sum(acct.kernel_flops.values()),
        "aten_max_device": _figure(acct.flops, exact)["max"],
        "kernels_max_device": _figure(acct.kernel_flops, exact)["max"]}
    rec["bytes_split"] = {
        "aten_max_device": _figure(acct.bytes, exact)["max"],
        "kernels_max_device": _figure(acct.kernel_bytes, exact)["max"],
        "host_to_device_max": _figure(acct.host_to_device, exact)["max"],
        "host_to_device_total": sum(v for k, v in acct.host_to_device.items()
                                    if k is not None),
        "device_to_host_total": sum(acct.device_to_host.values())}
    rec["kernels"] = {k: dict(v) for k, v in sorted(acct.kernels.items())}
    rec["collectives"] = _collectives(acct, exact, n)
    rec["placeholders_reported"] = len(exact)
    rec["argument_bytes_by_device"] = [int(arg.get(i, 0)) for i in range(n)]
    rec["peak_bytes_by_device"] = {i: int(acct.peak.get(i, 0)) for i in exact}
    return rec, out


def _collectives(acct: Accounting, exact: list[int], n: int) -> dict:
    """The copies between devices by kind: the bytes the device that takes
    in most receives (``wire_bytes`` and ``result_bytes``: a copy's
    result is what crosses), the lead's, and, where every device has a
    placeholder of its own, every device's together and the copies'
    count."""
    whole = len(exact) == n
    kinds = {}
    per: dict = defaultdict(int)
    for kind, recv in sorted(acct.received.items()):
        top = _figure(recv, exact)
        kinds[kind] = {"count": acct.copies[kind] if whole else None,
                       "result_bytes": top["max"], "wire_bytes": top["max"],
                       "lead_bytes": top["lead"],
                       "total_bytes": sum(recv.values()) if whole else None}
        for i, v in recv.items():
            per[i] += v
    top = _figure(per, exact)
    return {"kinds": kinds, "wire_bytes": top["max"], "result_bytes": top["max"],
            "lead_wire_bytes": top["lead"],
            "total_bytes": sum(per.values()) if whole else None}


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def parse_opts(opt: str | None) -> dict[str, str]:
    if not opt:
        return {}
    return dict(kv.split("=", 1) for kv in opt.split(",") if kv)


def _round_up(v: int, m: int) -> int:
    return m * ((v + m - 1) // m)


def apply_opt_flags(cfg, mesh, opts: dict[str, str]):
    """The reference's perf-variant toggles: the five opt-in attention and
    placement flags and ``SSD_BF16`` set on their modules (left set, as
    there), ``padvocab`` (the vocabulary rounded up to the model axis) and
    ``chunk`` (the SSD chunk) on the config."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod

    attn_mod.SEQ_SHARD_FALLBACK = opts.get("seqshard", "0") == "1"
    attn_mod.ATTN_BF16_SCORES = opts.get("attnbf16", "0") == "1"
    attn_mod.ATTN_KV_CHUNK = int(opts.get("attnchunk", "0"))
    S.KV_SEQ_SHARD = opts.get("kvseq", "0") == "1"
    S.FSDP_PARAMS = opts.get("fsdp", "0") == "1"
    ssm_mod.SSD_BF16 = opts.get("ssdbf16", "0") == "1"
    if opts.get("padvocab", "0") == "1":
        tp = MeshContext.of(mesh).axis_size("model")
        cfg = dataclasses.replace(cfg, vocab_size=_round_up(cfg.vocab_size, tp))
    if "chunk" in opts and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=int(opts["chunk"])))
    return cfg


#: The cells' activation and cache dtype (the reference's).
DTYPE = torch.bfloat16


def train_config(opts: dict[str, str]) -> TrainConfig:
    """The train cells' config: ``remat`` (default ``"dots"``), ``accum``,
    ``compress`` and ``bf16params`` from the options, bf16 activations."""
    remat = opts.get("remat", "dots")
    return TrainConfig(
        optimizer=AdamWConfig(),
        remat=None if remat in ("none", "") else remat,
        accum_steps=int(opts.get("accum", "1")),
        dtype=DTYPE,
        compress_grads=opts.get("compress", "0") == "1",
        param_dtype=torch.bfloat16 if opts.get("bf16params", "0") == "1"
        else None,
    )


def step_fn(cfg, kind: str, opts: dict[str, str]):
    """The step a cell of ``kind`` runs: the train step on (state, batch),
    a prefill or a decode step on (params, batch, caches)."""
    if kind == "train":
        return make_train_step(cfg, train_config(opts))
    if kind == "prefill":
        def prefill_fn(params, batch, caches):
            return M.prefill(params, cfg, batch, caches, dtype=DTYPE)

        return prefill_fn

    def decode_fn(params, batch, caches):   # one token against a seq_len cache
        return M.decode_step(params, cfg, batch["tokens"], caches, dtype=DTYPE)

    return decode_fn


def build_cell(cfg, shape_name: str, mesh, opts: dict[str, str]):
    """(fn, args, batch) of one cell, every leaf fake: the train step on the
    train state, or a prefill / a decode step on the parameters and
    caches, bf16 activations and caches as in the reference (``mesh``
    None: one placeholder)."""
    cfg = apply_opt_flags(cfg, mesh, opts)
    sh = configs.SHAPES[shape_name]
    batch = S.input_specs_for(cfg, shape_name)
    fn = step_fn(cfg, sh.kind, opts)
    if sh.kind == "train":
        state = S.abstract_train_state(cfg, train_config(opts), mesh,
                                       zero1=opts.get("zero1", "1") != "0")
        return fn, (state, batch), batch
    params = S.abstract_params(cfg, mesh)
    caches = S.abstract_caches(cfg, sh.global_batch, sh.seq_len, DTYPE, mesh)
    return fn, (params, batch, caches), batch


def _make_mesh(mesh_kind: str, opts: dict[str, str]):
    """The production mesh on its placeholders, or a custom geometry via
    ``--opt mesh=32x8`` (``mesh=1`` or ``mesh_kind == "one"``: one
    placeholder, no mesh)."""
    if "mesh" in opts:
        dims = tuple(int(x) for x in opts["mesh"].split("x"))
        if math.prod(dims) == 1:
            return None
        names = ("pod", "data", "model")[-len(dims):]
        return make_mesh_from_plan(dims, names,
                                   placeholders(math.prod(dims), dims[-1]))
    multi = mesh_kind == "multi"
    return make_production_mesh(multi_pod=multi,
                                devices=placeholders(512 if multi else 256, 16))


def run_cell(arch: str, shape_name: str, mesh_kind: str, opts: dict[str, str]) -> dict:
    ok, reason = configs.cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    cfg = configs.get_config(arch)
    with recording() as acct:
        mesh = _make_mesh(mesh_kind, opts)
        record: dict[str, Any] = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "mesh_shape": dict(mesh.shape) if mesh is not None else {},
            "devices": mesh.size if mesh is not None else 1,
            "placeholders": "fake tensors on host devices cpu:0 .. cpu:127",
            "opts": opts, "n_layers": cfg.n_layers,
        }
        t0 = time.perf_counter()
        fn, args, batch = build_cell(cfg, shape_name, mesh, opts)
        record["build_s"] = round(time.perf_counter() - t0, 2)
        rec, _ = run_step(fn, args, batch, mesh, acct)
        del fn, args, batch
    record.update(rec)
    record["extrapolate"] = (
        f"not applied (--opt extrapolate={opts['extrapolate']} changes "
        "nothing): every layer runs, so the counts are at full depth"
        if "extrapolate" in opts else
        "none needed: every layer runs, so the counts are at full depth")
    record["no_counterpart"] = list(NO_COUNTERPART)
    record["status"] = "ok"
    return record


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def result_path(arch, shape, mesh_kind, opts) -> str:
    suffix = ""
    if opts:
        suffix = "__" + "_".join(f"{k}-{v}" for k, v in sorted(opts.items()))
    safe_arch = arch.replace(".", "_")
    return os.path.join(
        os.path.abspath(RESULTS_DIR), f"{safe_arch}__{shape}__{mesh_kind}{suffix}.json"
    )


def _run_all(args, opts: dict[str, str]) -> int:
    """Every cell of ``configs.all_cells()`` in a subprocess of its own,
    ``--jobs`` at a time, the train cells (the longest) first; a cell whose
    record exists is skipped unless ``--force``."""
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    cells = sorted(configs.all_cells(),
                   key=lambda c: configs.SHAPES[c[1]].kind != "train")
    for arch, shape in cells:
        for mesh_kind in meshes:
            out = result_path(arch, shape, mesh_kind, opts)
            if os.path.exists(out) and not args.force:
                print(f"[cached] {arch} {shape} {mesh_kind}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
            if args.opt:
                cmd += ["--opt", args.opt]
            if args.force:
                cmd += ["--force"]
            todo.append(((arch, shape, mesh_kind), cmd))
    failures, running = [], []
    while todo or running:
        while todo and len(running) < max(args.jobs, 1):
            cell, cmd = todo.pop(0)
            print(f"[run] {' '.join(cell)}", flush=True)
            running.append((cell, subprocess.Popen(cmd)))
        time.sleep(0.2)
        for item in list(running):
            cell, proc = item
            if proc.poll() is not None:
                running.remove(item)
                if proc.returncode != 0:
                    print(f"[failed] {' '.join(cell)} (exit {proc.returncode})",
                          flush=True)
                    failures.append(cell)
    if failures:
        print("FAILED cells:", failures)
        return 1
    print("all cells ok")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS)
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once under --all (a process each)")
    ap.add_argument("--opt", default="", help="k=v,... perf variant options")
    args = ap.parse_args(argv)
    opts = parse_opts(args.opt)
    os.makedirs(os.path.abspath(RESULTS_DIR), exist_ok=True)
    if args.all:
        return _run_all(args, opts)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required without --all")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        out = result_path(args.arch, args.shape, mesh_kind, opts)
        if os.path.exists(out) and not args.force:
            print(f"[cached] {out}")
            continue
        t0 = time.perf_counter()
        try:
            record = run_cell(args.arch, args.shape, mesh_kind, opts)
        except Exception as exc:
            raise RuntimeError(f"dry run of {args.arch} {args.shape} "
                               f"{mesh_kind} failed: {exc}") from exc
        record["seconds"] = round(time.perf_counter() - t0, 2)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        status = record["status"]
        coll = record.get("collectives", {})
        print(
            f"[{status}] {args.arch} {args.shape} {mesh_kind} "
            f"flops={record.get('flops', 0):.3e} "
            f"collective_wire={coll.get('wire_bytes', 0):.3e}B "
            f"run={record.get('run_s', 0)}s in {record['seconds']}s -> {out}"
        )
        if status == "ok":
            print("per device (max):", {
                k: record.get(k) for k in
                ("argument_size_in_bytes", "temp_size_in_bytes",
                 "output_size_in_bytes", "peak_bytes_per_device")
            })
    return 0


if __name__ == "__main__":
    sys.exit(main())
