"""Parity of the port's dry run (``repro_torch.launch.dryrun``, the abstract
builders of ``repro_torch.launch.specs`` and the abstract forms of kernels
B8 / B9) with the JAX reference, on the CPU.

* (a) ``input_specs`` of every arch x shape: the reference's
  ShapeDtypeStructs, shape and dtype;
* (b) every leaf of ``abstract_params`` / ``abstract_caches`` at the
  published widths (and ``abstract_train_state`` of a dense, an MoE and an
  SSM arch) against ``jax.eval_shape`` of the reference's, the parameters
  mapped through ``convert.reference_path``;
* (c) per-device argument bytes of two reduced cells on (4, 2) against the
  reference's compiled ``memory_analysis()`` in one subprocess with 8 host
  devices: equal for mixtral's decode; the train cell (ZeRO-1 off) 8 bytes
  short, the reference's two int32 step counters (``opt["step"]`` and
  ``TrainState.step``), which the port keeps on the host as Python ints;
* (d) the dry run on ``cpu:0 … cpu:3`` placeholders against the same
  reduced cell run for real: the real step runs on real CPU tensors that
  report the placeholder they lie on (:class:`Placed`; its results
  ``torch.equal`` to the same step on ``("cpu",) * 4``), so its copies
  between devices are visible too; equal aten FLOPs (``FlopCounterMode``;
  the plain versions of B8, which the real step runs where the dry run
  charges the kernel, are left out of the count), equal transfer bytes and
  copies by kind, equal per-device argument bytes;
* (e) each abstract form of B8 / B9 (forward, backward, shard, bf16)
  against its plain version on real CPU inputs: same shapes and dtypes,
  its charge ``core.autotune``'s formula (``PERF.md`` §2), the card path's
  scratch allocated;
* (f) ``apply_opt_flags`` against the reference's: the same module flags
  in both packages and the same config changes;
* (g) ``main`` writes a record with every key; a ``long_500k`` cell of a
  full-attention arch is skipped with the reference's reason; one cell at
  the production mesh, 256 placeholders, cut to one layer (a whole
  production cell takes minutes: ``CHANGES.md``).

The real steps run on one torch thread (multithreaded BLAS is not
bit-reproducible, and the (d) values are held ``torch.equal``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_map

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro.models import attention as ref_attn
from repro.models import model as RM
from repro.models import ssm as ref_ssm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.core import autotune
from repro_torch.kernels import abstract, gather, ssd
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs
from repro_torch.models import attention, convert, sharding, ssm
from repro_torch.models import model as M
from repro_torch.train.step import init_train_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REFERENCE_CELLS = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    from repro import configs
    from repro.compat import use_mesh
    from repro.launch import specs as S
    from repro.launch.mesh import make_mesh_from_plan
    from repro.models import model as M
    from repro.optim import AdamWConfig
    from repro.train.step import TrainConfig, make_train_step
    out = {}
    mesh = make_mesh_from_plan((4, 2), ("data", "model"))
    cfg = configs.reduced_config("mixtral-8x7b")
    batch = {"tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32)}
    with use_mesh(mesh):
        p = S.abstract_params(cfg)
        c = S.abstract_caches(cfg, 8, 64, jnp.bfloat16)
        sh = (S.param_shardings(mesh, cfg, p), S.batch_shardings(mesh, batch, 8),
              S.cache_shardings(mesh, cfg, c, 8))
        fn = lambda p, b, c: M.decode_step(p, cfg, b["tokens"], c, dtype=jnp.bfloat16)
        out["decode"] = int(jax.jit(fn, in_shardings=sh).lower(p, batch, c)
                            .compile().memory_analysis().argument_size_in_bytes)
    cfg = configs.reduced_config("qwen2-1.5b")
    batch = {k: jax.ShapeDtypeStruct((8, 32), jnp.int32) for k in ("tokens", "labels")}
    tcfg = TrainConfig(optimizer=AdamWConfig(), remat="dots", dtype=jnp.bfloat16)
    with use_mesh(mesh):
        st = S.abstract_train_state(cfg, tcfg)
        sh = (S.state_shardings(mesh, cfg, st, zero1=False),
              S.batch_shardings(mesh, batch, 8))
        out["train"] = int(jax.jit(make_train_step(cfg, tcfg), in_shardings=sh)
                           .lower(st, batch).compile().memory_analysis()
                           .argument_size_in_bytes)
    print(json.dumps(out))
""")


@pytest.fixture(autouse=True, scope="module")
def _reference_cells():
    """The reference's compiled per-device argument bytes of the two (c)
    cells, from one subprocess on 8 host devices (the device-count flag
    never reaches this process), started with the module so that it
    compiles beside the tests before (c)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_CELLS], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference_argument_bytes(_reference_cells):
    out, err = _reference_cells.communicate(timeout=600)
    assert _reference_cells.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# (a) input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_input_specs_match_reference(arch):
    for shape in ref_configs.SHAPES:
        want = ref_specs.input_specs(arch, shape)
        got = specs.input_specs(arch, shape)
        assert list(got) == list(want), (arch, shape)
        for k, sds in want.items():
            assert tuple(got[k].shape) == tuple(sds.shape), (arch, shape, k)
            assert got[k].dtype == _DTYPES[jnp.dtype(sds.dtype)], (arch, shape, k)
            assert got[k].device == torch.device("cpu")     # the host


# ---------------------------------------------------------------------------
# (b) abstract params / caches / train state at the published widths
# ---------------------------------------------------------------------------


def _ref_leaf(tree, name):
    keys, idx = convert.reference_path(name)
    for k in keys:
        tree = tree[k]
    return tree, idx


def _check_params(ref_tree, named, what):
    """Each port leaf is its reference leaf's trailing dims (its stacked
    layer index in range), dtype float32; together they cover every
    reference leaf's stacked entries."""
    covered = {}
    for name, t in named:
        leaf, idx = _ref_leaf(ref_tree, name)
        assert tuple(leaf.shape[len(idx):]) == tuple(t.shape), (what, name)
        assert t.dtype == _DTYPES[jnp.dtype(leaf.dtype)] == torch.float32, (what, name)
        covered.setdefault(id(leaf), [leaf.shape[:len(idx)], set()])[1].add(idx)
    assert len(covered) == len(jax.tree_util.tree_leaves(ref_tree)), what
    for stacked, seen in covered.values():
        assert seen == set(np.ndindex(*stacked)), what


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_paths(v, f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _port_paths(v, f"{prefix}.{f}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_abstract_params_and_caches_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    lm = specs.abstract_params(cfg)
    named = list(lm.named_parameters())
    assert all(t.device == specs.PLACEHOLDER for _, t in named)
    _check_params(ref, named, arch)
    sh = ref_configs.SHAPES["decode_32k"]
    want = jax.eval_shape(lambda: RM.init_caches(rcfg, sh.global_batch, sh.seq_len,
                                                 dtype=jnp.bfloat16))
    want = sorted((jax.tree_util.keystr(p), leaf)
                  for p, leaf in jax.tree_util.tree_flatten_with_path(want)[0])
    got = sorted(_port_paths(specs.abstract_caches(cfg, sh.global_batch, sh.seq_len)))
    assert [p for p, _ in got] == [p for p, _ in want], arch
    for (path, t), (_, leaf) in zip(got, want):
        assert tuple(t.shape) == tuple(leaf.shape), (arch, path)
        assert t.dtype == _DTYPES[jnp.dtype(leaf.dtype)], (arch, path)
        assert t.device == specs.PLACEHOLDER


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b", "mamba2-2.7b"])
def test_abstract_train_state_matches_reference(arch):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import TrainConfig

    rcfg = ref_configs.get_config(arch)
    rt = ref_step.TrainConfig(optimizer=RefAdamWConfig(), param_dtype=jnp.bfloat16)
    ref = jax.eval_shape(lambda k: ref_step.init_train_state(k, rcfg, rt),
                         jax.random.PRNGKey(0))
    st = specs.abstract_train_state(configs.get_config(arch), TrainConfig(
        optimizer=AdamWConfig(), param_dtype=torch.bfloat16))
    for name, t in st.params.named_parameters():
        leaf, idx = _ref_leaf(ref.params, name)
        assert tuple(leaf.shape[len(idx):]) == tuple(t.shape), name
        assert t.dtype == _DTYPES[jnp.dtype(leaf.dtype)] == torch.bfloat16, name
        assert t.requires_grad
        for key in ("m", "v", "master"):
            ref_m, _ = _ref_leaf(ref.opt[key], name)
            assert tuple(ref_m.shape[len(idx):]) == tuple(st.opt[key][name].shape)
            assert st.opt[key][name].dtype == _DTYPES[jnp.dtype(ref_m.dtype)]
    assert set(st.opt) == set(ref.opt)


def test_abstract_builders_place_on_a_mesh():
    """With a mesh every leaf is a placed value whose pieces lie on their
    coordinates' placeholders, by the specs' rules."""
    cfg = configs.reduced_config("qwen2-1.5b")
    with specs.fake_mode():
        mesh = make_mesh((2, 2), ("data", "model"), D.placeholders(4))
        p = specs.abstract_params(cfg, mesh)
        c = specs.abstract_caches(cfg, 4, 16, mesh=mesh)
    want = specs.param_shardings(mesh, cfg, p)
    for name, leaf in p.items():
        assert leaf.spec == sharding.canonical(want[name]) + (None,) * (
            len(leaf.shape) - len(want[name]))
        for coord in np.ndindex(leaf.pieces.shape):
            assert leaf.pieces[coord].device == mesh.devices[coord]
    k = c["layers"].kv.k
    assert all(k.pieces[co].device == mesh.devices[co] for co in np.ndindex(2, 2))


# ---------------------------------------------------------------------------
# (c) argument bytes against the reference's memory analysis
# ---------------------------------------------------------------------------


def _reduced_shape(monkeypatch, name, seq, batch, kind):
    monkeypatch.setitem(configs.SHAPES, name, configs.InputShape(name, seq, batch, kind))


def _dry(cfg, shape, opts):
    with D.recording() as acct:
        mesh = D._make_mesh("single", opts)
        fn, args, batch = D.build_cell(cfg, shape, mesh, opts)
        rec, _ = D.run_step(fn, args, batch, mesh, acct)
    return rec


def _arguments(cfg, shape, opts):
    """The cell's per-device argument bytes, as ``run_step`` records them
    (the step itself changes none)."""
    with D.recording():
        mesh = D._make_mesh("single", opts)
        _, args, batch = D.build_cell(cfg, shape, mesh, opts)
        arg = D.argument_bytes(args, batch, mesh)
    return [arg[i] for i in range(mesh.size)]


def test_decode_argument_bytes_equal_reference_memory_analysis(
        monkeypatch, reference_argument_bytes):
    _reduced_shape(monkeypatch, "cell_c", 64, 8, "decode")
    got = _arguments(configs.reduced_config("mixtral-8x7b"), "cell_c",
                     {"mesh": "4x2"})
    assert got == [reference_argument_bytes["decode"]] * 8


def test_train_argument_bytes_against_reference_memory_analysis(
        monkeypatch, reference_argument_bytes):
    """ZeRO-1 off (the port splits each layer's moments by their own first
    dim, the reference its stacked layer axis: ``launch/specs.py``).  The
    port is 8 bytes short on each device: the reference's ``opt["step"]``
    and ``TrainState.step`` are int32 device scalars, the port's host
    ints."""
    _reduced_shape(monkeypatch, "cell_c", 32, 8, "train")
    got = _arguments(configs.reduced_config("qwen2-1.5b"), "cell_c",
                     {"mesh": "4x2", "zero1": "0"})
    assert got == [reference_argument_bytes["train"] - 8] * 8


# ---------------------------------------------------------------------------
# (d) the dry run against the same cell run for real
# ---------------------------------------------------------------------------


class Placed(torch.Tensor):
    """A real CPU tensor that reports the placeholder ``cpu:k`` it lies on
    (a real CPU tensor keeps no index): what a real step's copies between
    devices need to be seen.  :class:`PlaceMode` computes every op on the
    plain tensors and wraps the results."""

    @staticmethod
    def __new__(cls, elem, index):
        r = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(), storage_offset=elem.storage_offset(),
            dtype=elem.dtype, layout=elem.layout, device=torch.device("cpu", index),
            requires_grad=False)
        r.elem = elem
        return r

    __torch_function__ = torch._C._disabled_torch_function_impl

    def untyped_storage(self):
        return self.elem.untyped_storage()

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return _placed_call(func, args, kwargs or {})


def _placed_call(func, args, kwargs):
    index = None
    dev = kwargs.get("device")
    if dev is not None:
        index = torch.device(dev).index
        kwargs = dict(kwargs, device=torch.device(torch.device(dev).type))
    seen = []

    def unwrap(x):
        if isinstance(x, Placed):
            seen.append(x)
            return x.elem
        return x
    args, kwargs = tree_map(unwrap, args), tree_map(unwrap, kwargs)
    if dev is None and seen:
        index = seen[0].device.index
    out = func(*args, **kwargs)

    def wrap(o):
        if not isinstance(o, torch.Tensor) or index is None:
            return o
        same = [w for w in seen if w.elem is o]     # an in-place result
        return same[0] if same else Placed(o, index)
    return tree_map(wrap, out)


class PlaceMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return _placed_call(func, args, kwargs or {})


def _plain_b8_uncounted(monkeypatch):
    """B8's plain versions run outside every mode: the real step runs them
    where the dry run charges the kernel (no aten op)."""
    for name in ("ssd_fused_ref", "ssd_fused_bwd_ref"):
        fn = getattr(ssd, name)

        def quiet(*a, fn=fn, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        monkeypatch.setattr(ssd, name, quiet)


def _real_args(cfg, kind, opts, mesh, b, s):
    rng = np.random.default_rng(0)
    gen = M.make_generator(0, "cpu")
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, 1 if kind == "decode" else s)).astype(np.int32))}
    if kind == "train":
        batch["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
        return (init_train_state(gen, cfg, D.train_config(opts), mesh=mesh), batch), batch
    return (M.init_params(gen, cfg, mesh=mesh), batch,
            M.init_caches(cfg, b, s, D.DTYPE, mesh=mesh)), batch


def _unwrap(x):
    return tree_map(lambda t: t.elem if isinstance(t, Placed) else t, x)


def _summary(rec):
    return {"aten": rec["flops_split"]["aten"],
            "aten_by_device": rec["flops_split"]["aten_by_device"],
            "kinds": {k: (v["total_bytes"], v["wire_bytes"], v["count"])
                      for k, v in rec["collectives"]["kinds"].items()},
            "arguments": rec["argument_bytes_by_device"]}


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b", "mamba2-2.7b"])
def test_dry_run_matches_the_real_step(monkeypatch, arch, kind):
    b, s = 8, 32
    _reduced_shape(monkeypatch, "cell_d", s, b, kind)
    _plain_b8_uncounted(monkeypatch)
    cfg = configs.reduced_config(arch)
    opts = {"mesh": "2x2"}
    fake = _dry(cfg, "cell_d", opts)
    with D.recording(base=PlaceMode()) as acct:
        mesh = D._make_mesh("single", opts)
        args, batch = _real_args(cfg, kind, opts, mesh, b, s)
        real, out = D.run_step(D.step_fn(cfg, kind, opts), args, batch, mesh, acct)
    assert _summary(real) == _summary(fake)
    assert fake["flops_split"]["aten"] > 0 and fake["collectives"]["wire_bytes"] > 0
    # the wrapper changes no value: the same step on ("cpu",) * 4
    mesh = make_mesh((2, 2), ("data", "model"), ("cpu",) * 4)
    args, batch = _real_args(cfg, kind, opts, mesh, b, s)
    plain = D.step_fn(cfg, kind, opts)(*args)
    got = _unwrap(out)
    if kind == "train":
        assert torch.equal(got[1]["loss"], plain[1]["loss"])
    else:
        assert torch.equal(got[0], plain[0])


# ---------------------------------------------------------------------------
# (e) the abstract forms of B8 and B9
# ---------------------------------------------------------------------------


@pytest.fixture
def charges(monkeypatch):
    got = []
    monkeypatch.setattr(abstract, "CHARGE", lambda *a: got.append(a))
    return got


def _fake(mode, *ts):
    return [None if t is None else mode.from_tensor(t) for t in ts]


def _same(fake, real):
    assert (fake is None) == (real is None)
    if real is not None:
        assert tuple(fake.shape) == tuple(real.shape) and fake.dtype == real.dtype


def _ssd_inputs(dtype, b=2, l=64, h=4, p=8, g=2, n=8, init=False):
    rng = np.random.default_rng(0)
    acc = torch.float32

    def r(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(dt)
    xd, B, C = r(b, l, h, p), r(b, l, g, n), r(b, l, g, n)
    ad = -torch.from_numpy(rng.random((b, l, h))).to(acc)
    return xd, ad, B, C, (r(b, h, p, n, dt=acc) if init else None)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_abstract_forms(charges, dtype, init):
    chunk = 16
    xd, ad, B, C, st = _ssd_inputs(dtype, init=init)
    b, l, h, p = xd.shape
    g, n = B.shape[2:]
    y, fin = ssd.ssd_fused_ref(xd, ad, B, C, chunk=chunk, init_state=st)
    dy = torch.ones_like(y)
    want_bwd = ssd.ssd_fused_bwd(xd, ad, B, C, dy, chunk=chunk, init_state=st)
    with FakeTensorMode() as mode, D.Accounting() as acct:
        fx, fa, fb, fc, fs, fdy = _fake(mode, xd, ad, B, C, st, dy)
        before = acct.live[None]                   # the host: from_tensor's
        got = ssd.ssd_fused(fx, fa, fb, fc, chunk=chunk, init_state=fs)
        peak = acct.peak[None] - before
        got_bwd = ssd.ssd_fused_bwd(fx, fa, fb, fc, fdy, chunk=chunk, init_state=fs)
    for f, r in zip(got + got_bwd, (y, fin) + want_bwd):
        _same(f, r)
    assert got[0].device == xd.device
    acc = 4
    assert charges[0][0] == "ssd_fused" and charges[0][2:] == (
        autotune.ssd_flops(b, l, h, p, n, chunk),
        autotune.ssd_bytes(b, l, h, p, g, n, xd.element_size(), acc, init))
    # the backward without the forward's saves runs the forward's form first
    assert [c[0] for c in charges] == ["ssd_fused", "ssd_fused", "ssd_fused_bwd"]
    assert charges[2][2:] == (autotune.ssd_bwd_flops(b, l, h, p, n, chunk),
                              autotune.ssd_bwd_bytes(b, l, h, p, g, n, chunk,
                                                     xd.element_size(), acc))
    # the card path's scratch: cum, the chunk states and the entering states
    n_cum, n_st = -(-b * h * l // 4) * 4, b * h * (l // chunk) * p * n
    scratch = (n_cum + 2 * n_st) * acc
    assert peak >= y.nbytes + fin.nbytes + scratch


def test_ssd_abstract_form_records_the_autograd_function(charges):
    xd, ad, B, C, _ = _ssd_inputs(torch.float32)
    with FakeTensorMode() as mode:
        fx, fa, fb, fc = _fake(mode, xd, ad, B, C)
        fx.requires_grad_(True)
        y, _ = ssd.ssd_fused(fx, fa, fb, fc, chunk=16)
        (gx,) = torch.autograd.grad(y.sum(), [fx])
    _same(gx, xd)
    assert [c[0] for c in charges] == ["ssd_fused", "ssd_fused_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_abstract_forms(charges, dtype):
    rng = np.random.default_rng(1)
    v, d, t = 40, 12, 9
    table = torch.from_numpy(rng.standard_normal((v, d))).to(dtype)
    ids = torch.from_numpy(rng.integers(0, v, t))
    out_dtype = torch.float32 if dtype == torch.bfloat16 else None
    want = gather.embedding_gather(table, ids, out_dtype=out_dtype)
    want_s = gather.embedding_gather_shard(table[10:20], ids, 10, v, out_dtype=out_dtype)
    dout = torch.ones_like(want)
    want_b = gather.embedding_gather_bwd(dout, ids, v, dtype=dtype)
    want_sb = gather.embedding_gather_shard_bwd(dout, ids, 10, 10, v, dtype=dtype)
    with FakeTensorMode() as mode:
        ft, fi, fd = _fake(mode, table, ids, dout)
        got = [gather.embedding_gather(ft, fi, out_dtype=out_dtype),
               gather.embedding_gather_shard(ft[10:20], fi, 10, v, out_dtype=out_dtype),
               gather.embedding_gather_bwd(fd, fi, v, dtype=dtype),
               gather.embedding_gather_shard_bwd(fd, fi, 10, 10, v, dtype=dtype)]
    for f, r in zip(got, (want, want_s, want_b, want_sb)):
        _same(f, r)
    item, ditem = table.element_size(), dout.element_size()
    assert charges == [
        ("embedding_gather", table.device, 0, autotune.gather_bytes(t, d, item)),
        ("embedding_gather_shard", table.device, 0, autotune.gather_bytes(t, d, item)),
        ("embedding_gather_bwd", table.device, 0,
         autotune.gather_bwd_bytes(v, t, d, item, ditem)),
        ("embedding_gather_shard_bwd", table.device, 0,
         autotune.gather_bwd_bytes(10, t, d, item, ditem))]
    assert charges[0][3] == 2 * t * d * item + 8 * t        # PERF.md §2


def test_gather_abstract_form_reads_no_id_and_uploads_as_the_card(charges):
    """Fake ids (no values) pass the plan of their shape; int16 ids are
    widened to int64 and moved to the table's placeholder, as the card path
    uploads them; the bf16 backward past one slice of ids allocates its
    float32 carry."""
    with FakeTensorMode(), D.Accounting() as acct:
        table = torch.empty((50, 8), dtype=torch.bfloat16, device="cpu:1")
        ids = torch.empty((4,), dtype=torch.int16)
        acct.counting = True
        out = gather.embedding_gather(table, ids, out_dtype=torch.float32)
        acct.counting = False
        assert out.device == table.device and out.dtype == torch.float32
        assert acct.host_to_device[1] == 4 * 8
        t = autotune.GATHER_BWD_SLICE + 1
        before = acct.live[1]
        gather.embedding_gather_bwd(torch.empty((t, 8), device="cpu:1"),
                                    torch.empty((t,), dtype=torch.int64), 50,
                                    dtype=torch.bfloat16)
        assert acct.peak[1] - before >= 50 * 8 * 2 + t * 8 * 4 + t * 8


def test_moe_auto_runs_dense_on_fake_tensors():
    from repro_torch.kernels.execspec import ExecSpec
    from repro_torch.models import moe as MOE

    assert not MOE._under_capture()
    with FakeTensorMode():
        assert MOE._under_capture()
        assert MOE._dispatch_mode(ExecSpec(dispatch="auto")) == "dense"
        with pytest.raises(ValueError, match="sell"):
            MOE._dispatch_mode(ExecSpec(dispatch="sell"))


# ---------------------------------------------------------------------------
# (f) the options
# ---------------------------------------------------------------------------


_FLAGS = ((attention, ref_attn, ("SEQ_SHARD_FALLBACK", "ATTN_BF16_SCORES",
                                 "ATTN_KV_CHUNK")),
          (specs, ref_specs, ("KV_SEQ_SHARD", "FSDP_PARAMS")),
          (ssm, ref_ssm, ("SSD_BF16",)))


def _reference_apply_opt_flags():
    """The reference's ``apply_opt_flags``; its module sets
    ``XLA_FLAGS`` at import, so the backend is initialized first (the flag
    then changes nothing) and the variable is restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref_dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref_dryrun.apply_opt_flags


class _Duck:
    """A mesh the reference's ``MeshContext`` reads: names and sizes."""

    empty = False

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("opts", [
    {},
    {"seqshard": "1", "attnbf16": "1", "attnchunk": "256", "kvseq": "1",
     "fsdp": "1", "ssdbf16": "1", "padvocab": "1", "chunk": "64"},
    {"attnchunk": "128", "padvocab": "1"},
])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium", "mamba2-2.7b"])
def test_apply_opt_flags_matches_reference(monkeypatch, arch, opts):
    ref_apply = _reference_apply_opt_flags()
    for port_mod, ref_mod, names in _FLAGS:
        for name in names:
            monkeypatch.setattr(port_mod, name, getattr(port_mod, name))
            monkeypatch.setattr(ref_mod, name, getattr(ref_mod, name))
    shape = {"data": 16, "model": 16}
    want = ref_apply(ref_configs.get_config(arch), _Duck(shape), opts)
    got = D.apply_opt_flags(configs.get_config(arch),
                            make_mesh((16, 16), ("data", "model"), D.placeholders(256)),
                            opts)
    for port_mod, ref_mod, names in _FLAGS:
        for name in names:
            assert getattr(port_mod, name) == getattr(ref_mod, name), name
    assert got.vocab_size == want.vocab_size
    assert (got.ssm is None) == (want.ssm is None)
    if got.ssm is not None:
        assert got.ssm.chunk == want.ssm.chunk
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# (g) the CLI and its records
# ---------------------------------------------------------------------------


_KEYS = ("arch", "shape", "mesh", "mesh_shape", "devices", "opts", "n_layers",
         "build_s", "run_s", "seconds", "argument_size_in_bytes",
         "output_size_in_bytes", "peak_bytes_per_device", "temp_size_in_bytes",
         "flops", "bytes_accessed", "collectives", "lead", "argmax",
         "flops_split", "bytes_split", "kernels", "extrapolate",
         "no_counterpart", "status")


def test_main_writes_a_record(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setitem(configs._MODULES, "mamba2-cut", "mamba2_2_7b")
    cut = dataclasses.replace(configs.get_config("mamba2-2.7b"), n_layers=2)
    real_get = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda a: cut if a == "mamba2-2.7b" else real_get(a))
    opts = "mesh=2x2,extrapolate=0"
    assert D.main(["--arch", "mamba2-2.7b", "--shape", "train_4k", "--opt", opts]) == 0
    path = D.result_path("mamba2-2.7b", "train_4k", "single", D.parse_opts(opts))
    rec = json.load(open(path))
    assert rec["status"] == "ok"
    for k in _KEYS:
        assert k in rec, k
    assert rec["no_counterpart"] == ["hlo_lines", "generated_code_size_in_bytes"]
    assert "changes nothing" in rec["extrapolate"]
    assert rec["mesh_shape"] == {"data": 2, "model": 2} and rec["devices"] == 4
    kinds = rec["collectives"]["kinds"]
    assert {"all-reduce", "all-gather", "reduce-scatter", "collective-permute"} <= set(kinds)
    for k in kinds.values():
        assert set(k) >= {"count", "result_bytes", "wire_bytes"}
    # B8 and B9 and their backwards, charged at the train cell's shapes:
    # each data replica's (128, 4096) rows, mamba2's 80 heads on 2 devices
    assert rec["kernels"]["ssd_fused"]["launches"] == 2 * 2 * 2 * 2   # fwd + remat
    assert rec["kernels"]["ssd_fused_bwd"]["launches"] == 2 * 2 * 2
    assert rec["kernels"]["embedding_gather_shard_bwd"]["launches"] == 4
    assert rec["flops"] == max(rec["lead"]["flops"], rec["flops"])
    assert rec["peak_bytes_per_device"] >= rec["argument_size_in_bytes"]
    assert "[ok] mamba2-2.7b train_4k single" in capsys.readouterr().out
    # a cached record is not run again
    assert D.main(["--arch", "mamba2-2.7b", "--shape", "train_4k", "--opt", opts]) == 0
    assert "[cached]" in capsys.readouterr().out


def test_long_context_cell_of_full_attention_is_skipped(monkeypatch, tmp_path):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    assert D.main(["--arch", "qwen3-14b", "--shape", "long_500k"]) == 0
    rec = json.load(open(D.result_path("qwen3-14b", "long_500k", "single", {})))
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_configs.cell_supported("qwen3-14b", "long_500k")[1]


def test_production_mesh_cell_at_one_layer():
    """llama-3.2-3b's decode_32k on the single-pod mesh's 256 placeholders
    at the published widths, cut to one layer (a whole production cell
    takes minutes: ``CHANGES.md``): the 16 data replicas each run their 8
    rows on their 16 model devices; its 8 kv heads do not divide the
    16-way model axis, so each device holds its replica's whole ring of
    the layer (8 x 32768 x 8 x 128 bf16 for k and for v).  Devices past
    the seventh replica share placeholders (``dryrun.placeholders``), so
    112 are reported; the argument bytes are every device's."""
    cut = dataclasses.replace(configs.get_config("llama3.2-3b"), n_layers=1)
    with D.recording() as acct:
        mesh = D._make_mesh("single", {})
        fn, args, batch = D.build_cell(cut, "decode_32k", mesh, {})
        rec, _ = D.run_step(fn, args, batch, mesh, acct)
    assert mesh.shape == {"data": 16, "model": 16}
    assert rec["placeholders_reported"] == 7 * 16
    kv = 2 * 8 * 32768 * 8 * 128 * 2
    args_by_device = rec["argument_bytes_by_device"]
    assert len(args_by_device) == 256
    assert min(args_by_device) > kv
    # the lead of every replica holds what its model devices hold
    assert len(set(args_by_device)) == 1
    assert rec["peak_bytes_per_device"] >= rec["argument_size_in_bytes"] + kv
    assert rec["kernels"]["embedding_gather_shard"]["launches"] == 256
