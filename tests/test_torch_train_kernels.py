"""Gradients of the port's LM kernels — the fused SSD scan (kernel B8,
``repro_torch.kernels.ssd``) and the embedding gather (kernel B9,
``repro_torch.kernels.gather``) — and of the model's remat policies,
against the JAX reference.

The same numpy-seeded inputs go through both packages.  The reference has
no backward kernel: it differentiates its jnp scans (``ssd_chunked``, the
per-token ``ssd_reference``) and XLA's gather, so ``jax.grad`` of those is
the reference here.  The port runs on the CPU, where each wrapper and its
autograd Function take the plain versions (``ssd_fused_bwd_ref``,
``embedding_gather_bwd_ref``) because their tensors lie there; the
kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: fp64 1e-10 (the forward's); fp32 2e-4 x max|grad| of each
output (the forward's 2e-4, taken relative as the card test does: sums in
another order).  ``ssd_chunked`` carries its inter-chunk state and final
state in float32 and takes ``ad`` in float32 whatever the inputs
(``ssm.py:118-119, 142``; with float64 ``ad`` it does not trace under x64),
so with float64 inputs it agrees only to fp32 rounding (2e-4 x max|grad|,
as ``tests/test_torch_lm_kernels.py`` holds the forward); the fp64
reference at 1e-10, over several chunks, g > 1 and an initial state, is
``jax.grad`` of ``ssd_reference``, the exact recurrence.  The gather's gradient sums
repeated ids in another order than XLA's scatter: 1e-12 at fp64, 1e-6 x
max at fp32.  The remat policies recompute the same operations on the
CPU: 1e-6 x max|g|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import model as RM
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro.models.ssm import ssd_reference as ref_ssd_reference
from repro_torch import configs
from repro_torch.analysis import LaunchPlanError, plan_embedding_gather_bwd, plan_ssd_fused_bwd
from repro_torch.core import autotune
from repro_torch.kernels import cuda_lib, gather, ssd
from repro_torch.models.convert import params_from_reference
from repro_torch.train import TrainConfig
from repro_torch.train.step import loss_and_grads


def _inputs(rng, b, l, h, p, g, n, dtype, init=False):
    arrs = [rng.standard_normal((b, l, h, p)),
            -np.abs(rng.standard_normal((b, l, h))) * 0.3,
            rng.standard_normal((b, l, g, n)), rng.standard_normal((b, l, g, n))]
    s0 = rng.standard_normal((b, h, p, n)).astype(dtype) if init else None
    dy = rng.standard_normal((b, l, h, p)).astype(dtype)
    df = rng.standard_normal((b, h, p, n)).astype(dtype)
    return [a.astype(dtype) for a in arrs], s0, dy, df


def _ref_grads(fn, arrs, s0, dy, df):
    """jax.grad of <y, dy> + <final, df> over (xd, ad, B, C[, init])."""
    def loss(*a):
        y, f = fn(*a)
        return jnp.sum(y * dy) + jnp.sum(f * df)
    args = [jnp.asarray(a) for a in arrs] + ([] if s0 is None else [jnp.asarray(s0)])
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


def _port_grads(arrs, s0, dy, df, chunk):
    t = [torch.from_numpy(a) for a in arrs]
    return ssd.ssd_fused_bwd_ref(*t, torch.from_numpy(dy), torch.from_numpy(df),
                                 chunk=chunk,
                                 init_state=None if s0 is None else torch.from_numpy(s0))


def _close(got, want, dtype, fp32_level=False):
    want = np.asarray(want)
    tol = (1e-10 if dtype == np.float64 and not fp32_level
           else 2e-4 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_backward_matches_jax_grad_of_the_exact_recurrence(g, init):
    """fp64, several chunks, g > 1 and an initial state: the backward's
    chunk formulas against jax.grad of the reference's per-token scan."""
    rng = np.random.default_rng(10 + g + 2 * init)
    arrs, s0, dy, df = _inputs(rng, 2, 48, 4, 8, g, 16, np.float64, init)
    want = _ref_grads(ref_ssd_reference, arrs, s0, dy, df)
    got = _port_grads(arrs, s0, dy, df, chunk=16)
    for i, w in enumerate(want):
        _close(got[i].numpy(), w, np.float64)
    assert (got[4] is not None)


@pytest.mark.parametrize("dtype,shape,chunk,init", [
    (np.float64, (2, 64, 4, 8, 2, 16), 16, True),    # fp32 carry: fp32 level
    (np.float32, (2, 64, 4, 8, 2, 16), 16, True),    # four chunks, g = 2
    (np.float32, (1, 96, 3, 5, 1, 7), 32, False),    # ragged widths
])
def test_ssd_backward_matches_jax_grad_of_ssd_chunked(dtype, shape, chunk, init):
    rng = np.random.default_rng(chunk)
    arrs, s0, dy, df = _inputs(rng, *shape, dtype, init)
    # the reference's chunked scan traces ad in float32 under x64 only
    arrs[1] = arrs[1].astype(np.float32).astype(dtype)
    fn = (lambda xd, ad, B, C, s=None: ref_ssd_chunked(
        xd, ad.astype(jnp.float32), B, C, chunk, s))
    want = _ref_grads(fn, arrs, s0, dy, df.astype(np.float32))
    got = _port_grads(arrs, s0, dy, df.astype(np.float32).astype(dtype), chunk)
    for i, w in enumerate(want):
        _close(got[i].numpy(), w, dtype, fp32_level=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssd_backward_matches_torch_autograd_of_the_plain_scan(dtype):
    rng = np.random.default_rng(4)
    arrs, s0, dy, df = _inputs(rng, 2, 60, 6, 5, 3, 9, np.float64, True)
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs + [s0]]
    dy_t, df_t = torch.from_numpy(dy).to(dtype), torch.from_numpy(df).to(dtype)
    y, f = ssd.ssd_fused_ref(*ins[:4], chunk=20, init_state=ins[4])
    want = torch.autograd.grad((y * dy_t).sum() + (f * df_t).sum(), ins)
    got = ssd.ssd_fused_bwd(*(t.detach() for t in ins[:4]), dy_t, df_t, chunk=20,
                            init_state=ins[4].detach())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for gv, wv in zip(got, want):
        scale = max(1.0, float(wv.abs().max()))
        torch.testing.assert_close(gv, wv, rtol=0, atol=tol * scale)
    # no final-state gradient is a zero one; no initial state, no gradient
    a = ssd.ssd_fused_bwd(*(t.detach() for t in ins[:4]), dy_t, None, chunk=20)
    b = ssd.ssd_fused_bwd(*(t.detach() for t in ins[:4]), dy_t,
                          torch.zeros_like(df_t), chunk=20)
    assert a[4] is None
    for u, v in zip(a[:4], b[:4]):
        assert torch.equal(u, v)


def test_ssd_and_gather_functions_pass_gradcheck():
    rng = np.random.default_rng(7)
    arrs, s0, _, _ = _inputs(rng, 1, 24, 4, 3, 2, 5, np.float64, True)
    ins = tuple(torch.from_numpy(a).requires_grad_() for a in arrs + [s0])
    assert torch.autograd.gradcheck(
        lambda *a: ssd.ssd_fused(*a[:4], chunk=8, init_state=a[4]), ins)
    table = torch.from_numpy(rng.standard_normal((11, 4))).requires_grad_()
    ids = np.array([3, 7, 3, 10, 0, 3])
    assert torch.autograd.gradcheck(lambda t: gather.embedding_gather(t, ids),
                                    (table,))


def test_ssd_records_a_graph_only_when_asked():
    """Serving records nothing; a gradient goes through the Function."""
    rng = np.random.default_rng(8)
    arrs, _, _, _ = _inputs(rng, 1, 16, 2, 4, 1, 4, np.float32)
    t = [torch.from_numpy(a) for a in arrs]
    y, f = ssd.ssd_fused(*t, chunk=8)
    assert y.grad_fn is None and f.grad_fn is None
    t[0].requires_grad_()
    y, _ = ssd.ssd_fused(*t, chunk=8)
    assert type(y.grad_fn).__name__ == "_SSDFusedBackward"
    with torch.no_grad():
        assert ssd.ssd_fused(*t, chunk=8)[0].grad_fn is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_backward_matches_jax_grad_with_repeated_ids(dtype):
    rng = np.random.default_rng(3)
    v, d, t = 40, 12, 300
    table = rng.standard_normal((v, d)).astype(dtype)
    ids = rng.integers(0, 9, (t,)).astype(np.int32)       # many repeats
    dout = rng.standard_normal((t, d)).astype(dtype)
    want = np.asarray(jax.grad(lambda tb: jnp.sum(tb[ids] * dout))(jnp.asarray(table)))
    got = gather.embedding_gather_bwd_ref(torch.from_numpy(dout),
                                          torch.from_numpy(ids), v).numpy()
    tol = 1e-12 if dtype == np.float64 else 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert not got[9:].any()                                # untouched rows zero
    # the sorted-run order: each row summed from zero in ascending position
    rows = [np.zeros(d, dtype) for _ in range(v)]
    for i, r in enumerate(ids):
        rows[r] = rows[r] + dout[i]
    np.testing.assert_array_equal(got, np.stack(rows))
    # the Function on a CPU table gives the same, through autograd
    tt = torch.from_numpy(table).requires_grad_()
    (g,) = torch.autograd.grad(gather.embedding_gather(tt, ids), tt,
                               torch.from_numpy(dout))
    np.testing.assert_array_equal(g.numpy(), got)


def test_gather_backward_bounds_card_style_ids_as_the_forward_does():
    """Ids outside [0, V) (possible only for ids already on the card) send
    their rows where the forward read them: clamp_ids' rule."""
    dout = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([-1, 10, 2, -13])                    # V = 10
    got = gather.embedding_gather_bwd_ref(dout, ids, 10)
    want = torch.zeros(10, 3).index_add_(0, gather.clamp_ids(ids, 10), dout)
    assert torch.equal(got, want)


def test_backward_plans_and_sources():
    plan = plan_ssd_fused_bwd(2, 512, 80, 64, 1, 128, chunk=256)
    assert plan.ok and plan.n_launches == ssd.LAUNCHES_PER_BWD == 5
    assert [b.label for b in plan.blocks] == list(autotune.SSD_BWD_LAUNCHES) == [
        "bwd_local", "bwd_state_pass", "bwd_key", "bwd_query", "bwd_finish"]
    assert [b.grid for b in plan.blocks] == [(320, 1, 2), (160, 32), (320, 4),
                                             (320, 4), (512, 3)]
    assert [b.smem_bytes for b in plan.blocks] == [74240, 0, 91168, 90624, 0]
    assert plan_ssd_fused_bwd(1, 512, 80, 64, 1, 128, chunk=256,
                              dtype="float64").blocks[2].smem_bytes == 2 * 91168
    assert 2 * (91168 + 1024) <= 228 * 1024        # two key blocks an SM
    # the key launch hands the query launch one M tile a tile pair
    ops = {o[0]: o[1] for o in plan.blocks[2].operands}
    assert ops["mh"] == ops["gh"] == (320 * 10, 64, 64)
    assert ops["rh"] == (320 * 10, 64)
    assert {o[0] for o in plan.blocks[3].operands} >= {"mh", "rh", "dch", "dcq"}
    with pytest.raises(LaunchPlanError, match="multiple of the chunk"):
        plan_ssd_fused_bwd(1, 100, 4, 8, 1, 16, chunk=64).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="multiple of the chunk"):
        ssd.ssd_fused_bwd(*(torch.zeros(s) for s in ((1, 100, 4, 8), (1, 100, 4),
                                                     (1, 100, 1, 16),
                                                     (1, 100, 1, 16))),
                          torch.zeros(1, 100, 4, 8), chunk=64)
    assert autotune.ssd_bwd_flops(2, 512, 80, 64, 128, 256) == 16_148_070_400
    # B9's backward: stripes of 64 rows, 4 chunks of 160 threads, 16 B vectors
    g = plan_embedding_gather_bwd(50280, 2560, 1024)
    assert g.ok and g.blocks[0].grid == (786 * 4,) and g.blocks[0].block == (160,)
    assert autotune.gather_bwd_grid(50280, 2560, 1024, 4) == (64, 4, 160, 16)
    assert g.blocks[0].smem_bytes == autotune.gather_bwd_smem_bytes() <= 48 * 1024
    # every backward entry point is bound with as many arguments as its C
    # signature takes
    for lib, fns in (("ssd_bwd", None), ("embedding_gather", None)):
        source, table = cuda_lib.KERNELS[lib]
        text = (cuda_lib.CSRC / source).read_text()
        for fn, (argtypes, _) in table.items():
            if "error_string" in fn:
                continue
            sig = text[text.index(f"int {fn}("):]
            sig = sig[:sig.index(")")]
            assert sig.count(",") + 1 == len(argtypes), fn


@pytest.mark.parametrize("vocab,d,t,itemsize", [
    (50280, 2560, 1024, 4),     # mamba2's train step
    (50280, 2560, 8192, 8),     # past one slice of ids, fp64
    (1000, 24, 5000, 4),        # V not a multiple of the stripe
    (97, 3, 2049, 4),           # 4 B vectors, one id past a slice
    (97, 6, 1, 8),              # 16 B vectors of fp64, T = 1
])
def test_gather_backward_stripes_cover_every_row_once(vocab, d, t, itemsize):
    """B9's backward grid: the stripes cover rows [0, V) once (the last one
    ragged), the chunks every vector of a row once (none starting past its
    end), the vector divides a row, and ids past one slice are walked in
    slices (the kernel's limit, not a refusal)."""
    stripe, chunks, threads, vec = autotune.gather_bwd_grid(vocab, d, t, itemsize)
    assert 1 <= stripe <= autotune.GATHER_BWD_MAX_STRIPE and threads % 32 == 0
    assert threads <= autotune.GATHER_MAX_THREADS and vec >= itemsize
    assert (d * itemsize) % vec == 0
    row_vecs = d * itemsize // vec
    stripes = -(-vocab // stripe)
    rows = np.zeros(vocab, int)
    for s in range(stripes):
        rows[s * stripe:min((s + 1) * stripe, vocab)] += 1
    assert (rows == 1).all() and (stripes - 1) * stripe < vocab
    cols = np.zeros(row_vecs, int)
    for c in range(chunks):
        assert c * threads < row_vecs
        cols[c * threads:min((c + 1) * threads, row_vecs)] += 1
    assert (cols == 1).all()
    plan = plan_embedding_gather_bwd(vocab, d, t,
                                     dtype="float64" if itemsize == 8 else "float32")
    assert plan.ok and plan.blocks[0].grid == (stripes * chunks,)
    assert plan.blocks[0].block == (threads,)
    slices = -(-t // autotune.GATHER_BWD_SLICE)
    assert slices == (1 if t <= 2048 else -(-t // 2048))


def test_gather_backward_on_cpu_runs_only_the_plain_version(monkeypatch):
    """One launch a call on the card (the plan's one block); on CPU tensors
    the plain version and no launch, whatever the id dtype."""
    assert plan_embedding_gather_bwd(50280, 2560, 1024).n_launches == 1

    def no_launch(*a, **k):
        raise AssertionError("a CPU call reached the kernel")

    monkeypatch.setattr(gather, "_launch_bwd", no_launch)
    rng = np.random.default_rng(9)
    dout = torch.from_numpy(rng.standard_normal((40, 6)))
    before = gather.BWD_LAUNCHES
    for ids in (rng.integers(-3, 14, 40), rng.integers(0, 11, 40).astype(np.int32)):
        got = gather.embedding_gather_bwd(dout, torch.from_numpy(ids), 11)
        want = torch.zeros(11, 6, dtype=dout.dtype).index_add_(
            0, gather.clamp_ids(torch.from_numpy(ids), 11), dout)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
        assert torch.equal(got, gather.embedding_gather_bwd_ref(
            dout, torch.from_numpy(ids), 11))
    assert gather.BWD_LAUNCHES == before


def test_header_change_builds_a_new_library(tmp_path, monkeypatch):
    """A library is named by its source, every csrc header and the flags: an
    edited header never loads a stale library (ssd_mma.cuh is shared by B8's
    forward and backward)."""
    for f in cuda_lib.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    assert (tmp_path / "ssd_mma.cuh").exists()
    before = {name: cuda_lib._target(name)[1] for name in ("ssd_fused", "ssd_bwd",
                                                           "embedding_gather")}
    with open(tmp_path / "ssd_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: cuda_lib._target(name)[1] for name in before}
    assert all(after[k] != before[k] for k in before)
    assert after["ssd_fused"].parent == before["ssd_fused"].parent
    assert cuda_lib._target("ssd_bwd") == (tmp_path / "ssd_bwd.cu", after["ssd_bwd"])


@pytest.fixture(scope="module")
def mamba():
    cfg = ref_configs.reduced_config("mamba2-2.7b")
    tree = jax.tree_util.tree_map(np.asarray, RM.init_params(jax.random.PRNGKey(3), cfg))
    return configs.reduced_config("mamba2-2.7b"), tree


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_equal_no_remat(mamba, remat):
    cfg, tree = mamba
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    outs = []
    for policy in (None, remat):
        params = params_from_reference(tree, cfg, "cpu", trainable=True)
        outs.append(loss_and_grads(params, cfg, TrainConfig(remat=policy), batch))
    (g0, l0, _), (g1, l1, _) = outs
    assert float(abs(l0 - l1)) <= 1e-6 * float(abs(l0))
    for k in g0:
        tol = 1e-6 * max(1e-30, float(g0[k].abs().max()))
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=tol)


def test_remat_full_recomputes_the_scan_in_the_backward(mamba, monkeypatch):
    """Under remat "full" each layer's scan runs twice a step (forward and
    recompute), its backward once; without remat once and once."""
    cfg, tree = mamba
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ssd._forward, ssd.ssd_fused_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(ssd, "_forward", count_fwd)
    monkeypatch.setattr(ssd, "ssd_fused_bwd", count_bwd)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)}
    for policy, want in ((None, 1), ("full", 2)):
        calls.update(fwd=0, bwd=0)
        params = params_from_reference(tree, cfg, "cpu", trainable=True)
        loss_and_grads(params, cfg, TrainConfig(remat=policy), batch)
        assert calls == {"fwd": want * cfg.n_layers, "bwd": cfg.n_layers}


# ---------------------------------------------------------------------------
# bf16 forms of the backwards
# ---------------------------------------------------------------------------


def _bf16_values(a):
    """``a`` rounded to bf16 once, as float32 numpy (exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("shape,chunk,init", [((2, 64, 4, 8, 2, 16), 16, True),
                                              ((1, 96, 3, 5, 1, 7), 32, False)])
def test_ssd_bf16_backward_matches_jax_grad_and_the_fp32_backward(shape, chunk,
                                                                  init):
    """B8's plain backward on the bf16 mix (bf16 xd / B / C / dy, float32
    ad, final-state gradient and initial state): dxd, dB and dC in bf16
    equal to its float32 backward on the upcast inputs rounded once (the
    kernel's contract on the card), dad and d init_state float32 and equal
    to it; and each within SSD_TOL x max(1, max|g|) (+ one bf16 ulp of the
    bf16 outputs) of ``jax.vjp`` of the reference's ``ssd_chunked`` on the
    upcast float32 inputs."""
    rng = np.random.default_rng(50 + chunk)
    arrs, s0, dy, df = _inputs(rng, *shape, np.float32, init)
    for i in (0, 2, 3):
        arrs[i] = _bf16_values(arrs[i])
    dy = _bf16_values(dy)
    t32 = [torch.from_numpy(a) for a in arrs]
    tb = [t.bfloat16() if i != 1 else t for i, t in enumerate(t32)]
    s0t = None if s0 is None else torch.from_numpy(s0)
    got = ssd.ssd_fused_bwd(*tb, torch.from_numpy(dy).bfloat16(),
                            torch.from_numpy(df), chunk=chunk, init_state=s0t)
    want32 = ssd.ssd_fused_bwd(*t32, torch.from_numpy(dy), torch.from_numpy(df),
                               chunk=chunk, init_state=s0t)
    assert [g.dtype for g in got[:4]] == [torch.bfloat16, torch.float32,
                                          torch.bfloat16, torch.bfloat16]
    for gv, wv in zip(got, want32):
        if gv is not None:
            assert torch.equal(gv, wv.to(gv.dtype))
    fn = (lambda xd, ad, B, C, s=None: ref_ssd_chunked(xd, ad, B, C, chunk, s))
    ref = _ref_grads(fn, arrs, s0, dy, df)
    for gv, rv in zip(got, ref):
        rv = np.asarray(rv)
        g = gv.float().numpy()
        tol = 2e-4 * max(1.0, float(np.abs(rv).max()))
        if gv.dtype == torch.bfloat16:
            tol = tol + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(rv), 2.0 ** -126))) - 7)
        assert np.all(np.abs(g - rv) <= tol)


@pytest.mark.parametrize("t", [300, 2100])
def test_gather_bf16_backward_forms(t):
    """B9's plain backward into a bf16 table: from bf16 output gradients and
    from float32 ones (the model's path), each equal to the float32
    backward of the upcast gradients rounded once (sums in float32 in
    ascending position); the shard form's the same per shard.  Against
    ``jax.vjp`` of the reference's gather of the bf16 table (XLA sums the
    repeated ids in bf16): per entry within n_v 2^-8 sum_i |dout_i|, the
    recursive-summation bound of n_v bf16 additions and one rounding (n_v
    the row's id count), a loose bound at large n_v; and against ``jax.vjp``
    of the reference's gather of the float32 table on the same gradients,
    rounded once, within one bf16 ulp (plus the float32 sums' order).
    t = 2100 walks the ids in two slices on the card."""
    rng = np.random.default_rng(t)
    v, d = 40, 12
    ids = rng.integers(0, 9, (t,)).astype(np.int32)       # many repeats
    dout32 = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    doutb = dout32.bfloat16()
    idt = torch.from_numpy(ids)
    got = gather.embedding_gather_bwd(doutb, idt, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gather.embedding_gather_bwd(doutb.float(), idt, v)
                       .bfloat16())
    wide = gather.embedding_gather_bwd(dout32, idt, v, dtype=torch.bfloat16)
    assert torch.equal(wide, gather.embedding_gather_bwd(dout32, idt, v).bfloat16())
    for lo, rows in ((0, 4), (4, 36)):
        part = gather.embedding_gather_shard_bwd(doutb, idt, lo, rows, v)
        assert part.dtype == torch.bfloat16 and torch.equal(part, got[lo:lo + rows])
        part = gather.embedding_gather_shard_bwd(dout32, idt, lo, rows, v,
                                                 dtype=torch.bfloat16)
        assert torch.equal(part, wide[lo:lo + rows])
    table = jnp.zeros((v, d), jnp.bfloat16)
    _, vjp = jax.vjp(lambda tb: tb[jnp.asarray(ids)], table)
    (ref,) = vjp(jnp.asarray(doutb.float().numpy()).astype(jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    absum = np.zeros((v, d), np.float64)
    np.add.at(absum, ids, np.abs(doutb.float().numpy()))
    n_v = np.bincount(ids, minlength=v)[:, None]
    assert np.all(np.abs(got.float().numpy() - ref) <= n_v * 2.0 ** -8 * absum)
    # Tight: jax.vjp of the reference's gather of the float32 table on the
    # same (upcast) gradients, rounded once to bf16.  Within one bf16 ulp
    # plus n_v 2^-23 sum_i |dout_i| (two float32 sums whose order may
    # differ), far below |sum| ~ sqrt(n_v) where the loose bound above is not.
    table32 = jnp.zeros((v, d), jnp.float32)
    _, vjp32 = jax.vjp(lambda tb: tb[jnp.asarray(ids)], table32)
    for src, mine in ((doutb.float(), got), (dout32, wide)):
        (r32,) = vjp32(jnp.asarray(src.numpy()))
        r16 = np.asarray(r32.astype(jnp.bfloat16).astype(jnp.float32))
        absum = np.zeros((v, d), np.float64)
        np.add.at(absum, ids, np.abs(src.numpy()))
        m = mine.float().numpy()
        mag = np.maximum(np.maximum(np.abs(m), np.abs(r16)), 2.0 ** -126)
        bound = 2.0 ** (np.floor(np.log2(mag)) - 7) + n_v * 2.0 ** -23 * absum
        assert np.all(np.abs(m - r16) <= bound)
        assert np.all(bound[:9] < 0.05 * np.abs(r16[:9]).max())   # rows hit
    with pytest.raises(TypeError, match="bfloat16 from float32"):
        gather.embedding_gather_bwd(doutb, idt, v, dtype=torch.float32)


def test_gather_bf16_backward_plan():
    """The bf16 pairs the backward's plan takes (one type, or float32
    gradients into a bf16 table), its vectors cut from dout's rows, and
    the float32 carry past one slice of ids."""
    plan = plan_embedding_gather_bwd(50_280, 2560, 1024, dtype="float32",
                                     table_dtype="bfloat16")
    assert plan.ok
    ops = {o[0]: o for o in plan.blocks[0].operands}
    assert ops["dtable"][2] == "bfloat16" and "carry" not in ops
    plan = plan_embedding_gather_bwd(50_280, 2560, 4096, dtype="bfloat16")
    assert plan.ok and "carry" in {o[0] for o in plan.blocks[0].operands}
    assert plan_embedding_gather_bwd(10, 7, 4, dtype="bfloat16").ok   # odd d
    assert "pairs" in plan_embedding_gather_bwd(
        10, 4, 4, dtype="bfloat16", table_dtype="float32").violations[0]
    assert "float16" in plan_embedding_gather_bwd(10, 4, 4,
                                                  dtype="float16").violations[0]
