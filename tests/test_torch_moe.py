"""Parity of the port's MoE families (``repro_torch.models.moe``, block kind
``"moe"``, DeepSeek's dense first layer, the fused kernel-service engine
and ``retrieve_context``) with the JAX reference, on the CPU, the same
numpy-seeded inputs and the reference's weights moved over.

Tolerances:

* ``moe_forward`` in float64: outputs at 1e-10 (the reference's own,
  ``tests/test_moe_dispatch.py``) given the same router probabilities.
  The router softmax is float32 in both packages (the reference's
  ``moe.py:145``), and XLA's float32 ``exp`` differs from PyTorch's in the
  last bit for about a tenth of its inputs, so the parity cases hand the
  port the reference's probabilities (:func:`_reference_router`); with
  its own router the port agrees to ``ROUTER_TOL`` x max|out| (float32
  rounding of the weights), and the same experts are chosen.
* the aux loss: float32, so ``AUX_RTOL`` (eight float32 ulps; ROADMAP C);
* the LM's logits and caches: ``LOGIT_TOL`` x max(1, max|reference|)
  (float32 rounding in another summation order), greedy tokens equal
  wherever the reference's top-2 margin exceeds that, as in
  ``tests/test_torch_attention.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.graphs import gen as ref_gen
from repro.kernels.execspec import ExecSpec as RefSpec
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.serve import Batcher as RefBatcher
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve.engine import retrieve_context as ref_retrieve_context
from repro.service import KernelRegistry as RefRegistry
from repro.service import KernelService as RefService
from repro_torch import configs
from repro_torch.graphs import gen
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.launch import serve as cli
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import MLP
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine
from repro_torch.serve.engine import retrieve_context
from repro_torch.service import KernelRegistry, KernelService

TOL = dict(rtol=1e-10, atol=1e-10)
AUX_RTOL = 8 * 2.0 ** -23
ROUTER_TOL = 1e-6
LOGIT_TOL = 1e-5
MOE_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
PATHS = {"dense": (RefSpec(dispatch="dense"), ExecSpec(dispatch="dense")),
         "sell": (RefSpec(dispatch="sell", vl=32),
                  ExecSpec(dispatch="sell", vl=32, device="cpu"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# moe_forward against the reference
# ---------------------------------------------------------------------------


def _moe_cfgs(name="mixtral-8x7b", **moe):
    """The reduced config in both packages, its MoE fields replaced."""
    ref, port = ref_configs.reduced_config(name), configs.reduced_config(name)
    if moe:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe))
        port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, **moe))
    return ref, port


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _moe_pair(cfg, seed):
    """One MoE layer's weights in both packages."""
    jp = RMOE.init_moe_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    shared = tree.get("shared")
    tp = MOE.MoE(_t(tree["router"]), _t(tree["experts_gate"]),
                 _t(tree["experts_up"]), _t(tree["experts_down"]),
                 None if shared is None else MLP(_t(shared["w_gate"]),
                                                 _t(shared["w_up"]),
                                                 _t(shared["w_down"])))
    return jp, tp


def _reference_router(jp):
    """A stand-in for the port's :func:`~repro_torch.models.moe.router_probs`
    computing the reference's probabilities (``moe.py:144-145``) on the
    port's activations."""
    def probs(p, xg):
        xj = jnp.asarray(xg.numpy())
        logits = jnp.einsum("bngd,de->bnge", xj,
                            jp["router"].astype(jnp.float32).astype(xj.dtype))
        return torch.from_numpy(np.array(
            jax.nn.softmax(logits.astype(jnp.float32), axis=-1)))
    return probs


def _both(cfg, tcfg, path, *, b=2, s=16, seed=0, monkeypatch=None):
    """moe_forward in both packages on one float64 input; with
    ``monkeypatch`` the port takes the reference's router probabilities."""
    jp, tp = _moe_pair(cfg, seed)
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    ref_spec, spec = PATHS[path]
    if monkeypatch is not None:
        monkeypatch.setattr(MOE, "router_probs", _reference_router(jp))
    out_j, aux_j = RMOE.moe_forward(jp, cfg, jnp.asarray(x), spec=ref_spec)
    out_t, aux_t = MOE.moe_forward(tp, tcfg, torch.from_numpy(x), spec=spec)
    assert out_t.dtype == torch.float64 and aux_t.dtype == torch.float32
    return np.asarray(out_j), float(aux_j), out_t.numpy(), float(aux_t)


def _assert_parity(out_j, aux_j, out_t, aux_t):
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(aux_t, aux_j, rtol=AUX_RTOL)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_forward_matches_reference_reduced_configs(name, path, monkeypatch):
    _assert_parity(*_both(*_moe_cfgs(name), path, monkeypatch=monkeypatch))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_forward_with_its_own_router_agrees_to_float32_weights(name, path):
    """The port's own float32 softmax: the same experts chosen, outputs at
    float32 rounding of the router weights."""
    out_j, aux_j, out_t, aux_t = _both(*_moe_cfgs(name), path)
    tol = ROUTER_TOL * max(1.0, float(np.abs(out_j).max()))
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=tol)
    np.testing.assert_allclose(aux_t, aux_j, rtol=AUX_RTOL)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("e,k", [(4, 1), (8, 3), (16, 4)])
def test_moe_forward_matches_reference_expert_sweep(e, k, path, monkeypatch):
    cfg, tcfg = _moe_cfgs(n_experts=e, top_k=k, capacity_factor=float(e))
    _assert_parity(*_both(cfg, tcfg, path, seed=e * 10 + k,
                          monkeypatch=monkeypatch))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_forward_matches_reference_under_capacity_overflow(path, monkeypatch):
    """capacity_factor 0.5 drops assignments: the port drops the same ones
    (the top-k order and the capacity ranks are the reference's), and the
    run without drops differs (overflow engaged)."""
    tight = _moe_cfgs(n_experts=4, top_k=2, capacity_factor=0.5)
    out_j, aux_j, out_t, aux_t = _both(*tight, path, b=2, s=32, seed=7,
                                       monkeypatch=monkeypatch)
    _assert_parity(out_j, aux_j, out_t, aux_t)
    roomy = _moe_cfgs(n_experts=4, top_k=2, capacity_factor=4.0)
    _, _, out_full, _ = _both(*roomy, path, b=2, s=32, seed=7,
                              monkeypatch=monkeypatch)
    assert np.abs(out_full - out_t).max() > 1e-6


@pytest.mark.parametrize("case", ["mixtral", "deepseek", "overflow", "sweep"])
def test_port_sell_matches_port_dense(case):
    """The port's SELL path against its own dense path, same router."""
    cfg, tcfg = {
        "mixtral": _moe_cfgs("mixtral-8x7b"),
        "deepseek": _moe_cfgs("deepseek-moe-16b"),
        "overflow": _moe_cfgs(n_experts=4, top_k=2, capacity_factor=0.5),
        "sweep": _moe_cfgs(n_experts=16, top_k=4, capacity_factor=1.0),
    }[case]
    _, tp = _moe_pair(cfg, 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 24, cfg.d_model)))
    out_d, aux_d = MOE.moe_forward(tp, tcfg, x, spec=PATHS["dense"][1])
    out_s, aux_s = MOE.moe_forward(tp, tcfg, x, spec=PATHS["sell"][1])
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), **TOL)
    assert float(aux_s) == float(aux_d)


def _reference_routing(cfg, jp, xj):
    """The reference's routing arrays (``moe.py:136-156``) on the host."""
    m = cfg.moe
    b, s, d = xj.shape
    e, k, g = m.n_experts, m.top_k, s
    xg = xj.reshape(b, 1, g, d)
    logits = jnp.einsum("bngd,de->bnge", xg,
                        jp["router"].astype(jnp.float32).astype(xj.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_w, top_i = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(top_i, e, dtype=jnp.float32)
    flat = onehot.reshape(b, 1, g * k, e)
    pos = (jnp.cumsum(flat, axis=2) - flat).reshape(b, 1, g, k, e)
    cap = int(g * k / e * m.capacity_factor) + 1
    keep = (pos < cap) & (onehot > 0)
    slot = jnp.where(keep, pos, 0).astype(jnp.int32)
    return (xg, np.asarray(top_i), np.asarray(top_w, np.float64),
            np.asarray(keep), np.asarray(slot), cap)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_sell_routing_csr_equals_reference_array_for_array(cf, dtype):
    """The same routing in: the combine CSR (indptr, indices, data and its
    dtype) and the slot activations equal the reference's exactly; the
    port's one host read reduces keep / slot over the experts without
    changing the assignment order."""
    cfg, _ = _moe_cfgs(n_experts=8, top_k=3, capacity_factor=cf)
    jp, _ = _moe_pair(cfg, 5)
    x = np.random.default_rng(5).standard_normal((2, 20, cfg.d_model)).astype(dtype)
    xg, top_i, top_w, keep, slot, cap = _reference_routing(cfg, jp, jnp.asarray(x))
    e = cfg.moe.n_experts
    ein_j, csr_j = RMOE._sell_routing(xg, top_i, top_w, keep, slot, cap=cap, e=e)
    reads = MOE.ROUTING_READS
    host = MOE._routing_to_host(
        torch.from_numpy(top_i.astype(np.int64)),
        torch.from_numpy(top_w.astype(np.float32)),
        torch.from_numpy(np.array(keep)), torch.from_numpy(np.array(slot)))
    assert MOE.ROUTING_READS == reads + 1
    want = (top_i, top_w, keep.any(-1), slot.sum(-1))
    for got, w in zip(host, want):
        np.testing.assert_array_equal(got, w)
    ein_t, csr_t = MOE._sell_routing(torch.from_numpy(np.array(xg)), *host,
                                     cap=cap, e=e)
    assert csr_t.n_cols == csr_j.n_cols == 2 * e * cap
    for name in ("indptr", "indices", "data"):
        got, want = getattr(csr_t, name), getattr(csr_j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ein_t.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(ein_t.numpy(), np.asarray(ein_j))
    if cf < 1:
        assert csr_t.nnz < 2 * 20 * 3           # assignments dropped


def test_sell_routing_refuses_activations_outside_fp32_fp64():
    """The combine CSR's values take the activations' dtype; bfloat16 (no
    numpy dtype) and float16 are refused, naming the dtypes it takes,
    before the pack."""
    cfg, _ = _moe_cfgs(n_experts=4, top_k=2)
    e, k, cap = cfg.moe.n_experts, cfg.moe.top_k, 3
    top_i = np.zeros((1, 1, 4, k), np.int64)
    top_i[..., 1] = 1
    host = (top_i, np.full((1, 1, 4, k), 0.5), np.ones((1, 1, 4, k), bool),
            np.zeros((1, 1, 4, k), np.int64))
    for dtype in (torch.bfloat16, torch.float16):
        xg = torch.zeros((1, 1, 4, cfg.d_model), dtype=dtype)
        with pytest.raises(ValueError, match="float32 or float64"):
            MOE._sell_routing(xg, *host, cap=cap, e=e)


def test_auto_runs_dense_under_capture_and_sell_raises(monkeypatch):
    """The reference's rule with PyTorch's counterpart of a tracer: under
    CUDA-graph capture or compilation ``auto`` runs the dense path (no
    host read), ``sell`` raises; elsewhere ``auto`` runs SELL (one host
    read a combine)."""
    cfg, tcfg = _moe_cfgs()
    _, tp = _moe_pair(cfg, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, cfg.d_model)))
    auto = ExecSpec(dispatch="auto", vl=32, device="cpu")
    dense, _ = MOE.moe_forward(tp, tcfg, x, spec=PATHS["dense"][1])
    assert not MOE._under_capture()
    reads = MOE.ROUTING_READS
    eager, _ = MOE.moe_forward(tp, tcfg, x, spec=auto)
    assert MOE.ROUTING_READS == reads + 1
    np.testing.assert_allclose(eager.numpy(), dense.numpy(), **TOL)
    monkeypatch.setattr(MOE, "_under_capture", lambda: True)
    captured, _ = MOE.moe_forward(tp, tcfg, x, spec=auto)
    assert MOE.ROUTING_READS == reads + 1
    assert torch.equal(captured, dense)
    with pytest.raises(ValueError, match="concrete activations"):
        MOE.moe_forward(tp, tcfg, x, spec=PATHS["sell"][1])
    with MOE.sell_dispatch():                   # auto: dense under capture
        assert torch.equal(MOE.moe_forward(tp, tcfg, x)[0], dense)


def test_dispatch_scope_and_spec_rules():
    """spec=None without a scope is dense; the scope's spec applies inside
    it and is restored after; an unknown dispatch and a spec naming
    another device than the activations' raise."""
    cfg, tcfg = _moe_cfgs()
    _, tp = _moe_pair(cfg, 2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)))
    reads = MOE.ROUTING_READS
    dense, _ = MOE.moe_forward(tp, tcfg, x)
    assert MOE.ROUTING_READS == reads
    with MOE.sell_dispatch():
        assert MOE._ACTIVE["spec"] is MOE.SELL_SPEC
        scoped, _ = MOE.moe_forward(tp, tcfg, x)
    assert MOE.ROUTING_READS == reads + 1
    assert MOE._ACTIVE == {"spec": None, "submit": None}
    np.testing.assert_allclose(scoped.numpy(), dense.numpy(), **TOL)
    with pytest.raises(ValueError, match="unknown dispatch"):
        MOE.moe_forward(tp, tcfg, x, spec=ExecSpec(dispatch="sparse"))
    with pytest.raises(ValueError, match="not the activations' device"):
        MOE.moe_forward(tp, tcfg, x, spec=ExecSpec(dispatch="sell",
                                                   device="cuda"))


def test_submit_hook_receives_the_routing_and_the_tensor_as_it_is():
    cfg, tcfg = _moe_cfgs("deepseek-moe-16b")
    _, tp = _moe_pair(cfg, 4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, cfg.d_model)))
    seen = []

    def submit(csr, stack):
        seen.append((csr, stack))
        dense = np.zeros((csr.n_rows, csr.n_cols))
        rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
        dense[rows, csr.indices] = csr.data
        return torch.from_numpy(dense) @ stack

    with MOE.sell_dispatch(submit=submit):
        got, _ = MOE.moe_forward(tp, tcfg, x)
    want, _ = MOE.moe_forward(tp, tcfg, x, spec=PATHS["dense"][1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    (csr, stack), = seen
    cap = int(8 * 2 / 4 * cfg.moe.capacity_factor) + 1
    assert isinstance(stack, torch.Tensor) and stack.shape == (2 * 4 * cap, 64)
    assert csr.n_rows == 16 and np.diff(csr.indptr).max() <= cfg.moe.top_k


# ---------------------------------------------------------------------------
# The MoE LMs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def lm(request):
    arch = request.param
    cfg = ref_configs.reduced_config(arch)
    jp = RM.init_params(jax.random.PRNGKey(2), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = configs.reduced_config(arch)
    return cfg, jp, tcfg, params_from_reference(tree, tcfg, "cpu"), tree


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    tol = LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


def _n_moe_layers(cfg) -> int:
    return cfg.n_layers - (1 if cfg.dense_first_layer_ff else 0)


def test_params_from_reference_copies_every_moe_and_dense0_leaf(lm):
    cfg, _, tcfg, tp, tree = lm

    def leaves(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    got = dict(tp.named_parameters())
    want = {}
    for name, arr in leaves(tree):
        if name.startswith("blocks."):
            for i in range(np.shape(arr)[0]):
                head, rest = name.split(".", 1)
                want[f"{head}.{i}.{rest}"] = np.asarray(arr[i])
        else:
            want[name] = np.asarray(arr)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert torch.equal(got[name], torch.from_numpy(arr.copy())), name
    assert (tp.dense0 is not None) == bool(cfg.dense_first_layer_ff)
    assert all(b.moe is not None and b.mlp is None for b in tp.blocks)
    assert (tp.blocks[0].moe.shared is not None) == bool(cfg.moe.n_shared)
    assert not any(p.requires_grad for p in tp.parameters())
    fresh = M.init_params(M.make_generator(0, "cpu"), tcfg)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tp.named_parameters()}


def test_init_caches_and_blocks_of_the_moe_kind(lm):
    cfg, _, tcfg, _, _ = lm
    cj = RM.init_caches(cfg, 2, 32, dtype=jnp.float32)
    ct = M.init_caches(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    assert sorted(ct) == sorted(cj)
    for name in ct:
        assert ct[name].ssm is None
        for got, want in zip(ct[name].kv, cj[name].kv):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kv = blocks.init_layer_caches(tcfg, 3, "moe", 1, 8, device="cpu").kv
    assert kv.k.shape[0] == 3
    # a cross block (served now) at the moe config's widths: an MLP, no MoE
    block = blocks.init_block_params(M.make_generator(0, "cpu"), tcfg, "cross")
    assert block.moe is None and block.mlp is not None
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.init_block_params(M.make_generator(0, "cpu"), tcfg, "expert")


@pytest.mark.parametrize("length", [16, 13])
def test_forward_prefill_and_decode_logits_match_reference(lm, length):
    cfg, jp, tcfg, tp, _ = lm
    toks = np.random.default_rng(length).integers(
        0, cfg.vocab_size, (2, length)).astype(np.int32)
    lj, aux_j = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    lt, aux_t = M.forward(tp, tcfg, {"tokens": toks})
    _close(lt, lj)
    assert float(aux_j) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)
    cj = RM.init_caches(cfg, 2, 64, dtype=jnp.float32)
    ct = M.init_caches(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    lj, cj = RM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, cj)
    lt, ct = M.prefill(tp, tcfg, {"tokens": toks}, ct)
    _close(lt, lj)
    tok = toks[:, -1:]
    for _ in range(3):
        lj, cj = RM.decode_step(jp, cfg, jnp.asarray(tok), cj)
        lt, ct = M.decode_step(tp, tcfg, tok, ct)
        _close(lt, lj)
        for name in ct:
            _close(ct[name].kv.k, cj[name].kv.k)
            _close(ct[name].kv.v, cj[name].kv.v)
            np.testing.assert_array_equal(ct[name].kv.pos.numpy(),
                                          np.asarray(cj[name].kv.pos))
            np.testing.assert_array_equal(ct[name].kv.length.numpy(),
                                          np.asarray(cj[name].kv.length))
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)


def test_sell_dispatch_forward_matches_reference(lm):
    """The whole LM with every combine on the SELL path (the plain B1 on
    the CPU): logits and aux as the reference's dense path gives them."""
    cfg, jp, tcfg, tp, _ = lm
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lj, aux_j = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    reads = MOE.ROUTING_READS
    with MOE.sell_dispatch():
        lt, aux_t = M.forward(tp, tcfg, {"tokens": toks})
    assert MOE.ROUTING_READS == reads + _n_moe_layers(cfg)
    _close(lt, lj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)


def _reference_steps(cfg, jp, prompts, n_new):
    """The reference's greedy tokens and, per position, its top-2 margin."""
    caches = RM.init_caches(cfg, prompts.shape[0], 64, dtype=jnp.float32)
    logits, caches = RM.prefill(jp, cfg, {"tokens": jnp.asarray(prompts)}, caches)
    last = logits[:, -1]
    toks, margins = [], []
    for i in range(n_new):
        top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
        toks.append(tok)
        if i + 1 < n_new:
            last, caches = RM.decode_step(jp, cfg, jnp.asarray(tok[:, None]), caches)
    return np.stack(toks, 1), np.stack(margins, 1), float(np.abs(logits).max())


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    close = []
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                close.append((r, c, float(margins[r, c])))
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])
    if close:
        print(f"{what}: positions with a top-2 margin <= {tol:.2e}: {close}")


def test_engine_greedy_tokens_match_reference(lm):
    cfg, jp, tcfg, tp, _ = lm
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (3, 12)).astype(np.int32)
    want, margins, scale = _reference_steps(cfg, jp, prompts, 6)
    ref = RefEngine(cfg, jp, RefGenerationConfig(max_new_tokens=6,
                                                 cache_len=64)).generate(prompts)
    np.testing.assert_array_equal(ref, want)
    got = ServeEngine(tcfg, tp, GenerationConfig(max_new_tokens=6,
                                                 cache_len=64)).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    _assert_tokens_agree(got, want, margins, scale, "engine")


def test_batcher_greedy_tokens_match_reference(lm):
    """Five requests of one prompt length through two slots; the batcher
    writes the ``"dense0"`` cache's rows as well as the stacked layers'."""
    cfg, jp, tcfg, tp, _ = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
               for _ in range(5)]

    def serve(batcher_cls, request_cls, c, p, gcfg):
        b = batcher_cls(c, p, n_slots=2, gcfg=gcfg)
        for i, pr in enumerate(prompts):
            b.submit(request_cls(rid=i, prompt=pr, max_new_tokens=4))
        return {r.rid: r.generated for r in b.run()}, b

    want, _ = serve(RefBatcher, RefRequest, cfg, jp, RefGenerationConfig(cache_len=64))
    got, b = serve(Batcher, Request, tcfg, tp, GenerationConfig(cache_len=64))
    assert sorted(got) == sorted(want) == list(range(5))
    assert sorted(b.caches) == (["dense0", "layers"] if cfg.dense_first_layer_ff
                                else ["layers"])
    own, margins, scale = _reference_steps(cfg, jp, np.stack(prompts), 4)
    for rid in range(5):
        _assert_tokens_agree(np.asarray([got[rid]]), np.asarray([want[rid]]),
                             margins[rid:rid + 1], scale, f"batcher {rid}")
        _assert_tokens_agree(np.asarray([got[rid]]), own[rid:rid + 1],
                             margins[rid:rid + 1], scale, f"own {rid}")


def test_batcher_writes_the_dense0_rows_of_each_slot():
    """Each slot's rows of the ``"dense0"`` cache are its own b = 1
    prefill's, as the stacked layers' are."""
    cfg, tcfg = _moe_cfgs("deepseek-moe-16b")
    tp = M.init_params(M.make_generator(1, "cpu"), tcfg)
    gcfg = GenerationConfig(cache_len=32, dtype=torch.float32)
    b = Batcher(tcfg, tp, n_slots=2, gcfg=gcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab_size, (8,)).astype(np.int32)
               for _ in range(2)]
    for i, pr in enumerate(prompts):
        b.submit(Request(rid=i, prompt=pr, max_new_tokens=2))
    b.step()                                    # both admitted, one decode
    for slot, pr in enumerate(prompts):
        one = M.init_caches(tcfg, 1, 32, dtype=torch.float32, device="cpu")
        _, one = M.prefill(tp, tcfg, {"tokens": pr[None]}, one)
        for name in ("dense0", "layers"):
            k = b.caches[name].kv.k[:, slot, :8]
            torch.testing.assert_close(k, one[name].kv.k[:, 0, :8],
                                       rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The fused kernel-service engine
# ---------------------------------------------------------------------------


def _fused(tcfg, tp, gcfg, b, s, dtype="float64"):
    m = tcfg.moe
    cap = int(s * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = KernelRegistry(device="cpu")
    reg.register_moe("moe", n_tokens=b * s, n_slots=b * m.n_experts * cap,
                     d_model=tcfg.d_model, top_k=m.top_k, dtype=dtype)
    svc = KernelService(reg, n_slots=4)
    return svc, ServeEngine(tcfg, tp, gcfg, kernel_service=svc,
                            moe_operand="moe")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_generate_matches_plain_engine(lm, dtype):
    """The reference's ``test_fused_generate_matches_plain_engine``: the
    fused engine's tokens equal the plain engine's and the reference's,
    one ``moe_dispatch`` launch a MoE layer a step, one token-latency
    observation a token, one ``moe_dispatch`` latency a launch.  A float64
    envelope promotes the residual stream to float64, as in the
    reference; a float32 one keeps it float32."""
    cfg, jp, tcfg, tp, _ = lm
    gcfg = GenerationConfig(max_new_tokens=4, cache_len=64)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    plain = ServeEngine(tcfg, tp, gcfg).generate(prompts)
    svc, eng = _fused(tcfg, tp, gcfg, 2, 6, dtype)
    assert eng.fused and not ServeEngine(tcfg, tp, gcfg).fused
    reads = MOE.ROUTING_READS
    fused = eng.generate(prompts)
    np.testing.assert_array_equal(fused, plain)
    want, margins, scale = _reference_steps(cfg, jp, prompts, 4)
    _assert_tokens_agree(fused, want, margins, scale, "fused")
    launches = _n_moe_layers(cfg) * gcfg.max_new_tokens
    assert svc.stats["moe_dispatch_launches"] == launches
    assert MOE.ROUTING_READS == reads + launches
    assert svc.metrics.get("latency_us_class_lm_token").count == \
        gcfg.max_new_tokens
    assert svc.metrics.get("latency_us_class_moe_dispatch").count == launches
    assert MOE._ACTIVE == {"spec": None, "submit": None}


def test_fused_engine_matches_the_reference_fused_engine():
    """The reference's fused engine (float64 envelope) on the same weights
    gives the same tokens and the same launch and histogram counts."""
    cfg, tcfg = _moe_cfgs("mixtral-8x7b")
    jp = RM.init_params(jax.random.PRNGKey(2), cfg)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    m = cfg.moe
    cap = int(6 * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = RefRegistry()
    reg.register_moe("moe", n_tokens=12, n_slots=2 * m.n_experts * cap,
                     d_model=cfg.d_model, top_k=m.top_k)
    ref_svc = RefService(reg, n_slots=4)
    want = RefEngine(cfg, jp, RefGenerationConfig(max_new_tokens=4, cache_len=64),
                     kernel_service=ref_svc, moe_operand="moe").generate(prompts)
    svc, eng = _fused(tcfg, tp, GenerationConfig(max_new_tokens=4, cache_len=64),
                      2, 6)
    np.testing.assert_array_equal(eng.generate(prompts), want)
    for key in ("moe_dispatch_launches", "served", "submitted"):
        assert svc.stats[key] == ref_svc.stats[key], key
    for name in ("latency_us_class_lm_token", "latency_us_class_moe_dispatch"):
        assert svc.metrics.get(name).count == ref_svc.metrics.get(name).count


def test_fused_mode_needs_a_moe_operand():
    cfg, tcfg = _moe_cfgs("deepseek-moe-16b")
    tp = M.init_params(M.make_generator(0, "cpu"), tcfg)
    with pytest.raises(ValueError, match="moe_operand"):
        ServeEngine(tcfg, tp, GenerationConfig(), kernel_service=object())


def test_retrieve_context_returns_the_reference_ids():
    """PageRank through each package's service, then the top node ids."""
    ref_graph = ref_gen.random_graph(n_nodes=600, avg_degree=6, seed=3)
    graph = gen.random_graph(n_nodes=600, avg_degree=6, seed=3)
    np.testing.assert_array_equal(graph.adj, ref_graph.adj)
    reg = RefRegistry()
    reg.register_graph("g", ref_graph)
    want = ref_retrieve_context(RefService(reg, n_slots=4), "g", 10)
    treg = KernelRegistry(device="cpu")
    treg.register_graph("g", graph)
    svc = KernelService(treg, n_slots=4)
    got = retrieve_context(svc, "g", 10)
    assert got.shape == (10,) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert svc.stats["served"] == 1 and not svc.completed
    got2 = retrieve_context(svc, "g", 5, damping=0.9, iters=12)
    want2 = ref_retrieve_context(RefService(reg, n_slots=4), "g", 5,
                                 damping=0.9, iters=12)
    np.testing.assert_array_equal(got2, want2)


def test_retrieve_context_steps_a_full_queue():
    """A full admission queue is stepped, not dropped: the retrieval is
    refused once (QueueFull, counted), then served after the queued
    request's round."""
    graph = gen.random_graph(n_nodes=300, avg_degree=5, seed=4)
    reg = KernelRegistry(device="cpu")
    reg.register_graph("g", graph)
    svc = KernelService(reg, n_slots=1, max_queue=1)
    queued = svc.submit("pagerank", "g", damping=0.85, iters=8)
    got = retrieve_context(svc, "g", 6)
    assert svc.stats["rejected"] == 1
    assert svc.poll(queued) is not None
    np.testing.assert_array_equal(
        got, np.argsort(svc.poll(queued).numpy())[::-1][:6])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cli_serves_reduced_moe_archs_on_the_cpu(arch, capsys):
    cli.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots",
              "2", "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: 3 requests, 12 tokens" in out
    assert out.count("  req ") == 3
