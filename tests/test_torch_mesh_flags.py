"""Parity of the port's mesh flags (``repro_torch.models.attention
.SEQ_SHARD_FALLBACK``, ``repro_torch.launch.specs.KV_SEQ_SHARD`` and
``FSDP_PARAMS``) with the reference's specs under the same flags, the
port unsharded and the JAX reference without a mesh, on the CPU.

The port runs on meshes naming the CPU N times (``("cpu",) * N``).  Both
packages' flags are set with ``monkeypatch``.  The reference's cache rule
shards a KV leaf only where it holds more than one kv head, so the mesh
cases take configs with several: qwen2 (reduced) at 4 q / 2 kv heads (on
a 4-way model axis the q heads divide, the kv heads do not) and at 6 q /
2 kv heads of 16 (neither divides: the sequence-parallel rows), hymba
(reduced) at d_model 80 with 5 q / 5 kv heads of 16 (neither divides, as
hymba-1.5b's 25 / 5 on (1, 4); its 10 SSM heads split on a 2-way axis).
Tolerances:

* the sequence-parallel rows against the port unsharded: ``TOL64`` =
  1e-10 x max(1, |logit|) in float64 (each row's scores and softmax are
  the unsharded row's);
* a context-split cache against the port unsharded: ``TOL_MERGE`` = 1e-6
  in float64, not 1e-10: each device's softmax normalizer is a float32
  exp rescaled by its max, merged across the devices, where the unsharded
  softmax sums one float32 row (the largest difference seen: 1.4e-7);
  hymba (float32 model, float32 scan inputs) ``TOL_SSM`` = 1e-5, as
  ``tests/test_torch_mesh_families.py`` holds it;
* against the reference without a mesh (float32): ``LOGIT_TOL`` x max(1,
  max|reference|), greedy tokens equal past that margin;
* ``FSDP_PARAMS``: ``torch.equal`` to the same mesh without the flag
  (logits, losses, updated parameters): the gathered block is the
  unflagged piece, and each parameter block's gradient sums two data
  replicas' contributions, whose order does not change a sum of two.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro.models import attention as ref_attn
from repro.models import model as RM
from repro.optim.compression import CompressionState as RefComp
from repro.train.step import TrainState as RefTrainState
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.data import DataConfig
from repro_torch.launch import specs
from repro_torch.models import attention, blocks, sharding, ssm
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import AdamWConfig, CompressionState
from repro_torch.serve import Batcher, GenerationConfig, Request
from repro_torch.train import (TrainConfig, TrainLoopConfig, TrainState,
                               init_train_state, train_loop)
from repro_torch.train.step import loss_and_grads, make_train_step

TOL64 = 1e-10
TOL_MERGE = 1e-6
TOL_SSM = 1e-5
LOGIT_TOL = 1e-5
CACHE_LEN = 48
N_NEW = 4
#: (name, arch, config overrides, prompt length, dtype of the unsharded
#: comparison)
CASES = {
    "qwen2_kv": ("qwen2-1.5b", {"n_kv_heads": 2}, 16, torch.float64),
    "qwen2_rows": ("qwen2-1.5b", {"n_heads": 6, "n_kv_heads": 2,
                                  "head_dim": 16}, 16, torch.float64),
    "hymba": ("hymba-1.5b", {"d_model": 80, "n_heads": 5, "n_kv_heads": 5},
              32, torch.float32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), ("cpu",) * math.prod(shape))


def _flags(monkeypatch, *, seq=False, kv=False, fsdp=False, chunk=0,
           bf16=False):
    """Each flag set in both packages' modules of its name."""
    for mod, name, value in (
            (attention, "SEQ_SHARD_FALLBACK", seq), (ref_attn, "SEQ_SHARD_FALLBACK", seq),
            (attention, "ATTN_KV_CHUNK", chunk), (ref_attn, "ATTN_KV_CHUNK", chunk),
            (attention, "ATTN_BF16_SCORES", bf16), (ref_attn, "ATTN_BF16_SCORES", bf16),
            (specs, "KV_SEQ_SHARD", kv), (ref_specs, "KV_SEQ_SHARD", kv),
            (specs, "FSDP_PARAMS", fsdp), (ref_specs, "FSDP_PARAMS", fsdp)):
        monkeypatch.setattr(mod, name, value)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float64) if not isinstance(want, torch.Tensor) \
        else want.detach().double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# Specs against the reference's under the flags
# ---------------------------------------------------------------------------


class _Spec:
    """The reference's NamedSharding stood in by its PartitionSpec."""

    def __init__(self, mesh, spec):
        self.spec = spec


class _Duck:
    empty = False

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _meta_device(device=None):
    return torch.device("meta")


def _meta_randn(shape, generator=None, dtype=None, device=None, **kw):
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_cache_shardings_match_reference_under_kv_seq_shard(arch, shape,
                                                            monkeypatch):
    """``KV_SEQ_SHARD``: every cache leaf's spec is the reference's under
    the flag at the published widths, at a batch the data axis divides (8)
    and one it does not (1); where the kv heads do not divide the model
    axis (and hold more than one head), the context axis takes it."""
    _flags(monkeypatch, kv=True)
    monkeypatch.setattr(ref_specs, "NamedSharding", _Spec)
    for mod in (M, blocks, attention, ssm):
        monkeypatch.setattr(mod, "resolve_device", _meta_device)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    axes = {"data": shape[0], "model": shape[1]}
    mesh = _cpu_mesh(shape)
    for batch in (1, 8):
        caches = M.init_caches(cfg, batch, 16)
        want = ref_specs.cache_shardings(
            _Duck(axes), ref_cfg,
            jax.eval_shape(lambda: RM.init_caches(ref_cfg, batch, 16)), batch)
        got = specs.cache_shardings(mesh, cfg, caches, batch)
        for key in got:
            g = sharding.tree_leaves(got[key])
            w = jax.tree_util.tree_leaves(want[key],
                                          is_leaf=lambda x: isinstance(x, _Spec))
            assert len(g) == len(w), key
            assert g == [tuple(x.spec) for x in w], (arch, batch, key)
        kv = got["layers"].kv
        if kv is not None and cfg.n_kv_heads > 1 and cfg.n_kv_heads % shape[1]:
            assert kv.k[-3] == "model", kv.k


@pytest.fixture(scope="module")
def full_params():
    """``full_params(arch)``: the port's LM at the published widths with
    meta tensors for every draw, and the same leaves as a reference-style
    tree (one subtree a layer), built once an arch."""
    built = {}

    def get(arch):
        if arch not in built:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch, "randn", _meta_randn)
                port = M.init_params(M.make_generator(0, "cpu"),
                                     configs.get_config(arch))
            tree = {}
            for name, p in port.named_parameters():
                node, parts = tree, name.split(".")
                for k in parts[:-1]:
                    node = node.setdefault(k, {})
                node[parts[-1]] = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
            built[arch] = (port, tree)
        return built[arch]
    return get


def _node(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-1.5b", "hymba-1.5b",
                                  "mixtral-8x7b", "mamba2-2.7b",
                                  "llama-3.2-vision-11b"])
def test_param_and_state_shardings_match_reference_under_fsdp(
        full_params, arch, shape, monkeypatch):
    """``FSDP_PARAMS``: ``param_shardings`` and ``state_shardings`` (params,
    moments, master, compression error) equal the reference's under the
    flag leaf by leaf on the same per-layer leaves; the parameters' specs
    are then the moments' (ZeRO-1's), and name ``data``."""
    _flags(monkeypatch, fsdp=True)
    monkeypatch.setattr(ref_specs, "NamedSharding", _Spec)
    port, tree = full_params(arch)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    duck = _Duck({"data": shape[0], "model": shape[1]})
    mesh = _cpu_mesh(shape)
    got = specs.param_shardings(mesh, cfg, port)
    want = ref_specs.param_shardings(duck, ref_cfg, tree)
    for name, _ in port.named_parameters():
        assert got[name] == tuple(_node(want, name).spec), name
    assert any("data" in spec for spec in got.values())
    sds = jax.ShapeDtypeStruct((), jnp.int32)
    ref_state = ref_specs.state_shardings(duck, ref_cfg, RefTrainState(
        tree, {"m": tree, "v": tree, "step": sds, "master": tree},
        RefComp(error=tree), sds))
    state = specs.state_shardings(mesh, cfg, TrainState(
        port, {"m": {}, "v": {}, "step": 0, "master": {}},
        CompressionState(error={}), 0))
    for name, _ in port.named_parameters():
        assert state.params[name] == tuple(_node(ref_state.params, name).spec)
        for part in ("m", "v", "master"):
            assert state.opt[part][name] == \
                tuple(_node(ref_state.opt[part], name).spec), (part, name)
        assert state.comp.error[name] == tuple(_node(ref_state.comp.error, name).spec)
        assert state.params[name] == state.opt["m"][name], name


# ---------------------------------------------------------------------------
# Serving under SEQ_SHARD_FALLBACK and KV_SEQ_SHARD
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """``built(case)``: the case's config in both packages, the reference's
    weights moved over, (4, prompt) prompts, and the reference's (jitted,
    no flags, no mesh) prefill logits, greedy tokens, their margins and
    first decode step's logits."""
    out = {}

    def get(case):
        if case not in out:
            arch, over, plen, dt = CASES[case]
            cfg = dataclasses.replace(ref_configs.reduced_config(arch), **over)
            tcfg = dataclasses.replace(configs.reduced_config(arch), **over)
            jp = RM.init_params(jax.random.PRNGKey(1), cfg)
            tree = jax.tree_util.tree_map(np.asarray, jp)
            prompts = np.random.default_rng(2).integers(
                0, cfg.vocab_size, (4, plen)).astype(np.int32)
            pre = jax.jit(lambda p, t, c: RM.prefill(p, cfg, {"tokens": t}, c))
            step = jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c))
            caches = RM.init_caches(cfg, 4, CACHE_LEN, dtype=jnp.float32)
            logits, caches = pre(jp, jnp.asarray(prompts), caches)
            last, toks, margins = logits[:, -1], [], []
            step1 = None
            for i in range(N_NEW):
                top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
                margins.append(top2[:, 1] - top2[:, 0])
                toks.append(np.asarray(jnp.argmax(last, -1)).astype(np.int32))
                if i + 1 < N_NEW:
                    last, caches = step(jp, jnp.asarray(toks[-1][:, None]), caches)
                    step1 = np.asarray(last) if i == 0 else step1
            out[case] = dict(
                cfg=tcfg, ref_cfg=cfg, jp=jp, dt=dt, tp=params_from_reference(tree, tcfg, "cpu"),
                prompts=prompts, logits=np.asarray(logits),
                tokens=np.stack(toks, 1), margins=np.stack(margins, 1),
                step1=step1, scale=float(np.abs(logits).max()))
        return out[case]
    return get


def _drive(params, cfg, prompts, dtype, mesh=None):
    """Prefill, then three greedy decode steps: (each step's logits, the
    last caches)."""
    caches = M.init_caches(cfg, prompts.shape[0], CACHE_LEN, dtype=dtype,
                           device="cpu", mesh=mesh)
    logits, caches = M.prefill(params, cfg, {"tokens": prompts}, caches,
                               dtype=dtype, mesh=mesh)
    outs = [logits]
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for _ in range(3):
        last, caches = M.decode_step(params, cfg, tok, caches, dtype=dtype,
                                     mesh=mesh)
        outs.append(last)
        tok = torch.argmax(last, -1)[:, None]
    return outs, caches


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])


def _counted_rows(monkeypatch) -> list:
    calls = []
    real = attention._attention_rows

    def wrapped(p, cfg, x, *args, **kw):
        calls.append(x.shape[1])
        return real(p, cfg, x, *args, **kw)
    monkeypatch.setattr(attention, "_attention_rows", wrapped)
    return calls


#: (case, mesh shape, flags): the context split where the q heads divide
#: (qwen2 4 / 2 on (1, 4)); the query rows split (qwen2 6 / 2, hymba);
#: both (hymba, its ring of 16 wrapped by the 32-token prefill) on (1, 4)
#: and (2, 2), where the kv heads divide and only the rows split
MESH_CASES = [
    ("qwen2_kv", (1, 4), {"kv": True}),
    ("qwen2_rows", (1, 4), {"seq": True}),
    ("qwen2_rows", (1, 4), {"seq": True, "kv": True}),
    ("hymba", (1, 4), {"seq": True, "kv": True}),
    ("hymba", (2, 2), {"seq": True, "kv": True}),
]


@pytest.mark.parametrize("case,shape,flags", MESH_CASES,
                         ids=[f"{c}-{s[0]}x{s[1]}-{'+'.join(f)}"
                              for c, s, f in MESH_CASES])
def test_mesh_flags_match_unsharded_and_reference(built, case, shape, flags,
                                                  monkeypatch):
    """A prefill and three decode steps on the mesh under the flags: each
    model device's k / v piece holds C / model slots where the context
    splits; logits and every cache leaf (gathered) against the port
    unsharded; in float32 the prefill and first decode step against the
    reference without a mesh; the batcher's tokens (b = 1 prefills written
    into the split cache) against the reference's greedy continuation."""
    s = built(case)
    cfg, dt, mesh = s["cfg"], s["dt"], _cpu_mesh(shape)
    lm = copy.deepcopy(s["tp"]).to(dt)
    want, want_c = _drive(lm, cfg, s["prompts"], dt)
    _flags(monkeypatch, **flags)
    rows = _counted_rows(monkeypatch)
    placed = sharding.place_params(lm, cfg, mesh)
    got, got_c = _drive(placed, cfg, s["prompts"], dt, mesh)
    split = flags.get("kv") and cfg.n_kv_heads % shape[1] != 0
    k = got_c["layers"].kv.k
    c = want_c["layers"].kv.k.shape[2]
    assert k.pieces.flat[0].shape[2] == (c // shape[1] if split else c)
    q_rows = flags.get("seq") and cfg.n_heads % shape[1] != 0
    assert bool(rows) == bool(split or q_rows)
    tol = TOL_SSM if cfg.hybrid else TOL_MERGE if split else TOL64
    for g, w in zip(got, want):
        _close(g, w, tol)
    for name in sorted(got_c):
        for g, w in zip(sharding.tree_leaves(got_c[name]),
                        sharding.tree_leaves(want_c[name])):
            _close(g.full().to(w.dtype), w, tol)
    if dt != torch.float32:
        return
    placed = sharding.place_params(s["tp"], cfg, mesh)
    got, _ = _drive(placed, cfg, s["prompts"], torch.float32, mesh)
    _close(got[0], s["logits"], LOGIT_TOL)
    if np.array_equal(torch.argmax(got[0][:, -1], -1).numpy(), s["tokens"][:, 0]):
        _close(got[1], s["step1"], LOGIT_TOL)
    b = Batcher(cfg, placed, n_slots=4, mesh=mesh,
                gcfg=GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN))
    for rid in range(4):
        b.submit(Request(rid=rid, prompt=s["prompts"][rid], max_new_tokens=N_NEW))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == list(range(4))
    for rid, t in done.items():
        _assert_tokens_agree(np.asarray([t]), s["tokens"][rid:rid + 1],
                             s["margins"][rid:rid + 1], s["scale"], f"batcher {rid}")


def test_qwen2_float32_context_split_matches_reference(built, monkeypatch):
    """qwen2 at 4 q / 2 kv heads on (1, 4) under ``KV_SEQ_SHARD`` in
    float32: prefill and first decode step against the reference without
    a mesh, batcher tokens against its greedy continuation."""
    s = built("qwen2_kv")
    cfg, mesh = s["cfg"], _cpu_mesh((1, 4))
    _flags(monkeypatch, kv=True)
    placed = sharding.place_params(s["tp"], cfg, mesh)
    got, caches = _drive(placed, cfg, s["prompts"], torch.float32, mesh)
    assert caches["layers"].kv.k.pieces.flat[0].shape[2] == CACHE_LEN // 4
    _close(got[0], s["logits"], LOGIT_TOL)
    if np.array_equal(torch.argmax(got[0][:, -1], -1).numpy(), s["tokens"][:, 0]):
        _close(got[1], s["step1"], LOGIT_TOL)
    b = Batcher(cfg, placed, n_slots=4, mesh=mesh,
                gcfg=GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN))
    for rid in range(4):
        b.submit(Request(rid=rid, prompt=s["prompts"][rid], max_new_tokens=N_NEW))
    for r in b.run():
        _assert_tokens_agree(np.asarray([r.generated]), s["tokens"][r.rid:r.rid + 1],
                             s["margins"][r.rid:r.rid + 1], s["scale"],
                             f"batcher {r.rid}")


def test_rows_under_chunk_match_unsharded_chunk(built, monkeypatch):
    """``SEQ_SHARD_FALLBACK`` with ``ATTN_KV_CHUNK = 4``: each device's
    query rows through ``_sdpa_chunked`` at their global positions, without
    a cache (the training forward) and into the cache: within ``TOL64`` of
    the port unsharded under the same chunk."""
    s = built("qwen2_rows")
    cfg, dt, mesh = s["cfg"], s["dt"], _cpu_mesh((1, 4))
    lm = copy.deepcopy(s["tp"]).to(dt)
    _flags(monkeypatch, seq=True, chunk=4)
    want, _ = M.forward(lm, cfg, {"tokens": s["prompts"]}, dtype=dt)
    want_d, _ = _drive(lm, cfg, s["prompts"], dt)
    rows = _counted_rows(monkeypatch)
    placed = sharding.place_params(lm, cfg, mesh)
    got, _ = M.forward(placed, cfg, {"tokens": s["prompts"]}, dtype=dt, mesh=mesh)
    _close(got, want, TOL64)
    got_d, _ = _drive(placed, cfg, s["prompts"], dt, mesh)
    for g, w in zip(got_d, want_d):
        _close(g, w, TOL64)
    assert rows[:cfg.n_layers] == [16] * cfg.n_layers


def test_rows_train_step_matches_unsharded(built, monkeypatch):
    """A training forward (no cache) under ``SEQ_SHARD_FALLBACK`` and
    ``ATTN_KV_CHUNK = 4`` on (1, 4), each block under remat "full": loss
    and every gradient within ``TOL64`` of the port unsharded under the
    same chunk (float64)."""
    s = built("qwen2_rows")
    cfg, mesh = s["cfg"], _cpu_mesh((1, 4))
    lm = copy.deepcopy(s["tp"]).double().requires_grad_(True)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels[:, -1] = -1
    batch = {"tokens": s["prompts"], "labels": labels}
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat="full",
                     dtype=torch.float64)
    _flags(monkeypatch, seq=True, chunk=4)
    want, loss, _ = loss_and_grads(lm, cfg, tc, batch)
    rows = _counted_rows(monkeypatch)
    got, got_loss, _ = loss_and_grads(sharding.place_params(lm, cfg, mesh), cfg,
                                      tc, batch)
    assert rows and set(rows) == {16}
    assert abs(float(got_loss) - float(loss)) <= TOL64 * float(loss)
    for k, g in got.items():
        _close(g.full(), want[k], TOL64)


def test_rows_keep_todays_path_where_the_length_does_not_divide(built,
                                                                monkeypatch):
    """``SEQ_SHARD_FALLBACK`` on a prompt of 18 (4 does not divide it) and on
    decode steps: the layer runs whole on the lead as without the flag,
    every logit ``torch.equal``."""
    s = built("qwen2_rows")
    cfg, mesh = s["cfg"], _cpu_mesh((1, 4))
    prompts = np.concatenate([s["prompts"], s["prompts"][:, :2]], axis=1)
    placed = sharding.place_params(s["tp"], cfg, mesh)
    want, _ = _drive(placed, cfg, prompts, torch.float32, mesh)
    _flags(monkeypatch, seq=True)
    rows = _counted_rows(monkeypatch)
    got, _ = _drive(placed, cfg, prompts, torch.float32, mesh)
    assert rows == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_all_five_flags_on_hymba(built, monkeypatch):
    """hymba on (1, 4) with all five flags (the chunk 8 divides its
    32-token prompt; ``FSDP_PARAMS`` on a data axis of 1 names ``data`` in
    every spec it can): prefill and decode steps within ``TOL_SSM`` of the
    port unsharded under the same single-device flags, the prefill within
    ``LOGIT_TOL`` of the reference under them."""
    s = built("hymba")
    cfg, mesh = s["cfg"], _cpu_mesh((1, 4))
    _flags(monkeypatch, chunk=8, bf16=True)
    want, _ = _drive(s["tp"], cfg, s["prompts"], torch.float32)
    ref_cfg, jp = s["ref_cfg"], s["jp"]
    ref, _ = RM.prefill(jp, ref_cfg, {"tokens": jnp.asarray(s["prompts"])},
                        RM.init_caches(ref_cfg, 4, CACHE_LEN, dtype=jnp.float32))
    _flags(monkeypatch, seq=True, kv=True, fsdp=True, chunk=8, bf16=True)
    placed = sharding.place_params(s["tp"], cfg, mesh)
    assert placed["blocks.0.attn.wq"].spec == ("data", "model")
    got, caches = _drive(placed, cfg, s["prompts"], torch.float32, mesh)
    assert caches["layers"].kv.k.pieces.flat[0].shape[2] == 16 // 4
    for g, w in zip(got, want):
        _close(g, w, TOL_SSM)
    _close(got[0], np.asarray(ref), LOGIT_TOL)


# ---------------------------------------------------------------------------
# FSDP_PARAMS: parameters split over data
# ---------------------------------------------------------------------------


def _bytes(placed) -> int:
    return sum(t.numel() * t.element_size() for _, leaf in placed.items()
               for t in leaf.pieces.flat)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b"])
def test_fsdp_serves_and_trains_equal_to_the_unflagged_mesh(arch, monkeypatch):
    """``FSDP_PARAMS`` on (2, 2): a device holds 1 / 2 of its model block
    of each parameter ZeRO-1 splits (fewer resident bytes); the logits and
    two train steps (losses, updated parameters, every block's pieces
    agreeing) ``torch.equal`` to the same mesh without the flag."""
    cfg = configs.reduced_config(arch)
    dt = torch.float32 if cfg.ssm else torch.float64
    mesh = _cpu_mesh((2, 2))
    lm = M.init_params(M.make_generator(1, "cpu"), cfg).to(dt)
    prompts = np.random.default_rng(2).integers(0, 256, (4, 16)).astype(np.int32)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat="full", dtype=dt)
    runs = {}
    for flag in (False, True):
        monkeypatch.setattr(specs, "FSDP_PARAMS", flag)
        placed = sharding.place_params(lm, cfg, mesh)
        logits, _ = M.forward(placed, cfg, {"tokens": prompts}, dtype=dt, mesh=mesh)
        state = init_train_state(None, cfg, tcfg, params=sharding.place_params(
            lm, cfg, mesh))
        step = make_train_step(cfg, tcfg)
        rng = np.random.default_rng(5)
        losses = []
        for _ in range(2):
            batch = {k: rng.integers(0, 256, (4, 16)).astype(np.int32)
                     for k in ("tokens", "labels")}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        runs[flag] = (logits, _bytes(placed), losses, state.params)
    (l0, b0, s0, p0), (l1, b1, s1, p1) = runs[False], runs[True]
    assert torch.equal(l0, l1) and s0 == s1
    assert b1 < b0
    assert p1["blocks.0.attn.wq"].spec == ("data", "model")
    for name, leaf in p1.items():
        assert torch.equal(leaf.full(), p0[name].full()), name
        assert all(torch.equal(leaf.pieces[g[0]], leaf.pieces[c])
                   for g in sharding.groups(leaf) for c in g), name


def test_fsdp_local_blocks_gather_over_data():
    """``Sharded.local`` joins the data blocks of a device's model block on
    its device (the pieces themselves where the spec names no data axis),
    and hands the gradient of each use back to each piece."""
    mesh = _cpu_mesh((2, 2))
    x = torch.arange(48.0).reshape(8, 6)
    whole = sharding.place(x, (None, "model"), mesh)
    fsdp = sharding.place(x, ("data", "model"), mesh)
    for coord in np.ndindex(2, 2):
        assert whole.local(coord) is whole.pieces[coord]
        assert fsdp.pieces[coord].shape == (4, 3)
        assert torch.equal(fsdp.local(coord), whole.pieces[coord])
    fsdp_pieces = [t.requires_grad_() for t in fsdp.pieces.flat]
    total = sum(fsdp.local(c).sum() * (1 + c[0]) for c in np.ndindex(2, 2))
    grads = torch.autograd.grad(total, fsdp_pieces)
    for g in grads:
        assert torch.equal(g, torch.full((4, 3), 3.0))


def _loop(tmp_path, name, mesh, steps):
    cfg = configs.reduced_config("llama3.2-3b")
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    lc = TrainLoopConfig(total_steps=steps, ckpt_every=2, log_every=100,
                         ckpt_dir=str(tmp_path / name))
    return train_loop(cfg, tc, dc, lc, mesh=mesh, device="cpu",
                      log=lambda s: None)


def test_fsdp_checkpoint_restores_across_placements(tmp_path, monkeypatch):
    """A state checkpointed under ``FSDP_PARAMS`` on (2, 2) restores without
    the flag (a loop asked for as many steps ends where it starts), equal to
    its parameters and moments; one checkpointed without it restores under
    the flag, equal, every block's pieces agreeing."""
    mesh = _cpu_mesh((2, 2))
    monkeypatch.setattr(specs, "FSDP_PARAMS", True)
    flagged, hist = _loop(tmp_path, "fsdp", mesh, 2)
    assert [h["step"] for h in hist] == [0, 1]
    assert flagged.params["blocks.0.mlp.w_up"].spec == ("data", "model")
    monkeypatch.setattr(specs, "FSDP_PARAMS", False)
    back, hist = _loop(tmp_path, "fsdp", mesh, 2)
    assert hist == [] and back.step == 2
    assert back.params["blocks.0.mlp.w_up"].spec == (None, "model")
    for k, leaf in back.params.items():
        assert torch.equal(leaf.full(), flagged.params[k].full()), k
        assert torch.equal(back.opt["v"][k].full(), flagged.opt["v"][k].full()), k
    plain, _ = _loop(tmp_path, "plain", mesh, 2)
    monkeypatch.setattr(specs, "FSDP_PARAMS", True)
    again, hist = _loop(tmp_path, "plain", mesh, 2)
    assert hist == []
    for k, leaf in again.params.items():
        assert torch.equal(leaf.full(), plain.params[k].full()), k
        assert all(torch.equal(leaf.pieces[g[0]], leaf.pieces[c])
                   for g in sharding.groups(leaf) for c in g), k
