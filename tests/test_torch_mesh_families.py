"""Parity of the hybrid, vision and enc-dec families on a (data, model) mesh
(``repro_torch.models.model``'s mesh path with ``ctx_embeds``, the
``"hybrid"`` and ``"cross"`` kinds of ``blocks.block_forward_tp``,
``attention.attention_tp(ctx=)``, the engine, the batcher, training and
checkpoints) with the port unsharded and the JAX reference, on the CPU.

The port runs on meshes naming the CPU N times (``("cpu",) * N``), every
kernel through its plain version.  The reference's GSPMD never changes a
result, so the reference without a mesh is the oracle of the port with
one.  The configs are the reduced ones, hymba's at d_model 80 with 5 query
/ 1 kv heads of 16 (:func:`_cfgs`): its 10 SSM heads split on a 2-way
model axis (kernel B8's plain version on 5 heads a device) and not on a
4-way one (the scan whole on the lead), and its query heads split on
neither (the attention whole on the lead), as hymba-1.5b's 50 SSM and 25
query heads do.  Tolerances, those of ``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_train.py``:

* against the port unsharded: vision and enc-dec in float64, 1e-10 x
  max(1, |logit|), every cache leaf gathered; hymba in float32 at 1e-5
  (its scan takes float32 B / C whatever the parameters' dtype, as
  mamba2's does);
* against the reference without a mesh (float32): ``LOGIT_TOL`` x max(1,
  max|reference|); greedy tokens equal wherever the reference's top-2
  margin exceeds that;
* training: the loss and grad norm 1e-5 relative, each gradient 1e-4 x
  max|g| of the reference's; against the port unsharded 1e-10 x max|g|
  (float64, one data replica), 1e-6 with two (the float32 loss
  weighting), 1e-5 for hymba (float32); AdamW on the mesh given the
  unsharded gradients 1e-6 x max|p|.
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
from repro.models import layers as ref_layers
from repro.models import model as RM
from repro.optim.adamw import global_norm as ref_global_norm
from repro_torch import configs
from repro_torch.compat import make_mesh
from repro_torch.data import DataConfig
from repro_torch.kernels import ssd
from repro_torch.models import convert, sharding
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, decay_mask,
                               global_norm)
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine
from repro_torch.train import (TrainConfig, TrainLoopConfig, init_train_state,
                               train_loop)
from repro_torch.train.step import loss_and_grads

LOGIT_TOL = 1e-5
TOL64 = 1e-10
#: hymba against the port unsharded (float32 scan inputs)
TOL_SSM = 1e-5
#: several data replicas: the float32 loss weighting's rounding
TOL_DATA = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
HYMBA, VISION, SEAMLESS = "hymba-1.5b", "llama-3.2-vision-11b", "seamless-m4t-medium"
FAMILIES = (HYMBA, VISION, SEAMLESS)
#: (data, model) meshes: tensor parallel, data and tensor parallel, and a
#: 4-way model axis (hymba's scan whole on the lead)
MESHES = ((1, 2), (2, 2), (1, 4))
#: a cache length other than the reduced d_model (64): vision's (G, every,
#: C) ring positions then take the replicated rule
#: (``test_vision_ring_positions_the_rule_splits_over_data`` takes 64)
CACHE_LEN = 48
PROMPT = 16
N_NEW = 4


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


def _cfgs(arch):
    """The reduced config in both packages; hymba's at d_model 80 with 5
    query / 1 kv heads of 16 (10 SSM heads of 16)."""
    out = []
    for c in (ref_configs.reduced_config(arch), configs.reduced_config(arch)):
        if c.hybrid:
            c = dataclasses.replace(c, d_model=80, n_heads=5, n_kv_heads=1)
        out.append(c)
    return tuple(out)


def _ctx(cfg, b, seed=0):
    """The stub frontend's output (vision patch embeddings (b, T, d_ctx),
    enc-dec frames (b, T, d_model)), float32; None for hymba."""
    rng = np.random.default_rng(seed)
    if cfg.encdec is not None:
        shape = (b, cfg.encdec.n_ctx_tokens, cfg.d_model)
    elif cfg.cross_attn is not None:
        shape = (b, cfg.cross_attn.n_ctx_tokens, cfg.cross_attn.d_ctx or cfg.d_model)
    else:
        return None
    return rng.standard_normal(shape).astype(np.float32)


def _batch(toks, ctx):
    return {"tokens": toks} if ctx is None else {"tokens": toks, "ctx_embeds": ctx}


def _greedy(pre, step, jp, batch, caches):
    """The reference's prefill logits, its greedy tokens (N_NEW), their
    top-2 margins and its first decode step's logits."""
    logits, caches = pre(jp, {k: jnp.asarray(v) for k, v in batch.items()}, caches)
    last, toks, margins, step1 = logits[:, -1], [], [], None
    for i in range(N_NEW):
        top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(np.asarray(jnp.argmax(last, -1)).astype(np.int32))
        if i + 1 < N_NEW:
            last, caches = step(jp, jnp.asarray(toks[-1][:, None]), caches)
            if i == 0:
                step1 = np.asarray(last)
    return np.asarray(logits), np.stack(toks, 1), np.stack(margins, 1), step1


@pytest.fixture(scope="module")
def fam():
    """``fam(arch)``: the reduced arch in both packages on the reference's
    weights, (4, PROMPT) prompts and their context, and the reference's
    (under ``jax.jit``) forward logits, prefill logits, greedy tokens,
    margins and first decode step with the context, and its greedy tokens
    and margins against the caches' zero context (the batcher's), built
    once."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg, tcfg = _cfgs(arch)
            jp = RM.init_params(jax.random.PRNGKey(1), cfg)
            tree = jax.tree_util.tree_map(np.asarray, jp)
            tp = params_from_reference(tree, tcfg, "cpu")
            prompts = np.random.default_rng(2).integers(
                0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
            ctx = _ctx(cfg, 4, seed=3)
            pre = jax.jit(lambda p, b, c: RM.prefill(p, cfg, b, c))
            step = jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c))
            fwd = jax.jit(lambda p, b: RM.forward(p, cfg, b)[0])

            def zero():
                return RM.init_caches(cfg, 4, CACHE_LEN, dtype=jnp.float32)
            logits, toks, margins, step1 = _greedy(pre, step, jp,
                                                   _batch(prompts, ctx), zero())
            own = (toks, margins) if ctx is None else _greedy(
                pre, step, jp, _batch(prompts, None), zero())[1:3]
            built[arch] = dict(
                cfg=tcfg, ref_cfg=cfg, tree=tree, tp=tp, prompts=prompts,
                ctx=ctx, logits=logits, tokens=toks, margins=margins,
                step1=step1, own=own,
                forward=np.asarray(fwd(jp, {k: jnp.asarray(v) for k, v in
                                            _batch(prompts, ctx).items()})),
                scale=float(np.abs(logits).max()))
        return built[arch]
    return get


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])


def _dtype(cfg):
    return torch.float32 if cfg.hybrid else torch.float64


def _as(lm, dtype):
    """A copy of ``lm`` in ``dtype`` (the fixture's model stays float32)."""
    return copy.deepcopy(lm).to(dtype)


def _drive(params, cfg, prompts, ctx, dtype, mesh=None, cache_len=CACHE_LEN):
    """Prefill with the context, then three greedy decode steps reading it
    back from the caches: (each step's logits, the last caches)."""
    caches = M.init_caches(cfg, prompts.shape[0], cache_len, dtype=dtype,
                           device="cpu", mesh=mesh)
    logits, caches = M.prefill(params, cfg, _batch(prompts, ctx), caches,
                               dtype=dtype, mesh=mesh)
    outs = [logits]
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for _ in range(3):
        last, caches = M.decode_step(params, cfg, tok, caches, dtype=dtype,
                                     mesh=mesh)
        outs.append(last)
        tok = torch.argmax(last, -1)[:, None]
    return outs, caches


def _cache_leaves(caches) -> list:
    """Every leaf of a cache dict (entries by name, fields in order)."""
    out = []
    for name in sorted(caches):
        out += sharding.tree_leaves(caches[name])
    return out


def _unsharded(s):
    """The port unsharded, in float64 (hymba float32), driven once."""
    if "drive" not in s:
        lm = _as(s["tp"], _dtype(s["cfg"]))
        s["drive"] = _drive(lm, s["cfg"], s["prompts"], s["ctx"], _dtype(s["cfg"]))
        s["fwd64"], _ = M.forward(lm, s["cfg"], _batch(s["prompts"], s["ctx"]),
                                  dtype=_dtype(s["cfg"]))
    return s["drive"]


# ---------------------------------------------------------------------------
# Born-sharded init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_born_sharded_init_equals_place_params(arch, shape):
    """``init_params(mesh=)`` draws the nested stacks (vision's
    ``self_blocks.g.i`` / ``cross_blocks.g`` / ``ctx_proj``, the enc-dec's
    ``encoder.i`` / ``decoder.i.{self,cross}`` / ``enc_norm``, hymba's
    attention and mixer) block after block: every piece ``torch.equal`` to
    ``place_params`` of the whole model drawn from the same seed, with
    storage of its own."""
    cfg = _cfgs(arch)[1]
    mesh = _cpu_mesh(shape)
    born = M.init_params(M.make_generator(3, "cpu"), cfg, mesh=mesh)
    lm = M.init_params(M.make_generator(3, "cpu"), cfg)
    placed = sharding.place_params(lm, cfg, mesh)
    assert dict(born.named_leaves()).keys() == dict(placed.named_leaves()).keys()
    ptrs = set()
    for name, leaf in born.named_leaves():
        assert leaf.spec == placed[name].spec, name
        for coord in np.ndindex(mesh.devices.shape):
            assert torch.equal(leaf.pieces[coord], placed[name].pieces[coord]), \
                (name, coord)
            ptrs.add(leaf.pieces[coord].untyped_storage().data_ptr())
    assert len(ptrs) == sum(1 for _ in born.named_leaves()) * mesh.size
    assert any(leaf.tp_dim() is not None for _, leaf in born.named_leaves())


# ---------------------------------------------------------------------------
# Serving on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_logits_match_unsharded_and_reference(fam, arch, shape):
    """A prefill with ``ctx_embeds`` and three decode steps reading the
    context back from the placed caches: logits and every cache leaf
    (gathered) against the port unsharded; in float32 the prefill, the
    first decode step and the forward against the reference."""
    s = fam(arch)
    cfg, mesh, dt = s["cfg"], _cpu_mesh(shape), _dtype(s["cfg"])
    tol = TOL_SSM if cfg.hybrid else TOL64
    want, want_c = _unsharded(s)
    placed = sharding.place_params(_as(s["tp"], dt), cfg, mesh)
    got, got_c = _drive(placed, cfg, s["prompts"], s["ctx"], dt, mesh)
    for g, w in zip(got, want):
        _close(g, w, tol)
    assert sorted(got_c) == sorted(want_c)
    for g, w in zip(_cache_leaves(got_c), _cache_leaves(want_c)):
        _close(g.full().to(w.dtype), w, tol)
    logits, _ = M.forward(placed, cfg, _batch(s["prompts"], s["ctx"]), dtype=dt,
                          mesh=mesh)
    _close(logits, s["fwd64"], tol)
    placed = sharding.place_params(s["tp"], cfg, mesh)
    got, _ = _drive(placed, cfg, s["prompts"], s["ctx"], torch.float32, mesh)
    assert got[0].device == mesh.devices.flat[0]
    _close(got[0], s["logits"], LOGIT_TOL)
    if np.array_equal(torch.argmax(got[0][:, -1], -1).numpy(), s["tokens"][:, 0]):
        _close(got[1], s["step1"], LOGIT_TOL)      # the same token fed back
    logits, _ = M.forward(placed, cfg, _batch(s["prompts"], s["ctx"]), mesh=mesh)
    _close(logits, s["forward"], LOGIT_TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_engine_and_batcher_tokens_match_reference(fam, arch, shape):
    """``ServeEngine(mesh=)`` with ``extras={"ctx_embeds": ...}`` on the
    (4, PROMPT) prompts against the reference's greedy tokens, and
    ``Batcher(mesh=, n_slots=4)`` on the same prompts twice over (8
    requests, two waves, each admission a b = 1 prefill on the replica
    owning its slot, no context: the zero one) against the reference's
    continuation of each prompt against the zero context (its engine,
    request by request, as ``tests/test_torch_families.py`` holds the
    unsharded vision batcher at ``every = 1``)."""
    s = fam(arch)
    cfg, mesh = s["cfg"], _cpu_mesh(shape)
    placed = sharding.place_params(s["tp"], cfg, mesh)
    gcfg = GenerationConfig(max_new_tokens=N_NEW, cache_len=CACHE_LEN)
    extras = None if s["ctx"] is None else {"ctx_embeds": s["ctx"]}
    got = ServeEngine(cfg, placed, gcfg, mesh=mesh).generate(s["prompts"],
                                                             extras=extras)
    assert got.shape == (4, N_NEW) and got.dtype == np.int32
    _assert_tokens_agree(got, s["tokens"], s["margins"], s["scale"], "engine")
    b = Batcher(cfg, placed, n_slots=4, gcfg=gcfg, mesh=mesh)
    for rid in range(8):
        b.submit(Request(rid=rid, prompt=s["prompts"][rid % 4],
                         max_new_tokens=N_NEW))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == list(range(8))
    toks, margins = s["own"]
    for rid, got in done.items():
        r = rid % 4
        _assert_tokens_agree(np.asarray([got]), toks[r:r + 1],
                             margins[r:r + 1], s["scale"], f"batcher {rid}")
    for name in ("ctx", "memory"):
        if name in b.caches:
            assert not b.caches[name].full().any()


@pytest.mark.parametrize("m_size,heads", [(2, 5), (4, None)])
def test_hybrid_mixer_splits_its_heads_or_runs_whole(fam, m_size, heads,
                                                     monkeypatch):
    """hymba's 10 SSM heads on a 2-way model axis: kernel B8's plain
    version runs once a device and layer on its 5 heads; on a 4-way axis
    (10 % 4) once a layer on all 10, on the lead; the prefill logits
    within TOL_SSM of the unsharded either way."""
    s = fam(HYMBA)
    cfg = s["cfg"]
    assert ssm.head_split(cfg, m_size) == heads
    calls = []
    real = ssd.ssd_fused

    def counted(xd, *args, **kw):
        calls.append(xd.shape[2])
        return real(xd, *args, **kw)
    monkeypatch.setattr(ssd, "ssd_fused", counted)
    mesh = _cpu_mesh((1, m_size))
    placed = sharding.place_params(s["tp"], cfg, mesh)
    caches = M.init_caches(cfg, 4, CACHE_LEN, dtype=torch.float32, mesh=mesh)
    got, _ = M.prefill(placed, cfg, {"tokens": s["prompts"]}, caches, mesh=mesh)
    if heads is None:
        assert calls == [cfg.n_ssm_heads] * cfg.n_layers
    else:
        assert calls == [heads] * (cfg.n_layers * m_size)
    _close(got, _unsharded(s)[0][0], TOL_SSM)


def test_vision_ring_positions_the_rule_splits_over_data(fam):
    """At a cache length of d_model the reference's cache rule takes
    vision's (G, every, C) ring positions for a context and splits their
    group axis over ``data``: each device runs with the whole positions
    (gathered) and gets back its block; prefill and decode logits and
    every cache leaf within 1e-10 of the port unsharded."""
    s = fam(VISION)
    cfg, mesh = s["cfg"], _cpu_mesh((2, 2))
    lm = _as(s["tp"], torch.float64)
    caches = M.init_caches(cfg, 4, cfg.d_model, dtype=torch.float64, mesh=mesh)
    assert caches["layers"].kv.pos.spec[0] == "data"
    want, want_c = _drive(lm, cfg, s["prompts"], s["ctx"], torch.float64,
                          cache_len=cfg.d_model)
    got, got_c = _drive(sharding.place_params(lm, cfg, mesh), cfg, s["prompts"],
                        s["ctx"], torch.float64, mesh, cache_len=cfg.d_model)
    for g, w in zip(got, want):
        _close(g, w, TOL64)
    for g, w in zip(_cache_leaves(got_c), _cache_leaves(want_c)):
        _close(g.full(), w, TOL64)
    assert got_c["layers"].kv.pos.spec[0] == "data"


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------


def _train_batch(cfg, b=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
    labels[:, -1] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32),
             "labels": labels}
    ctx = _ctx(cfg, b, seed=seed + 1)
    if ctx is not None:
        batch["ctx_embeds"] = ctx
    return batch


def _ref_leaf(tree, name):
    keys, idx = convert.reference_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree)[idx] if idx else np.asarray(tree)


def _rel(a, b, floor: float = 1e-30) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor)


def _blocks_agree(x: sharding.Sharded) -> bool:
    return all(torch.equal(x.pieces[g[0]], x.pieces[c])
               for g in sharding.groups(x) for c in g)


@pytest.fixture(scope="module")
def stepped(fam):
    """``stepped(arch)``: a train batch (with ``ctx_embeds`` for vision
    and the enc-dec), the reference's loss, gradients and their global
    norm under ``jax.jit``, and the port's unsharded gradients (float64;
    hymba float32), their norm and the parameters AdamW makes of them."""
    built = {}

    def get(arch):
        if arch not in built:
            s = fam(arch)
            cfg, ref_cfg = s["cfg"], s["ref_cfg"]
            batch = _train_batch(cfg)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            jp = jax.tree_util.tree_map(jnp.asarray, s["tree"])

            def ref_loss(params):
                logits, _ = RM.forward(params, ref_cfg, jb, dtype=jnp.float32)
                return ref_layers.softmax_cross_entropy(logits, jb["labels"])[0]
            loss, grads = jax.jit(jax.value_and_grad(ref_loss))(jp)
            dt = _dtype(cfg)
            tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None, dtype=dt)
            lm = params_from_reference(s["tree"], cfg, "cpu", trainable=True).to(dt)
            g_one, _, _ = loss_and_grads(lm, cfg, tc, batch)
            named = {k: p.detach().clone() for k, p in lm.named_parameters()}
            om = adamw_update(g_one, adamw_init(named), named, tc.optimizer,
                              decay=decay_mask(named))[2]
            built[arch] = dict(
                cfg=cfg, tree=s["tree"], batch=batch, dt=dt, tc=tc,
                ref_loss=float(loss), ref_norm=float(ref_global_norm(grads)),
                ref_grads=jax.tree_util.tree_map(np.asarray, grads),
                grads=g_one, norm=float(om["grad_norm"]), params=named)
        return built[arch]
    return get


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_step_matches_reference_and_unsharded(stepped, arch, shape):
    """``loss_and_grads`` on a mesh, the batch's ``ctx_embeds`` split over
    the data replicas with its tokens: float32 loss, gradients (``ctx_proj``
    and the encoder's among them) and grad norm against the reference's
    ``value_and_grad``; in the unsharded run's dtype the gradients and
    their norm against the port unsharded; AdamW on the mesh's ZeRO-1
    blocks given the unsharded gradients against the unsharded update,
    every block's pieces equal after it."""
    s = stepped(arch)
    cfg, mesh = s["cfg"], _cpu_mesh(shape)
    tc32 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    placed = sharding.place_params(params_from_reference(
        s["tree"], cfg, "cpu", trainable=True), cfg, mesh)
    grads, loss, _ = loss_and_grads(placed, cfg, tc32, s["batch"])
    assert float(loss) == pytest.approx(s["ref_loss"], rel=LOSS_RTOL)
    for k, g in grads.items():
        want = _ref_leaf(s["ref_grads"], k)
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.full().numpy(), want, rtol=0, atol=tol,
                                   err_msg=k)
    assert float(global_norm(grads)) == pytest.approx(s["ref_norm"], rel=LOSS_RTOL)

    lm = params_from_reference(s["tree"], cfg, "cpu", trainable=True).to(s["dt"])
    placed = sharding.place_params(lm, cfg, mesh)
    grads, _, _ = loss_and_grads(placed, cfg, s["tc"], s["batch"])
    tol = TOL_SSM if cfg.hybrid else TOL64 if shape[0] == 1 else TOL_DATA
    for k, g in grads.items():
        assert _rel(g.full(), s["grads"][k]) <= tol, k
    assert float(global_norm(grads)) == pytest.approx(s["norm"], rel=LOSS_RTOL)
    state = init_train_state(None, cfg, s["tc"], params=placed)
    grads = {k: sharding.place(s["grads"][k], state.opt["m"][k].spec, mesh)
             for k in s["grads"]}
    adamw_update(grads, state.opt, placed, s["tc"].optimizer)
    for k, leaf in placed.items():
        assert _rel(leaf.full(), s["params"][k]) <= PARAM_TOL, k
        assert _blocks_agree(leaf), k


@pytest.mark.parametrize("arch", [VISION, SEAMLESS])
def test_remat_on_a_mesh_keeps_the_context_gradient(stepped, arch):
    """``remat`` "full" and "dots" around each placed block hand the
    context (each device's copy) to the recompute as an input: the
    gradients of ``ctx_proj`` and of the encoder (which reach the loss
    only through the cross blocks' context) equal those without remat."""
    s = stepped(arch)
    cfg, mesh = s["cfg"], _cpu_mesh((2, 2))
    placed = sharding.place_params(params_from_reference(
        s["tree"], cfg, "cpu", trainable=True).double(), cfg, mesh)
    base, _, _ = loss_and_grads(placed, cfg, s["tc"], s["batch"])
    ctx_side = [k for k in base if k.startswith(("ctx_proj", "encoder", "enc_norm"))]
    assert ctx_side and all(float(base[k].full().abs().max()) > 0 for k in ctx_side)
    for remat in ("full", "dots"):
        tc = TrainConfig(remat=remat, dtype=torch.float64)
        got, _, _ = loss_and_grads(placed, cfg, tc, s["batch"])
        for k in base:
            assert _rel(got[k].full(), base[k].full()) <= 1e-12, (remat, k)


def _hymba_loop(tmp_path, name, mesh, steps=2, **kw):
    cfg = _cfgs(HYMBA)[1]
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), remat=None)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT, global_batch=4)
    lc = TrainLoopConfig(total_steps=steps, ckpt_every=2, log_every=100,
                         ckpt_dir=None if tmp_path is None else str(tmp_path / name))
    return train_loop(cfg, tc, dc, lc, mesh=mesh, device="cpu",
                      log=lambda s: None, **kw)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_train_loop_trains_hymba_on_a_mesh(shape):
    """``train_loop(mesh=)`` on hymba (state born sharded, B8's plain
    version a head shard): its first step's loss and grad norm those of
    the unsharded loop from the same seed."""
    mesh, dt = _cpu_mesh(shape), torch.float32
    state, hist = _hymba_loop(None, "", mesh, steps=1)
    one, want = _hymba_loop(None, "", None, steps=1)
    assert isinstance(state.params, sharding.PlacedParams)
    assert state.params.mesh == mesh and state.step == one.step == 1
    assert hist[0]["loss"] == pytest.approx(want[0]["loss"], rel=LOSS_RTOL)
    assert hist[0]["grad_norm"] == pytest.approx(want[0]["grad_norm"],
                                                 rel=LOSS_RTOL)
    assert all(leaf.dtype == dt for _, leaf in state.params.items())


def test_hymba_checkpoint_restores_across_placements(tmp_path):
    """A hymba state checkpointed on a (2, 2) mesh restores on one device
    (an unsharded loop asked for as many steps ends where it starts)
    equal to the mesh's parameters and moments; a one-device checkpoint
    restores on a (1, 4) mesh, equal, every block's pieces agreeing."""
    whole, hist = _hymba_loop(tmp_path, "mesh", _cpu_mesh((2, 2)))
    assert [h["step"] for h in hist] == [0, 1]
    one, hist = _hymba_loop(tmp_path, "mesh", None)
    assert hist == [] and one.step == 2
    for k, p in one.params.named_parameters():
        assert torch.equal(p.detach(), whole.params[k].full()), k
        assert torch.equal(one.opt["v"][k], whole.opt["v"][k].full()), k
    ref_one, _ = _hymba_loop(tmp_path, "one", None)
    back, hist = _hymba_loop(tmp_path, "one", _cpu_mesh((1, 4)))
    assert hist == []
    for k, p in ref_one.params.named_parameters():
        assert torch.equal(back.params[k].full(), p.detach()), k
        assert _blocks_agree(back.params[k]) and _blocks_agree(back.opt["m"][k])
