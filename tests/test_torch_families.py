"""Parity of the port's last three LM families with the JAX reference: the
hybrid (hymba-1.5b: block kind ``"hybrid"``, attention and a mamba2 mixer
in parallel), the vision stack (llama-3.2-vision-11b: groups of self
blocks, each followed by a cross block over the projected patch
embeddings) and the encoder-decoder (seamless-m4t-medium: a bidirectional
encoder over stub frames, decoder layers of self- and cross-attention).
Reduced configs, the reference's weights moved over by
``repro_torch.models.convert.params_from_reference``.

Both packages run on the CPU in float32 (the reference with x64 on, as
every test here runs it); the port's kernels B8 / B9 take their plain
versions there.  Tolerances, as ``tests/test_torch_attention.py``'s:

* attention and block outputs, caches and logits: ``LOGIT_TOL`` x max(1,
  max|reference|);
* greedy tokens: equal at every position where the reference's top-2
  logit margin exceeds that tolerance (closer margins are reported and
  end the row's check).

The reference's batcher guesses each cache leaf's batch axis from its
shape (``repro/serve/batcher.py::_splice_caches``); at the reduced vision
config's ``every = 1`` the vision KV leaves (G, 1, B, C, Hkv, dh) make it
write along the ``every`` axis.  The port writes each field by name, so
its vision batcher is held to the reference's engine run per request
there, and to the reference's batcher at ``every = 2``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.kernels.ssd import ssd_fused as ref_ssd_fused
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import model as RM
from repro.serve import Batcher as RefBatcher
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.kernels import ssd
from repro_torch.launch import serve as cli
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine

LOGIT_TOL = 1e-5
HYMBA, VISION, SEAMLESS = "hymba-1.5b", "llama-3.2-vision-11b", "seamless-m4t-medium"
FAMILIES = (HYMBA, VISION, SEAMLESS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    tol = LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)


def _cfgs(arch, every=None):
    """The reduced config in both packages; ``every`` replaces the vision
    stack's group size."""
    out = []
    for c in (ref_configs.reduced_config(arch), configs.reduced_config(arch)):
        if every is not None:
            c = dataclasses.replace(c, cross_attn=dataclasses.replace(
                c.cross_attn, every=every))
        out.append(c)
    return tuple(out)


def _pair(arch, every=None):
    cfg, tcfg = _cfgs(arch, every)
    jp = RM.init_params(jax.random.PRNGKey(1), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jp, tcfg, params_from_reference(tree, tcfg, "cpu"), tree


def _jitted(cfg):
    """The reference's forward, prefill and decode step at ``cfg``, each
    under ``jax.jit`` (the same operations, compiled once per shape:
    eager JAX dispatches every small op of the per-token recurrence)."""
    return (jax.jit(lambda p, b: RM.forward(p, cfg, b)),
            jax.jit(lambda p, b, c: RM.prefill(p, cfg, b, c)),
            jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c)))


@pytest.fixture(scope="module")
def lms():
    """``lms(arch)``: the reduced arch's (cfg, params) in both packages and
    the reference's numpy tree, built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _pair(arch)
        return built[arch]

    return get


def _ctx(cfg, b, seed=0):
    """The stub frontend's output for a batch of ``b``: vision patch
    embeddings (b, T, d_ctx), enc-dec frames (b, T, d_model); None for the
    families without one."""
    rng = np.random.default_rng(seed)
    if cfg.encdec is not None:
        shape = (b, cfg.encdec.n_ctx_tokens, cfg.d_model)
    elif cfg.cross_attn is not None:
        shape = (b, cfg.cross_attn.n_ctx_tokens,
                 cfg.cross_attn.d_ctx or cfg.d_model)
    else:
        return None
    return rng.standard_normal(shape).astype(np.float32)


def _batch(toks, ctx):
    batch = {"tokens": toks}
    if ctx is not None:
        batch["ctx_embeds"] = ctx
    return batch


def _leaves(tree) -> list:
    """The tensors of a port cache dict (entries by name, fields in order)."""
    out = []
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            out += [a for part in v if part is not None for a in part]
    return out


def _ref_leaves(tree) -> list:
    out = []
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, tuple):
            out += [a for part in v if part is not None for a in part]
        else:
            out.append(v)
    return out


def _close_caches(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    g, w = _leaves(got), _ref_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        if a.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)


# ---------------------------------------------------------------------------
# Cross-attention and the hybrid / cross block kinds
# ---------------------------------------------------------------------------


def _attn_pair(cfg, seed, d_ctx):
    """One cross-attention layer's parameters in both packages; the
    optional leaves (biases, qk norms) drawn at random so they count."""
    ref_p = ref_attn.init_attn_params(jax.random.PRNGKey(seed), cfg, d_ctx=d_ctx)
    rng = np.random.default_rng(seed)
    tree = {k: (np.asarray(v) if k.startswith("w")
                else rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in ref_p.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            attn.Attention({k: torch.from_numpy(v.copy()) for k, v in tree.items()}))


@pytest.mark.parametrize("arch,d_ctx", [
    (VISION, 1280),               # GQA: 4 query heads over 1 kv head
    (SEAMLESS, 64),               # MHA, the context at d_model
    ("qwen2-1.5b", 48),           # QKV biases
    ("qwen3-14b", 24),            # qk norms
])
def test_cross_attention_matches_reference(arch, d_ctx):
    """``attention(ctx=)`` against the reference's: k / v projected from a
    context of another length (T = 7 against S = 5) and width, no rope,
    no mask; no cache returned, and a cache handed in is not read."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _attn_pair(cfg, 3, d_ctx)
    assert tuple(tp.wk.shape) == (d_ctx, cfg.n_kv_heads * cfg.d_head)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, d_ctx)).astype(np.float32)
    want, none = ref_attn.attention(jp, cfg, jnp.asarray(x), ctx=jnp.asarray(ctx))
    got, nothing = attn.attention(tp, tcfg, torch.from_numpy(x),
                                  ctx=torch.from_numpy(ctx))
    assert none is None and nothing is None
    _close(got, want)
    cache = attn.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    again, nothing = attn.attention(tp, tcfg, torch.from_numpy(x),
                                    ctx=torch.from_numpy(ctx), cache=cache)
    assert nothing is None and torch.equal(again, got)


def _block_pair(arch, kind, seed, d_ctx=0):
    """One block of ``kind`` at the reduced arch's widths: the reference's
    parameters, the port's config and the block moved over (as the one
    block of a plain stack)."""
    cfg, tcfg = _cfgs(arch)
    ref_p = ref_blocks.init_block_params(jax.random.PRNGKey(seed), cfg, kind,
                                         d_ctx=d_ctx)
    stacked = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], ref_p)
    tree = {"tok_embed": np.zeros((cfg.vocab_size, cfg.d_model), np.float32),
            "final_norm": np.ones((cfg.d_model,), np.float32),
            "blocks": stacked}
    plain = dataclasses.replace(tcfg, n_layers=1, cross_attn=None, encdec=None)
    return cfg, ref_p, tcfg, params_from_reference(tree, plain, "cpu").blocks[0]


@pytest.mark.parametrize("length", [16, 13])
def test_hybrid_block_matches_reference(length):
    """Kind ``"hybrid"``: ``x + (attention + mamba2) / 2`` from one shared
    ``ln1``, then the MLP: without caches, then a prefill of ``length``
    (16: two chunks, B8's path; 13: the recurrence) and a decode step,
    the KV cache and the SSM state after each."""
    cfg, jp, tcfg, tp = _block_pair(HYMBA, "hybrid", 5)
    assert tp.attn is not None and tp.ssm is not None and tp.mlp is not None
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, x, kv=None, st=None: ref_blocks.block_forward(
        p, cfg, "hybrid", x, kv=kv, ssm_state=st))
    want, kv, st, aux = ref(jp, jnp.asarray(x))
    got, tkv, tst, taux = blocks.block_forward(tp, tcfg, "hybrid", torch.from_numpy(x))
    assert kv is st is tkv is tst is None and float(taux) == float(aux) == 0.0
    _close(got, want)
    rc = ref_blocks.init_layer_caches(cfg, 1, "hybrid", 2, 32, jnp.float32)
    tc = blocks.init_layer_caches(tcfg, 1, "hybrid", 2, 32, torch.float32,
                                  device="cpu")
    kv, st = jax.tree_util.tree_map(lambda a: a[0], (rc.kv, rc.ssm))
    tkv, tst = blocks.layer_of(tc.kv, 0), blocks.layer_of(tc.ssm, 0)
    for s in (length, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        want, kv, st, _ = ref(jp, jnp.asarray(x), kv, st)
        got, tkv, tst, _ = blocks.block_forward(tp, tcfg, "hybrid",
                                                torch.from_numpy(x), kv=tkv,
                                                ssm_state=tst)
        _close(got, want)
        for a, b in zip(tuple(tkv) + tuple(tst), tuple(kv) + tuple(st)):
            assert tuple(a.shape) == tuple(b.shape)
            if a.dtype == torch.int32:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _close(a, b)


@pytest.mark.parametrize("arch,d_ctx", [(VISION, 0), (SEAMLESS, 0), (VISION, 40)])
def test_cross_block_matches_reference(arch, d_ctx):
    """Kind ``"cross"``: ln -> cross-attention over ``ctx`` -> ln -> MLP,
    no caches; ``d_ctx`` 0 takes the context at d_model."""
    cfg, jp, tcfg, tp = _block_pair(arch, "cross", 7, d_ctx=d_ctx)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, d_ctx or cfg.d_model)).astype(np.float32)
    want, kv, st, _ = ref_blocks.block_forward(jp, cfg, "cross", jnp.asarray(x),
                                               ctx=jnp.asarray(ctx))
    got, tkv, tst, _ = blocks.block_forward(tp, tcfg, "cross", torch.from_numpy(x),
                                            ctx=torch.from_numpy(ctx))
    assert kv is st is tkv is tst is None
    _close(got, want)


def test_block_kinds_init_their_reference_leaves():
    """Each kind's parameters by name and shape as the reference's (a
    dense block with ``d_ff = 0`` has no ``ln2`` / MLP), its caches'
    fields as the reference's, and an unknown kind refused."""
    cfg, tcfg = _cfgs(HYMBA)
    gen = M.make_generator(0, "cpu")
    for kind, c, tc in (("hybrid", cfg, tcfg), ("cross", cfg, tcfg),
                        ("dense", dataclasses.replace(cfg, d_ff=0),
                         dataclasses.replace(tcfg, d_ff=0))):
        want = jax.tree_util.tree_leaves_with_path(
            ref_blocks.init_block_params(jax.random.PRNGKey(0), c, kind))
        want = {".".join(str(getattr(k, "key", k)) for k in path): np.shape(v)
                for path, v in want}
        got = {n: tuple(p.shape) for n, p in
               blocks.init_block_params(gen, tc, kind).named_parameters()}
        assert got == want, kind
        rc = ref_blocks.init_layer_caches(c, 3, kind, 2, 8, jnp.float32)
        cc = blocks.init_layer_caches(tc, 3, kind, 2, 8, torch.float32,
                                      device="cpu")
        for field in ("kv", "ssm"):
            r, t = getattr(rc, field), getattr(cc, field)
            assert (r is None) == (t is None), (kind, field)
            if r is not None:
                assert [tuple(a.shape) for a in t] == [a.shape for a in r]
    for fn in (lambda: blocks.init_block_params(gen, tcfg, "mixture"),
               lambda: blocks.init_layer_caches(tcfg, 1, "mixture", 1, 8,
                                                device="cpu")):
        with pytest.raises(ValueError, match="unknown block kind 'mixture'"):
            fn()


# ---------------------------------------------------------------------------
# The three LMs: parameters, caches, forward, prefill, decode
# ---------------------------------------------------------------------------


def _ref_path_leaves(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_copies_every_leaf(lms, arch):
    """Every port parameter equals its slice of the reference's leaf (its
    name's numbers are the leaf's stacking indices, group then layer), the
    two hold as many numbers, nothing needs a gradient, a fresh init has
    the same names and shapes, and a wrong layer count is refused."""
    cfg, _, tcfg, tp, tree = lms(arch)
    leaves = _ref_path_leaves(tree)
    n = 0
    for name, p in tp.named_parameters():
        parts = name.split(".")
        path = tuple(x for x in parts if not x.isdigit())
        idx = tuple(int(x) for x in parts if x.isdigit())
        assert torch.equal(p, torch.from_numpy(leaves[path][idx].copy())), name
        n += p.numel()
        assert not p.requires_grad
    assert n == sum(a.size for a in leaves.values())
    fresh = M.init_params(M.make_generator(0, "cpu"), tcfg)
    assert {k: tuple(p.shape) for k, p in fresh.named_parameters()} == \
        {k: tuple(p.shape) for k, p in tp.named_parameters()}
    with pytest.raises(ValueError, match="the tree stacks"):
        params_from_reference(tree, dataclasses.replace(tcfg, n_layers=8), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_zero_caches_match_reference(arch, dtype):
    """``init_caches``: the reference's entries, each leaf's shape, dtype
    and value (zeros, pos -1, length 0); vision's KV leaves carry two
    leading axes (G, every)."""
    cfg, tcfg = _cfgs(arch)
    want = RM.init_caches(cfg, 3, 20, getattr(jnp, dtype))
    got = M.init_caches(tcfg, 3, 20, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want)
    for a, b in zip(_leaves(got), _ref_leaves(want)):
        assert a.device.type == "cpu"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b).astype(np.float32))
    if arch == VISION:
        every = cfg.cross_attn.every
        assert tuple(got["layers"].kv.k.shape[:3]) == (cfg.n_layers // every,
                                                       every, 3)


@pytest.mark.parametrize("arch,length", [
    (HYMBA, 16), (HYMBA, 13), (HYMBA, 24),
    (VISION, 16), (VISION, 13), (SEAMLESS, 16), (SEAMLESS, 13)])
def test_forward_prefill_and_decode_logits_match_reference(lms, arch, length):
    """Forward, then a prefill (``ctx_embeds`` for vision and the enc-dec;
    the second as a tensor) and three decode steps reading the context
    back from the caches: logits and every cache leaf.  hymba: a chunk
    multiple (B8's path), a ragged prompt, and 24 tokens past its window
    of 16 (the ring's tail re-laid by slot, then overwritten)."""
    cfg, jp, tcfg, tp, _ = lms(arch)
    rng = np.random.default_rng(length)
    toks = rng.integers(0, cfg.vocab_size, (2, length)).astype(np.int32)
    ctx = _ctx(cfg, 2, seed=length)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(toks, ctx).items()}
    fwd, pre, step = _jitted(cfg)
    lj, aux = fwd(jp, jbatch)
    lt, aux_t = M.forward(tp, tcfg, _batch(toks, ctx))
    _close(lt, lj)
    assert float(aux_t) == float(aux) == 0.0
    cj = RM.init_caches(cfg, 2, 64, dtype=jnp.float32)
    ct = M.init_caches(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    lj, cj = pre(jp, jbatch, cj)
    lt, ct = M.prefill(tp, tcfg, _batch(toks, torch.from_numpy(ctx)
                                        if ctx is not None else None), ct)
    _close(lt, lj)
    _close_caches(ct, cj)
    tok = toks[:, -1:]
    for _ in range(3):
        lj, cj = step(jp, jnp.asarray(tok), cj)
        lt, ct = M.decode_step(tp, tcfg, tok, ct)
        _close(lt, lj)
        _close_caches(ct, cj)
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    if cfg.hybrid and length > cfg.sliding_window:
        assert ct["layers"].kv.k.shape[2] == cfg.sliding_window
        assert int(ct["layers"].kv.pos.min()) == length + 3 - cfg.sliding_window


def test_forward_without_context_or_caches_is_refused():
    """A vision or enc-dec forward needs ``ctx_embeds`` or caches holding
    a context (the reference would index None)."""
    for arch in (VISION, SEAMLESS):
        tcfg = configs.reduced_config(arch)
        tp = M.init_params(M.make_generator(0, "cpu"), tcfg)
        with pytest.raises(ValueError, match="ctx_embeds"):
            M.forward(tp, tcfg, {"tokens": np.zeros((1, 4), np.int32)})


# ---------------------------------------------------------------------------
# Engine, batcher, CLI
# ---------------------------------------------------------------------------


def _reference_steps(cfg, jp, prompts, n_new, ctx=None):
    """The reference's greedy tokens and, per position, its top-2 margin."""
    _, pre, step = _jitted(cfg)
    caches = RM.init_caches(cfg, prompts.shape[0], 64, dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in _batch(prompts, ctx).items()}
    logits, caches = pre(jp, batch, caches)
    last = logits[:, -1]
    toks, margins = [], []
    for i in range(n_new):
        top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
        toks.append(tok)
        if i + 1 < n_new:
            last, caches = step(jp, jnp.asarray(tok[:, None]), caches)
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_greedy_tokens_match_reference(lms, arch):
    """``generate(prompts, extras={"ctx_embeds": ...})`` in both packages
    (hymba: no extras), against the reference's own greedy steps."""
    cfg, jp, tcfg, tp, _ = lms(arch)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                (3, 16)).astype(np.int32)
    ctx = _ctx(cfg, 3, seed=5)
    extras = None if ctx is None else {"ctx_embeds": ctx}
    want, margins, scale = _reference_steps(cfg, jp, prompts, 6, ctx)
    ref = RefEngine(cfg, jp, RefGenerationConfig(max_new_tokens=6, cache_len=64)) \
        .generate(prompts, extras=None if ctx is None
                  else {"ctx_embeds": jnp.asarray(ctx)})
    np.testing.assert_array_equal(ref, want)
    got = ServeEngine(tcfg, tp, GenerationConfig(max_new_tokens=6, cache_len=64)) \
        .generate(prompts, extras=extras)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    _assert_tokens_agree(got, want, margins, scale, "engine")


def _serve(batcher_cls, request_cls, cfg, params, gcfg, prompts, n_new=4):
    b = batcher_cls(cfg, params, n_slots=2, gcfg=gcfg)
    for i, pr in enumerate(prompts):
        b.submit(request_cls(rid=i, prompt=pr, max_new_tokens=n_new))
    return {r.rid: r.generated for r in b.run()}


def _batcher_case(cfg, jp, tcfg, tp, n_req=4, length=16):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (length,)).astype(np.int32)
               for _ in range(n_req)]
    got = _serve(Batcher, Request, tcfg, tp, GenerationConfig(cache_len=64),
                 prompts)
    # each request alone, as the reference's engine decodes it: against the
    # caches' zero context, as the batcher (no ctx_embeds) does
    own, margins, scale = _reference_steps(cfg, jp, np.stack(prompts), 4)
    assert sorted(got) == list(range(n_req))
    return prompts, got, own, margins, scale


@pytest.mark.parametrize("arch", [HYMBA, SEAMLESS])
def test_batcher_greedy_tokens_match_reference(lms, arch):
    """Four requests of one prompt length through two slots (hymba's 16
    tokens: B8's path in each admission): the batcher's tokens against
    the reference batcher's, both against each prompt's own greedy
    continuation (the enc-dec against zero memory, as neither batcher
    passes ``ctx_embeds``)."""
    cfg, jp, tcfg, tp, _ = lms(arch)
    prompts, got, own, margins, scale = _batcher_case(cfg, jp, tcfg, tp)
    want = _serve(RefBatcher, RefRequest, cfg, jp,
                  RefGenerationConfig(cache_len=64), prompts)
    for rid in range(len(prompts)):
        _assert_tokens_agree(np.asarray([got[rid]]), np.asarray([want[rid]]),
                             margins[rid:rid + 1], scale, f"batcher {rid}")
        _assert_tokens_agree(np.asarray([got[rid]]), own[rid:rid + 1],
                             margins[rid:rid + 1], scale, f"own {rid}")


@pytest.mark.parametrize("every", [1, 2])
def test_vision_batcher_tokens_match_the_reference_per_request(lms, every):
    """The vision batcher decodes each request against the zero context,
    as the reference does.  At ``every = 1`` (the reduced config) the
    reference's batcher splices the KV leaves along the wrong axis, so the
    port is held to the reference's engine run request by request; at
    ``every = 2`` the splice guesses right and the port equals both."""
    if every == 1:
        cfg, jp, tcfg, tp, _ = lms(VISION)
    else:
        cfg, jp, tcfg, tp, _ = _pair(VISION, every=every)
    assert len(tp.self_blocks[0]) == every
    prompts, got, own, margins, scale = _batcher_case(cfg, jp, tcfg, tp)
    want = None
    if every != 1:
        want = _serve(RefBatcher, RefRequest, cfg, jp,
                      RefGenerationConfig(cache_len=64), prompts)
    for rid in range(len(prompts)):
        _assert_tokens_agree(np.asarray([got[rid]]), own[rid:rid + 1],
                             margins[rid:rid + 1], scale, f"own {rid}")
        if want is not None:
            _assert_tokens_agree(np.asarray([got[rid]]), np.asarray([want[rid]]),
                                 margins[rid:rid + 1], scale, f"batcher {rid}")


def test_batcher_writes_each_slot_row_by_name():
    """After a wave of admissions each slot holds its own prefill's rows:
    hymba's k / v on axis 1 and its SSM state, vision's k / v on axis 2 of
    (G, every, B, ...), the enc-dec's zero memory; pos and length shared."""
    for arch in FAMILIES:
        tcfg = configs.reduced_config(arch)
        tp = M.init_params(M.make_generator(0, "cpu"), tcfg)
        rng = np.random.default_rng(7)
        b = Batcher(tcfg, tp, n_slots=2, gcfg=GenerationConfig(cache_len=32))
        prompts = [rng.integers(0, tcfg.vocab_size, (9,)).astype(np.int32)
                   for _ in range(2)]
        for i, pr in enumerate(prompts):
            b.submit(Request(rid=i, prompt=pr, max_new_tokens=2))
        b.step()
        kv = b.caches["layers"].kv
        axis = kv.pos.dim() - 1
        assert axis == (2 if arch == VISION else 1)
        assert (kv.length == 10).all()
        for slot, pr in enumerate(prompts):
            one = M.init_caches(tcfg, 1, 32, dtype=torch.float32, device="cpu")
            _, one = M.prefill(tp, tcfg, {"tokens": pr[None]}, one)
            one_kv = one["layers"].kv
            got = kv.k.select(axis, slot).narrow(axis, 0, 9)
            assert torch.equal(got, one_kv.k.select(axis, 0).narrow(axis, 0, 9))
        for name in ("ctx", "memory"):
            if name in b.caches:
                assert not b.caches[name].any()


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_serves_reduced_families_on_the_cpu(arch, capsys):
    cli.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots",
              "2", "--prompt-len", "16", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: 3 requests, 12 tokens" in out
    assert out.count("  req ") == 3


# ---------------------------------------------------------------------------
# B8's decomposition at hymba's widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunk_parallel_model_at_hymba_widths(init):
    """B8's chunk-parallel decomposition at hymba's (h 50, p 64, n 16 —
    below B8's 32-row k step and 64-wide tiles —, chunk 256) over two
    chunks, against the reference's kernel in interpret mode (zero state)
    and the plain chunk loop (a random one), in fp32 at the reference's
    2e-4."""
    cfg = configs.get_config(HYMBA)
    s = cfg.ssm
    h, p, n, g, q = cfg.n_ssm_heads, s.head_dim, s.d_state, s.n_groups, s.chunk
    assert (h, p, n, g, q) == (50, 64, 16, 1, 256)
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal((1, 2 * q, h, p)).astype(np.float32),
            (-np.abs(rng.standard_normal((1, 2 * q, h))) * 0.3).astype(np.float32),
            rng.standard_normal((1, 2 * q, g, n)).astype(np.float32),
            rng.standard_normal((1, 2 * q, g, n)).astype(np.float32)]
    tens = [torch.from_numpy(a) for a in arrs]
    if init:
        s0 = torch.from_numpy(rng.standard_normal((1, h, p, n)).astype(np.float32))
        want = ssd.ssd_fused_ref(*tens, chunk=q, init_state=s0)
    else:
        s0 = None
        want = ref_ssd_fused(*(jnp.asarray(a) for a in arrs), chunk=q)
    got = ssd.ssd_chunk_parallel_model(*tens, chunk=q, init_state=s0)
    for a, b in zip(got, want):
        b = np.asarray(b)
        tol = 2e-4 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=tol)
