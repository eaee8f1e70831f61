"""Parity of the port's attention family (``repro_torch.models.attention``,
the ``"dense"`` block kind, the dense LMs through ``repro_torch.serve``)
with the JAX reference, on the reduced configs of the four dense archs
with the reference's weights moved over by
``repro_torch.models.convert.params_from_reference``.

Both packages run on the CPU in float32 (the reference with x64 on, as
every test here runs it; its parameters and activations are float32 all
the same); the port's token embedding takes kernel B9's plain version
there.  Tolerances, as ``tests/test_torch_lm.py``'s:

* attention outputs, caches and logits: ``LOGIT_TOL`` x max(1,
  max|reference|) (1e-5: float32 rounding in another summation order;
  the largest difference seen is ~1e-6 relative);
* greedy tokens: equal at every position where the reference's top-2
  logit margin exceeds that tolerance (a closer margin could flip the
  argmax without a fault; such positions are reported and end the row's
  check).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import layers as ref_layers
from repro.models import model as RM
from repro.serve import Batcher as RefBatcher
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.launch import serve as cli
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine

LOGIT_TOL = 1e-5
DENSE = ("llama3.2-3b", "qwen2-1.5b", "qwen3-14b", "minicpm-2b")


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


@pytest.fixture(scope="module", params=DENSE)
def lm(request):
    arch = request.param
    cfg = ref_configs.reduced_config(arch)
    jp = RM.init_params(jax.random.PRNGKey(2), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = configs.reduced_config(arch)
    return cfg, jp, tcfg, params_from_reference(tree, tcfg, "cpu"), tree


# ---------------------------------------------------------------------------
# Layers: rope, SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0])
def test_rope_and_swiglu_match_reference(theta):
    rng = np.random.default_rng(1)
    pos = np.arange(37, dtype=np.int32)[None, :] + 1000
    cj, sj = ref_layers.rope_freqs(64, theta, jnp.asarray(pos))
    ct, st = layers.rope_freqs(64, theta, torch.from_numpy(pos))
    assert ct.dtype == torch.float32 and tuple(ct.shape) == (1, 37, 32)
    _close(ct, cj)
    _close(st, sj)
    x = rng.standard_normal((2, 37, 3, 64)).astype(np.float32)
    _close(layers.apply_rope(torch.from_numpy(x), ct, st),
           ref_layers.apply_rope(jnp.asarray(x), cj, sj))
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((16, 24), (16, 24), (24, 16))]
    _close(layers.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w)),
           ref_layers.swiglu(jnp.asarray(h), *map(jnp.asarray, w)))


# ---------------------------------------------------------------------------
# The attention module: no cache, cache, ring wrap
# ---------------------------------------------------------------------------


def _attn_pair(cfg, seed):
    """One attention layer's parameters in both packages, the optional
    leaves (biases, qk norms) drawn at random so they count."""
    ref_p = ref_attn.init_attn_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    tree = {k: (np.asarray(v) if k.startswith("w")
                else rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in ref_p.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            attn.Attention({k: torch.from_numpy(v.copy()) for k, v in tree.items()}))


def _cfgs(arch, window=None):
    cfg, tcfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    return cfg, tcfg


def _close_cache(got: attn.KVCache, want) -> None:
    _close(got.k, want.k)
    _close(got.v, want.v)
    assert got.pos.dtype == torch.int32 and got.length.dtype == torch.int32
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_without_cache_matches_reference(arch, causal, window):
    cfg, tcfg = _cfgs(arch, window)
    jp, tp = _attn_pair(cfg, 3)
    x = np.random.default_rng(4).standard_normal((2, 11, cfg.d_model)) \
        .astype(np.float32)
    want, none = ref_attn.attention(jp, cfg, jnp.asarray(x), causal=causal)
    got, nothing = attn.attention(tp, tcfg, torch.from_numpy(x), causal=causal)
    assert none is None and nothing is None
    _close(got, want)


@pytest.mark.parametrize("length", [16, 13])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_cache_path_matches_reference(arch, length):
    """A prompt of ``length`` into an empty cache of 64, then three decode
    steps: outputs and every cache field after each call."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _attn_pair(cfg, 5)
    rng = np.random.default_rng(length)
    cj = ref_attn.init_cache(cfg, 2, 64, dtype=jnp.float32)
    ct = attn.init_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    for s in (length, 1, 1, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        want, cj = ref_attn.attention(jp, cfg, jnp.asarray(x), cache=cj)
        got, ct = attn.attention(tp, tcfg, torch.from_numpy(x), cache=ct)
        _close(got, want)
        _close_cache(ct, cj)


@pytest.mark.parametrize("first", [13, 8, 5])
def test_attention_ring_wrap_matches_reference(first):
    """``sliding_window = 8`` makes a ring of 8 slots: a first block of 13
    (longer than the ring: the tail re-laid by ring slot), of 8 (exactly
    the ring) or of 5, then a block of 6 and decode steps that overwrite
    the oldest slots; the window masks what the ring still holds."""
    cfg, tcfg = _cfgs("llama3.2-3b", window=8)
    jp, tp = _attn_pair(cfg, 6)
    rng = np.random.default_rng(first)
    cj = ref_attn.init_cache(cfg, 2, 64, dtype=jnp.float32)
    ct = attn.init_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    assert ct.k.shape[1] == cj.k.shape[1] == 8
    for s in (first, 6, 1, 1, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        want, cj = ref_attn.attention(jp, cfg, jnp.asarray(x), cache=cj)
        got, ct = attn.attention(tp, tcfg, torch.from_numpy(x), cache=ct)
        _close(got, want)
        _close_cache(ct, cj)


def test_cache_append_relays_a_long_block_by_ring_slot():
    """The ``s >= cap`` branch on its own, from a cache already holding
    3 tokens: the last ``cap`` positions, each in slot ``pos % cap``."""
    cfg, tcfg = _cfgs("llama3.2-3b", window=8)
    rng = np.random.default_rng(9)
    shape = (1, 11, cfg.n_kv_heads, cfg.d_head)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cj = ref_attn.init_cache(cfg, 1, 64, dtype=jnp.float32)._replace(
        length=jnp.asarray(3, jnp.int32))
    ct = attn.init_cache(tcfg, 1, 64, dtype=torch.float32, device="cpu")._replace(
        length=torch.tensor(3, dtype=torch.int32))
    want = ref_attn.cache_append(cj, jnp.asarray(k), jnp.asarray(v))
    got = attn.cache_append(ct, torch.from_numpy(k), torch.from_numpy(v))
    _close_cache(got, want)
    assert got.pos.tolist() == [8, 9, 10, 11, 12, 13, 6, 7]


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_caches_match_reference(window, dtype):
    """Empty caches: one layer's and the layer-stacked ones of
    ``init_layer_caches`` / ``init_caches``, in shape, dtype, zeros, pos -1
    and length 0."""
    cfg, tcfg = _cfgs("qwen2-1.5b", window)
    one = attn.init_cache(tcfg, 3, 20, getattr(torch, dtype), device="cpu")
    want = ref_attn.init_cache(cfg, 3, 20, getattr(jnp, dtype))
    caches = blocks.init_layer_caches(tcfg, tcfg.n_layers, "dense", 3, 20,
                                      getattr(torch, dtype), device="cpu")
    ref = ref_blocks.init_layer_caches(cfg, cfg.n_layers, "dense", 3, 20,
                                       getattr(jnp, dtype))
    whole = M.init_caches(tcfg, 3, 20, getattr(torch, dtype), device="cpu")
    assert caches.ssm is None and ref.ssm is None
    for got_c, want_c in ((one, want), (caches.kv, ref.kv),
                          (whole["layers"].kv, ref.kv)):
        for got, exp in zip(got_c, want_c):
            assert got.device.type == "cpu"
            assert tuple(got.shape) == tuple(exp.shape)
            assert str(got.dtype).removeprefix("torch.") == str(exp.dtype)
        assert not got_c.k.any() and not got_c.v.any() and not got_c.length.any()
        assert (got_c.pos == -1).all()


# ---------------------------------------------------------------------------
# The dense LMs: forward, prefill, decode, engine, batcher
# ---------------------------------------------------------------------------


def test_params_from_reference_copies_every_dense_leaf(lm):
    cfg, _, tcfg, tp, tree = lm
    assert torch.equal(tp.tok_embed, torch.from_numpy(np.array(tree["tok_embed"])))
    assert (tp.lm_head is None) == cfg.tie_embeddings
    if tp.lm_head is not None:
        assert torch.equal(tp.lm_head, torch.from_numpy(np.array(tree["lm_head"])))
    stacked = tree["blocks"]
    for i, block in enumerate(tp.blocks):
        for name in ("ln1", "ln2"):
            assert torch.equal(getattr(block, name),
                               torch.from_numpy(np.array(stacked[name][i])))
        for group, module in (("attn", block.attn), ("mlp", block.mlp)):
            names = {n for n, _ in module.named_parameters()}
            assert names == set(stacked[group])
            for name, arr in stacked[group].items():
                assert torch.equal(getattr(module, name),
                                   torch.from_numpy(np.array(arr[i])))
    assert not any(p.requires_grad for p in tp.parameters())
    fresh = M.init_params(M.make_generator(0, "cpu"), tcfg)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tp.named_parameters()}


@pytest.mark.parametrize("length", [16, 13])
def test_forward_prefill_and_decode_logits_match_reference(lm, length):
    cfg, jp, tcfg, tp, _ = lm
    toks = np.random.default_rng(length).integers(
        0, cfg.vocab_size, (2, length)).astype(np.int32)
    lj, aux = RM.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    lt, aux_t = M.forward(tp, tcfg, {"tokens": toks})
    _close(lt, lj)
    assert float(aux_t) == float(aux) == 0.0
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
        _close_cache(ct["layers"].kv, cj["layers"].kv)
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)


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
    """Five requests of one prompt length through two slots, each admitted
    by a single-row prefill written into its slot, in aligned waves (the
    KV caches' shared length, as in the reference); the batcher's tokens
    against the reference batcher's, both against each prompt's own
    greedy continuation."""
    cfg, jp, tcfg, tp, _ = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (12,)).astype(np.int32)
               for _ in range(5)]

    def serve(batcher_cls, request_cls, c, p, gcfg):
        b = batcher_cls(c, p, n_slots=2, gcfg=gcfg)
        for i, pr in enumerate(prompts):
            b.submit(request_cls(rid=i, prompt=pr, max_new_tokens=4))
        return {r.rid: r.generated for r in b.run()}

    want = serve(RefBatcher, RefRequest, cfg, jp, RefGenerationConfig(cache_len=64))
    got = serve(Batcher, Request, tcfg, tp, GenerationConfig(cache_len=64))
    assert sorted(got) == sorted(want) == list(range(5))
    own, margins, scale = _reference_steps(cfg, jp, np.stack(prompts), 4)
    for rid in range(5):
        _assert_tokens_agree(np.asarray([got[rid]]), np.asarray([want[rid]]),
                             margins[rid:rid + 1], scale, f"batcher {rid}")
        _assert_tokens_agree(np.asarray([got[rid]]), own[rid:rid + 1],
                             margins[rid:rid + 1], scale, f"own {rid}")


def test_batcher_copies_the_shared_kv_length_and_positions(lm):
    """After a wave of admissions the shared KV cache's pos and length are
    the prefill's (every slot shares them, as in the reference), and each
    slot's k / v rows are its own prefill's."""
    _, _, tcfg, tp, _ = lm
    rng = np.random.default_rng(7)
    b = Batcher(tcfg, tp, n_slots=2, gcfg=GenerationConfig(cache_len=32))
    prompts = [rng.integers(0, tcfg.vocab_size, (9,)).astype(np.int32)
               for _ in range(2)]
    for i, pr in enumerate(prompts):
        b.submit(Request(rid=i, prompt=pr, max_new_tokens=1))
    b.step()
    kv = b.caches["layers"].kv
    assert kv.length.tolist() == [10] * tcfg.n_layers     # 9 + one decode step
    assert (kv.pos[:, :10] == torch.arange(10, dtype=torch.int32)).all()
    assert (kv.pos[:, 10:] == -1).all()
    for slot, pr in enumerate(prompts):
        one = M.init_caches(tcfg, 1, 32, dtype=torch.float32, device="cpu")
        _, one = M.prefill(tp, tcfg, {"tokens": pr[None]}, one)
        assert torch.equal(kv.k[:, slot, :9], one["layers"].kv.k[:, 0, :9])


def test_batcher_refuses_an_admission_that_moves_the_shared_kv_length(lm):
    """Prompts of two lengths: the second wave's shorter prompt is
    refused while a slot of the first wave still decodes (its keys would
    move, as the reference's splice moves them silently), and the request
    waits at the head of the queue; once no slot decodes it is admitted,
    and a prompt of the shared length joins a live wave."""
    _, _, tcfg, tp, _ = lm
    rng = np.random.default_rng(9)
    b = Batcher(tcfg, tp, n_slots=2, gcfg=GenerationConfig(cache_len=32))
    long_, short = (rng.integers(0, tcfg.vocab_size, (n,)).astype(np.int32)
                    for n in (9, 6))
    b.submit(Request(rid=0, prompt=long_, max_new_tokens=4))
    b.submit(Request(rid=1, prompt=long_, max_new_tokens=1))
    b.step()                                    # both admitted at length 9
    b.submit(Request(rid=2, prompt=short, max_new_tokens=2))
    with pytest.raises(ValueError, match="shared KV length"):
        b.step()                                # rid 1 done; rid 0 decodes
    assert b.slots[1] is None and b.queue[0].rid == 2
    assert not b.queue[0].generated
    kv = b.caches["layers"].kv
    assert kv.length.tolist() == [10] * tcfg.n_layers   # left as it was
    b.queue.popleft()
    b.submit(Request(rid=3, prompt=rng.integers(
        0, tcfg.vocab_size, (10,)).astype(np.int32), max_new_tokens=2))
    b.step()                                    # length 10 joins the wave
    assert b.slots[1].rid == 3
    b.step()                                    # rid 3 leaves, rid 0 ends
    b.submit(Request(rid=2, prompt=short, max_new_tokens=2))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == [0, 1, 2, 3]
    assert [len(done[r]) for r in range(4)] == [4, 1, 2, 2]


# ---------------------------------------------------------------------------
# The CLI and what is not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_cli_serves_reduced_dense_archs_on_the_cpu(arch, capsys):
    cli.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots",
              "2", "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: 3 requests, 12 tokens" in out
    assert out.count("  req ") == 3


def test_cross_attention_and_unported_kinds_raise():
    """``ctx=`` (cross-attention, served since the vision and enc-dec
    families) returns the reference's result and no cache; a block kind
    the reference does not have is still refused."""
    cfg, tcfg = _cfgs("llama3.2-3b")
    jp, tp = _attn_pair(cfg, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, cfg.d_model)).astype(np.float32)
    want, none = ref_attn.attention(jp, cfg, jnp.asarray(x), ctx=jnp.asarray(ctx))
    got, nothing = attn.attention(tp, tcfg, torch.from_numpy(x),
                                  ctx=torch.from_numpy(ctx))
    assert none is None and nothing is None
    _close(got, want)
    gen = M.make_generator(0, "cpu")
    for kind in ("encoder", "ssm2"):
        with pytest.raises(ValueError, match="unknown block kind"):
            blocks.init_block_params(gen, tcfg, kind)
        with pytest.raises(ValueError, match="unknown block kind"):
            blocks.init_layer_caches(tcfg, 1, kind, 1, 8, device="cpu")
