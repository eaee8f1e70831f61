"""Parity of the port's single-device attention flags
(``repro_torch.models.attention.ATTN_KV_CHUNK`` and ``ATTN_BF16_SCORES``)
with the JAX reference run with the same flag set, on the CPU.

Both packages' flags are set with ``monkeypatch`` (each module attribute
of the same name, read at the call, or at the trace under ``jax.jit``:
every jitted function here is made after the flags are set).  The configs
are the reduced ones.  Tolerances:

* float64 inputs against the reference: ``F64_TOL`` = 1e-6 x max(1,
  |reference|).  Not 1e-10: both packages compute rope's cos / sin in
  float32, and the chunked path's (o, m, l) and exp in float32 whatever
  the inputs (the reference's casts), and XLA's float32 exp / cos differ
  from torch's by up to one ulp (1.2e-7 relative), so the outputs agree to
  float32 rounding (the largest difference seen: 1.4e-7 relative);
* float32 inputs and the LMs: ``LOGIT_TOL`` x max(1, |reference|), greedy
  tokens equal wherever the reference's top-2 margin exceeds it, as
  ``tests/test_torch_attention.py`` holds them;
* bf16 scores in a bf16 model: ``BF16_TOL`` = 1e-2 x max|reference|, the
  bound the reference's comment gives (``attention.py:143-147``: ~1e-2
  relative on the weights);
* where the flag must change nothing (a chunk that does not divide the
  length, bf16 scores in a float32 model): ``torch.equal`` to the port
  without the flag.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import model as RM
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import Batcher, GenerationConfig, Request

F64_TOL = 1e-6
LOGIT_TOL = 1e-5
BF16_TOL = 1e-2
N_NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny tensors (the workers of
    a parallel test run share the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(monkeypatch, **flags):
    """Set each named flag in both packages' attention modules."""
    for name, value in flags.items():
        monkeypatch.setattr(ref_attn, name, value)
        monkeypatch.setattr(attn, name, value)


def _counted(monkeypatch) -> list:
    """The calls of the port's ``_sdpa_chunked`` (their query count)."""
    calls = []
    real = attn._sdpa_chunked

    def wrapped(q, *args, **kw):
        calls.append(q.shape[1])
        return real(q, *args, **kw)
    monkeypatch.setattr(attn, "_sdpa_chunked", wrapped)
    return calls


def _cfgs(arch, **over):
    return tuple(dataclasses.replace(c, **over) if over else c
                 for c in (ref_configs.reduced_config(arch),
                           configs.reduced_config(arch)))


def _layer(cfg, dtype, seed=3):
    """One attention layer's parameters in both packages in ``dtype``
    (numpy's name), the optional leaves (biases, qk norms) drawn at random
    so they count."""
    ref_p = ref_attn.init_attn_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    tree = {k: (np.asarray(v, np.float64) if k.startswith("w")
                else rng.standard_normal(np.shape(v))) for k, v in ref_p.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ({k: jnp.asarray(v).astype(jdt) for k, v in tree.items()},
            attn.Attention({k: torch.from_numpy(v.copy()).to(tdt)
                            for k, v in tree.items()}))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float64))
    got = got.detach().double().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _close_cache(got, want, tol):
    _close(got.k, want.k, tol)
    _close(got.v, want.v, tol)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))


# ---------------------------------------------------------------------------
# ATTN_KV_CHUNK: the online softmax over key blocks
# ---------------------------------------------------------------------------

#: (arch, config overrides, cache length (None: no cache), block lengths,
#: chunk): causal without a cache; the cache from scratch then a decode
#: step (the full path); a sliding window whose ring (5) the block wraps;
#: GQA with 2 kv heads and qkv biases (qwen2); chunks that do not divide
#: the length, or do not exceed it (the full path)
CHUNK_CASES = {
    "causal": ("llama3.2-3b", {}, None, (16,), 4),
    "cache": ("llama3.2-3b", {}, 32, (16, 1), 4),
    "window_wrapped": ("llama3.2-3b", {"sliding_window": 5}, 32, (16, 1, 1), 4),
    "gqa": ("qwen2-1.5b", {"n_kv_heads": 2}, None, (16,), 8),
    "gqa_cache": ("qwen2-1.5b", {"n_kv_heads": 2, "sliding_window": 6}, 32,
                  (16, 1), 8),
    "indivisible": ("llama3.2-3b", {}, 32, (16, 1), 5),
    "not_longer": ("qwen2-1.5b", {"n_kv_heads": 2}, None, (16,), 16),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_attention_matches_reference(case, monkeypatch):
    """The attention module under ``ATTN_KV_CHUNK`` against the reference's
    with the same chunk, in float64, each block then the cache: the port
    takes ``_sdpa_chunked`` exactly where the reference's condition holds
    (a length the chunk divides and exceeds), and a block it does not take
    is ``torch.equal`` to the port without the flag."""
    arch, over, cache_len, blocks, chunk = CHUNK_CASES[case]
    cfg, tcfg = _cfgs(arch, **over)
    jp, tp = _layer(cfg, "float64")
    _flags(monkeypatch, ATTN_KV_CHUNK=chunk)
    calls = _counted(monkeypatch)
    rng = np.random.default_rng(len(case))
    cj = ct = c_off = None
    if cache_len is not None:
        cj = ref_attn.init_cache(cfg, 2, cache_len, dtype=jnp.float64)
        ct = attn.init_cache(tcfg, 2, cache_len, dtype=torch.float64, device="cpu")
        c_off = ct
    want_calls = []
    for s in blocks:
        x = rng.standard_normal((2, s, cfg.d_model))
        want, cj = ref_attn.attention(jp, cfg, jnp.asarray(x), cache=cj)
        got, ct_new = attn.attention(tp, tcfg, torch.from_numpy(x), cache=ct)
        _close(got, want, F64_TOL)
        if cache_len is not None:
            _close_cache(ct_new, cj, F64_TOL)
        taken = s % chunk == 0 and s > chunk
        want_calls += [s] if taken else []
        if not taken:
            with monkeypatch.context() as off:
                off.setattr(attn, "ATTN_KV_CHUNK", 0)
                plain, c_off = attn.attention(tp, tcfg, torch.from_numpy(x),
                                              cache=c_off if cache_len else None)
            assert torch.equal(got, plain)
        elif cache_len is not None:
            c_off = ct_new
        ct = ct_new
    assert calls == want_calls


def test_chunked_cache_branch_attends_over_the_fresh_keys_only(monkeypatch):
    """The cache branch of ``ATTN_KV_CHUNK`` (the reference's, right only
    where the call starts the sequence): a second block of 8 after 8 cached
    tokens, against the reference, attends over its own keys alone: within
    ``F64_TOL`` of the same block with no cache (rope is relative, so only
    the angles' float32 rounding differs) and unlike the full path over the
    16 cached keys."""
    cfg, tcfg = _cfgs("llama3.2-3b")
    jp, tp = _layer(cfg, "float64")
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)))
          for _ in range(2)]
    cj = ref_attn.init_cache(cfg, 2, 32, dtype=jnp.float64)
    first = attn.init_cache(tcfg, 2, 32, dtype=torch.float64, device="cpu")
    _, first = attn.attention(tp, tcfg, xs[0], cache=first)
    full, _ = attn.attention(tp, tcfg, xs[1], cache=first)
    _flags(monkeypatch, ATTN_KV_CHUNK=4)
    ct = attn.init_cache(tcfg, 2, 32, dtype=torch.float64, device="cpu")
    for x in xs:
        want, cj = ref_attn.attention(jp, cfg, jnp.asarray(x.numpy()), cache=cj)
        got, ct = attn.attention(tp, tcfg, x, cache=ct)
        _close(got, want, F64_TOL)
    _close_cache(ct, cj, F64_TOL)
    assert int(ct.length) == 16
    alone, _ = attn.attention(tp, tcfg, xs[1])
    _close(got, alone.numpy(), F64_TOL)
    assert float((got - full).abs().max()) > 1e-3 * float(full.abs().max())


# ---------------------------------------------------------------------------
# ATTN_BF16_SCORES: score buffers in the compute dtype
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [16, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_bf16_scores_match_reference(dtype, head_dim, monkeypatch):
    """``ATTN_BF16_SCORES`` on qwen2's GQA layer (2 kv heads, qkv biases)
    without a cache and through the cache (a prefill of 12, a decode step)
    against the reference with the flag: float32 ``torch.equal`` to the
    port without it (the reference's flag changes nothing in float32 either)
    and within ``LOGIT_TOL`` of the reference; float64 within ``F64_TOL``;
    bf16 within ``BF16_TOL`` x max|reference|.  At a head of 8 the scale
    8^-0.5 is no bf16 number (16^-0.5 is), so the flag's rounding of the
    scaled scores shows; in bf16 the port under the flag then differs from
    the port without it."""
    cfg, tcfg = _cfgs("qwen2-1.5b", n_kv_heads=2, head_dim=head_dim)
    jp, tp = _layer(cfg, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = {"float32": LOGIT_TOL, "float64": F64_TOL, "bfloat16": BF16_TOL}[dtype]
    rng = np.random.default_rng(7)
    _flags(monkeypatch, ATTN_BF16_SCORES=True)
    cj = ref_attn.init_cache(cfg, 2, 32, dtype=jdt)
    ct = attn.init_cache(tcfg, 2, 32, dtype=tdt, device="cpu")
    for s, cached in ((12, False), (12, True), (1, True)):
        x = rng.standard_normal((2, s, cfg.d_model))
        xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
        want, cj_new = ref_attn.attention(jp, cfg, xj, cache=cj if cached else None)
        got, ct_new = attn.attention(tp, tcfg, xt, cache=ct if cached else None)
        assert got.dtype == tdt
        _close(got, want, tol)
        with monkeypatch.context() as m:
            m.setattr(attn, "ATTN_BF16_SCORES", False)
            plain, _ = attn.attention(tp, tcfg, xt, cache=ct if cached else None)
        if dtype == "float32":
            assert torch.equal(got, plain)
        elif dtype == "bfloat16" and head_dim == 8:
            assert not torch.equal(got, plain)
        if cached:
            cj, ct = cj_new, ct_new


# ---------------------------------------------------------------------------
# The LMs through prefill, decode and the batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: the reduced arch in both packages on the
    reference's weights, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg, tcfg = _cfgs(arch)
            jp = RM.init_params(jax.random.PRNGKey(1), cfg)
            tree = jax.tree_util.tree_map(np.asarray, jp)
            built[arch] = (cfg, tcfg, jp, params_from_reference(tree, tcfg, "cpu"))
        return built[arch]
    return get


def _ref_greedy(cfg, jp, prompts, cache_len):
    """The reference (jitted after the flags are set): prefill logits, the
    greedy tokens, their top-2 margins, and each decode step's logits."""
    pre = jax.jit(lambda p, t, c: RM.prefill(p, cfg, {"tokens": t}, c))
    step = jax.jit(lambda p, t, c: RM.decode_step(p, cfg, t, c))
    caches = RM.init_caches(cfg, prompts.shape[0], cache_len, dtype=jnp.float32)
    logits, caches = pre(jp, jnp.asarray(prompts), caches)
    last, toks, margins, steps = logits[:, -1], [], [], []
    for i in range(N_NEW):
        top2 = np.sort(np.asarray(last), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(np.asarray(jnp.argmax(last, -1)).astype(np.int32))
        if i + 1 < N_NEW:
            last, caches = step(jp, jnp.asarray(toks[-1][:, None]), caches)
            steps.append(np.asarray(last))
    return np.asarray(logits), np.stack(toks, 1), np.stack(margins, 1), steps


def _port_greedy(tcfg, tp, prompts, cache_len, ref_toks):
    """The port's prefill logits and its decode steps fed the reference's
    tokens."""
    caches = M.init_caches(tcfg, prompts.shape[0], cache_len,
                           dtype=torch.float32, device="cpu")
    logits, caches = M.prefill(tp, tcfg, {"tokens": prompts}, caches)
    steps = []
    for i in range(N_NEW - 1):
        last, caches = M.decode_step(tp, tcfg, ref_toks[:, i:i + 1], caches)
        steps.append(last)
    return logits, steps


def _assert_tokens_agree(got, want, margins, scale, what):
    tol = LOGIT_TOL * max(1.0, scale)
    for r in range(want.shape[0]):
        for c in range(want.shape[1]):
            if margins[r, c] <= tol:
                if got[r, c] != want[r, c]:
                    break               # prefixes differ from here on
                continue
            assert got[r, c] == want[r, c], (what, r, c, got[r], want[r])


def test_lm_under_chunk_and_bf16_scores_matches_reference(models, monkeypatch):
    """llama (reduced) with ``ATTN_KV_CHUNK = 4`` and ``ATTN_BF16_SCORES``
    in both packages: 16-token prompts (chunked prefill), decode steps (the
    full path) and the port's ``Batcher`` (b = 1 chunked prefills written
    into their slots) against the reference's greedy continuation."""
    cfg, tcfg, jp, tp = models("llama3.2-3b")
    _flags(monkeypatch, ATTN_KV_CHUNK=4, ATTN_BF16_SCORES=True)
    calls = _counted(monkeypatch)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    logits, toks, margins, steps = _ref_greedy(cfg, jp, prompts, 32)
    got, got_steps = _port_greedy(tcfg, tp, prompts, 32, toks)
    assert calls == [16] * tcfg.n_layers
    _close(got, logits, LOGIT_TOL)
    for g, w in zip(got_steps, steps):
        _close(g, w, LOGIT_TOL)
    b = Batcher(tcfg, tp, n_slots=2, gcfg=GenerationConfig(cache_len=32))
    for rid in range(4):
        b.submit(Request(rid=rid, prompt=prompts[rid], max_new_tokens=N_NEW))
    done = {r.rid: r.generated for r in b.run()}
    assert sorted(done) == list(range(4))
    scale = float(np.abs(logits).max())
    for rid, t in done.items():
        _assert_tokens_agree(np.asarray([t]), toks[rid:rid + 1],
                             margins[rid:rid + 1], scale, f"batcher {rid}")


def test_hymba_prefill_past_its_ring_under_chunk(models, monkeypatch):
    """hymba (reduced: a window and ring of 16) prefilled with 32 tokens
    under ``ATTN_KV_CHUNK = 8``: against the reference with the flag at
    every position and decode step.  The flag's queries attend over the
    fresh K/V, so the prefill equals the forward without a cache (every
    query finds its window), and each decode step the forward over the
    prompt and the tokens fed so far, at its last position (the ring then
    holds those keys).  Without the flag the full path's queries before
    the last find part of their window evicted from the ring (ROADMAP C,
    reference behaviour): its prefill differs from the flag's."""
    cfg, tcfg, jp, tp = models("hymba-1.5b")
    assert cfg.sliding_window == 16
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    caches = M.init_caches(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    plain, _ = M.prefill(tp, tcfg, {"tokens": prompts}, caches)
    _flags(monkeypatch, ATTN_KV_CHUNK=8)
    calls = _counted(monkeypatch)
    logits, toks, _, steps = _ref_greedy(cfg, jp, prompts, 64)
    got, got_steps = _port_greedy(tcfg, tp, prompts, 64, toks)
    assert calls == [32] * tcfg.n_layers
    _close(got, logits, LOGIT_TOL)
    for g, w in zip(got_steps, steps):
        _close(g, w, LOGIT_TOL)
    with monkeypatch.context() as m:
        m.setattr(attn, "ATTN_KV_CHUNK", 0)
        seq = prompts
        whole, _ = M.forward(tp, tcfg, {"tokens": seq})
        _close(got, whole.numpy(), LOGIT_TOL)
        for i, g in enumerate(got_steps):
            seq = np.concatenate([seq, toks[:, i:i + 1]], axis=1)
            whole, _ = M.forward(tp, tcfg, {"tokens": seq})
            _close(g, whole[:, -1].numpy(), LOGIT_TOL)
    assert float((got - plain).abs().max()) > 1e-3 * float(plain.abs().max())
