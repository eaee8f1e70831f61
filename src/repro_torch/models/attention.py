"""Attention — port of ``repro.models.attention``: GQA with RoPE, qk-norm,
QKV bias, sliding windows, cross-attention and the ring-buffer KV-cache
decode.

Shapes as in the reference: hidden (B, S, d); q (B, S, Hq, dh); k / v (B,
S, Hkv, dh) with Hq % Hkv == 0 (GQA groups).

The KV cache is a ring buffer of capacity ``min(max_len, sliding_window)``
for sliding-window layers and ``max_len`` otherwise.  Keys are stored with
RoPE already applied at their absolute position; a parallel ``pos`` array
holds each slot's absolute position (-1: empty) for the mask, so
wrap-around eviction is just overwriting slots.  ``length`` and ``pos``
stay tensors on the cache's device and every position is computed from
them with tensor ops: no call here reads a device value back to the host.
Caches are written functionally (a new :class:`KVCache` each call), as the
reference writes them.

The reference computes attention with plain einsums outside any Pallas
kernel, so the port does the same with ``torch.einsum`` / ``torch.matmul``:
scores in float32, the additive ``NEG_INF`` mask, a float32 softmax (in
q's dtype under :data:`ATTN_BF16_SCORES`, below).  It does not call ``F.scaled_dot_product_attention``, whose masking is not the
reference's.

Cross-attention (``ctx=``: the vision and enc-dec families' memory)
projects keys and values from the context, of its own length T and width
``d_ctx``, and attends without rope, mask or cache, as the reference does:
so a decode step recomputes them from the whole context.

On a mesh (:func:`attention_tp`) each device of a data replica's model
axis runs its own q heads against its own kv heads and its own piece of
the KV cache, and the partial products of ``wo``'s row shards are summed
on the replica's lead device (the reference's GSPMD constraints, made
explicit).  Where the spec splits ``wk`` / ``wv`` inside a head (the kv
heads do not divide over the model axis), each device gathers those
weights, keeps every kv head in its (replicated) cache piece and attends
with the kv head of each of its q heads; where the q heads do not divide,
the layer runs whole on the lead.  Cross-attention on a mesh (``ctx=``, a
copy of the context on each of the replica's devices) splits the same
way: each device projects its q heads from ``x`` and its kv heads from its
copy of the context.

The reference's opt-in module flags, each off by default as there, take
effect under the reference's conditions:

- :data:`ATTN_BF16_SCORES`: scores, scale, mask and softmax in q's dtype
  (a float32 model computes what it computes without the flag; torch's
  bf16 softmax sums in float32 and rounds once, so a bf16 model's weights
  are those the float32 path rounds, and only the buffers' bytes halve);
- :data:`ATTN_KV_CHUNK`: the online softmax over key blocks
  (:func:`_sdpa_chunked`) for a causal call without a cache, and for a call
  with one, whose queries then attend over the fresh K/V only (the cache
  is still appended): right where the call starts the sequence, the
  engine's prefill, as in the reference;
- :data:`SEQ_SHARD_FALLBACK`: on a mesh whose model axis does not divide
  the q heads but divides the sequence, each model device takes its share
  of the query rows (global positions in the mask) against the whole K/V,
  the rows joined on the lead before ``wo`` (:func:`_attention_rows`);
- a KV cache whose context axis the model axis splits
  (:data:`repro_torch.launch.specs.KV_SEQ_SHARD`): each device appends the
  ring slots it owns and scores every query against them; the lead merges
  the partial (o, m, l) by the online-softmax rule, then applies ``wo``.

Parameters live in :class:`Attention`, an ``nn.Module`` whose tensors keep
the reference's names and layouts (``wq`` is (d, Hq dh), ``wo`` (Hq dh,
d)), so the reference's weights move over as they are
(:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, he_init, param, rms_norm, rope_freqs

__all__ = ["ATTN_BF16_SCORES", "ATTN_KV_CHUNK", "NEG_INF", "SEQ_SHARD_FALLBACK",
           "Attention", "KVCache", "attention", "attention_tp", "cache_append",
           "init_attn_params", "init_cache"]

NEG_INF = -1e30

#: Sequence-parallel attention where the q heads do not divide the model
#: axis: each model device takes the sequence's rows its share names
#: (:func:`attention_tp`).  Off by default, as in the reference.
SEQ_SHARD_FALLBACK: bool = False

#: Score buffers in the compute dtype (:func:`_sdpa`).  Off by default.
ATTN_BF16_SCORES: bool = False

#: Key-block size of the online-softmax attention (:func:`_sdpa_chunked`);
#: 0 = off (the default: the (S, T) scores materialized).
ATTN_KV_CHUNK: int = 0

#: The parameter names an :class:`Attention` may hold, in the reference's
#: order: the projections, then the ``qkv_bias`` and ``qk_norm`` leaves.
PARAM_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")
#: The parameters a kv head owns (split with the kv heads on a mesh).
_KV_SIDE = ("wk", "wv", "bk", "bv")


class KVCache(NamedTuple):
    """Ring-buffer cache.  k / v: (B, C, Hkv, dh); pos: (C,) int32 absolute
    positions of each slot (-1 = empty); length: () int32 tokens cached so
    far.  Stacked per layer, each leaf gains a leading layer axis."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """An empty cache on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    cap = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, cap, cfg.n_kv_heads, cfg.d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((cap,), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def cache_append(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """Append S new tokens (absolute positions length .. length + S - 1) to
    the ring; returns a new cache."""
    s = k.shape[1]
    cap = cache.k.shape[1]
    newpos = cache.length + torch.arange(s, dtype=torch.int32, device=k.device)
    if s >= cap:
        # keep only the last `cap` tokens, laid out by their ring slots
        k_tail, v_tail, p_tail = k[:, -cap:], v[:, -cap:], newpos[-cap:]
        inv = torch.argsort(p_tail % cap)
        return KVCache(k=k_tail[:, inv].to(cache.k.dtype),
                       v=v_tail[:, inv].to(cache.v.dtype),
                       pos=p_tail[inv], length=cache.length + s)
    slots = (newpos % cap).long()
    return KVCache(k=cache.k.index_copy(1, slots, k.to(cache.k.dtype)),
                   v=cache.v.index_copy(1, slots, v.to(cache.v.dtype)),
                   pos=cache.pos.index_copy(0, slots, newpos),
                   length=cache.length + s)


class Attention(nn.Module):
    """The parameters of one attention layer (see :func:`init_attn_params`),
    without a gradient until the model is made trainable
    (:func:`repro_torch.models.layers.param`)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        unknown = set(tensors) - set(PARAM_NAMES)
        if unknown:
            raise ValueError(f"unknown attention parameters {sorted(unknown)}")
        for name in PARAM_NAMES:
            if name in tensors:
                self.register_parameter(name, param(tensors[name]))


def init_attn_params(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    """Random init on the generator's device, the reference's scheme: He
    projections, zero biases (``qkv_bias``), unit norms (``qk_norm``).  A
    cross-attention layer's ``wk`` / ``wv`` take the context at d_model,
    as every model here feeds it (the vision context projected first)."""
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dev = gen.device
    p = {"wq": he_init(gen, (d, hq * dh)),
         "wk": he_init(gen, (d, hkv * dh)),
         "wv": he_init(gen, (d, hkv * dh)),
         "wo": he_init(gen, (hq * dh, d), fan_in=hq * dh)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((n * dh,), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), device=dev)
        p["k_norm"] = torch.ones((dh,), device=dev)
    return Attention(p)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 ctx: torch.Tensor | None = None):
    """q from ``x`` (B, S, d); k / v from ``ctx`` (B, T, d_ctx) when given,
    else from ``x``."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_in = ctx if ctx is not None else x
    t = kv_in.shape[1]
    q = torch.matmul(x, p.wq.to(x.dtype))
    k = torch.matmul(kv_in, p.wk.to(x.dtype))
    v = torch.matmul(kv_in, p.wv.to(x.dtype))
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Grouped scores (B, Hkv, G, S, T), scaled and masked: float32, or in
    q's dtype under :data:`ATTN_BF16_SCORES` (the scale and the mask cast
    to it, as the reference casts them).  q (B, S, Hq, dh), k (B, T, Hkv,
    dh)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", q, k)
    if ATTN_BF16_SCORES:
        scale = torch.tensor(dh ** -0.5, dtype=scores.dtype, device=scores.device)
        return scores * scale + mask.to(scores.dtype)
    return scores.float() * (dh ** -0.5) + mask.float()


def _heads_last(out: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, dh) -> (B, S, Hq dh)."""
    b, h, g, s, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h * g * dh)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Grouped SDPA.  mask: additive, broadcastable to (1, Hkv, 1, S, T).
    Returns (B, S, Hq dh)."""
    b, s, hq, dh = q.shape
    w = torch.softmax(_scores(q, k, mask), dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(b, s, hq * dh)


def _chunked(s: int) -> bool:
    """Whether a call of ``s`` queries takes :func:`_sdpa_chunked` (the
    reference's condition; a causal call without a cache needs ``causal``
    too)."""
    return bool(ATTN_KV_CHUNK) and s % ATTN_KV_CHUNK == 0 and s > ATTN_KV_CHUNK


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None, chunk: int, q0: int = 0) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``chunk`` (the
    reference's flash-attention recipe): (o, m, l) carried in float32, one
    (S, chunk) score tile a block, causal plus the optional sliding
    window, then o / max(l, 1e-30).  ``q0``: the global position of q's
    first row (a sequence shard's rows); the keys start at position 0.
    q / k / v as in :func:`_sdpa`; returns (B, S, Hq dh) in v's dtype."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, s, hkv, groups, dh)
    dev = q.device
    qpos = q0 + torch.arange(s, device=dev)[:, None]
    o = torch.zeros((b, hkv, groups, s, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, groups, s), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, groups, s), dtype=torch.float32, device=dev)
    for blk in range(k.shape[1] // chunk):
        keys = slice(blk * chunk, (blk + 1) * chunk)
        scores = torch.einsum("bshgd,bthd->bhgst", qg, k[:, keys]).float()
        kpos = blk * chunk + torch.arange(chunk, device=dev)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok = ok & (kpos > qpos - window)
        scores = scores * (dh ** -0.5) + torch.where(ok, 0.0, NEG_INF)[None, None, None]
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p_blk = torch.exp(scores - m_new[..., None])
        l = l * alpha + p_blk.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", p_blk.to(v.dtype), v[:, keys]).float()
        m = m_new
    return _heads_last((o / torch.clamp(l[..., None], min=1e-30)).to(v.dtype))


def _window_mask(ok: torch.Tensor, kpos: torch.Tensor, qpos: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """``ok`` narrowed to the sliding window, if any, as the additive mask
    (1, 1, 1, S, T)."""
    if cfg.sliding_window is not None:
        ok = ok & (kpos > qpos - cfg.sliding_window)
    return torch.where(ok, 0.0, NEG_INF)[None, None, None]


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
              ctx: torch.Tensor | None = None, cache: KVCache | None = None,
              causal: bool = True, kv_heads: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, KVCache | None]:
    """One attention layer.

    - no cache: (a)causal self-attention over ``x`` (``causal=False`` for
      encoder stacks), the sliding window applied when causal;
    - ``cache``: ``x`` is the new token block (a prefill into the ring or a
      decode step); keys and values are appended, then the queries attend
      over every filled slot at or before their position (and inside the
      window).  Returns (out, new cache);
    - ``ctx`` (B, T, d_ctx): cross-attention over the encoder / vision
      memory: bidirectional, no rope on either side, no cache (``cache``
      is not read).  Returns (out, None);
    - ``kv_heads`` (Hq,): the kv head each query head attends with, in
      place of the GQA grouping (a model device's share of the q heads
      against every kv head, :func:`attention_tp`).

    Under :data:`ATTN_KV_CHUNK` a causal call without a cache, and any call
    with one, of a length the chunk divides (and exceeds) attends through
    :func:`_sdpa_chunked` over its own fresh K/V.
    """
    s = x.shape[1]
    q, k, v = _project_qkv(p, cfg, x, ctx)
    if ctx is not None:
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        out = _sdpa(q, k, v, torch.zeros((1, 1, 1, 1, 1), device=x.device))
        return torch.matmul(out, p.wo.to(x.dtype)), None
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    pos = ar if cache is None else cache.length + ar
    cos, sin = rope_freqs(cfg.d_head, cfg.rope_theta, pos[None, :])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_cache = None if cache is None else cache_append(cache, k, v)
    if _chunked(s) and (causal or cache is not None):
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        out = _sdpa_chunked(q, k, v, window=cfg.sliding_window,
                            chunk=ATTN_KV_CHUNK)
        return torch.matmul(out, p.wo.to(x.dtype)), new_cache
    if cache is None:
        if causal:
            qpos, kpos = ar[:, None], ar[None, :]
            mask = _window_mask(kpos <= qpos, kpos, qpos, cfg)
        else:
            mask = torch.zeros((1, 1, 1, 1, 1), device=x.device)
    else:
        qpos, kpos = pos[:, None], new_cache.pos[None, :]
        mask = _window_mask((kpos >= 0) & (kpos <= qpos), kpos, qpos, cfg)
        k, v = new_cache.k.to(q.dtype), new_cache.v.to(q.dtype)
    if kv_heads is not None:
        k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    out = _sdpa(q, k, v, mask)
    return torch.matmul(out, p.wo.to(x.dtype)), new_cache


def _slots_split(cache: list[KVCache] | None) -> bool:
    """Whether the model axis splits the cache pieces' ring slots (a cache
    placed under :data:`repro_torch.launch.specs.KV_SEQ_SHARD`): a piece
    holds fewer slots than its whole ``pos``."""
    return cache is not None and cache[0].k.shape[1] != cache[0].pos.shape[-1]


def _seq_shard(cfg: ModelConfig, s: int, m_size: int) -> bool:
    """The reference's :data:`SEQ_SHARD_FALLBACK` condition on a model axis
    of ``m_size``."""
    return (SEQ_SHARD_FALLBACK and m_size > 1 and cfg.n_heads % m_size != 0
            and s % m_size == 0)


def _append_slots(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                  block: int) -> KVCache:
    """:func:`cache_append` on a piece that holds ring slots ``block`` x
    C_local … (``block`` + 1) x C_local - 1 of the whole ``pos``: each slot
    takes the last of the new tokens the ring puts there (every slot of the
    ``s >= cap`` rewrite), or keeps its key; ``pos`` and ``length`` whole,
    as :func:`cache_append` makes them."""
    s, cap, c_loc = k.shape[1], cache.pos.shape[-1], cache.k.shape[1]
    newpos = cache.length + torch.arange(s, dtype=torch.int32, device=k.device)
    if s >= cap:
        tail = newpos[-cap:]
        pos = tail[torch.argsort(tail % cap)]
    else:
        pos = cache.pos.index_copy(0, (newpos % cap).long(), newpos)
    slots = torch.arange(block * c_loc, (block + 1) * c_loc, device=k.device)
    first = (slots - cache.length) % cap              # the first token there
    hit = first < s
    tok = torch.where(hit, first + cap * (torch.clamp(s - 1 - first, min=0) // cap), 0)
    keep = hit[None, :, None, None]
    return KVCache(k=torch.where(keep, k.index_select(1, tok).to(cache.k.dtype), cache.k),
                   v=torch.where(keep, v.index_select(1, tok).to(cache.v.dtype), cache.v),
                   pos=pos, length=cache.length + s)


def _partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor):
    """(o, m, l) of the queries against one device's keys: the scores'
    row max ``m`` (float32), ``l`` = Σ exp(score - m) and ``o`` = Σ
    exp(score - m) v, both in v's dtype widened to at least float32."""
    scores = _scores(q, k, mask)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    acc = torch.promote_types(v.dtype, torch.float32)
    o = torch.einsum("bhgst,bthd->bhgsd", p.to(v.dtype), v).to(acc)
    return o, m.float(), p.to(acc).sum(dim=-1)


def _merge(parts: list, device, dtype: torch.dtype) -> torch.Tensor:
    """The devices' partial (o, m, l) merged on ``device`` in model order by
    the online-softmax rule of :func:`_sdpa_chunked`, then o / max(l,
    1e-30): (B, S, Hq dh) in ``dtype``."""
    o, m, l = (t.to(device) for t in parts[0])
    for part in parts[1:]:
        o_d, m_d, l_d = (t.to(device) for t in part)
        m_new = torch.maximum(m, m_d)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_d - m_new)
        o = o * alpha[..., None] + o_d * beta[..., None]
        l = l * alpha + l_d * beta
        m = m_new
    return _heads_last((o / torch.clamp(l[..., None], min=1e-30)).to(dtype))


def _gathered(p: shrd.PlacedParams, device) -> types.SimpleNamespace:
    """A layer's placed parameters gathered whole on ``device``."""
    return types.SimpleNamespace(**{n: leaf.full(device)
                                    for n, leaf in p.named_leaves()})


def _copies(cache: KVCache, devices) -> list[KVCache]:
    """``cache`` (on the first of ``devices``), then a copy on each other."""
    return [cache] + [KVCache(*(a.to(dev, copy=True) for a in cache))
                      for dev in devices[1:]]


def _attention_rows(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                    row: shrd.Row, cache: list[KVCache] | None, causal: bool
                    ) -> tuple[torch.Tensor, list | None]:
    """:func:`attention_tp` where the rows of the sequence or the ring's
    slots split over the model devices.  The projections, rope and ``wo``
    run whole on the lead.  A cache is appended whole on the lead (copies to
    the other devices), or slot by slot on each device where the model axis
    splits its slots.  Then, under :func:`_seq_shard`, each device attends
    with its share of the query rows (their global positions in the mask)
    over the fresh K/V (no cache, or :data:`ATTN_KV_CHUNK`) or the whole
    ring (gathered where its slots split), and the rows join on the lead;
    else the lead attends over the fresh K/V (:data:`ATTN_KV_CHUNK`) or
    each device scores every query against its slots and the lead merges
    their partial (o, m, l) (:func:`_merge`)."""
    lead, m_size = row.lead, row.size
    whole = _gathered(p, lead)
    s = x.shape[1]
    q, k, v = _project_qkv(whole, cfg, x)
    ar = torch.arange(s, dtype=torch.int32, device=lead)
    pos = ar if cache is None else cache[0].length.to(lead) + ar
    cos, sin = rope_freqs(cfg.d_head, cfg.rope_theta, pos[None, :])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    split = _slots_split(cache)
    new = None
    if split:
        new = [_append_slots(c, k.to(dev), v.to(dev), m)
               for m, (c, dev) in enumerate(zip(cache, row.devices))]
    elif cache is not None:
        new = _copies(cache_append(cache[0], k, v), row.devices)
    fresh = cache is None or _chunked(s)
    chunk = _chunked(s) and (causal or cache is not None)
    if not (_seq_shard(cfg, s, m_size) or fresh):
        # every query against each device's slots; the partials merged
        parts = []
        for i, (n, dev) in enumerate(zip(new, row.devices)):
            lo = i * n.k.shape[1]
            qpos, kpos = pos.to(dev)[:, None], n.pos[None, lo:lo + n.k.shape[1]]
            mask = _window_mask((kpos >= 0) & (kpos <= qpos), kpos, qpos, cfg)
            parts.append(_partial(q.to(dev), n.k.to(q.dtype), n.v.to(q.dtype), mask))
        out = _merge(parts, lead, q.dtype)
        return torch.matmul(out, whole.wo.to(x.dtype)), new
    n_rows = s // m_size if _seq_shard(cfg, s, m_size) else s
    outs = []
    for m, dev in enumerate(row.devices[:s // n_rows]):
        rows = slice(m * n_rows, (m + 1) * n_rows)
        qm, qpos = q[:, rows].to(dev), pos[rows].to(dev)[:, None]
        if chunk:
            outs.append(_sdpa_chunked(qm, k.to(dev), v.to(dev),
                                      window=cfg.sliding_window,
                                      chunk=ATTN_KV_CHUNK, q0=m * n_rows))
            continue
        if fresh:
            kpos = ar.to(dev)[None, :]
            mask = (_window_mask(kpos <= qpos, kpos, qpos, cfg) if causal
                    else torch.zeros((1, 1, 1, 1, 1), device=dev))
            km, vm = k.to(dev), v.to(dev)
        else:
            ring = new[m]
            km = torch.cat([n.k.to(dev) for n in new], 1) if split else ring.k
            vm = torch.cat([n.v.to(dev) for n in new], 1) if split else ring.v
            kpos = ring.pos[None, :]
            mask = _window_mask((kpos >= 0) & (kpos <= qpos), kpos, qpos, cfg)
            km, vm = km.to(q.dtype), vm.to(q.dtype)
        outs.append(_sdpa(qm, km, vm, mask))
    out = shrd.cat_on(outs, lead, dim=1)
    return torch.matmul(out, whole.wo.to(x.dtype)), new


def attention_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                 row: shrd.Row, *, cache: list[KVCache] | None = None,
                 causal: bool = True, ctx: list[torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, list | None]:
    """One attention layer over the model devices of a data replica.
    ``p``: the layer's placed parameters; ``x``: (B, S, d) on the replica's
    lead; ``cache``: each model device's piece of the layer's KV cache (heads
    split where the model axis divides the kv heads, else every kv head;
    the ring's slots split where the cache was placed so,
    :data:`repro_torch.launch.specs.KV_SEQ_SHARD`); ``ctx``: cross-attention
    over a context (B, T, d), one copy on each of the replica's devices, in
    model order (no rope, mask or cache).  A self-attention layer whose
    slots or (under :data:`SEQ_SHARD_FALLBACK`) query rows split runs
    through :func:`_attention_rows`.  Returns (out on the lead, the new
    cache pieces)."""
    hq, hkv, m_size = cfg.n_heads, cfg.n_kv_heads, row.size
    if ctx is None and (_slots_split(cache) or _seq_shard(cfg, x.shape[1], m_size)):
        return _attention_rows(p, cfg, x, row, cache, causal)
    if hq % m_size:
        # the q heads do not split: the layer runs whole on the lead, and
        # the other devices take copies of its cache (every kv head)
        out, new = attention(_gathered(p, row.lead), cfg, x,
                             cache=None if cache is None else cache[0],
                             causal=causal, ctx=None if ctx is None else ctx[0])
        return out, None if new is None else _copies(new, row.devices)
    c = hq // m_size
    kv_split = hkv % m_size == 0
    local_cfg = dataclasses.replace(cfg, n_heads=c, head_dim=cfg.d_head,
                                    n_kv_heads=hkv // m_size if kv_split else hkv)
    parts, new_cache = [], []
    for m, (coord, dev) in enumerate(zip(row.coords, row.devices)):
        def weight(name: str, split: bool) -> torch.Tensor:
            leaf = p[name]
            if split or leaf.tp_dim() is None:
                return leaf.local(coord)
            return leaf.full(dev)             # split inside a head: gathered
        w = {n: weight(n, n not in _KV_SIDE or kv_split)
             for n, _ in p.named_leaves()}
        kv_heads = None
        if not kv_split:
            kv_heads = torch.arange(m * c, (m + 1) * c, device=dev) // (hq // hkv)
        out, new = attention(types.SimpleNamespace(**w), local_cfg, x.to(dev),
                             cache=None if cache is None else cache[m],
                             causal=causal, kv_heads=kv_heads,
                             ctx=None if ctx is None else ctx[m])
        parts.append(out)
        new_cache.append(new)
    return shrd.sum_on(parts, row.lead), None if cache is None else new_cache
