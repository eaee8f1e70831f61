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
scores in float32, the additive ``NEG_INF`` mask, a float32 softmax.  It
does not call ``F.scaled_dot_product_attention``, whose masking is not the
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

Not ported: the reference's opt-in module flags, all off by default there:
``ATTN_KV_CHUNK`` (online-softmax key blocks), ``ATTN_BF16_SCORES`` (bf16
score buffers) and ``SEQ_SHARD_FALLBACK`` (sequence-parallel queries on a
mesh, ROADMAP A10c, the reference's mesh flags).

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

__all__ = ["NEG_INF", "Attention", "KVCache", "attention", "attention_tp",
           "cache_append", "init_attn_params", "init_cache"]

NEG_INF = -1e30

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


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Grouped SDPA.  mask: additive, broadcastable to (1, Hkv, 1, S, T).
    Returns (B, S, Hq dh)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).float()
    scores = scores * (dh ** -0.5) + mask.float()
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(b, s, hq * dh)


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
    """
    s = x.shape[1]
    q, k, v = _project_qkv(p, cfg, x, ctx)
    if ctx is not None:
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        out = _sdpa(q, k, v, torch.zeros((1, 1, 1, 1, 1), device=x.device))
        return torch.matmul(out, p.wo.to(x.dtype)), None
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    if cache is None:
        cos, sin = rope_freqs(cfg.d_head, cfg.rope_theta, ar[None, :])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if causal:
            qpos, kpos = ar[:, None], ar[None, :]
            mask = _window_mask(kpos <= qpos, kpos, qpos, cfg)
        else:
            mask = torch.zeros((1, 1, 1, 1, 1), device=x.device)
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        out, new_cache = _sdpa(q, k, v, mask), None
    else:
        pos = cache.length + ar
        cos, sin = rope_freqs(cfg.d_head, cfg.rope_theta, pos[None, :])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        new_cache = cache_append(cache, k, v)
        qpos, kpos = pos[:, None], new_cache.pos[None, :]
        mask = _window_mask((kpos >= 0) & (kpos <= qpos), kpos, qpos, cfg)
        k, v = new_cache.k.to(q.dtype), new_cache.v.to(q.dtype)
        if kv_heads is not None:
            k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
        out = _sdpa(q, k, v, mask)
    return torch.matmul(out, p.wo.to(x.dtype)), new_cache


def attention_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                 row: shrd.Row, *, cache: list[KVCache] | None = None,
                 causal: bool = True, ctx: list[torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, list | None]:
    """One attention layer over the model devices of a data replica.
    ``p``: the layer's placed parameters; ``x``: (B, S, d) on the replica's
    lead; ``cache``: each model device's piece of the layer's KV cache (heads
    split where the model axis divides the kv heads, else every kv head);
    ``ctx``: cross-attention over a context (B, T, d), one copy on each of
    the replica's devices, in model order (no rope, mask or cache).
    Returns (out on the lead, the new cache pieces)."""
    hq, hkv, m_size = cfg.n_heads, cfg.n_kv_heads, row.size
    if hq % m_size:
        # the q heads do not split: the layer runs whole on the lead, and
        # the other devices take copies of its cache (every kv head)
        whole = types.SimpleNamespace(**{n: leaf.full(row.lead)
                                         for n, leaf in p.named_leaves()})
        out, new = attention(whole, cfg, x, cache=None if cache is None
                             else cache[0], causal=causal,
                             ctx=None if ctx is None else ctx[0])
        if new is None:
            return out, None
        return out, [new] + [KVCache(*(a.to(dev, copy=True) for a in new))
                             for dev in row.devices[1:]]
    c = hq // m_size
    kv_split = hkv % m_size == 0
    local_cfg = dataclasses.replace(cfg, n_heads=c, head_dim=cfg.d_head,
                                    n_kv_heads=hkv // m_size if kv_split else hkv)
    parts, new_cache = [], []
    for m, (coord, dev) in enumerate(zip(row.coords, row.devices)):
        def weight(name: str, split: bool) -> torch.Tensor:
            leaf = p[name]
            if split or leaf.tp_dim() is None:
                return leaf.pieces[coord]
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
