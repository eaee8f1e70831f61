"""Blocks and block stacks — port of ``repro.models.blocks``.  Block kinds:

  dense  : ln -> attention -> ln -> SwiGLU MLP     (llama, qwen, minicpm)
  moe    : ln -> attention -> ln -> MoE (+shared)  (mixtral, deepseek)
  ssm    : ln -> mamba2 mixer                      (mamba2)
  hybrid : ln -> (attention ∥ mamba2) / 2 -> ln -> MLP   (hymba)
  cross  : ln -> cross-attention -> ln -> MLP      (vision / enc-dec memory)

A block whose config has ``d_ff = 0`` has no MLP (the enc-dec decoder's
self-attention blocks).

A Python loop over the layers replaces the reference's ``lax.scan``
(``blocks.py:161``): PyTorch runs eagerly, so every layer sees concrete
activations, which the MoE SELL dispatch needs (the reference's
``eager_blocks`` scope is the default here and is not ported).

``remat`` (the reference's ``jax.checkpoint`` around its scan body) wraps
each block where a graph is recorded (:func:`remat_call`): ``"full"``
saves a block's inputs only and recomputes the rest in the backward,
``"dots"`` also saves the outputs of the un-batched matrix products
(``aten.mm`` / ``aten.addmm``: the counterpart of
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest, kernel
B8 included.  The
per-layer decode caches stay stacked on a leading layer axis, as in the
reference: a KV cache's k / v are (L, B, C, Hkv, dh), its pos (L, C) and
length (L,); an SSM state's leaves (L, B, ...).  A hybrid stack carries
both.  Any other kind raises ``ValueError``.

On a mesh (:func:`run_blocks_tp`, :func:`block_forward_tp`) every kind
runs over the placed layers of each data replica: the residual stream and
the norms stay on the replica's lead device, the attention (a cross
block's over a copy of the context on each device), MLP, experts and the
Mamba2 mixer run over its model devices
(:func:`~repro_torch.models.attention.attention_tp`,
:func:`~repro_torch.models.layers.swiglu_tp`,
:func:`~repro_torch.models.moe.moe_forward_tp`,
:func:`~repro_torch.models.ssm.ssm_forward_tp`; a hybrid block's attention
and mixer side by side on the same normed input, joined on the lead), each
device keeps its own pieces of the KV caches and SSM states (a hybrid
layer's both), and ``remat`` wraps each block (:func:`remat_call_tp`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as shrd
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, he_init, param, rms_norm, swiglu,
                                       swiglu_tp)
from repro_torch.models.ssm import SSMState

__all__ = ["Block", "LayerCaches", "MLP", "REMAT_POLICIES", "block_forward",
           "block_forward_tp", "init_block_params", "init_layer_caches",
           "remat_call", "remat_call_tp", "run_blocks", "run_blocks_tp",
           "stack_init"]

#: The block kinds, the reference's.
KINDS = ("dense", "moe", "ssm", "hybrid", "cross")
#: The rematerialization policies, the reference's (None: save everything).
REMAT_POLICIES = (None, "full", "dots")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep un-batched matrix products, recompute the
    rest."""
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def remat_call(fn, remat: str | None, *args):
    """``fn(*args)`` under the ``remat`` policy where grad is enabled:
    ``"full"`` a non-reentrant checkpoint, ``"dots"`` a selective one that
    saves the un-batched matrix products; ``None``, or no grad, a plain
    call."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; the policies are "
                         f"{REMAT_POLICIES}")
    if remat is None or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


class _Dots(TorchDispatchMode):
    """The ``"dots"`` policy of :class:`_Recompute`: a block's forward
    keeps the outputs of its un-batched matrix products (``saved`` None),
    and its recompute hands them back in the same order (``saved``: the
    forward's), below autograd, so the backward still reaches their
    inputs; every other op runs."""

    def __init__(self, saved: list | None = None):
        super().__init__()
        self.replay = saved is not None
        self.saved = [] if saved is None else saved
        self.at = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DOTS:
            return func(*args, **kwargs)
        shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
        if not self.replay:
            out = func(*args, **kwargs)
            self.saved.append((func, shapes, out.detach(), out._version))
            return out
        entry = self.saved[self.at] if self.at < len(self.saved) else None
        if entry is None or entry[:2] != (func, shapes) or \
                entry[2]._version != entry[3]:
            raise RuntimeError(f"remat 'dots': the recompute's product {self.at} "
                               f"({func}, {shapes}) is not the forward's")
        self.at += 1
        return entry[2].detach()


class _Recompute(torch.autograd.Function):
    """``fn(x) -> (out, aux)`` keeping only ``x`` (and, under ``"dots"``,
    the outputs of the un-batched matrix products, :class:`_Dots`): the
    backward recomputes ``fn`` under grad and takes the gradients of ``x``
    and of ``tensors`` (the placed block's pieces, which ``fn`` reads) by
    one nested ``torch.autograd.grad``.  The remat of a placed block:
    torch's checkpoint hooks are not safe where a block spans several
    cards (the autograd engine runs each card's part of the backward on a
    thread of its own, and two of them unpack one checkpoint)."""

    @staticmethod
    def forward(ctx, fn, dots, x, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(x, *tensors)
        mode = _Dots() if dots else None
        with torch.no_grad(), contextlib.nullcontext() if mode is None else mode:
            out = fn(x)
        ctx.dots = None if mode is None else mode.saved
        return out

    @staticmethod
    def backward(ctx, *grads):
        x, *tensors = ctx.saved_tensors
        replay = None if ctx.dots is None else _Dots(ctx.dots)
        with (torch.enable_grad(),
              contextlib.nullcontext() if replay is None else replay):
            xi = x.detach().requires_grad_(x.requires_grad)
            outs = ctx.fn(xi)
        if replay is not None and replay.at != len(ctx.dots):
            raise RuntimeError(f"remat 'dots': the recompute ran {replay.at} of "
                               f"the forward's {len(ctx.dots)} products")
        ctx.dots = None
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t in [xi] + tensors if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs], allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in [xi] + tensors)


def remat_call_tp(fn, remat: str | None, x: torch.Tensor,
                  p: shrd.PlacedParams, ctx: list[torch.Tensor] | None = None):
    """:func:`remat_call` of a placed block's ``fn(x) -> (x, caches,
    aux)``: where grad is enabled and ``remat`` is given, :class:`_Recompute`
    over ``p``'s pieces and the context copies ``fn`` reads (``ctx``, each
    tensor once), saving the block's input (``"full"``) and also the
    outputs of its un-batched matrix products (``"dots"``); a block makes
    no caches under a gradient."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; the policies are "
                         f"{REMAT_POLICIES}")
    if remat is None or not torch.is_grad_enabled():
        return fn(x)
    extra = list({id(t): t for t in ctx or ()}.values())
    out, aux = _Recompute.apply(lambda h: fn(h)[::2], remat == "dots", x,
                                *extra, *p.pieces())
    return out, None, aux


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the kinds are "
                         f"{', '.join(map(repr, KINDS))}")


class LayerCaches(NamedTuple):
    """Per-stack decode caches (leaves stacked on a leading layer axis)."""

    kv: KVCache | None
    ssm: SSMState | None


class Block(nn.Module):
    """One block: ``ln1`` and its mixers (``attn`` for every kind but
    ``"ssm"``, ``ssm`` for kinds ``"ssm"`` and ``"hybrid"``), then ``ln2``
    and ``moe`` (kind ``"moe"``) or ``mlp`` (the other attention kinds,
    where ``d_ff`` is not 0)."""

    def __init__(self, ln1: torch.Tensor, *, ssm: ssm_mod.SSMMixer | None = None,
                 attn: attn_mod.Attention | None = None,
                 ln2: torch.Tensor | None = None, mlp: MLP | None = None,
                 moe: moe_mod.MoE | None = None):
        super().__init__()
        self.ln1 = param(ln1)
        self.ssm = ssm
        self.attn = attn
        self.ln2 = None if ln2 is None else param(ln2)
        self.mlp = mlp
        self.moe = moe


def init_block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Block:
    """Random init of one block (a cross block's context at d_model)."""
    _check_kind(kind)
    d, dev = cfg.d_model, gen.device
    kw = {}
    if kind != "ssm":
        kw["attn"] = attn_mod.init_attn_params(gen, cfg)
    if kind in ("ssm", "hybrid"):
        kw["ssm"] = ssm_mod.init_ssm_params(gen, cfg)
    if kind == "moe":
        kw["moe"] = moe_mod.init_moe_params(gen, cfg)
    elif kind != "ssm" and cfg.d_ff:
        f = cfg.d_ff
        kw["mlp"] = MLP(he_init(gen, (d, f)), he_init(gen, (d, f)),
                        he_init(gen, (f, d), fan_in=f))
    if "moe" in kw or "mlp" in kw:
        kw["ln2"] = torch.ones((d,), device=dev)
    return Block(torch.ones((d,), device=dev), **kw)


def block_forward(p: Block, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                  kv: KVCache | None = None, ssm_state: SSMState | None = None,
                  ctx: torch.Tensor | None = None, causal: bool = True
                  ) -> tuple[torch.Tensor, KVCache | None, SSMState | None,
                             torch.Tensor]:
    """Returns (x, new_kv, new_ssm, aux_loss): the aux loss is the MoE
    layer's (zero for the other kinds).  ``ctx`` is a cross block's memory;
    ``causal=False`` makes a self-attention block bidirectional (the
    encoder's)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    new_kv, new_ssm = None, None
    if kind == "cross":
        a, _ = attn_mod.attention(p.attn, cfg, h, ctx=ctx)
        x = x + a
    elif kind == "ssm":
        s_out, new_ssm = ssm_mod.ssm_forward(p.ssm, cfg, h, ssm_state)
        x = x + s_out
    elif kind == "hybrid":
        a, new_kv = attn_mod.attention(p.attn, cfg, h, cache=kv)
        s_out, new_ssm = ssm_mod.ssm_forward(p.ssm, cfg, h, ssm_state)
        x = x + 0.5 * (a + s_out)          # hymba: fused parallel heads
    else:
        a, new_kv = attn_mod.attention(p.attn, cfg, h, cache=kv, causal=causal)
        x = x + a
    if p.moe is not None:
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        m_out, aux = moe_mod.moe_forward(p.moe, cfg, h2)
        x = x + m_out
    elif p.mlp is not None:
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        m = p.mlp
        x = x + swiglu(h2, m.w_gate.to(x.dtype), m.w_up.to(x.dtype),
                       m.w_down.to(x.dtype))
    return x, new_kv, new_ssm, aux


def block_forward_tp(p: shrd.PlacedParams, cfg: ModelConfig, kind: str,
                     x: torch.Tensor, row: shrd.Row, *,
                     caches: list[LayerCaches] | None = None,
                     ctx: list[torch.Tensor] | None = None, causal: bool = True
                     ) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """:func:`block_forward` of a placed block over a data replica's model
    devices (``x`` on its lead; ``caches``: each device's pieces of the
    layer's KV cache and SSM state; ``ctx``: a cross block's context, a
    copy on each device).  Returns (x, each device's new
    :class:`LayerCaches`, or None for a cross block or without ``caches``,
    aux_loss)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, row.pieces(p["ln1"])[0], cfg.norm_eps)
    kvs = None if caches is None else [c.kv for c in caches]
    states = None if caches is None else [c.ssm for c in caches]
    new = None
    if kind == "cross":
        a, _ = attn_mod.attention_tp(p.sub("attn"), cfg, h, row, ctx=ctx)
        x = x + a
    elif kind == "ssm":
        s_out, new_ssm = ssm_mod.ssm_forward_tp(p.sub("ssm"), cfg, h, row, states)
        return x + s_out, None if new_ssm is None else [
            LayerCaches(kv=None, ssm=st) for st in new_ssm], aux
    elif kind == "hybrid":
        a, new_kv = attn_mod.attention_tp(p.sub("attn"), cfg, h, row, cache=kvs)
        s_out, new_ssm = ssm_mod.ssm_forward_tp(p.sub("ssm"), cfg, h, row, states)
        x = x + 0.5 * (a + s_out)          # hymba: fused parallel heads
        if new_kv is not None:
            new = [LayerCaches(kv=kv, ssm=st) for kv, st in zip(new_kv, new_ssm)]
    else:
        a, new_kv = attn_mod.attention_tp(p.sub("attn"), cfg, h, row, cache=kvs,
                                          causal=causal)
        x = x + a
        if new_kv is not None:
            new = [LayerCaches(kv=kv, ssm=None) for kv in new_kv]
    if "moe" in p:
        h2 = rms_norm(x, row.pieces(p["ln2"])[0], cfg.norm_eps)
        m_out, aux = moe_mod.moe_forward_tp(p.sub("moe"), cfg, h2, row)
        x = x + m_out
    elif "mlp" in p:
        h2 = rms_norm(x, row.pieces(p["ln2"])[0], cfg.norm_eps)
        x = x + swiglu_tp(h2, p.sub("mlp"), row)
    return x, new, aux


def run_blocks_tp(p: shrd.PlacedParams, n_layers: int, cfg: ModelConfig,
                  kind: str, x: torch.Tensor, row: shrd.Row, *,
                  caches: list[LayerCaches] | None = None,
                  ctx: list[torch.Tensor] | None = None, causal: bool = True,
                  remat: str | None = None
                  ) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """:func:`run_blocks` over the placed stack ``p`` (layers ``0`` ..
    ``n_layers - 1``) of a data replica, ``ctx`` and ``causal`` to every
    block, each block under ``remat`` (:func:`remat_call_tp`); ``caches``:
    each model device's layer-stacked cache pieces.  Returns (x, each
    device's new stacked pieces, aux_sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = []
    for i in range(n_layers):
        layer = None if caches is None else [
            LayerCaches(kv=layer_of(c.kv, i), ssm=layer_of(c.ssm, i))
            for c in caches]

        block = p.sub(str(i))

        def body(h, block=block, layer=layer):
            return block_forward_tp(block, cfg, kind, h, row, caches=layer,
                                    ctx=ctx, causal=causal)

        x, new, aux_l = remat_call_tp(body, remat, x, block, ctx)
        aux = aux + aux_l
        layers.append(new)
    if caches is None:
        return x, None, aux
    return x, [LayerCaches(kv=_stack([layer[m].kv for layer in layers], KVCache),
                           ssm=_stack([layer[m].ssm for layer in layers], SSMState))
               for m in range(row.size)], aux


def stack_init(gen: torch.Generator, n_layers: int, cfg: ModelConfig,
               kind: str) -> nn.ModuleList:
    """``n_layers`` blocks drawn one after another from ``gen``."""
    return nn.ModuleList(init_block_params(gen, cfg, kind) for _ in range(n_layers))


def layer_of(stacked, i: int):
    """Layer ``i`` of a layer-stacked cache (a NamedTuple) or parameter
    subtree (a dict of arrays): every leaf indexed."""
    if stacked is None:
        return None
    if isinstance(stacked, dict):
        return {k: layer_of(v, i) for k, v in stacked.items()}
    if isinstance(stacked, tuple):
        return type(stacked)(*(a[i] for a in stacked))
    return stacked[i]


def _stack(per_layer: list, cls):
    """The per-layer caches stacked on a new leading layer axis (None
    where the layers have none)."""
    if not per_layer or per_layer[0] is None:
        return None
    return cls(*(torch.stack(leaves) for leaves in zip(*per_layer)))


def run_blocks(stack: nn.ModuleList, cfg: ModelConfig, kind: str, x: torch.Tensor,
               *, caches: LayerCaches | None = None,
               ctx: torch.Tensor | None = None, causal: bool = True,
               remat: str | None = None
               ) -> tuple[torch.Tensor, LayerCaches | None, torch.Tensor]:
    """Run a homogeneous stack layer by layer (the reference's
    ``scan_blocks``; ``ctx`` and ``causal`` go to every block, each block
    under ``remat``, :func:`remat_call`).  Returns (x, new_caches,
    aux_sum); new caches are new tensors, the given ones are left as they
    were."""
    _check_kind(kind)
    kvs, states = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, block in enumerate(stack):
        kv = layer_of(caches.kv, i) if caches is not None else None
        st = layer_of(caches.ssm, i) if caches is not None else None

        def body(h, block=block, kv=kv, st=st):
            return block_forward(block, cfg, kind, h, kv=kv, ssm_state=st,
                                 ctx=ctx, causal=causal)

        x, new_kv, new_ssm, aux_l = remat_call(body, remat, x)
        aux = aux + aux_l
        if new_kv is not None:
            kvs.append(new_kv)
        if new_ssm is not None:
            states.append(new_ssm)
    if caches is None:
        return x, None, aux
    return (x, LayerCaches(kv=_stack(kvs, KVCache), ssm=_stack(states, SSMState)),
            aux)


def init_layer_caches(cfg: ModelConfig, n_layers: int, kind: str, batch: int,
                      max_len: int, dtype=torch.bfloat16,
                      device=None) -> LayerCaches:
    """Stacked decode caches for one homogeneous group on ``device``
    (``None``: the card): each leaf of one layer's cache broadcast to a
    leading ``n_layers`` axis, as the reference's.  ``max_len`` sizes a KV
    cache (kinds ``"dense"``, ``"moe"``, ``"hybrid"``); an SSM state
    (``"ssm"``, ``"hybrid"``) is O(1) in length; a cross stack has none."""
    device = resolve_device(device)
    _check_kind(kind)

    def stacked(one):
        return type(one)(*(a.expand((n_layers,) + a.shape).contiguous()
                           for a in one))

    kv = ssm = None
    if kind in ("dense", "moe", "hybrid"):
        kv = stacked(attn_mod.init_cache(cfg, batch, max_len, dtype,
                                         device=device))
    if kind in ("ssm", "hybrid"):
        ssm = stacked(ssm_mod.init_ssm_state(cfg, batch, dtype, device=device))
    return LayerCaches(kv=kv, ssm=ssm)
