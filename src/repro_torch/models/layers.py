"""Shared low-level layers: RMSNorm, rotary embeddings, SwiGLU and the
initializers and the training loss (port of ``repro.models.layers``).

The initializers draw from an explicit ``torch.Generator`` (the counterpart
of a ``jax.random`` key) on the generator's device; the same seed gives
other numbers than JAX's, so parity tests move the reference's weights over
instead (:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as Fn

from repro_torch.models import sharding as shrd

__all__ = ["MLP", "apply_rope", "embed_init", "frozen", "he_init", "rms_norm",
           "rope_freqs", "swiglu", "swiglu_tp"]


def param(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter without a gradient: the port serves only."""
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """A SwiGLU MLP's weights: ``w_gate`` / ``w_up`` (d, f), ``w_down`` (f, d)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate = param(w_gate)
        self.w_up = param(w_up)
        self.w_down = param(w_down)


def he_init(gen: torch.Generator, shape, dtype=torch.float32,
            fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[-1]
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * math.sqrt(1.0 / fan)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * 0.02


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, computed in float32, returned in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings at the given positions, on the
    positions' device: shape ``positions.shape + (head_dim // 2,)``, angles
    in float32 as the reference computes them."""
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim // 2).
    Rotates the two halves of the head dimension; returns x's dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` over the last axis."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(Fn.silu(g) * u, w_down)


def swiglu_tp(x: torch.Tensor, p, row) -> torch.Tensor:
    """:func:`swiglu` over the model devices of a data replica (``row``, a
    :class:`~repro_torch.models.sharding.Row`; ``p``: the MLP's placed
    weights): ``w_gate`` / ``w_up`` column-parallel, ``w_down``
    row-parallel, each device's partial product summed on the replica's
    lead, where ``x`` lies.  An MLP whose width the model axis does not
    divide is replicated and runs on the lead."""
    names = ("w_gate", "w_up", "w_down")
    if p["w_gate"].tp_dim() is None:
        return swiglu(x, *(row.pieces(p[n])[0].to(x.dtype) for n in names))
    parts = [swiglu(x.to(dev), *(w.to(x.dtype) for w in ws))
             for dev, *ws in zip(row.devices, *(row.pieces(p[n]) for n in names))]
    return shrd.sum_on(parts, x.device)


def softmax_cross_entropy(logits: torch.Tensor, labels, ignore_id: int = -1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy in float32 over the labels that are not
    ``ignore_id``; returns (loss, n_valid_tokens), the reference's."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device)
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, logz - gold, 0.0)
    n = torch.clamp(mask.sum(), min=1)
    return nll.sum() / n, n
