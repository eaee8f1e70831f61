"""Shared low-level layers: RMSNorm and the initializers (port of
``repro.models.layers``).

The initializers draw from an explicit ``torch.Generator`` (the counterpart
of a ``jax.random`` key) on the generator's device; the same seed gives
other numbers than JAX's, so parity tests move the reference's weights over
instead (:mod:`repro_torch.models.convert`).  Rope, SwiGLU and the loss
come with the attention and training slices (ROADMAP A12).
"""
from __future__ import annotations

import math

import torch

__all__ = ["embed_init", "he_init", "rms_norm"]


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
