"""Int8 gradient compression with error feedback — port of
``repro.optim.compression``.

Quantizing gradients to int8 (a per-tensor scale) cuts the data-parallel
reduce's traffic 4x against float32; error feedback keeps the sum of
applied updates unbiased: the residual of each quantization is added back
before the next one (Seide et al.; Karimireddy et al.).  Trees are dicts of
name -> tensor, in plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CompressionState", "compress_tree", "compression_init",
           "decompress_tree"]


class CompressionState(NamedTuple):
    error: dict          # name -> float32 residual, the gradients' shapes


def compression_init(params) -> CompressionState:
    items = params.items() if isinstance(params, dict) else params
    return CompressionState(error={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in items})


def _quantize(g: torch.Tensor, err: torch.Tensor):
    g = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.float() * scale
    return q, scale, new_err


def compress_tree(grads: dict, state: CompressionState):
    """Returns (int8 tree, scale tree, new state)."""
    q, s, e = {}, {}, {}
    for k, g in grads.items():
        q[k], s[k], e[k] = _quantize(g, state.error[k])
    return q, s, CompressionState(error=e)


def decompress_tree(q_tree: dict, scale_tree: dict, n_replicas: int = 1) -> dict:
    """Dequantize (after an integer sum over replicas: their mean)."""
    return {k: q.float() * scale_tree[k] / n_replicas for k, q in q_tree.items()}
