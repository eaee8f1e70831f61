"""Int8 gradient compression with error feedback — port of
``repro.optim.compression``.

Quantizing gradients to int8 (a per-tensor scale) cuts the data-parallel
reduce's traffic 4x against float32; error feedback keeps the sum of
applied updates unbiased: the residual of each quantization is added back
before the next one (Seide et al.; Karimireddy et al.).  Trees are dicts of
name -> tensor, in plain PyTorch.

On a mesh the trees are placed (name -> :class:`~repro_torch.models
.sharding.Sharded`): the residuals by the moments' specs (ZeRO-1), the
gradients reduced and cut by them (one piece a block).  A leaf's scale
is the maximum over all its blocks, so each element is quantized as
without a mesh; the new residuals' replicas are copies of their blocks'.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import sharding as shrd

__all__ = ["CompressionState", "compress_tree", "compression_init",
           "decompress_tree"]


class CompressionState(NamedTuple):
    error: dict          # name -> float32 residual, the gradients' shapes


def compression_init(params, specs: dict | None = None) -> CompressionState:
    """Zero float32 residuals shaped as the parameters; placed parameters
    take them placed by ``specs`` (name -> spec; default their own)."""
    if isinstance(params, shrd.PlacedParams):
        return CompressionState(error={
            k: shrd.zeros(p.shape, p.spec if specs is None else specs[k],
                          p.mesh, torch.float32) for k, p in params.items()})
    items = params.items() if isinstance(params, dict) else params
    return CompressionState(error={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in items})


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, g - q.float() * scale


def _compress_placed(g: shrd.Sharded, err: shrd.Sharded):
    """One placed leaf: the scale of the maximum over every block."""
    blocks = {c: t.float() + err.pieces[c] for c, t in shrd.leads(g)}
    dev = g.mesh.devices.flat[0]
    scale = _scale(torch.max(torch.stack(
        [torch.max(torch.abs(t)).to(dev) for t in blocks.values()])))
    q = shrd.Sharded.empty(g.mesh, g.spec, g.shape)
    e = shrd.zeros(err.shape, err.spec, err.mesh, torch.float32)
    for c, t in blocks.items():
        q.pieces[c], e.pieces[c] = _quantize(t, scale.to(t.device))
    shrd.write_blocks(e, e)
    return q, scale, e


def compress_tree(grads: dict, state: CompressionState):
    """Returns (int8 tree, scale tree, new state)."""
    q, s, e = {}, {}, {}
    for k, g in grads.items():
        if isinstance(g, shrd.Sharded):
            q[k], s[k], e[k] = _compress_placed(
                shrd.recut(g, state.error[k].spec), state.error[k])
            continue
        g = g.float() + state.error[k]
        s[k] = _scale(torch.max(torch.abs(g)))
        q[k], e[k] = _quantize(g, s[k])
    return q, s, CompressionState(error=e)


def decompress_tree(q_tree: dict, scale_tree: dict, n_replicas: int = 1) -> dict:
    """Dequantize (after an integer sum over replicas: their mean)."""
    out = {}
    for k, q in q_tree.items():
        if isinstance(q, shrd.Sharded):
            d = shrd.Sharded.empty(q.mesh, q.spec, q.shape)
            for c, t in shrd.leads(q):
                d.pieces[c] = t.float() * scale_tree[k].to(t.device) / n_replicas
            out[k] = d
        else:
            out[k] = q.float() * scale_tree[k] / n_replicas
    return out
