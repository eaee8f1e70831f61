"""Blocks and block stacks — port of ``repro.models.blocks`` for kind
``"ssm"`` (ln -> mamba2 mixer, the mamba2 family).

A Python loop over the layers replaces the reference's ``lax.scan``
(``blocks.py:161``): PyTorch runs eagerly, and the per-layer decode caches
stay stacked on a leading layer axis, as in the reference.  Every other
block kind (dense, moe, hybrid, cross) raises ``NotImplementedError``:
attention, MoE and cross-attention are ROADMAP A12.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import SSMState

__all__ = ["Block", "LayerCaches", "block_forward", "init_block_params",
           "init_layer_caches", "run_blocks", "stack_init"]


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported: the port serves kind 'ssm' "
        "(mamba2); attention, MoE, hybrid and cross blocks are ROADMAP A12")


class LayerCaches(NamedTuple):
    """Per-stack decode caches (leaves stacked on a leading layer axis)."""

    kv: None
    ssm: SSMState | None


class Block(nn.Module):
    """One ``"ssm"`` block: ``ln1`` and the mixer ``ssm``."""

    def __init__(self, ln1: torch.Tensor, mixer: ssm_mod.SSMMixer):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ssm = mixer


def init_block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Block:
    if kind != "ssm":
        raise _unported(kind)
    ln1 = torch.ones((cfg.d_model,), device=gen.device)
    return Block(ln1, ssm_mod.init_ssm_params(gen, cfg))


def block_forward(p: Block, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                  ssm_state: SSMState | None = None
                  ) -> tuple[torch.Tensor, SSMState | None]:
    """Returns (x, new_ssm).  The reference's kv, ctx and aux-loss outputs
    belong to the attention and MoE kinds (ROADMAP A12)."""
    if kind != "ssm":
        raise _unported(kind)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    s_out, new_ssm = ssm_mod.ssm_forward(p.ssm, cfg, h, ssm_state)
    return x + s_out, new_ssm


def stack_init(gen: torch.Generator, n_layers: int, cfg: ModelConfig,
               kind: str) -> nn.ModuleList:
    """``n_layers`` blocks drawn one after another from ``gen``."""
    return nn.ModuleList(init_block_params(gen, cfg, kind) for _ in range(n_layers))


def run_blocks(stack: nn.ModuleList, cfg: ModelConfig, kind: str, x: torch.Tensor,
               *, caches: LayerCaches | None = None
               ) -> tuple[torch.Tensor, LayerCaches | None]:
    """Run a homogeneous stack layer by layer (the reference's
    ``scan_blocks``).  Returns (x, new_caches); new caches are new tensors,
    the given ones are left as they were."""
    if kind != "ssm":
        raise _unported(kind)
    states, convs = [], []
    for i, block in enumerate(stack):
        st = (SSMState(caches.ssm.state[i], caches.ssm.conv[i])
              if caches is not None else None)
        x, new = block_forward(block, cfg, kind, x, ssm_state=st)
        if new is not None:
            states.append(new.state)
            convs.append(new.conv)
    if caches is None:
        return x, None
    return x, LayerCaches(kv=None, ssm=SSMState(torch.stack(states),
                                                torch.stack(convs)))


def init_layer_caches(cfg: ModelConfig, n_layers: int, kind: str, batch: int,
                      max_len: int, dtype=torch.bfloat16,
                      device=None) -> LayerCaches:
    """Stacked decode caches for one homogeneous group on ``device``
    (``None``: the card).  ``max_len`` sizes a KV cache; an SSM state is
    O(1) in length."""
    device = resolve_device(device)
    if kind != "ssm":
        raise _unported(kind)
    one = ssm_mod.init_ssm_state(cfg, batch, dtype, device=device)
    return LayerCaches(kv=None, ssm=SSMState(
        state=one.state.expand((n_layers,) + one.state.shape).contiguous(),
        conv=one.conv.expand((n_layers,) + one.conv.shape).contiguous()))
