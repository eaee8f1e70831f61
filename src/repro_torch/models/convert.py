"""Move the JAX package's parameters into the port's modules.

:func:`params_from_reference` takes the reference's parameter pytree as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``: stacked
blocks carry a leading layer axis) and builds the port's :class:`~repro_torch
.models.model.LM` with the same values on ``device``.  The parity tests
use it so that both packages compute with the same weights; nothing here
imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP
from repro_torch.models.model import LM, _check_family

__all__ = ["params_from_reference"]


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``init_params`` pytree (numpy leaves) as an
    :class:`LM` on ``device`` (``None``: the card).  The families the
    port's model runs: ``"ssm"`` (``ln1``, ``ssm.*``), ``"dense"`` (``ln1``,
    ``attn.{wq, wk, wv, wo}`` with ``bq / bk / bv`` and ``q_norm /
    k_norm`` where the config has them, ``ln2``, ``mlp.{w_gate, w_up,
    w_down}``) and ``"moe"`` (``mlp`` replaced by ``moe.{router,
    experts_gate, experts_up, experts_down}`` and ``moe.shared.{w_gate,
    w_up, w_down}`` where the config has shared experts), each leaf
    stacked on the layer axis; DeepSeek's ``dense0`` subtree (one dense
    block, unstacked) too."""
    _check_family(cfg)
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    stacked = tree["blocks"]
    n_layers = np.asarray(stacked["ln1"]).shape[0]
    want = cfg.n_layers - (1 if "dense0" in tree else 0)
    if n_layers != want:
        raise ValueError(f"the tree stacks {n_layers} blocks; {cfg.name} has "
                         f"{want}")

    def mlp(leaves: dict) -> MLP:
        return MLP(t(leaves["w_gate"]), t(leaves["w_up"]), t(leaves["w_down"]))

    def block(leaves: dict) -> blk.Block:
        ln1 = t(leaves["ln1"])
        if "ssm" in leaves:
            return blk.Block(ln1, ssm=ssm_mod.SSMMixer(
                {k: t(v) for k, v in leaves["ssm"].items()}))
        attn = attn_mod.Attention({k: t(v) for k, v in leaves["attn"].items()})
        if "moe" in leaves:
            m = leaves["moe"]
            shared = mlp(m["shared"]) if "shared" in m else None
            return blk.Block(ln1, attn=attn, ln2=t(leaves["ln2"]),
                             moe=moe_mod.MoE(t(m["router"]), t(m["experts_gate"]),
                                             t(m["experts_up"]),
                                             t(m["experts_down"]), shared))
        return blk.Block(ln1, attn=attn, ln2=t(leaves["ln2"]),
                         mlp=mlp(leaves["mlp"]))

    blocks = nn.ModuleList(block(blk.layer_of(stacked, i))
                           for i in range(n_layers))
    dense0 = block(tree["dense0"]) if "dense0" in tree else None
    head = tree.get("lm_head")
    return LM(t(tree["tok_embed"]), t(tree["final_norm"]),
              None if head is None else t(head), blocks, dense0)
