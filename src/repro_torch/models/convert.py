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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, _check_family

__all__ = ["params_from_reference"]


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``init_params`` pytree (numpy leaves) as an
    :class:`LM` on ``device`` (``None``: the card).  The families the
    port's model runs: ``"ssm"`` (``ln1``, ``ssm.*``) and ``"dense"``
    (``ln1``, ``attn.{wq, wk, wv, wo}`` with ``bq / bk / bv`` and ``q_norm
    / k_norm`` where the config has them, ``ln2``, ``mlp.{w_gate, w_up,
    w_down}``), each leaf stacked on the layer axis."""
    _check_family(cfg)
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    stacked = tree["blocks"]
    n_layers = np.asarray(stacked["ln1"]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"the tree stacks {n_layers} blocks; {cfg.name} has "
                         f"{cfg.n_layers}")

    def layer(group: str, i: int) -> dict:
        return {k: t(v[i]) for k, v in stacked[group].items()}

    def block(i: int) -> blk.Block:
        ln1 = t(stacked["ln1"][i])
        if "ssm" in stacked:
            return blk.Block(ln1, ssm=ssm_mod.SSMMixer(layer("ssm", i)))
        m = layer("mlp", i)
        return blk.Block(ln1, attn=attn_mod.Attention(layer("attn", i)),
                         ln2=t(stacked["ln2"][i]),
                         mlp=blk.MLP(m["w_gate"], m["w_up"], m["w_down"]))

    blocks = nn.ModuleList(block(i) for i in range(n_layers))
    head = tree.get("lm_head")
    return LM(t(tree["tok_embed"]), t(tree["final_norm"]),
              None if head is None else t(head), blocks)
