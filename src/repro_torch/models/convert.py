"""Move the JAX package's parameters into the port's modules.

:func:`params_from_reference` takes the reference's parameter pytree as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``: stacked
blocks carry a leading layer axis) and builds the port's :class:`~repro_torch
.models.model.LM` with the same values on ``device``.  The parity tests
use it so that both packages compute with the same weights; nothing here
imports ``jax`` or ``repro``.

:func:`reference_path` maps a parameter's name in the port back to its
reference leaf and the index into that leaf's leading layer axes;
:func:`reference_rank` is that leaf's rank, which the reference's AdamW
reads to choose what to decay (:func:`repro_torch.optim.adamw.decay_mask`).
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
from repro_torch.models.model import LM, decoder_layer

__all__ = ["params_from_reference", "reference_path", "reference_rank"]


def reference_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The reference leaf of the port's parameter ``name`` (a
    ``named_parameters()`` name of an :class:`LM`): (its keys in the
    reference's pytree, its index into the leaf's stacked layer axes).
    ``blocks.3.ssm.in_proj`` is ``(("blocks", "ssm", "in_proj"), (3,))``,
    ``self_blocks.1.2.attn.wq`` is ``(("self_blocks", "attn", "wq"), (1,
    2))`` (group, layer), ``decoder.0.cross.ln1`` is ``(("decoder",
    "cross", "ln1"), (0,))``; ``dense0`` and the top-level leaves carry no
    index."""
    parts = name.split(".")
    return (tuple(k for k in parts if not k.isdigit()),
            tuple(int(k) for k in parts if k.isdigit()))


def reference_rank(name: str, shape) -> int:
    """The rank of the reference leaf that holds the port's parameter
    ``name`` of ``shape``: its own rank plus its stacked layer axes."""
    return len(shape) + len(reference_path(name)[1])


def params_from_reference(tree: dict, cfg: ModelConfig, device=None, *,
                          trainable: bool = False) -> LM:
    """The reference's ``init_params`` pytree (numpy leaves) as an
    :class:`LM` on ``device`` (``None``: the card).  Each block subtree
    holds ``ln1``, then whichever of its kind's leaves it has: ``attn.{wq,
    wk, wv, wo}`` with ``bq / bk / bv`` and ``q_norm / k_norm`` where the
    config has them, ``ssm.*``, ``ln2`` with ``mlp.{w_gate, w_up, w_down}``
    or ``moe.{router, experts_gate, experts_up, experts_down}`` and
    ``moe.shared.{w_gate, w_up, w_down}``.  The stacks by family:
    ``blocks`` (each leaf stacked on the layer axis) and DeepSeek's
    ``dense0`` (one block, unstacked); vision: ``self_blocks`` (two
    leading axes, group and layer), ``cross_blocks`` and ``ctx_proj``;
    enc-dec: ``encoder``, ``enc_norm`` and ``decoder.{self, cross}``.  The
    layer counts are checked against ``cfg``.  Every parameter requires
    grad when ``trainable``."""
    return _from_reference(tree, cfg, device).requires_grad_(trainable)


def _from_reference(tree: dict, cfg: ModelConfig, device) -> LM:
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    def count(stacked: dict, axis: int = 0) -> int:
        return np.asarray(stacked["ln1"]).shape[axis]

    def check(name: str, got: int, want: int) -> None:
        if got != want:
            raise ValueError(f"the tree stacks {got} {name}; {cfg.name} has "
                             f"{want}")

    def mlp(leaves: dict) -> MLP:
        return MLP(t(leaves["w_gate"]), t(leaves["w_up"]), t(leaves["w_down"]))

    def block(leaves: dict) -> blk.Block:
        kw = {}
        if "attn" in leaves:
            kw["attn"] = attn_mod.Attention(
                {k: t(v) for k, v in leaves["attn"].items()})
        if "ssm" in leaves:
            kw["ssm"] = ssm_mod.SSMMixer({k: t(v) for k, v in leaves["ssm"].items()})
        if "ln2" in leaves:
            kw["ln2"] = t(leaves["ln2"])
        if "mlp" in leaves:
            kw["mlp"] = mlp(leaves["mlp"])
        if "moe" in leaves:
            m = leaves["moe"]
            kw["moe"] = moe_mod.MoE(t(m["router"]), t(m["experts_gate"]),
                                    t(m["experts_up"]), t(m["experts_down"]),
                                    mlp(m["shared"]) if "shared" in m else None)
        return blk.Block(t(leaves["ln1"]), **kw)

    def stack(stacked: dict) -> nn.ModuleList:
        return nn.ModuleList(block(blk.layer_of(stacked, i))
                             for i in range(count(stacked)))

    head = tree.get("lm_head")
    common = (t(tree["tok_embed"]), t(tree["final_norm"]),
              None if head is None else t(head))
    if cfg.encdec is not None:
        check("encoder blocks", count(tree["encoder"]), cfg.encdec.encoder_layers)
        dec = tree["decoder"]
        check("decoder layers", count(dec["self"]), cfg.n_layers)
        decoder = nn.ModuleList(
            decoder_layer(block(blk.layer_of(dec["self"], i)),
                          block(blk.layer_of(dec["cross"], i)))
            for i in range(cfg.n_layers))
        return LM(*common, None, encoder=stack(tree["encoder"]),
                  enc_norm=t(tree["enc_norm"]), decoder=decoder)
    if cfg.cross_attn is not None and cfg.cross_attn.every:
        selfs, every = tree["self_blocks"], cfg.cross_attn.every
        n_groups = cfg.n_layers // every
        check("self-attention groups", count(selfs), n_groups)
        check("blocks a group", count(selfs, 1), every)
        check("cross blocks", count(tree["cross_blocks"]), n_groups)
        proj = tree.get("ctx_proj")
        return LM(*common, None,
                  self_blocks=nn.ModuleList(stack(blk.layer_of(selfs, g))
                                            for g in range(n_groups)),
                  cross_blocks=stack(tree["cross_blocks"]),
                  ctx_proj=None if proj is None else t(proj))
    check("blocks", count(tree["blocks"]),
          cfg.n_layers - (1 if "dense0" in tree else 0))
    dense0 = block(tree["dense0"]) if "dense0" in tree else None
    return LM(*common, stack(tree["blocks"]), dense0)
