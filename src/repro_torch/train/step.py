"""Train-step builder: loss, gradient, microbatch accumulation, optimizer —
port of ``repro.train.step``.

* **remat** (None | ``"dots"`` | ``"full"``) wraps each block of the
  forward (:func:`repro_torch.models.blocks.remat_call`);
* **grad accumulation**: ``accum_steps`` microbatches, the leading split of
  the batch, their gradients summed in float32 and averaged;
* **int8 compression** (optional): quantize with error feedback and
  dequantize, as the reference's single-process step does
  (:mod:`repro_torch.optim.compression`);
* **mixed precision**: ``param_dtype`` stores the model's parameters in
  that dtype with a float32 master in the optimizer state; activations run
  in ``dtype``, the loss and softmax in float32.

On the card the forward and the backward run kernels B8 (every mamba2
mixer of a chunk-multiple sequence) and B9 (the token embedding), each
with its backward kernel.  Both have bf16 forms: a bf16 embedding table
(``param_dtype=torch.bfloat16``) is gathered as it is, its gradient summed
in float32 from the float32 output gradients and rounded once
(:func:`repro_torch.models.model._embed`: no float32 copy of the table),
and the mixer's scan inputs are float32, or xd / B / C in bf16 beside
float32 ad under :data:`repro_torch.models.ssm.SSD_BF16`, whatever
``dtype`` is.  ``dtype`` defaults to
float32 (the reference's default is bf16 for the TPU's matrix units; the
port's CLI trains in float32 on the card and the CPU alike).

The MoE combine runs on the dense path under a gradient (kernel B1 has no
backward), as in the reference's jitted step.  The update is in place
(:func:`repro_torch.optim.adamw.adamw_update`): ``train_step`` returns a
new :class:`TrainState` holding the same, updated, parameter tensors.

**On a mesh** (parameters placed on a ``(data, model)`` or ``(pod, data,
model)`` mesh: :func:`init_train_state` with ``mesh=``) the batch splits
over the data replicas as ``batch_shardings`` says
(:func:`~repro_torch.models.sharding.place_batch`: the tokens, the labels
and the vision and enc-dec families' ``ctx_embeds``; ``accum_steps``
splits each replica's share), each replica's logits land on its lead, and the
loss is the token-weighted mean over the replicas: Σ (a replica's mean x
its token count) / the global count (the mean of replica means would be
wrong where the counts differ); the aux loss is the replicas' mean (the
reference's is a mean over batch rows, which split evenly).  The backward
gives every piece its gradient; :func:`~repro_torch.models.sharding
.reduce_grads` sums the pieces of each block once a step (after the
microbatches), each data replica its ZeRO-1 rows (the moments' specs),
and the update runs block by block (:mod:`repro_torch.optim.adamw`).
With one data replica the loss is that replica's mean, the unsharded
step's expression.  Under ``launch.specs.FSDP_PARAMS`` the parameters'
blocks are the moments' ZeRO-1 blocks: each replica's forward gathers
them (:meth:`~repro_torch.models.sharding.Sharded.local`), the backward
sums every replica's gradient into each block's one piece, and the update
writes each block in place; ``SEQ_SHARD_FALLBACK`` and ``ATTN_KV_CHUNK``
apply to the training forward (no cache) as to a prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.optim import (
    AdamWConfig,
    CompressionState,
    adamw_init,
    adamw_update,
    compress_tree,
    compression_init,
    decay_mask,
    decompress_tree,
)

__all__ = ["TrainConfig", "TrainState", "init_train_state", "loss_and_grads",
           "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: str | None = "dots"
    accum_steps: int = 1
    dtype: Any = torch.float32
    aux_weight: float = 0.01       # MoE load-balance loss weight
    compress_grads: bool = False
    # store model params in this dtype with an f32 master copy in the
    # optimizer state (None = f32 params, no master)
    param_dtype: Any = None


class TrainState(NamedTuple):
    params: M.LM | shrd.PlacedParams
    opt: dict
    comp: CompressionState | None
    step: int


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, params=None, *, mesh=None
                     ) -> TrainState:
    """A fresh state: trainable parameters drawn from ``gen`` on its device
    (or ``params``, made trainable), AdamW's state, the compression
    residuals where the config compresses.  With ``mesh`` (or placed
    ``params``) the parameters are born sharded on it and the rest of the
    state is placed by :func:`repro_torch.launch.specs.state_shardings`."""
    if params is None:
        params = M.init_params(gen, cfg, trainable=True, mesh=mesh)
    params.requires_grad_(True)
    keep = tcfg.param_dtype is not None
    if isinstance(params, shrd.PlacedParams):
        specs = S.moment_shardings(params.mesh, cfg, params)
        opt = adamw_init(params, keep_master=keep, specs=specs)
        comp = compression_init(params, specs) if tcfg.compress_grads else None
    else:
        opt = adamw_init(params.named_parameters(), keep_master=keep)
        comp = (compression_init(dict(params.named_parameters()))
                if tcfg.compress_grads else None)
    if keep:
        params.to(tcfg.param_dtype)
    return TrainState(params=params, opt=opt, comp=comp, step=0)


def _named(params) -> dict:
    if isinstance(params, shrd.PlacedParams):
        return dict(params.items())
    return dict(params.named_parameters())


def _split(x, a: int):
    """The ``a`` microbatches of ``x`` (numpy or a tensor), a leading split."""
    if x.shape[0] % a:
        raise ValueError(f"batch of {x.shape[0]} does not split into {a} "
                         "microbatches")
    m = x.shape[0] // a
    return [x[i * m:(i + 1) * m] for i in range(a)]


def _placed_loss(params: shrd.PlacedParams, cfg: ModelConfig,
                 tcfg: TrainConfig, shares: list):
    """(``loss + aux_weight * aux``, loss, aux) of the replicas' shares
    (:func:`~repro_torch.models.sharding.place_batch`), on the mesh's first
    device: the token-weighted mean over the replicas."""
    outs = M.forward_replicas(params, cfg, shares, dtype=tcfg.dtype,
                              remat=tcfg.remat)
    dev = params.device
    losses, counts = [], []
    for (_, b), (logits, _) in zip(shares, outs):
        loss, _ = softmax_cross_entropy(logits, b["labels"])
        losses.append(loss)
        counts.append((b["labels"] != -1).sum())
    if len(shares) == 1:
        loss = losses[0].to(dev)
    else:
        n = torch.clamp(shrd.sum_on(counts, dev), min=1)
        loss = shrd.sum_on([l * c for l, c in zip(losses, counts)], dev) / n
    aux = shrd.sum_on([a for _, a in outs], dev) / len(outs)
    return loss + tcfg.aux_weight * aux, loss, aux


def _placed_loss_and_grads(params: shrd.PlacedParams, cfg: ModelConfig,
                           tcfg: TrainConfig, batch, accum: int = 1,
                           specs: dict | None = None):
    """The gradients of ``accum`` microbatches (each replica's share split
    in ``accum``), averaged, reduced to one piece a block of ``specs``
    (name -> spec; default the parameters'): (name ->
    :class:`~repro_torch.models.sharding.Sharded`, loss, aux)."""
    shares = (batch if isinstance(batch, list)
              else shrd.place_batch(batch, params.mesh))
    leaves = list(params.items())
    coords = [(k, c) for k, leaf in leaves for c in np.ndindex(leaf.pieces.shape)]
    tensors = params.pieces()                    # in the order of coords
    acc, lsum, xsum = None, 0.0, 0.0
    for i in range(accum):
        micro = [(row, {k: _split(v, accum)[i] for k, v in b.items()})
                 for row, b in shares]
        total, loss, aux = _placed_loss(params, cfg, tcfg, micro)
        gs = torch.autograd.grad(total, tensors, allow_unused=True)
        if accum == 1:
            acc = list(gs)
        elif acc is None:
            acc = [None if g is None else g.float() for g in gs]
        else:
            acc = [a if g is None else g.float() if a is None else a + g
                   for a, g in zip(acc, gs)]
        lsum, xsum = lsum + loss.detach(), xsum + aux.detach()
    if accum > 1:
        acc = [None if g is None else g / accum for g in acc]
    per_leaf: dict = {k: {} for k, _ in leaves}
    for (k, c), g in zip(coords, acc):
        per_leaf[k][c] = g
    grads = {k: shrd.reduce_grads(leaf, per_leaf[k],
                                  None if specs is None else specs[k])
             for k, leaf in leaves}
    return grads, lsum / accum, xsum / accum


def loss_and_grads(params, cfg: ModelConfig, tcfg: TrainConfig,
                   batch) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One microbatch: (gradients of ``loss + aux_weight * aux`` by
    parameter name, zero for a parameter the loss does not reach; the mean
    token cross-entropy; the MoE aux loss), the last two detached.  Placed
    parameters: the batch split over the data replicas (or already split,
    :func:`~repro_torch.models.sharding.place_batch`), each gradient a
    reduced :class:`~repro_torch.models.sharding.Sharded` (one piece a
    block, ``.full()`` the whole)."""
    if isinstance(params, shrd.PlacedParams):
        return _placed_loss_and_grads(params, cfg, tcfg, batch)
    named = dict(params.named_parameters())
    logits, aux = M.forward(params, cfg, batch, dtype=tcfg.dtype,
                            remat=tcfg.remat)
    loss, _ = softmax_cross_entropy(logits, batch["labels"])
    total = loss + tcfg.aux_weight * aux
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    return ({k: g if g is not None else torch.zeros_like(p)
             for (k, p), g in zip(named.items(), grads)},
            loss.detach(), aux.detach())


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens": (B, S), "labels": (B, S)}`` (+ ``ctx_embeds``
    for the vision and enc-dec families), numpy or tensors; on a mesh also
    :func:`~repro_torch.models.sharding.place_batch`'s split.  With
    ``accum_steps`` > 1, B (on a mesh, each replica's share) must divide
    evenly.  ``metrics``: 0-d tensors ``loss``, ``aux``, ``grad_norm``,
    ``lr``.
    """

    def train_step(state: TrainState, batch):
        params = state.params
        named = _named(params)
        a = tcfg.accum_steps
        if isinstance(params, shrd.PlacedParams):
            grads, loss, aux = _placed_loss_and_grads(
                params, cfg, tcfg, batch, max(a, 1),
                {k: m.spec for k, m in state.opt["m"].items()})
        elif a <= 1:
            grads, loss, aux = loss_and_grads(params, cfg, tcfg, batch)
        else:
            micros = [dict(zip(batch, vals)) for vals in
                      zip(*(_split(v, a) for v in batch.values()))]
            grads, lsum, xsum = None, 0.0, 0.0
            for micro in micros:
                g, loss_i, aux_i = loss_and_grads(params, cfg, tcfg, micro)
                grads = ({k: v.float() for k, v in g.items()} if grads is None
                         else {k: grads[k] + g[k] for k in grads})
                lsum, xsum = lsum + loss_i, xsum + aux_i
            grads = {k: g / a for k, g in grads.items()}
            loss, aux = lsum / a, xsum / a

        comp = state.comp
        if tcfg.compress_grads and comp is not None:
            q, scales, comp = compress_tree(grads, comp)
            grads = decompress_tree(q, scales, n_replicas=1)

        placed = isinstance(params, shrd.PlacedParams)
        _, new_opt, om = adamw_update(grads, state.opt,
                                      params if placed else named,
                                      tcfg.optimizer, decay=decay_mask(named))
        del grads
        metrics = {"loss": loss, "aux": aux, "grad_norm": om["grad_norm"],
                   "lr": om["lr"]}
        return TrainState(params, new_opt, comp, state.step + 1), metrics

    return train_step
