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
with its backward kernel.  Both take float32 / float64 only: a bf16
embedding table (``param_dtype=torch.bfloat16``) is cast to float32 before
B9, one copy (:func:`repro_torch.models.model._embed`), and the mixer's
scan inputs are float32 whatever ``dtype`` is.  ``dtype`` defaults to
float32 (the reference's default is bf16 for the TPU's matrix units; the
port's CLI trains in float32 on the card and the CPU alike).

The MoE combine runs on the dense path under a gradient (kernel B1 has no
backward), as in the reference's jitted step.  The update is in place
(:func:`repro_torch.optim.adamw.adamw_update`): ``train_step`` returns a
new :class:`TrainState` holding the same, updated, parameter tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import model as M
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
    params: M.LM
    opt: dict
    comp: CompressionState | None
    step: int


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, params: M.LM | None = None
                     ) -> TrainState:
    """A fresh state: trainable parameters drawn from ``gen`` on its device
    (or ``params``, made trainable), AdamW's state, the compression
    residuals where the config compresses."""
    if params is None:
        params = M.init_params(gen, cfg, trainable=True)
    params.requires_grad_(True)
    opt = adamw_init(params.named_parameters(),
                     keep_master=tcfg.param_dtype is not None)
    if tcfg.param_dtype is not None:
        params.to(tcfg.param_dtype)
    named = dict(params.named_parameters())
    return TrainState(params=params, opt=opt,
                      comp=compression_init(named) if tcfg.compress_grads else None,
                      step=0)


def _split(x, a: int):
    """The ``a`` microbatches of ``x`` (numpy or a tensor), a leading split."""
    if x.shape[0] % a:
        raise ValueError(f"batch of {x.shape[0]} does not split into {a} "
                         "microbatches")
    m = x.shape[0] // a
    return [x[i * m:(i + 1) * m] for i in range(a)]


def loss_and_grads(params: M.LM, cfg: ModelConfig, tcfg: TrainConfig,
                   batch: dict) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One microbatch: (gradients of ``loss + aux_weight * aux`` by
    parameter name, zero for a parameter the loss does not reach; the mean
    token cross-entropy; the MoE aux loss), the last two detached."""
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
    for the vision and enc-dec families), numpy or tensors.  With
    ``accum_steps`` > 1, B must divide evenly.  ``metrics``: 0-d tensors
    ``loss``, ``aux``, ``grad_norm``, ``lr``.
    """

    def train_step(state: TrainState, batch: dict):
        params = state.params
        named = dict(params.named_parameters())
        a = tcfg.accum_steps
        if a <= 1:
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

        _, new_opt, om = adamw_update(grads, state.opt, named, tcfg.optimizer,
                                      decay=decay_mask(named))
        del grads
        metrics = {"loss": loss, "aux": aux, "grad_norm": om["grad_norm"],
                   "lr": om["lr"]}
        return TrainState(params, new_opt, comp, state.step + 1), metrics

    return train_step
