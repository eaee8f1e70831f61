"""AdamW with global-norm clipping over the port's parameters — port of
``repro.optim.adamw``.

Parameters are a dict of name -> tensor (an :class:`~repro_torch.models
.model.LM`'s ``named_parameters()`` fits); the optimizer state mirrors
them: float32 moments ``m`` and ``v``, the step count, and with
``keep_master`` a float32 master copy (mixed precision: bf16 model
parameters, the update applied to the master, the parameters its cast).
The reference's arithmetic: float32 moments, bias corrections from
``b ** step`` in float32, the clip scale ``min(1, max_norm / max(norm,
1e-9))``.

The update is made in place (the parameters, moments and master are
rewritten; PyTorch allows it where JAX's arrays are immutable): at
mamba2-2.7b's 11.3 GB of parameters a second copy of each would not fit
one card beside the moments.

Weight decay follows the reference's rule, ``p.ndim >= 2`` on the
*reference's* leaf, whose stacked blocks carry a leading layer axis (two
for the vision self blocks): every parameter of a stacked block is
decayed, norms, ``A_log``, ``dt_bias``, ``D`` and biases among them, while
DeepSeek's unstacked ``dense0`` and the top-level 1-D norms are not.
:func:`decay_mask` reads that rank from
:func:`repro_torch.models.convert.reference_rank` (on a mesh, from the
leaf's global shape).

**On a mesh** (placed parameters, :class:`~repro_torch.models.sharding
.PlacedParams`) the state is placed too: :func:`adamw_init` makes ``m``,
``v`` and any ``master`` by the moments' specs
(:func:`repro_torch.launch.specs.moment_shardings`: ZeRO-1 over ``data``),
so no device holds more than its share of them.  :func:`adamw_update`
takes the gradients reduced and cut by those specs (one piece a block,
:func:`~repro_torch.models.sharding.reduce_grads`): each block of the
moments is updated once, on its first device, with the clip scale of the
global norm
(each block counted once), its replicas then copied from it; the new
parameter blocks are copied into every piece that holds them (the
all-gather of ZeRO-1).  The arithmetic a value is the unsharded one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import sharding as shrd
from repro_torch.models.convert import reference_rank

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "decay_mask", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr_at(self, step) -> torch.Tensor:
        """The learning rate at ``step`` as a 0-d float32 tensor."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        return torch.as_tensor(lr, dtype=torch.float32)


def _named(params) -> dict:
    if isinstance(params, (dict, shrd.PlacedParams)):
        return dict(params.items())
    return dict(params)


def decay_mask(params) -> dict[str, bool]:
    """name -> whether AdamW decays it: the reference's ``ndim >= 2`` on
    the reference leaf that holds the parameter (its layer axes counted)."""
    return {k: reference_rank(k, v.shape) >= 2 for k, v in _named(params).items()}


def adamw_init(params, keep_master: bool = False,
               specs: dict | None = None) -> dict:
    """Optimizer state: zero float32 ``m`` / ``v`` per parameter, ``step``
    0 and, with ``keep_master``, a float32 ``master`` copy.  Placed
    parameters take their state placed by ``specs`` (name -> spec; default
    the parameters' own)."""
    if isinstance(params, shrd.PlacedParams):
        return _init_placed(params, keep_master, specs)
    params = _named(params)
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in params.items()}
    state = {"m": zeros,
             "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
             "step": 0}
    if keep_master:
        state["master"] = {k: v.detach().to(torch.float32, copy=True)
                           for k, v in params.items()}
    return state


def _init_placed(params: shrd.PlacedParams, keep_master: bool,
                 specs: dict | None) -> dict:
    leaves = dict(params.items())
    specs = specs or {k: leaf.spec for k, leaf in leaves.items()}

    def zeros():
        return {k: shrd.zeros(leaf.shape, specs[k], leaf.mesh, torch.float32)
                for k, leaf in leaves.items()}

    state = {"m": zeros(), "v": zeros(), "step": 0}
    if keep_master:
        state["master"] = {k: shrd.cut(leaf, specs[k], torch.float32)
                           for k, leaf in leaves.items()}
    return state


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (reduced
    placed leaves: each block once, :func:`repro_torch.models.sharding
    .global_norm`)."""
    leaves = list(tree.values())
    if leaves and isinstance(leaves[0], shrd.Sharded):
        return shrd.global_norm(tree)
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """The leaves scaled by ``min(1, max_norm / max(norm, 1e-9))`` (new
    tensors), and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, cfg: AdamWConfig, *,
                 decay: dict[str, bool] | None = None
                 ) -> tuple[dict, dict, dict]:
    """One AdamW step, in place.  ``grads`` and ``params`` share their
    names; ``decay`` is :func:`decay_mask` of the parameters unless given.
    On placed state a gradient reduced by its parameter's spec
    (:func:`~repro_torch.train.step.loss_and_grads`) is cut to its
    moments' ZeRO-1 blocks first.
    Returns (params, opt_state, metrics ``{"grad_norm", "lr"}``), the
    same parameter and state tensors, updated."""
    placed = isinstance(params, shrd.PlacedParams)
    named = _named(params)
    decay = decay_mask(named) if decay is None else decay
    gnorm = global_norm(grads)
    # clip_by_global_norm's scale, applied leaf by leaf below (a clipped
    # copy of every gradient at once would not fit the card beside them)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm else None)
    step = opt_state["step"] + 1
    lr = cfg.lr_at(step)
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf
    masters = opt_state.get("master")
    scalars: dict = {}         # (scale, lr, bc1, bc2) on each device, once

    def on(device):
        if device not in scalars:
            scalars[device] = [None if t is None else t.to(device)
                               for t in (scale, lr, bc1, bc2)]
        return scalars[device]

    def update(g, m, v, base, decayed: bool) -> torch.Tensor:
        """One tensor's update in place of ``m`` / ``v``: the new value."""
        scale_d, lr_d, bc1_d, bc2_d = on(m.device)
        g = g.float()
        if scale_d is not None:
            g = g * scale_d
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
        if decayed:
            delta = delta + cfg.weight_decay * base
        return base - lr_d * delta

    for k, p in named.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        if not placed:
            new = update(grads[k], m, v,
                         masters[k] if masters is not None else p.float(), decay[k])
            if masters is not None:
                masters[k].copy_(new)
            p.copy_(new.to(p.dtype))
            continue
        # each block of the moments once, on its first device
        g = shrd.recut(grads[k], m.spec)
        new = shrd.Sharded.empty(p.mesh, m.spec, p.shape)
        for coord, mb in shrd.leads(m):
            base = (masters[k].pieces[coord] if masters is not None else
                    p.pieces[coord][shrd.refine_slices(m, p, coord)].float())
            nb = update(g.pieces[coord], mb, v.pieces[coord], base,
                        decay[k])
            if masters is not None:
                masters[k].pieces[coord].copy_(nb)
            new.pieces[coord] = nb.to(p.dtype)
        for state in (m, v) + ((masters[k],) if masters is not None else ()):
            shrd.write_blocks(state, state)
        shrd.write_blocks(p, new)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
