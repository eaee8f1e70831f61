"""LR schedules: cosine, constant, and MiniCPM's WSD (warmup-stable-decay)
— port of ``repro.optim.schedules``.

Each schedule is a function of the step, a Python int or a 0-d tensor,
returning a 0-d float32 tensor (on the step's device), computed in float32
as the reference computes it.

WSD (arXiv:2404.06395 §4): linear warmup -> long stable plateau -> short
exponential decay tail; the schedule the minicpm-2b arch trains with.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_schedule", "wsd_schedule"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return f


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """Warmup-Stable-Decay: the tail decays exponentially to floor*peak."""

    def f(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        tail_prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        tail = peak_lr * torch.exp(math.log(floor) * tail_prog)
        out = torch.where(step < warmup, warm, torch.full_like(step, peak_lr))
        return torch.where(step > warmup + stable, tail, out)

    return f
