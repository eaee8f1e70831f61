"""Generation engine: prefill + decode loop over the model's cache API —
port of ``repro.serve.engine`` in its plain mode.

The model's parameters fix the device: a prompt batch (numpy, host) is
range-checked and uploaded by the first prefill's embedding gather (kernel
B9), a mamba2 chunk-multiple prefill runs the fused scan (kernel B8), an
attention model fills its KV caches, and each decode step feeds the
previous step's argmax, still on the device, back through B9.  PyTorch
runs eagerly, so there is no compiled step to reuse (ROADMAP A20).  The
families served are the model's: ``"dense"`` and ``"ssm"``.

The reference's fused kernel-service mode (MoE combines through the
service's slot loop) needs the MoE families: it raises
``NotImplementedError`` (ROADMAP A12.2), as do ``extras`` (the vision and
enc-dec families' ``ctx_embeds``, A12.3) and a ``mesh`` (A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["GenerationConfig", "ServeEngine", "sample_token"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no truncation
    eos_id: int = -1              # -1 = never stop early
    cache_len: int = 4096
    dtype: Any = torch.float32


def sample_token(logits: torch.Tensor, gen: torch.Generator | None,
                 gcfg: GenerationConfig) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 on the logits' device.  Greedy at
    temperature 0; otherwise a categorical draw from ``gen`` (on the
    logits' device) over the temperature-scaled, top-k-truncated logits."""
    if gcfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / gcfg.temperature
    if gcfg.top_k:
        kth = torch.topk(logits, gcfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: M.LM, gcfg: GenerationConfig,
                 mesh=None, kernel_service=None, moe_operand: str | None = None,
                 dispatch_spec=None):
        """Plain mode only: ``mesh`` is ROADMAP A10 and the fused
        kernel-service mode (``kernel_service``, ``moe_operand``,
        ``dispatch_spec``) is A12.2; either raises."""
        if mesh is not None:
            raise NotImplementedError("mesh: multi-device serving is ROADMAP A10")
        if kernel_service is not None or moe_operand is not None \
                or dispatch_spec is not None:
            raise NotImplementedError(
                "fused kernel-service mode serves the MoE families, which are "
                "ROADMAP A12.2; construct the engine without kernel_service")
        self.cfg = cfg
        self.params = params
        self.gcfg = gcfg

    def generate(self, prompts: np.ndarray, extras: dict | None = None,
                 seed: int = 0) -> np.ndarray:
        """Greedy/sampled continuation for a (B, S) prompt batch; returns
        (B, n_new) int32 on the host."""
        if extras:
            raise NotImplementedError(
                "extras (ctx_embeds) feed the vision and enc-dec families, "
                "ROADMAP A12.3")
        cfg, gcfg = self.cfg, self.gcfg
        dev = self.params.device
        b = prompts.shape[0]
        caches = M.init_caches(cfg, b, max_len=gcfg.cache_len, dtype=gcfg.dtype,
                               device=dev)
        logits, caches = M.prefill(self.params, cfg,
                                   {"tokens": np.asarray(prompts)}, caches,
                                   dtype=gcfg.dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = sample_token(logits[:, -1], gen, gcfg)
        out = [tok]
        done = tok == gcfg.eos_id
        for _ in range(1, gcfg.max_new_tokens):
            logits, caches = M.decode_step(self.params, cfg, tok[:, None], caches,
                                           dtype=gcfg.dtype)
            tok = sample_token(logits, gen, gcfg)
            tok = torch.where(done, gcfg.eos_id, tok)
            out.append(tok)
            done = done | (tok == gcfg.eos_id)
            if gcfg.eos_id >= 0 and bool(done.all()):
                break
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
