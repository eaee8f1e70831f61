"""Top-level model — port of ``repro.models.model`` for the stacked-block
families, of which families ``"dense"`` (llama-3.2-3b, qwen2-1.5b,
qwen3-14b, minicpm-2b), ``"moe"`` (mixtral-8x7b, deepseek-moe-16b, with
DeepSeek's dense first layer ``dense0``) and ``"ssm"`` (mamba2) are
ported.

Public surface (the reference's, with an ``nn.Module`` for the pytree):
  init_params(gen, cfg)                         -> LM on gen's device (f32)
  forward(params, cfg, batch, ...)              -> (logits, aux)
  init_caches(cfg, batch_size, max_len, ...)    -> decode caches
  prefill(params, cfg, batch, caches, ...)      -> (logits, caches)
  decode_step(params, cfg, tokens, caches, ...) -> (logits, caches)

``batch`` is a dict ``{"tokens": (B, S)}``: integers as a numpy array, a
CPU tensor (both range-checked against the vocabulary before upload) or a
tensor on the model's device (a decode step's argmax).  The token
embedding is kernel B9 (:func:`repro_torch.kernels.gather.embedding_gather`);
the head is a plain ``torch.matmul`` (the tied head ``tok_embed.T`` where
the config ties it), as the reference leaves it to XLA.  Everything runs on
the device the parameters live on.

The hybrid (hymba, ROADMAP A12.1b), vision and enc-dec (A12.3) families
raise ``NotImplementedError``; so do ``remat`` and ``mesh`` (training is
A12.4, multi-device A10).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import gather
from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_init, he_init, rms_norm

__all__ = ["LM", "decode_step", "forward", "init_caches", "init_params",
           "make_generator", "prefill"]

Caches = dict


def _kind(cfg: ModelConfig) -> str:
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    return "dense"


def _check_family(cfg: ModelConfig) -> str:
    kind = _kind(cfg)
    if cfg.encdec is not None or cfg.cross_attn is not None:
        item = "A12.3"
    elif kind == "hybrid":
        item = "A12.1b"
    else:
        return kind
    raise NotImplementedError(
        f"{cfg.name} (family {cfg.family!r}) is not ported: the port serves "
        f"families 'dense', 'moe' and 'ssm'; this one is ROADMAP {item}")


def _dense0_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of DeepSeek's dense first layer: its own FFN width, no
    MoE."""
    return dataclasses.replace(cfg, d_ff=cfg.dense_first_layer_ff, moe=None)


class LM(nn.Module):
    """Parameters of a stacked-block LM: ``tok_embed`` (V, d),
    ``final_norm`` (d), ``lm_head`` (d, V) unless tied, ``blocks`` and,
    where the config has a dense first layer, ``dense0`` (a kind
    ``"dense"`` block run before them)."""

    def __init__(self, tok_embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None, blocks: nn.ModuleList,
                 dense0: blk.Block | None = None):
        super().__init__()
        self.tok_embed = nn.Parameter(tok_embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.dense0 = dense0
        self.blocks = blocks

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random init at ``cfg``'s widths on ``gen``'s device, float32."""
    kind = _check_family(cfg)
    d = cfg.d_model
    tok = embed_init(gen, (cfg.vocab_size, d))
    head = None if cfg.tie_embeddings else he_init(gen, (d, cfg.vocab_size))
    dense0 = None
    if cfg.dense_first_layer_ff:
        dense0 = blk.init_block_params(gen, _dense0_cfg(cfg), "dense")
    blocks = blk.stack_init(gen, cfg.n_layers - (dense0 is not None), cfg, kind)
    return LM(tok, torch.ones((d,), device=gen.device), head, blocks, dense0)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (``None``: the card) seeded with
    ``seed``: the counterpart of ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _embed(p: LM, cfg: ModelConfig, tokens, dtype) -> torch.Tensor:
    """(B, S) tokens (numpy or a tensor) -> (B, S, d) through kernel B9."""
    b, s = tokens.shape
    x = gather.embedding_gather(p.tok_embed, tokens.reshape(-1))
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _logits(p: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    head = p.tok_embed.T if cfg.tie_embeddings else p.lm_head
    return torch.matmul(x, head.to(x.dtype))


def _run(p: LM, cfg: ModelConfig, batch: dict, caches: Caches | None,
         dtype) -> tuple[torch.Tensor, Caches | None, torch.Tensor]:
    kind = _check_family(cfg)
    with torch.no_grad():
        x = _embed(p, cfg, batch["tokens"], dtype)
        if p.dense0 is not None:
            kv0 = blk.layer_of(caches["dense0"].kv, 0) if caches is not None else None
            x, new_kv0, _, _ = blk.block_forward(p.dense0, _dense0_cfg(cfg),
                                                 "dense", x, kv=kv0)
        layer_caches = caches["layers"] if caches is not None else None
        x, new_layers, aux = blk.run_blocks(p.blocks, cfg, kind, x,
                                            caches=layer_caches)
        new_caches = None
        if caches is not None:
            new_caches = {"layers": new_layers}
            if p.dense0 is not None:
                new_caches["dense0"] = blk.LayerCaches(
                    kv=KVCache(*(a[None] for a in new_kv0)), ssm=None)
        return _logits(p, cfg, x), new_caches, aux


def _no_mesh(mesh, remat=None) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh: multi-device execution is ROADMAP A10")
    if remat is not None:
        raise NotImplementedError("remat: training is ROADMAP A12.4")


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(p: LM, cfg: ModelConfig, batch: dict, *, dtype=torch.float32,
            remat: str | None = None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal logits + the MoE aux loss (summed over the MoE
    layers; 0 without them)."""
    _no_mesh(mesh, remat)
    logits, _, aux = _run(p, cfg, batch, None, dtype)
    return logits, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> Caches:
    """Zero decode caches on ``device`` (``None``: the card): ``"layers"``
    for the stacked blocks and, with a dense first layer, ``"dense0"`` (a
    one-layer stack)."""
    kind = _check_family(cfg)
    device = resolve_device(device)
    n_stacked = cfg.n_layers - (1 if cfg.dense_first_layer_ff else 0)
    caches = {"layers": blk.init_layer_caches(cfg, n_stacked, kind, batch,
                                              max_len, dtype, device=device)}
    if cfg.dense_first_layer_ff:
        caches["dense0"] = blk.init_layer_caches(cfg, 1, "dense", batch,
                                                 max_len, dtype, device=device)
    return caches


def prefill(p: LM, cfg: ModelConfig, batch: dict, caches: Caches, *,
            dtype=torch.float32, remat: str | None = None, mesh=None
            ) -> tuple[torch.Tensor, Caches]:
    """Process the prompt, fill caches, return full-sequence logits."""
    _no_mesh(mesh, remat)
    logits, new_caches, _ = _run(p, cfg, batch, caches, dtype)
    return logits, new_caches


def decode_step(p: LM, cfg: ModelConfig, tokens, caches: Caches, *,
                dtype=torch.float32, mesh=None) -> tuple[torch.Tensor, Caches]:
    """One autoregressive step.  tokens: (B, S_new) with S_new typically 1."""
    _no_mesh(mesh)
    logits, new_caches, _ = _run(p, cfg, {"tokens": tokens}, caches, dtype)
    return logits[:, -1], new_caches
