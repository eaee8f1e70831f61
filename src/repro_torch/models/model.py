"""Top-level model — port of ``repro.models.model``: decoder-only stacks
(families ``"dense"``: llama-3.2-3b, qwen2-1.5b, qwen3-14b, minicpm-2b;
``"moe"``: mixtral-8x7b, deepseek-moe-16b with DeepSeek's dense first layer
``dense0``; ``"ssm"``: mamba2; ``"hybrid"``: hymba), the vision stack with
interleaved cross-attention (``"vlm"``: llama-3.2-vision-11b) and the
encoder-decoder (``"audio"``: seamless-m4t-medium).

Public surface (the reference's, with an ``nn.Module`` for the pytree):
  init_params(gen, cfg, trainable=False)        -> LM on gen's device (f32)
  forward(params, cfg, batch, ...)              -> (logits, aux)
  init_caches(cfg, batch_size, max_len, ...)    -> decode caches
  prefill(params, cfg, batch, caches, ...)      -> (logits, caches)
  decode_step(params, cfg, tokens, caches, ...) -> (logits, caches)

``batch`` is a dict ``{"tokens": (B, S)}``: integers as a numpy array, a
CPU tensor (both range-checked against the vocabulary before upload) or a
tensor on the model's device (a decode step's argmax).  The vision and
enc-dec families also take ``batch["ctx_embeds"]``, the stub frontend's
output (image patch embeddings (B, T, d_ctx), audio frames (B, T,
d_model)), numpy or a tensor, uploaded to the parameters' device.  A
prefill with it stores the projected context (vision) or the encoder's
memory (enc-dec) in the caches, and a step without it reads them back, as
the reference does.  The token embedding is kernel B9
(:func:`repro_torch.kernels.gather.embedding_gather`); the head is a plain
``torch.matmul`` (the tied head ``tok_embed.T`` where the config ties it),
as the reference leaves it to XLA.  Everything runs on the device the
parameters live on.

:func:`forward` records a graph where grad is enabled and the parameters
require it (a trainable model, the train step's); its ``remat`` wraps each
block (each vision group, each enc-dec decoder layer) as the reference's
``jax.checkpoint`` wraps its scan bodies
(:func:`repro_torch.models.blocks.remat_call`).  :func:`prefill` and
:func:`decode_step` record none.  A ``tok_embed`` in another dtype than
float32 / float64 (bf16 parameters) is cast to float32 before kernel B9,
one copy, the gradient flowing back through the cast.  ``mesh`` raises
``NotImplementedError`` (multi-device is ROADMAP A10b).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import gather
from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_init, he_init, param, rms_norm

__all__ = ["LM", "decode_step", "decoder_layer", "forward", "init_caches",
           "init_params", "make_generator", "prefill"]

Caches = dict


def _kind(cfg: ModelConfig) -> str:
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    return "dense"


def _dense0_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of DeepSeek's dense first layer: its own FFN width, no
    MoE."""
    return dataclasses.replace(cfg, d_ff=cfg.dense_first_layer_ff, moe=None)


def _vision(cfg: ModelConfig) -> bool:
    return cfg.cross_attn is not None and bool(cfg.cross_attn.every)


class LM(nn.Module):
    """Parameters of an LM: ``tok_embed`` (V, d), ``final_norm`` (d),
    ``lm_head`` (d, V) unless tied, and by family:

    - decoder-only: ``blocks`` and, where the config has a dense first
      layer, ``dense0`` (a kind ``"dense"`` block run before them);
    - vision: ``self_blocks`` (G groups of ``every`` blocks, G = n_layers
      // every), ``cross_blocks`` (G cross blocks, one after each group)
      and ``ctx_proj`` (d_ctx, d) where d_ctx is not d;
    - enc-dec: ``encoder`` (dense blocks run bidirectionally), ``enc_norm``
      (d) and ``decoder``: layers of ``{"self": a dense block without MLP,
      "cross": a cross block}``.
    """

    def __init__(self, tok_embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None, blocks: nn.ModuleList | None,
                 dense0: blk.Block | None = None, *,
                 self_blocks: nn.ModuleList | None = None,
                 cross_blocks: nn.ModuleList | None = None,
                 ctx_proj: torch.Tensor | None = None,
                 encoder: nn.ModuleList | None = None,
                 enc_norm: torch.Tensor | None = None,
                 decoder: nn.ModuleList | None = None):
        super().__init__()
        self.tok_embed = param(tok_embed)
        self.final_norm = param(final_norm)
        self.lm_head = None if lm_head is None else param(lm_head)
        self.dense0 = dense0
        self.blocks = blocks
        self.self_blocks = self_blocks
        self.cross_blocks = cross_blocks
        self.ctx_proj = None if ctx_proj is None else param(ctx_proj)
        self.encoder = encoder
        self.enc_norm = None if enc_norm is None else param(enc_norm)
        self.decoder = decoder

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


def decoder_layer(self_block: blk.Block, cross_block: blk.Block) -> nn.ModuleDict:
    """One enc-dec decoder layer: self-attention, then cross-attention over
    the encoder's memory with the MLP."""
    return nn.ModuleDict({"self": self_block, "cross": cross_block})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                trainable: bool = False) -> LM:
    """Random init at ``cfg``'s widths on ``gen``'s device, float32; every
    parameter requires grad when ``trainable``."""
    return _init_params(gen, cfg).requires_grad_(trainable)


def _init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    d = cfg.d_model
    tok = embed_init(gen, (cfg.vocab_size, d))
    head = None if cfg.tie_embeddings else he_init(gen, (d, cfg.vocab_size))
    norm = torch.ones((d,), device=gen.device)
    if cfg.encdec is not None:
        self_cfg = dataclasses.replace(cfg, d_ff=0)
        encoder = blk.stack_init(gen, cfg.encdec.encoder_layers, cfg, "dense")
        decoder = nn.ModuleList(
            decoder_layer(blk.init_block_params(gen, self_cfg, "dense"),
                          blk.init_block_params(gen, cfg, "cross"))
            for _ in range(cfg.n_layers))
        return LM(tok, norm, head, None, encoder=encoder,
                  enc_norm=torch.ones((d,), device=gen.device), decoder=decoder)
    if _vision(cfg):
        every = cfg.cross_attn.every
        n_groups = cfg.n_layers // every
        d_ctx = cfg.cross_attn.d_ctx or d
        selfs = nn.ModuleList(blk.stack_init(gen, every, cfg, _kind(cfg))
                              for _ in range(n_groups))
        cross = blk.stack_init(gen, n_groups, cfg, "cross")
        proj = he_init(gen, (d_ctx, d)) if d_ctx != d else None
        return LM(tok, norm, head, None, self_blocks=selfs, cross_blocks=cross,
                  ctx_proj=proj)
    dense0 = None
    if cfg.dense_first_layer_ff:
        dense0 = blk.init_block_params(gen, _dense0_cfg(cfg), "dense")
    blocks = blk.stack_init(gen, cfg.n_layers - (dense0 is not None), cfg,
                            _kind(cfg))
    return LM(tok, norm, head, blocks, dense0)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (``None``: the card) seeded with
    ``seed``: the counterpart of ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _embed(p: LM, cfg: ModelConfig, tokens, dtype) -> torch.Tensor:
    """(B, S) tokens (numpy or a tensor) -> (B, S, d) through kernel B9 (a
    table of another dtype than float32 / float64 cast to float32 first)."""
    b, s = tokens.shape
    table = p.tok_embed
    if table.dtype not in (torch.float32, torch.float64):
        table = table.float()
    x = gather.embedding_gather(table, tokens.reshape(-1))
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _logits(p: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, p.final_norm, cfg.norm_eps)
    head = p.tok_embed.T if cfg.tie_embeddings else p.lm_head
    return torch.matmul(x, head.to(x.dtype))


def _ctx_embeds(p: LM, batch: dict, dtype) -> torch.Tensor | None:
    """``batch["ctx_embeds"]`` (numpy or a tensor) on the parameters'
    device in ``dtype``, or None."""
    ctx = batch.get("ctx_embeds")
    if ctx is None:
        return None
    if not isinstance(ctx, torch.Tensor):
        ctx = torch.from_numpy(np.asarray(ctx))
    return ctx.to(device=p.device, dtype=dtype)


def _memory(caches: Caches | None, name: str, dtype) -> torch.Tensor:
    """The context a prefill stored in the caches (a step without
    ``ctx_embeds``)."""
    if caches is None:
        raise ValueError(f"a forward without caches needs batch['ctx_embeds'] "
                         f"(no {name!r} to read)")
    return caches[name].to(dtype)


def _encode(p: LM, cfg: ModelConfig, frames: torch.Tensor,
            remat: str | None = None) -> torch.Tensor:
    """The bidirectional encoder over the stub frames (enc-dec)."""
    h, _, _ = blk.run_blocks(p.encoder, cfg, "dense", frames, causal=False,
                             remat=remat)
    return rms_norm(h, p.enc_norm, cfg.norm_eps)


def _decoder_encdec(p: LM, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor, caches: blk.LayerCaches | None,
                    remat: str | None = None):
    """The enc-dec decoder layer by layer (each under ``remat``):
    self-attention (the KV cache), then cross-attention over ``memory``
    with the MLP."""
    kvs = []
    for i, layer in enumerate(p.decoder):
        kv = blk.layer_of(caches.kv, i) if caches is not None else None

        def body(h, layer=layer, kv=kv):
            h, new_kv, _, _ = blk.block_forward(layer["self"], cfg, "dense",
                                                h, kv=kv)
            h, _, _, _ = blk.block_forward(layer["cross"], cfg, "cross", h,
                                           ctx=memory)
            return h, new_kv

        x, new_kv = blk.remat_call(body, remat, x)
        kvs.append(new_kv)
    if caches is None:
        return x, None
    return x, blk.LayerCaches(kv=KVCache(*(torch.stack(a) for a in zip(*kvs))),
                              ssm=None)


def _vision_stack(p: LM, cfg: ModelConfig, x: torch.Tensor, ctx: torch.Tensor,
                  caches: blk.LayerCaches | None, remat: str | None = None):
    """Group by group (each under ``remat``): ``every`` self blocks (their
    KV caches (G, every, ...)), then the group's cross block over
    ``ctx``."""
    kind = _kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = []
    for g, (selfs, cross) in enumerate(zip(p.self_blocks, p.cross_blocks)):
        group = (blk.LayerCaches(kv=blk.layer_of(caches.kv, g), ssm=None)
                 if caches is not None else None)

        def body(h, selfs=selfs, cross=cross, group=group):
            h, new, aux_g = blk.run_blocks(selfs, cfg, kind, h, caches=group)
            h, _, _, _ = blk.block_forward(cross, cfg, "cross", h, ctx=ctx)
            return h, new, aux_g

        x, new, aux_g = blk.remat_call(body, remat, x)
        aux = aux + aux_g
        groups.append(new)
    if caches is None:
        return x, None, aux
    kv = KVCache(*(torch.stack(a) for a in zip(*(c.kv for c in groups))))
    return x, blk.LayerCaches(kv=kv, ssm=None), aux


def _run(p: LM, cfg: ModelConfig, batch: dict, caches: Caches | None,
         dtype, remat: str | None = None
         ) -> tuple[torch.Tensor, Caches | None, torch.Tensor]:
    x = _embed(p, cfg, batch["tokens"], dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer_caches = caches["layers"] if caches is not None else None
    ctx = _ctx_embeds(p, batch, dtype)
    if cfg.encdec is not None:
        memory = (_encode(p, cfg, ctx, remat) if ctx is not None
                  else _memory(caches, "memory", dtype))
        x, new_layers = _decoder_encdec(p, cfg, x, memory, layer_caches, remat)
        new_caches = None if caches is None else {
            "layers": new_layers,
            "memory": memory.to(caches["memory"].dtype)}
        return _logits(p, cfg, x), new_caches, aux
    if _vision(cfg):
        if ctx is not None:
            if p.ctx_proj is not None:
                ctx = torch.matmul(ctx, p.ctx_proj.to(dtype))
        else:
            ctx = _memory(caches, "ctx", dtype)
        x, new_layers, aux = _vision_stack(p, cfg, x, ctx, layer_caches, remat)
        new_caches = None if caches is None else {
            "layers": new_layers, "ctx": ctx.to(caches["ctx"].dtype)}
        return _logits(p, cfg, x), new_caches, aux
    if p.dense0 is not None:
        kv0 = blk.layer_of(caches["dense0"].kv, 0) if caches is not None else None

        def dense0(h):
            h, new_kv0, _, _ = blk.block_forward(p.dense0, _dense0_cfg(cfg),
                                                 "dense", h, kv=kv0)
            return h, new_kv0

        x, new_kv0 = blk.remat_call(dense0, remat, x)
    x, new_layers, aux = blk.run_blocks(p.blocks, cfg, _kind(cfg), x,
                                        caches=layer_caches, remat=remat)
    new_caches = None
    if caches is not None:
        new_caches = {"layers": new_layers}
        if p.dense0 is not None:
            new_caches["dense0"] = blk.LayerCaches(
                kv=KVCache(*(a[None] for a in new_kv0)), ssm=None)
    return _logits(p, cfg, x), new_caches, aux


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh: multi-device execution is ROADMAP A10b")


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(p: LM, cfg: ModelConfig, batch: dict, *, dtype=torch.float32,
            remat: str | None = None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal logits + the MoE aux loss (summed over the MoE
    layers; 0 without them).  Records a graph where grad is enabled and the
    parameters require it, each block under ``remat`` (None, ``"full"``
    or ``"dots"``)."""
    _no_mesh(mesh)
    logits, _, aux = _run(p, cfg, batch, None, dtype, remat)
    return logits, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> Caches:
    """Zero decode caches on ``device`` (``None``: the card), the
    reference's layout: ``"layers"`` for the stacked blocks and, with a
    dense first layer, ``"dense0"`` (a one-layer stack); vision: its KV
    leaves (G, every, B, C, Hkv, dh), pos (G, every, C), length (G, every)
    and ``"ctx"`` (B, n_ctx_tokens, d); enc-dec: the decoder's
    ``"layers"`` and ``"memory"`` (B, n_ctx_tokens, d)."""
    device = resolve_device(device)
    d = cfg.d_model
    if cfg.encdec is not None:
        return {"layers": blk.init_layer_caches(cfg, cfg.n_layers, "dense",
                                                batch, max_len, dtype,
                                                device=device),
                "memory": torch.zeros((batch, cfg.encdec.n_ctx_tokens, d),
                                      dtype=dtype, device=device)}
    if _vision(cfg):
        every = cfg.cross_attn.every
        one = attn_mod.init_cache(cfg, batch, max_len, dtype, device=device)
        lead = (cfg.n_layers // every, every)
        kv = KVCache(*(a.expand(lead + a.shape).contiguous() for a in one))
        return {"layers": blk.LayerCaches(kv=kv, ssm=None),
                "ctx": torch.zeros((batch, cfg.cross_attn.n_ctx_tokens, d),
                                   dtype=dtype, device=device)}
    n_stacked = cfg.n_layers - (1 if cfg.dense_first_layer_ff else 0)
    caches = {"layers": blk.init_layer_caches(cfg, n_stacked, _kind(cfg), batch,
                                              max_len, dtype, device=device)}
    if cfg.dense_first_layer_ff:
        caches["dense0"] = blk.init_layer_caches(cfg, 1, "dense", batch,
                                                 max_len, dtype, device=device)
    return caches


def prefill(p: LM, cfg: ModelConfig, batch: dict, caches: Caches, *,
            dtype=torch.float32, remat: str | None = None, mesh=None
            ) -> tuple[torch.Tensor, Caches]:
    """Process the prompt, fill caches, return full-sequence logits (no
    graph recorded, so ``remat`` changes nothing)."""
    _no_mesh(mesh)
    if remat not in blk.REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; the policies are "
                         f"{blk.REMAT_POLICIES}")
    with torch.no_grad():
        logits, new_caches, _ = _run(p, cfg, batch, caches, dtype)
    return logits, new_caches


def decode_step(p: LM, cfg: ModelConfig, tokens, caches: Caches, *,
                dtype=torch.float32, mesh=None) -> tuple[torch.Tensor, Caches]:
    """One autoregressive step.  tokens: (B, S_new) with S_new typically 1."""
    _no_mesh(mesh)
    with torch.no_grad():
        logits, new_caches, _ = _run(p, cfg, {"tokens": tokens}, caches, dtype)
    return logits[:, -1], new_caches
