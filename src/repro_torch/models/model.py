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
:func:`decode_step` record none.  A bf16 ``tok_embed`` (bf16 parameters)
is gathered by kernel B9's bf16 form as it is, its rows widened to
float32, and its gradient summed from float32 output gradients and rounded
once: no float32 copy of the table (515 MB at mamba2-2.7b's).

**On a mesh** (``mesh=``, a :class:`~repro_torch.compat.Mesh` with axes
``("pod", "data", "model")`` or a subset, or the ambient
:func:`~repro_torch.compat.use_mesh` scope) every family runs tensor-,
expert- and data-parallel, one process driving every device
(:mod:`repro_torch.models.sharding`).  The parameters are
placed by the reference's partition rules (:func:`init_params` with
``mesh=`` draws them born sharded;
:func:`~repro_torch.models.sharding.place_params` places an existing
model; under ``launch.specs.FSDP_PARAMS`` each piece is also split over
``data``, and each read of a device's block gathers it there,
:meth:`~repro_torch.models.sharding.Sharded.local`) and the caches by
:func:`repro_torch.launch.specs.cache_shardings` (:func:`init_caches` with
``mesh=``; under ``launch.specs.KV_SEQ_SHARD`` a KV cache whose kv heads
the model axis does not divide splits its ring's slots over it, ``pos``
and ``length`` whole on each device).  The batch splits over the data replicas where their count
divides it; a batch it does not divide (a b = 1 admission) runs on one
replica (``replica=``), whose new caches the other replicas copy.  In each
replica the token embedding is kernel B9's vocab-shard form on each
device's rows of ``tok_embed``, summed on the replica's lead (exact: one
shard owns each row; the whole-table B9 on the lead where the vocabulary
does not divide), the blocks run as :func:`~repro_torch.models.blocks
.run_blocks_tp` says, and the head's column shards (``lm_head``, or the
tied ``tok_embed.T``) give logits joined on the lead along the
vocabulary.  The vision and enc-dec families take each replica's rows of
``ctx_embeds``: vision projects them by ``ctx_proj``'s column shards
joined on the lead, the enc-dec runs its encoder bidirectionally through
the same block forms, its final norm on the lead; each model device then
attends over its own copy of that context.  A prefill with
``ctx_embeds`` stores the context in the placed caches, and a step
without it reads each replica's rows back.  Logits land on the mesh's
first device.  The result is the model's without a mesh, to rounding.
:func:`forward` records a graph on a mesh too, where grad is enabled and
the pieces require it (:func:`init_params` with ``trainable=True``), each
block under ``remat``; :func:`forward_replicas` gives each data replica's
logits on its lead, for a loss weighted across the replicas
(:mod:`repro_torch.train.step`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.compat import MeshContext, current_mesh_context
from repro_torch.kernels import gather
from repro_torch.kernels.execspec import resolve_device
from repro_torch.launch import specs as S
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import sharding as shrd
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_init, he_init, param, rms_norm

__all__ = ["LM", "cache_batch_axis", "decode_step", "decoder_layer", "forward",
           "forward_replicas", "init_caches", "init_params", "make_generator",
           "params_mesh", "prefill", "resolve_mesh"]

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


def _n_stacked(cfg: ModelConfig) -> int:
    """The blocks of a decoder-only stack after DeepSeek's ``dense0``."""
    return cfg.n_layers - (1 if cfg.dense_first_layer_ff else 0)


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
                trainable: bool = False, mesh=None) -> LM | shrd.PlacedParams:
    """Random init at ``cfg``'s widths on ``gen``'s device, float32; every
    parameter requires grad when ``trainable``.

    With ``mesh`` the parameters are born sharded: drawn from ``gen`` in
    the same order, block after block, each placed on the mesh by
    :func:`repro_torch.launch.specs.param_shardings` (which reads
    ``FSDP_PARAMS``) before the next is drawn,
    so no device holds more than its share and one whole block.  The
    pieces are ``torch.equal`` to those of ``place_params(init_params(gen,
    cfg), cfg, mesh)``; with ``trainable`` every piece is a leaf that
    requires grad."""
    mesh = resolve_mesh(mesh)
    if mesh is None:
        return _init_params(gen, cfg).requires_grad_(trainable)
    leaves: dict[str, shrd.Sharded] = {}

    def put(named) -> None:
        named = dict(named)
        specs = S.param_shardings(mesh, cfg, named)
        for name, t in named.items():
            leaves[name] = shrd.place(t, specs[name], mesh)

    def put_block(prefix: str, block_cfg: ModelConfig, kind: str) -> None:
        # the block is referenced only inside put(), so it is freed before
        # the next one is drawn
        put((f"{prefix}.{n}", t) for n, t in blk.init_block_params(
            gen, block_cfg, kind).named_parameters())

    d = cfg.d_model
    put([("tok_embed", embed_init(gen, (cfg.vocab_size, d)))])
    if not cfg.tie_embeddings:
        put([("lm_head", he_init(gen, (d, cfg.vocab_size)))])
    put([("final_norm", torch.ones((d,), device=gen.device))])
    # the draws in _init_params' order
    if cfg.encdec is not None:
        for i in range(cfg.encdec.encoder_layers):
            put_block(f"encoder.{i}", cfg, "dense")
        for i in range(cfg.n_layers):
            put_block(f"decoder.{i}.self", dataclasses.replace(cfg, d_ff=0),
                      "dense")
            put_block(f"decoder.{i}.cross", cfg, "cross")
        put([("enc_norm", torch.ones((d,), device=gen.device))])
    elif _vision(cfg):
        every = cfg.cross_attn.every
        for g in range(cfg.n_layers // every):
            for j in range(every):
                put_block(f"self_blocks.{g}.{j}", cfg, _kind(cfg))
        for g in range(cfg.n_layers // every):
            put_block(f"cross_blocks.{g}", cfg, "cross")
        d_ctx = cfg.cross_attn.d_ctx or d
        if d_ctx != d:
            put([("ctx_proj", he_init(gen, (d_ctx, d)))])
    else:
        if cfg.dense_first_layer_ff:
            put_block("dense0", _dense0_cfg(cfg), "dense")
        for i in range(_n_stacked(cfg)):
            put_block(f"blocks.{i}", cfg, _kind(cfg))
    return shrd.PlacedParams(mesh, leaves).requires_grad_(trainable)


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
    blocks = blk.stack_init(gen, _n_stacked(cfg), cfg, _kind(cfg))
    return LM(tok, norm, head, blocks, dense0)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (``None``: the card) seeded with
    ``seed``: the counterpart of ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _embed(p: LM, cfg: ModelConfig, tokens, dtype) -> torch.Tensor:
    """(B, S) tokens (numpy or a tensor) -> (B, S, d) through kernel B9.  A
    bf16 table is gathered as it is, its rows widened to float32 (the
    backward then sums float32 gradients and rounds once: the gradient of a
    float32 copy of the table, cast back, without the copy)."""
    b, s = tokens.shape
    x = gather.embedding_gather(p.tok_embed, tokens.reshape(-1),
                                out_dtype=_gathered(p.tok_embed))
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _gathered(table: torch.Tensor) -> torch.dtype:
    """The dtype B9 hands the model a table's rows in: float32 for a bf16
    table, else the table's (float16 and other dtypes are refused by the
    kernel's wrapper)."""
    return torch.float32 if table.dtype == torch.bfloat16 else table.dtype


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


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------


def resolve_mesh(mesh):
    """The mesh a call runs on: ``mesh`` (a Mesh or MeshContext), else the
    ambient scope's; None without either."""
    ctx = MeshContext.of(mesh) if mesh is not None else current_mesh_context()
    if ctx.empty:
        return None
    extra = set(ctx.axis_names) - {*shrd.DATA, shrd.TP}
    if extra:
        raise ValueError(f"the model runs on axes {shrd.DATA + (shrd.TP,)}; "
                         f"the mesh has {sorted(extra)} too")
    return ctx.mesh


def params_mesh(p, cfg: ModelConfig, mesh=None):
    """The mesh a call with parameters ``p`` runs on: the explicit or
    ambient mesh, else the one placed parameters lie on; None for an
    unplaced model without a mesh.  On a mesh the parameters must be
    placed on that mesh (else ``ValueError``)."""
    mesh = resolve_mesh(mesh)
    placed = isinstance(p, shrd.PlacedParams)
    if mesh is None and not placed:
        return None
    if not placed:
        raise ValueError("a mesh needs parameters placed on it: "
                         "init_params(gen, cfg, mesh=mesh) or "
                         "sharding.place_params(params, cfg, mesh)")
    if mesh is not None and mesh != p.mesh:
        raise ValueError(f"the parameters are placed on {p.mesh!r}, the "
                         f"call names {mesh!r}")
    return p.mesh


def _ids_for(ids, device: torch.device):
    """Token ids for a gather on ``device``: card ids move there (host ids
    stay, to be range-checked before upload)."""
    if isinstance(ids, torch.Tensor) and ids.device.type != "cpu":
        return ids.to(device)
    return ids


def _embed_tp(p: shrd.PlacedParams, cfg: ModelConfig, tokens, row: shrd.Row,
              dtype) -> torch.Tensor:
    """(B, S) tokens -> (B, S, d) on the replica's lead: kernel B9's
    vocab-shard form on each device's rows of the table, summed on the
    lead (the whole-table B9 there where ``tok_embed`` is replicated)."""
    b, s = tokens.shape
    ids = tokens.reshape(-1)
    table = p["tok_embed"]
    pieces = row.pieces(table)
    out = _gathered(pieces[0])
    if table.tp_dim() is None:
        x = gather.embedding_gather(pieces[0], _ids_for(ids, row.lead),
                                    out_dtype=out)
    else:
        rows = table.shape[0] // row.size
        x = shrd.sum_on([gather.embedding_gather_shard(
            t, _ids_for(ids, dev), m * rows, cfg.vocab_size, out_dtype=out)
            for m, (dev, t) in enumerate(zip(row.devices, pieces))], row.lead)
    return x.reshape(b, s, cfg.d_model).to(dtype)


def _logits_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
               row: shrd.Row) -> torch.Tensor:
    """The final norm on the lead, then the head's column shards joined on
    the lead along the vocabulary."""
    x = rms_norm(x, row.pieces(p["final_norm"])[0], cfg.norm_eps)
    leaf = p["tok_embed"] if cfg.tie_embeddings else p["lm_head"]
    heads = [w.T if cfg.tie_embeddings else w for w in row.pieces(leaf)]
    if leaf.tp_dim() is None:
        return torch.matmul(x, heads[0].to(x.dtype))
    return shrd.cat_on([torch.matmul(x.to(dev), w.to(x.dtype))
                        for dev, w in zip(row.devices, heads)], row.lead, dim=-1)


def cache_batch_axis(cache, field: str) -> int | None:
    """The batch axis of a cache field: a KV cache's k / v after its lead
    axes (``pos``'s but the last: the layer axis, or vision's groups and
    layers), an SSM state's state and conv ring after the layer axis; None
    for ``pos`` and ``length``, which every batch row shares."""
    if field in ("k", "v"):
        return len(cache.pos.shape) - 1
    if field in ("state", "conv"):
        return 1
    return None


def _piece(leaf: shrd.Sharded, coord, axis: int | None,
           part: slice | None) -> torch.Tensor:
    """The piece of ``leaf`` the device at ``coord`` runs with: its batch
    rows ``part`` where the piece holds every row (a leaf replicated over
    data, ``axis`` its batch axis); a shared field (``axis`` None) whole,
    gathered where the cache rule splits it (vision's (G, every, C) ring
    positions take the context's rule where C is d_model)."""
    t = leaf.pieces[coord]
    if axis is None:
        if tuple(t.shape) != leaf.shape:
            t = leaf.full(leaf.mesh.devices[coord])
        return t
    if part is not None and leaf.spec[axis] is None:
        t = t[(slice(None),) * axis + (part,)]
    return t


def _row_caches(stack: blk.LayerCaches, row: shrd.Row,
                part: slice | None) -> list[blk.LayerCaches]:
    """Each model device's pieces of a placed layer stack; ``part``: the
    replica's rows of a batch split over the data replicas (taken from
    pieces that hold every row: a cache replicated over data)."""
    def one(cache, coord):
        if cache is None:
            return None
        return type(cache)(*(_piece(leaf, coord, cache_batch_axis(cache, field),
                                    part)
                             for field, leaf in zip(cache._fields, cache)))
    return [blk.LayerCaches(kv=one(stack.kv, c), ssm=one(stack.ssm, c))
            for c in row.coords]


def _placed_leaf(leaf: shrd.Sharded, ran: dict, axis: int | None) -> shrd.Sharded:
    """The new placed value of a cache leaf.  ``ran`` maps the replicas
    that ran, in order, to their new pieces (one a model device); ``axis``
    is the leaf's batch axis (None: a field every row shares).  A batch
    leaf replicated over data while several replicas ran is their rows
    joined (an all-gather); a replica that did not run copies the pieces
    of the one that did, device by device; a shared field the rule splits
    is cut from the whole value each device ran with."""
    src = next(iter(ran.values()))
    gather = len(ran) > 1 and axis is not None and leaf.spec[axis] is None
    pieces = np.empty(leaf.pieces.shape, dtype=object)
    for row in shrd.rows(leaf.mesh):
        got = ran.get(row.index)
        for m, (c, dev) in enumerate(zip(row.coords, row.devices)):
            if gather:
                pieces[c] = torch.cat([g[m].to(dev) for g in ran.values()],
                                      dim=axis)
            elif axis is None and tuple(leaf.pieces[c].shape) != leaf.shape:
                pieces[c] = (src if got is None else got)[m][
                    leaf.region(c)].to(dev, copy=True)
            elif got is not None:
                pieces[c] = got[m]
            else:
                pieces[c] = src[m].to(dev, copy=True)
    return shrd.Sharded(leaf.mesh, leaf.spec, leaf.shape, pieces)


def _placed_stack(stack: blk.LayerCaches, ran: dict) -> blk.LayerCaches:
    """:func:`_placed_leaf` of each leaf of a layer stack; ``ran`` maps
    the replicas that ran to each device's new :class:`LayerCaches`."""
    def placed(name, cache):
        if cache is None:
            return None
        return type(cache)(*(
            _placed_leaf(leaf, {r: [getattr(getattr(c, name), field) for c in got]
                                for r, got in ran.items()},
                         cache_batch_axis(cache, field))
            for field, leaf in zip(cache._fields, cache)))
    return blk.LayerCaches(*(placed(name, cache) for name, cache
                             in zip(blk.LayerCaches._fields, stack)))


def _stored_context(caches: Caches | None, name: str, row: shrd.Row,
                    part: slice | None, dtype) -> torch.Tensor:
    """A replica's rows of the context a prefill stored in the placed
    caches (``"ctx"`` / ``"memory"``), on its lead: a step without
    ``ctx_embeds``."""
    if caches is None:
        raise ValueError(f"a forward without caches needs batch['ctx_embeds'] "
                         f"(no {name!r} to read)")
    return _piece(caches[name], row.coords[0], 0, part).to(dtype)


def _project_ctx_tp(p: shrd.PlacedParams, ctx: torch.Tensor,
                    row: shrd.Row) -> torch.Tensor:
    """The vision context projected to d_model on the lead: ``ctx_proj``'s
    column shards joined there (the reference's ``_project_ctx``); the
    context as it is without a ``ctx_proj``."""
    if "ctx_proj" not in p:
        return ctx
    leaf = p["ctx_proj"]
    ws = row.pieces(leaf)
    if leaf.tp_dim() is None:
        return torch.matmul(ctx, ws[0].to(ctx.dtype))
    return shrd.cat_on([torch.matmul(ctx.to(dev), w.to(ctx.dtype))
                        for dev, w in zip(row.devices, ws)], row.lead, dim=-1)


def _encode_tp(p: shrd.PlacedParams, cfg: ModelConfig, frames: torch.Tensor,
               row: shrd.Row, remat: str | None) -> torch.Tensor:
    """The bidirectional encoder over a replica's stub frames (enc-dec),
    its final norm on the lead."""
    h, _, _ = blk.run_blocks_tp(p.sub("encoder"), cfg.encdec.encoder_layers,
                                cfg, "dense", frames, row, causal=False,
                                remat=remat)
    return rms_norm(h, row.pieces(p["enc_norm"])[0], cfg.norm_eps)


def _stack_kv(per_layer: list, row: shrd.Row) -> list[blk.LayerCaches]:
    """Each device's per-layer (or per-group) KV pieces stacked on a new
    leading axis."""
    return [blk.LayerCaches(kv=KVCache(*(torch.stack(a) for a in zip(
        *(layer[m].kv for layer in per_layer)))), ssm=None)
        for m in range(row.size)]


def _decoder_encdec_tp(p: shrd.PlacedParams, cfg: ModelConfig,
                       x: torch.Tensor, memory: list[torch.Tensor],
                       caches: list | None, row: shrd.Row, remat: str | None):
    """The enc-dec decoder layer by layer (each under ``remat``): the self
    block (no MLP) with each device's KV piece, then the cross block over
    ``memory`` (a copy on each device) with the MLP."""
    layers = []
    for i in range(cfg.n_layers):
        layer = p.sub(f"decoder.{i}")
        kv = None if caches is None else [
            blk.LayerCaches(kv=blk.layer_of(c.kv, i), ssm=None) for c in caches]

        def body(h, layer=layer, kv=kv):
            h, new, aux = blk.block_forward_tp(layer.sub("self"), cfg, "dense",
                                               h, row, caches=kv)
            h, _, _ = blk.block_forward_tp(layer.sub("cross"), cfg, "cross",
                                           h, row, ctx=memory)
            return h, new, aux

        x, new, _ = blk.remat_call_tp(body, remat, x, layer, memory)
        layers.append(new)
    return x, None if caches is None else _stack_kv(layers, row)


def _vision_stack_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                     ctx: list[torch.Tensor], caches: list | None,
                     row: shrd.Row, remat: str | None):
    """Group by group: ``every`` self blocks through
    :func:`~repro_torch.models.blocks.run_blocks_tp` (each device's KV
    pieces of the group), then the group's cross block over ``ctx`` (a
    copy on each device), each block under ``remat``.  The new KV pieces
    are (G, every, ...), as the unsharded stack's."""
    every = cfg.cross_attn.every
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = []
    for g in range(cfg.n_layers // every):
        group = None if caches is None else [
            blk.LayerCaches(kv=blk.layer_of(c.kv, g), ssm=None) for c in caches]
        x, new, aux_g = blk.run_blocks_tp(p.sub(f"self_blocks.{g}"), every, cfg,
                                          _kind(cfg), x, row, caches=group,
                                          remat=remat)
        cross = p.sub(f"cross_blocks.{g}")

        def body(h, cross=cross):
            return blk.block_forward_tp(cross, cfg, "cross", h, row, ctx=ctx)

        x, _, _ = blk.remat_call_tp(body, remat, x, cross, ctx)
        aux = aux + aux_g
        groups.append(new)
    return x, None if caches is None else _stack_kv(groups, row), aux


def _run_replica(p: shrd.PlacedParams, cfg: ModelConfig, tokens, ctx_embeds,
                 row: shrd.Row, part: slice | None, caches: Caches | None,
                 dtype, remat: str | None):
    """One data replica's run (``tokens`` / ``ctx_embeds``: its rows):
    (logits on its lead, aux, the new cache entries it made by name, each
    a list of one device's pieces a model device).  A cache entry it did
    not change (a context read back) is left out."""
    x = _embed_tp(p, cfg, tokens, row, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=row.lead)
    new = {}
    ctx = None
    if ctx_embeds is not None:
        if not isinstance(ctx_embeds, torch.Tensor):
            ctx_embeds = torch.from_numpy(np.asarray(ctx_embeds))
        ctx = ctx_embeds.to(device=row.lead, dtype=dtype)
    layers = None
    if caches is not None:
        layers = _row_caches(caches["layers"], row, part)
    if cfg.encdec is not None or _vision(cfg):
        name = "memory" if cfg.encdec is not None else "ctx"
        if ctx is None:
            ctx = _stored_context(caches, name, row, part, dtype)
        else:
            ctx = (_encode_tp(p, cfg, ctx, row, remat) if cfg.encdec is not None
                   else _project_ctx_tp(p, ctx, row))
            if caches is not None:      # a copy a device, in the cache's dtype
                new[name] = [ctx.to(dev, caches[name].dtype, copy=True)
                             for dev in row.devices]
        copies = [ctx.to(dev) for dev in row.devices]
        if cfg.encdec is not None:
            x, new_layers = _decoder_encdec_tp(p, cfg, x, copies, layers, row,
                                               remat)
        else:
            x, new_layers, aux = _vision_stack_tp(p, cfg, x, copies, layers,
                                                  row, remat)
        if caches is not None:
            new["layers"] = new_layers
        return _logits_tp(p, cfg, x, row), aux, new
    if "dense0" in p:
        c0 = None if caches is None else [
            blk.LayerCaches(kv=blk.layer_of(c.kv, 0), ssm=None)
            for c in _row_caches(caches["dense0"], row, part)]

        def dense0(h):
            return blk.block_forward_tp(p.sub("dense0"), _dense0_cfg(cfg),
                                        "dense", h, row, caches=c0)

        x, new0, _ = blk.remat_call_tp(dense0, remat, x, p.sub("dense0"))
        if new0 is not None:
            new["dense0"] = [blk.LayerCaches(kv=KVCache(*(a[None] for a in c.kv)),
                                             ssm=None) for c in new0]
    x, new_layers, aux = blk.run_blocks_tp(p.sub("blocks"), _n_stacked(cfg), cfg,
                                           _kind(cfg), x, row, caches=layers,
                                           remat=remat)
    if caches is not None:
        new["layers"] = new_layers
    return _logits_tp(p, cfg, x, row), aux, new


def _run_mesh(p: shrd.PlacedParams, cfg: ModelConfig, batch: dict,
              caches: Caches | None, dtype, replica: int,
              remat: str | None = None
              ) -> tuple[torch.Tensor, Caches | None, torch.Tensor]:
    if set(batch) - {"tokens", "ctx_embeds"}:
        raise ValueError(f"the mesh path takes tokens and ctx_embeds, got "
                         f"{sorted(batch)}")
    tokens, ctx = batch["tokens"], batch.get("ctx_embeds")
    logits, auxes, ran = [], [], {}
    for row, part in shrd.replica_plan(p.mesh, tokens.shape[0], replica):
        out, aux, new = _run_replica(
            p, cfg, tokens if part is None else tokens[part],
            ctx if part is None or ctx is None else ctx[part], row, part,
            caches, dtype, remat)
        for name, pieces in new.items():
            ran.setdefault(name, {})[row.index] = pieces
        logits.append(out)
        auxes.append(aux)
    out = shrd.cat_on(logits, p.device, dim=0)
    aux = shrd.sum_on(auxes, p.device) / len(auxes)
    if caches is None:
        return out, None, aux
    new_caches = dict(caches)
    for name, got in ran.items():
        cur = caches[name]
        new_caches[name] = (_placed_leaf(cur, got, 0)
                            if isinstance(cur, shrd.Sharded)
                            else _placed_stack(cur, got))
    return out, new_caches, aux


def forward_replicas(p: shrd.PlacedParams, cfg: ModelConfig, shares, *,
                     dtype=torch.float32, remat: str | None = None, mesh=None
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The full-sequence logits and aux loss of each data replica's batch:
    ``shares`` is a list of (:class:`~repro_torch.models.sharding.Row`,
    its batch: ``tokens`` and, for the vision and enc-dec families,
    ``ctx_embeds``; :func:`~repro_torch.models.sharding.place_batch`); the
    logits land on each replica's lead.  A graph is recorded as by
    :func:`forward`."""
    params_mesh(p, cfg, mesh)
    if not isinstance(p, shrd.PlacedParams):
        raise ValueError("forward_replicas takes parameters placed on a mesh")
    return [_run_replica(p, cfg, b["tokens"], b.get("ctx_embeds"), row, None,
                         None, dtype, remat)[:2]
            for row, b in shares]


def _cache_layout(cfg: ModelConfig, kind: str, lead: tuple[int, ...],
                  batch: int, max_len: int, dtype) -> blk.LayerCaches:
    """The shapes of a stack's caches (meta tensors: nothing allocated),
    :func:`init_caches`' layout behind the ``lead`` axes (the layers, or
    vision's groups and layers): a KV cache for the attention kinds, an
    SSM state for ``"ssm"``, both for ``"hybrid"``."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    kv = ssm = None
    if kind != "ssm":
        cap = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        k = lead + (batch, cap, cfg.n_kv_heads, cfg.d_head)
        kv = KVCache(k=meta(k, dtype), v=meta(k, dtype),
                     pos=meta(lead + (cap,), torch.int32),
                     length=meta(lead, torch.int32))
    if kind in ("ssm", "hybrid"):
        s = cfg.ssm
        ssm = blk.SSMState(
            state=meta(lead + (batch, cfg.n_ssm_heads, s.head_dim, s.d_state),
                       torch.float32),
            conv=meta(lead + (batch, s.d_conv - 1,
                              cfg.d_inner + 2 * s.n_groups * s.d_state), dtype))
    return blk.LayerCaches(kv=kv, ssm=ssm)


def _init_caches_mesh(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      mesh) -> Caches:
    """Zero caches placed on ``mesh`` by ``cache_shardings``, each piece
    made on its device at its own shape (``pos`` -1, the rest 0)."""
    if cfg.encdec is not None:
        layout = {"layers": _cache_layout(cfg, "dense", (cfg.n_layers,), batch,
                                          max_len, dtype),
                  "memory": torch.empty((batch, cfg.encdec.n_ctx_tokens,
                                         cfg.d_model), dtype=dtype, device="meta")}
    elif _vision(cfg):
        every = cfg.cross_attn.every
        layout = {"layers": _cache_layout(cfg, "dense",
                                          (cfg.n_layers // every, every), batch,
                                          max_len, dtype),
                  "ctx": torch.empty((batch, cfg.cross_attn.n_ctx_tokens,
                                      cfg.d_model), dtype=dtype, device="meta")}
    else:
        layout = {"layers": _cache_layout(cfg, _kind(cfg), (_n_stacked(cfg),),
                                          batch, max_len, dtype)}
        if cfg.dense_first_layer_ff:
            layout["dense0"] = _cache_layout(cfg, "dense", (1,), batch, max_len,
                                             dtype)
    specs = S.cache_shardings(mesh, cfg, layout, batch)

    def placed(leaf, spec, field=None):
        return shrd.zeros(leaf.shape, spec, mesh, leaf.dtype,
                          fill=-1 if field == "pos" else 0)

    out = {}
    for name, stack in layout.items():
        if isinstance(stack, torch.Tensor):
            out[name] = placed(stack, specs[name])
            continue
        out[name] = blk.LayerCaches(*(
            None if cache is None else type(cache)(*(
                placed(leaf, sp, field)
                for field, leaf, sp in zip(cache._fields, cache, spec)))
            for cache, spec in zip(stack, specs[name])))
    return out


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(p: LM, cfg: ModelConfig, batch: dict, *, dtype=torch.float32,
            remat: str | None = None, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal logits + the MoE aux loss (summed over the MoE
    layers; 0 without them).  Records a graph where grad is enabled and the
    parameters require it (on a mesh, the pieces), each block under
    ``remat`` (None, ``"full"`` or ``"dots"``)."""
    if params_mesh(p, cfg, mesh) is not None:
        logits, _, aux = _run_mesh(p, cfg, batch, None, dtype, 0, remat)
        return logits, aux
    logits, _, aux = _run(p, cfg, batch, None, dtype, remat)
    return logits, aux


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None, mesh=None) -> Caches:
    """Zero decode caches on ``device`` (``None``: the card), the
    reference's layout: ``"layers"`` for the stacked blocks and, with a
    dense first layer, ``"dense0"`` (a one-layer stack); vision: its KV
    leaves (G, every, B, C, Hkv, dh), pos (G, every, C), length (G, every)
    and ``"ctx"`` (B, n_ctx_tokens, d); enc-dec: the decoder's
    ``"layers"`` and ``"memory"`` (B, n_ctx_tokens, d).  With ``mesh`` the
    same layout with every leaf placed by
    :func:`repro_torch.launch.specs.cache_shardings`."""
    mesh = resolve_mesh(mesh)
    if mesh is not None:
        return _init_caches_mesh(cfg, batch, max_len, dtype, mesh)
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
    caches = {"layers": blk.init_layer_caches(cfg, _n_stacked(cfg), _kind(cfg), batch,
                                              max_len, dtype, device=device)}
    if cfg.dense_first_layer_ff:
        caches["dense0"] = blk.init_layer_caches(cfg, 1, "dense", batch,
                                                 max_len, dtype, device=device)
    return caches


def prefill(p: LM, cfg: ModelConfig, batch: dict, caches: Caches, *,
            dtype=torch.float32, remat: str | None = None, mesh=None,
            replica: int = 0) -> tuple[torch.Tensor, Caches]:
    """Process the prompt, fill caches, return full-sequence logits (no
    graph recorded, so ``remat`` changes nothing).  On a mesh, a batch the
    data replicas do not divide runs on replica ``replica``."""
    if remat not in blk.REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; the policies are "
                         f"{blk.REMAT_POLICIES}")
    mesh = params_mesh(p, cfg, mesh)
    with torch.no_grad():
        if mesh is not None:
            logits, new_caches, _ = _run_mesh(p, cfg, batch, caches, dtype,
                                              replica)
        else:
            logits, new_caches, _ = _run(p, cfg, batch, caches, dtype)
    return logits, new_caches


def decode_step(p: LM, cfg: ModelConfig, tokens, caches: Caches, *,
                dtype=torch.float32, mesh=None, replica: int = 0
                ) -> tuple[torch.Tensor, Caches]:
    """One autoregressive step.  tokens: (B, S_new) with S_new typically 1.
    ``replica`` as for :func:`prefill`."""
    logits, new_caches = prefill(p, cfg, {"tokens": tokens}, caches,
                                 dtype=dtype, mesh=mesh, replica=replica)
    return logits[:, -1], new_caches
