"""Model configuration system (a copy of ``repro.models.config``).

One frozen dataclass describes every architecture in the assigned pool; the
family-specific pieces (MoE, SSM, cross-attention, enc-dec) are optional
sub-configs.  ``reduced()`` produces the CPU-smoke-test version of any config
(same family and code paths, tiny dimensions).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    def scaled(self, n_experts: int, top_k: int) -> "MoEConfig":
        return dataclasses.replace(self, n_experts=n_experts, top_k=top_k)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64
    n_groups: int = 1            # B/C groups (GVA)
    chunk: int = 256             # SSD chunk length
    d_conv: int = 4              # depthwise conv width


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """Cross-attention side input (VLM image tiles / enc-dec memory)."""

    every: int = 0               # insert a cross block after every N self blocks
    n_ctx_tokens: int = 1601     # stub frontend sequence length
    d_ctx: int = 0               # 0 = same as d_model


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    n_ctx_tokens: int = 1024     # stub audio frames fed to the encoder


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                    # dense FFN hidden (for MoE: per-expert)
    vocab_size: int

    head_dim: int = 0            # 0 = d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: bool = False         # parallel attn + ssm heads (Hymba)
    cross_attn: CrossAttnConfig | None = None
    encdec: EncDecConfig | None = None
    dense_first_layer_ff: int = 0   # DeepSeekMoE: layer 0 uses a dense FFN

    # --- derived ---------------------------------------------------------
    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context?  (SSM state or SWA window.)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.n_heads:
            attn = d * self.d_head * (self.n_heads + 2 * self.n_kv_heads) + (
                self.n_heads * self.d_head * d
            )
        ffn = 3 * d * self.d_ff
        if self.moe:
            ffn = 3 * d * self.d_ff * (self.moe.n_experts + self.moe.n_shared)
            ffn += d * self.moe.n_experts  # router
        ssm = 0
        if self.ssm:
            di, n = self.d_inner, self.ssm.d_state
            ssm = d * (2 * di + 2 * self.ssm.n_groups * n + self.n_ssm_heads) + di * d
        per_layer = attn + (ssm if self.family == "ssm" else 0) + (
            ssm if self.hybrid else 0
        ) + (ffn if self.d_ff else 0)
        total = emb + L * per_layer
        if self.encdec:
            total += self.encdec.encoder_layers * (attn + ffn)
        if self.cross_attn and self.cross_attn.every:
            n_cross = L // (self.cross_attn.every + 1)
            total += n_cross * (attn + ffn)
        return int(total)

    def active_params_per_token(self) -> int:
        """6*N_active*D FLOPs basis for MoE rooflines."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.d_head * (self.n_heads + 2 * self.n_kv_heads) + (
            self.n_heads * self.d_head * d
        )
        ffn_active = 3 * d * self.d_ff * (self.moe.top_k + self.moe.n_shared)
        total = emb + L * (attn + ffn_active)
        if self.dense_first_layer_ff:
            total += 3 * d * (self.dense_first_layer_ff - self.d_ff * self.moe.top_k)
        return int(total)

    # --- reduced (smoke-test) version -------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: runs a forward/train step on CPU in sec."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            sliding_window=16 if self.sliding_window else None,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, 4 * self.n_kv_heads // max(self.n_heads, 1))
        else:
            kw["n_heads"] = 0
            kw["n_kv_heads"] = 0
        if self.moe:
            # capacity_factor = n_experts -> no token ever drops, so the
            # decode-vs-teacher-forcing consistency tests are exact; dropping
            # behaviour is unit-tested separately.
            kw["moe"] = dataclasses.replace(self.moe, n_experts=4, top_k=2,
                                            n_shared=min(self.moe.n_shared, 1),
                                            capacity_factor=4.0)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, head_dim=16, chunk=8, n_groups=1
            )
        if self.cross_attn:
            kw["cross_attn"] = dataclasses.replace(
                self.cross_attn, every=1, n_ctx_tokens=8
            )
            kw["n_layers"] = 4
        if self.encdec:
            kw["encdec"] = dataclasses.replace(
                self.encdec, encoder_layers=2, n_ctx_tokens=8
            )
        if self.dense_first_layer_ff:
            kw["dense_first_layer_ff"] = 256
        return dataclasses.replace(self, **kw)
