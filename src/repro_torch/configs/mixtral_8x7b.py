"""Mixtral-8x7B [moe] — 8 experts top-2 with sliding-window attention
(arXiv:2401.04088).

32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=14336, vocab=32000,
SWA window 4096 — sub-quadratic, so the ``long_500k`` cell runs.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0),
)
