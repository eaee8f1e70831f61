"""Qwen3-14B [dense] — qk-norm + GQA (hf:Qwen/Qwen3-14B).

40L, d_model=5120, 40 heads (GQA kv=8), d_ff=17408, vocab=151936.
Full attention: ``long_500k`` skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17_408,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
