"""Llama-3.2-3B [dense] — small Llama3 (hf:meta-llama/Llama-3.2-3B).

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
Full attention: the ``long_500k`` cell is skipped (see DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
)
