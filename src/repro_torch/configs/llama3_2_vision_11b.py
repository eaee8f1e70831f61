"""Llama-3.2-Vision-11B [vlm] — cross-attention image layers
(hf:meta-llama/Llama-3.2-11B-Vision).

40L backbone, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256.
A cross-attention layer follows every 4 self-attention layers (8 cross
layers interleaved into the 40-layer stack = "every 5th layer").  The vision
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (1601 tokens/tile, d=1280 -> projected).
Full attention: ``long_500k`` skipped.
"""
from repro_torch.models.config import CrossAttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn=CrossAttnConfig(every=4, n_ctx_tokens=1601, d_ctx=1280),
)
