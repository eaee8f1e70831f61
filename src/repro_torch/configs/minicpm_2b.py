"""MiniCPM-2B [dense] — llama-like, trained with the WSD schedule
(arXiv:2404.06395; the WSD schedule itself lives in repro.optim.schedules).

40L, d_model=2304, 36 heads (MHA: kv=36), d_ff=5760, vocab=122753.
Full attention: ``long_500k`` skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    tie_embeddings=True,
)
