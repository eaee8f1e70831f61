"""Hymba-1.5B [hybrid] — parallel attention + Mamba heads (arXiv:2411.13676).

32L, d_model=1600, 25 query heads (GQA kv=5), d_ff=5504, vocab=32001,
ssm_state=16.  Every block runs attention and an SSM mixer in parallel and
fuses their outputs; sliding-window attention keeps the attention path
sub-quadratic while the SSM state carries global context — which is why this
arch runs the ``long_500k`` cell.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    hybrid=True,
    sliding_window=2048,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, n_groups=1, chunk=256),
)
