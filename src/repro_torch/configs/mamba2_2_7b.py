"""Mamba2-2.7B [ssm] — SSD, attention-free (arXiv:2405.21060).

64L, d_model=2560, d_inner=5120 (expand 2), head_dim=64 -> 80 SSM heads,
ssm_state=128, vocab=50280.  No attention, no MLP (d_ff=0): each block is a
Mamba2 mixer.  O(1) decode state -> runs the ``long_500k`` cell natively.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, chunk=256),
)
