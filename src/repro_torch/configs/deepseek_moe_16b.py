"""DeepSeekMoE-16B [moe] — fine-grained experts, 2 shared + 64 routed top-6
(arXiv:2401.06066).

28L, d_model=2048, 16 heads (MHA kv=16), per-expert d_ff=1408, vocab=102400.
Layer 0 uses a dense FFN (d_ff=10944) as in the released model.
Full attention: ``long_500k`` skipped.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2),
    dense_first_layer_ff=10_944,
)
