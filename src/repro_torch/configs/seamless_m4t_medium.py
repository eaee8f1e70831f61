"""SeamlessM4T-medium [audio] — encoder-decoder, multimodal
(arXiv:2308.11596).

12L encoder + 12L decoder, d_model=1024, 16 heads (MHA kv=16), d_ff=4096,
vocab=256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, 1024 frames,
d_model) consumed by the bidirectional encoder; the decoder cross-attends
the encoder memory.  Full attention decoder: ``long_500k`` skipped.
"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    head_dim=64,
    encdec=EncDecConfig(encoder_layers=12, n_ctx_tokens=1024),
)
