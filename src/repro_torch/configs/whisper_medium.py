"""whisper-medium [audio]: enc-dec, conv frontend stubbed to frame embeddings.

24L enc + 24L dec, d_model=1024, 16H (kv=16), d_ff=4096, vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865,
    use_rope=False, use_layernorm=True, gated_mlp=False, activation="gelu",
    encoder_seq=1500, max_position=32768,
)

SMOKE = CONFIG.replace(
    num_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, encoder_seq=16, max_position=256, dtype="float32",
)
