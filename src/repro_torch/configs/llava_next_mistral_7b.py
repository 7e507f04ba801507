"""llava-next-mistral-7b [vlm]: Mistral-7B backbone; anyres vision frontend
stubbed to precomputed patch embeddings (B, 2880, 1024) per the assignment
(`input_specs()` provides them); an in-model 2-layer MM projector maps them
to d_model.

32L, d_model=4096, 32H (kv=8), d_ff=14336, vocab=32000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_image_tokens=2880, rope_theta=1_000_000.0,
    activation="silu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_image_tokens=8, dtype="float32",
)
