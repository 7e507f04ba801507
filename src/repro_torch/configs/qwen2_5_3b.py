"""qwen2.5-3b [dense]: GQA with QKV bias.

36L, d_model=2048, 16H (kv=2), d_ff=11008, vocab=151936.
[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    attn_bias=True, activation="silu", rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, dtype="float32",
)
