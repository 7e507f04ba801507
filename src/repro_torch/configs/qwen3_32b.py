"""qwen3-32b [dense]: GQA with qk-norm.

64L, d_model=5120, 64H (kv=8), d_ff=25600, vocab=151936.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, activation="silu", rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
