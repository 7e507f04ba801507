"""deepseek-67b [dense]: llama-style GQA.

95L, d_model=8192, 64H (kv=8), d_ff=22016, vocab=102400.
[arXiv:2401.02954; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    activation="silu",
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32",
)
