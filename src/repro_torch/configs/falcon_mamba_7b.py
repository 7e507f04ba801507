"""falcon-mamba-7b [ssm]: pure Mamba1, attention-free.

64L, d_model=4096 (d_inner=8192), ssm_state=16, dt_rank=256, vocab=65024.
[arXiv:2410.05355; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    mamba_version=1, ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, vocab_size=256, ssm_state=8, dt_rank=8,
    dtype="float32",
)
