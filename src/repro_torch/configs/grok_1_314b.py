"""grok-1-314b [moe]: 8 experts, top-2 routing.

64L, d_model=6144, 48H (kv=8), expert d_ff=32768, vocab=131072.
[hf:xai-org/grok-1; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, moe_top_k=2, expert_d_ff=32768,
    activation="gelu", gated_mlp=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256, n_experts=4, expert_d_ff=64, dtype="float32",
)
