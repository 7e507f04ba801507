"""zamba2-2.7b [hybrid]: Mamba2 trunk + shared attention blocks.

54 Mamba2 layers, d_model=2560, ssm_state=64; shared transformer block
(32H kv=32, d_ff=10240) applied every 6 layers, 2 alternating shared blocks
with per-application LoRA (rank 128). vocab=32000.
[arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    mamba_version=2, ssm_state=64, ssm_conv=4, ssm_expand=2, mamba_headdim=64,
    ssm_chunk=64,
    attn_every=6, n_shared_attn_blocks=2, shared_lora_rank=128,
    activation="gelu", gated_mlp=True,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm_state=16, mamba_headdim=16, ssm_chunk=8,
    attn_every=2, shared_lora_rank=8, dtype="float32",
)
