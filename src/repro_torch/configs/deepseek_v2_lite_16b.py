"""deepseek-v2-lite-16b [moe]: MLA attention + fine-grained MoE.

27L, d_model=2048, 16H, vocab=102400. MLA: kv_lora=512, decoupled rope dim 64.
MoE: 2 shared + 64 routed experts, top-6, expert d_ff=1408; first layer dense
(d_ff=10944). Assignment line says both "64e top-6" and "160 routed"; 160
routed belongs to full V2 — V2-*Lite* has 64 routed (see DESIGN.md §3).
[arXiv:2405.04434; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, moe_top_k=6, n_shared_experts=2, expert_d_ff=1408,
    first_dense_layers=1,
    activation="silu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, moe_top_k=2, n_shared_experts=1, expert_d_ff=32,
    dtype="float32",
)
