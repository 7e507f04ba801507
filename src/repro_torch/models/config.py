"""Unified model configuration covering all assigned architectures.

One dataclass describes every family: dense decoder-only transformers (GQA,
qk-norm, qkv-bias, squared-ReLU), MoE (shared+routed, top-k), MLA
(compressed-KV attention), pure SSM (Mamba1), hybrid Mamba2+shared-attention
(Zamba2), encoder-decoder (Whisper) and VLM (LLaVA-NeXT, stub frontend).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm

    # trunk
    num_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab_size: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    attn_bias: bool = False           # qwen2.5 QKV bias
    qk_norm: bool = False             # qwen3 per-head RMSNorm on q/k
    use_rope: bool = True             # whisper uses learned absolute positions
    rope_theta: float = 10_000.0
    max_position: int = 1 << 20       # learned-abs position table size cap
    gated_mlp: bool = True            # llama-style gate/up/down (3 matrices)
    activation: str = "silu"          # silu | squared_relu | gelu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0       # deepseek-v2: first layer(s) dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba)
    mamba_version: int = 0            # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_headdim: int = 64           # mamba2 head dim (p)
    dt_rank: int = 0                  # mamba1; 0 -> d_model // 16
    ssm_chunk: int = 64               # mamba2 SSD chunk length

    # hybrid (zamba2): shared attention block applied every `attn_every`
    # mamba layers, cycling over `n_shared_attn_blocks` shared blocks, each
    # application owning a LoRA adapter of rank `shared_lora_rank`.
    attn_every: int = 0
    n_shared_attn_blocks: int = 2
    shared_lora_rank: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # whisper: 1500 post-conv frames (stub)

    # VLM (llava): image patch embeddings prepended to the text sequence.
    n_image_tokens: int = 0

    # norms / misc
    norm_eps: float = 1e-5
    use_layernorm: bool = False       # whisper uses LayerNorm, others RMSNorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # params/compute dtype for deployment
    logit_dtype: str = "float32"

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter count (used for roofline MODEL_FLOPS = 6*N*D and for
    # memory budgeting; exact count comes from the real param pytree).
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.use_mla:
                r = self.kv_lora_rank
                qd = self.qk_nope_dim + self.qk_rope_dim
                return (d * nq * qd + d * (r + self.qk_rope_dim)
                        + r * nq * (self.qk_nope_dim + self.v_head_dim)
                        + nq * self.v_head_dim * d)
            return d * (nq + 2 * nkv) * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            return d * ff * (3 if self.gated_mlp else 2)

        def mamba_params() -> int:
            di, n = self.d_inner, self.ssm_state
            if self.mamba_version == 2:
                h = self.n_ssm_heads
                return d * (2 * di + 2 * n + h) + di * d + di * self.ssm_conv
            r = self.resolved_dt_rank
            return (d * 2 * di + di * (r + 2 * n) + r * di + di * n
                    + di * d + di * self.ssm_conv)

        total = emb
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * (2 * attn_params() + mlp_params(self.d_ff))
            total += self.encoder_seq * d  # encoder positions (stub frontend)
            return total
        if self.family == "ssm":
            return total + self.num_layers * mamba_params()
        if self.family == "hybrid":
            total += self.num_layers * mamba_params()
            shared = self.n_shared_attn_blocks * (attn_params() + mlp_params(self.d_ff))
            n_app = self.num_layers // max(1, self.attn_every)
            lora = n_app * 4 * (d * self.shared_lora_rank + self.shared_lora_rank * nq * hd)
            return total + shared + lora
        # dense / moe / vlm
        per_layer_attn = attn_params()
        if self.family == "moe" or self.n_experts:
            routed = self.n_experts * mlp_params(self.expert_d_ff or self.d_ff)
            shared = self.n_shared_experts * mlp_params(self.expert_d_ff or self.d_ff)
            router = d * self.n_experts
            moe_layers = self.num_layers - self.first_dense_layers
            total += self.first_dense_layers * (per_layer_attn + mlp_params(self.d_ff))
            if active_only:
                active_ff = (self.moe_top_k + self.n_shared_experts) * \
                    mlp_params(self.expert_d_ff or self.d_ff)
                total += moe_layers * (per_layer_attn + router + active_ff)
            else:
                total += moe_layers * (per_layer_attn + router + routed + shared)
            return total
        return total + self.num_layers * (per_layer_attn + mlp_params(self.d_ff))
