"""Analytic FLOP/byte models per (arch x shape) — the MODEL_FLOPS side of the
roofline ratio (useful compute), plus detailed per-component estimates used
to correct cost_analysis where XLA while-loops hide trip counts (SSM time
scans). Conventions: 1 MAC = 2 FLOPs; train = 3x forward (fwd + 2x bwd).
"""
from __future__ import annotations

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The 6*N*D / 2*N*D "useful flops" number (dense: all params; MoE:
    active params only). D = processed tokens."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def attention_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Exact attention matmul FLOPs (causal counted as full S^2 for the XLA
    path — the Pallas kernel halves this; see EXPERIMENTS.md)."""
    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
    elif cfg.family == "encdec":
        n_attn = cfg.n_encoder_layers + cfg.num_layers
    else:
        n_attn = cfg.num_layers
    if shape.kind == "decode":
        per = 2 * 2 * H * hd * S                  # qk + pv against cache
        f = n_attn * B * per
    else:
        per = 2 * 2 * H * hd * S * S
        f = n_attn * B * per
        if shape.kind == "train":
            f *= 3
    return f


def ssm_scan_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Recurrence-interior FLOPs hidden inside XLA while loops."""
    if cfg.mamba_version == 0:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    if cfg.mamba_version == 1:
        per_tok = 9.0 * cfg.d_inner * cfg.ssm_state
    else:
        # SSD chunked matrix form per token (intra approx + states + inter)
        c = cfg.ssm_chunk
        h, p, N = cfg.n_ssm_heads, cfg.mamba_headdim, cfg.ssm_state
        per_tok = 2 * h * c * (p + N) + 6 * h * p * N
    f = cfg.num_layers * tokens * per_tok
    if shape.kind == "train":
        f *= 3
    return f


def hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, dtype_bytes: int = 2) -> float:
    """First-order HBM traffic: weights once per step/token-batch + KV cache
    reads for decode. (Roofline memory term; activations assumed cache/
    fusion-resident at this granularity.)"""
    n = cfg.param_count()
    w = n * dtype_bytes
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
        if cfg.family == "hybrid":
            n_attn = cfg.num_layers // cfg.attn_every
        elif cfg.family == "ssm":
            n_attn = 0
        elif cfg.family == "encdec":
            n_attn = cfg.num_layers
        else:
            n_attn = cfg.num_layers
        if cfg.use_mla:
            kv = n_attn * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
        else:
            kv = n_attn * B * S * 2 * nkv * hd * dtype_bytes
        ssm = 0.0
        if cfg.mamba_version:
            ssm = cfg.num_layers * B * cfg.d_inner * cfg.ssm_state * 4
        return w + kv + ssm
    tokens = shape.global_batch * shape.seq_len
    acts = tokens * cfg.d_model * dtype_bytes * cfg.num_layers * 2
    mult = 3 if shape.kind == "train" else 1
    return mult * (w + acts)
