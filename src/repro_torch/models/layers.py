"""Dense transformer layers in PyTorch (counterpart of `repro.models.layers`).

Plain functions on tensors and nested dicts of parameters, laid out as in
the JAX package (q/k/v projections (d, heads, head_dim), attention tensors
(B, S, H, D)). Only the dense subset the served path needs is ported; the
attention of the serving path runs on the paged KV pool through kernels K1
(decode) and K2 (chunk prefill), and `sdpa` / `decode_attention` are the
dense forms kept for tests and for the kernels' plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2

from .config import ModelConfig

# ---------------------------------------------------------------- norms ----


def rms_norm(x, w, eps: float):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def norm_apply(cfg: ModelConfig, p, x):
    if cfg.use_layernorm:
        raise NotImplementedError(
            "LayerNorm models (whisper) are not yet ported, see ROADMAP.md Queue 1")
    return rms_norm(x, p["w"], cfg.norm_eps)


# ----------------------------------------------------------------- rope ----


def rope_freqs(hd: int, theta: float, device=None):
    return theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) (hd even); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ activation ----


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


# ------------------------------------------------------------------ mlp ----


def mlp_apply(cfg: ModelConfig, p, x):
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_in"])
    return h @ p["w_down"]


# ------------------------------------------------------------ attention ----
# q is grouped for GQA: (B, S, Hkv, G, hd); k/v: (B, S, Hkv, hd).


def sdpa(q, k, v, *, causal: bool, q_offset=0, kv_len=None, scale=None):
    """Dense grouped attention. q: (B,Sq,Hkv,G,hd); k,v: (B,Skv,Hkv,hd)."""
    B, Sq, Hkv, G, hd = q.shape
    Skv = k.shape[1]
    scale = scale or hd ** -0.5
    s = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        ok &= kv_pos[None, :] < kv_len
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """One-token attention against a (possibly padded) dense cache.

    q: (B, 1, Hkv, G, hd); caches: (B, Smax, Hkv, hd); cache_len: int or (B,).
    """
    hd = q.shape[-1]
    scale = scale or hd ** -0.5
    s = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k_cache.float()) * scale
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    length = torch.as_tensor(cache_len, device=q.device)
    if length.ndim == 0:
        ok = (kv_pos < length)[None, None, None, None, :]
    else:
        ok = (kv_pos[None, :] < length[:, None])[:, None, None, None, :]
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", p.to(v_cache.dtype), v_cache)


def _project_qkv(cfg: ModelConfig, p, x):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_chunk_apply(cfg: ModelConfig, p, x, *, start: int, k_pool, v_pool,
                     ctx_ids, write_pages, write_offsets):
    """Chunked-prefill attention of one sequence on the page pool: the C
    query tokens at positions [start, start+C) attend every key up to their
    own position (causal within the chunk, full over the filled prefix).

    x: (1, C, d). Pools (P, ps, Hkv, hd) of this layer; ctx_ids (n_ctx,)
    int32 the sequence's page table; the chunk's K/V is written in place at
    pool[write_pages[i], write_offsets[i]] (the page and slot of position
    start+i) before kernel K2 reads the context. Returns (1, C, d).
    """
    B, C, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q_pos = start + torch.arange(C, device=x.device)
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        q = apply_rope(q, q_pos[None], cfg.rope_theta)
        k = apply_rope(k, q_pos[None], cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k[0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[0].to(v_pool.dtype)
    out = _k2.chunk_prefill_attention(q[0], k_pool, v_pool, ctx_ids, start)
    out = out.reshape(1, C, nq, hd)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def attn_decode_apply(cfg: ModelConfig, p, x, *, pos, k_pool, v_pool, table,
                      write_pages, write_offsets):
    """Single-token decode of every slot on the page pool. x: (B, 1, d);
    pos (B,) int32 per-row positions; table (B, nb) int32 page tables;
    the new K/V lands at pool[write_pages[b], write_offsets[b]] before
    kernel K1 attends positions < pos+1. Returns (B, 1, d)."""
    B, S, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.use_rope:
        pp = pos.reshape(B, 1)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k[:, 0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[:, 0].to(v_pool.dtype)
    out = _k1.paged_decode_attention(q[:, 0], k_pool, v_pool, table, pos + 1)
    out = out.reshape(B, S, nq, hd)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])
