"""Transformer layers in PyTorch (counterpart of `repro.models.layers`).

Plain functions on tensors and nested dicts of parameters, laid out as in
the JAX package (q/k/v projections (d, heads, head_dim), attention tensors
(B, S, H, D)). Only the subset the served path needs is ported: dense
attention (with the hybrid family's per-application LoRA adapters on q,
k, v and the output) and MLP, and DeepSeek-V2's MLA attention and
capacity-limited MoE.

The encoder-decoder family (whisper) adds LayerNorm, the encoder's
self-attention and the decoder's cross-attention over the encoder's
output, all of which see every key (kernel K2's non-causal form; K5 for a
decode step's cross-attention).

The attention of the serving path runs through kernels on either KV
layout. On the paged pool: K1 (decode), K2 (chunk prefill) and K4
(speculative verify). On the slab -- one contiguous (B, max_len, Hkv, hd)
cache per layer, the JAX package's `init_decode_cache` layout --
`attn_decode_apply_slab` runs K5, while `attn_apply_slab` (prefill) and
`attn_chunk_apply_slab` (verify) run K2 and K4 over the slab seen as a
page pool (`slab_pages`): the same bytes, no copy. `sdpa` and
`decode_attention` are the dense forms kept for the kernels' plain
versions and the tests.

MLA keeps a compressed cache, "ckv" (r) and "krope" (rope dim) per token,
and computes attention in plain PyTorch, as the JAX package does with
`jnp.einsum` (no TPU kernel computes it; K1/K2/K4/K5 take equal K and V
head dims): the slab forms attend the slab, and the paged forms index the
pools here in `layers` -- they gather each row's page-table view
(`page_view`), run the slab form on it and write the dirtied blocks back
(`write_view_blocks`), the JAX engine's own gather/scatter. MoE routes
through kernel K6 (`moe_gating`); dispatch, the expert products and the
combine are plain tensor code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels import moe_gating as _k6
from repro_torch.kernels import verify_attention as _k4

from .config import ModelConfig

# ---------------------------------------------------------------- norms ----


def rms_norm(x, w, eps: float):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def layer_norm(x, w, b, eps: float):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_apply(cfg: ModelConfig, p, x):
    if cfg.use_layernorm:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
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


def sinusoidal_positions(n: int, d: int, device=None):
    """(n, d) float32: sin of position / 10000^(2i/d) in the first half of
    the features, cos in the second (the encoder's fixed positions)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def _project_qkv(cfg: ModelConfig, p, x, lora=None):
    """q, k, v (B, S, heads, hd) of x (B, S, d); with `lora` (one
    application's adapter, the hybrid family's shared blocks) the low-rank
    deltas (x a) b are added before the bias and the q/k norms, as the JAX
    package adds them."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if lora is not None:
        q = q + ((x @ lora["a_q"]) @ lora["b_q"]).reshape(q.shape)
        k = k + ((x @ lora["a_k"]) @ lora["b_k"]).reshape(k.shape)
        v = v + ((x @ lora["a_v"]) @ lora["b_v"]).reshape(v.shape)
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(p, out, lora=None):
    """The output projection of the attention's heads (B, S, H, hd), plus
    the adapter's delta on it, out + (out a_o) b_o, when `lora` is given."""
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    if lora is not None:
        out = out + (out @ lora["a_o"]) @ lora["b_o"]
    return out


def attn_chunk_apply(cfg: ModelConfig, p, x, *, start: int, k_pool, v_pool,
                     ctx_ids, write_pages, write_offsets, lora=None):
    """Chunked-prefill attention of one sequence on the page pool: the C
    query tokens at positions [start, start+C) attend every key up to their
    own position (causal within the chunk, full over the filled prefix).

    x: (1, C, d). Pools (P, ps, Hkv, hd) of this layer; ctx_ids (n_ctx,)
    int32 the sequence's page table; the chunk's K/V is written in place at
    pool[write_pages[i], write_offsets[i]] (the page and slot of position
    start+i) before kernel K2 reads the context. The engine never lets a
    write land in the sink: a sink block the padded chunk writes is a
    scratch page in ctx_ids (`cache_ops.sink_plan`), so the chunk reads the
    sink as it was before the call plus its own tokens, as the JAX view.
    `lora`: the hybrid family's adapter of this application. Returns (1,
    C, d).
    """
    B, C, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q_pos = start + torch.arange(C, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        q = apply_rope(q, q_pos[None], cfg.rope_theta)
        k = apply_rope(k, q_pos[None], cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k[0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[0].to(v_pool.dtype)
    out = _k2.chunk_prefill_attention(q[0], k_pool, v_pool, ctx_ids, start)
    out = out.reshape(1, C, nq, hd)
    return _out_proj(p, out, lora)


def attn_decode_apply(cfg: ModelConfig, p, x, *, pos, k_pool, v_pool, table,
                      write_pages, write_offsets, lora=None):
    """Single-token decode of every slot on the page pool. x: (B, 1, d);
    pos (B,) int32 per-row positions; table (B, nb) int32 page tables;
    the new K/V lands at pool[write_pages[b], write_offsets[b]] before
    kernel K1 attends positions < pos+1. A dead row's table is the sink
    except the block it writes, which is its own scratch page, and a write
    at or past nb * ps (which JAX drops) goes to the trash page
    (`cache_ops.sink_plan`). `lora`: the hybrid family's adapter. Returns
    (B, 1, d)."""
    B, S, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        pp = pos.reshape(B, 1)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k[:, 0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[:, 0].to(v_pool.dtype)
    out = _k1.paged_decode_attention(q[:, 0], k_pool, v_pool, table, pos + 1)
    out = out.reshape(B, S, nq, hd)
    return _out_proj(p, out, lora)


def attn_verify_apply(cfg: ModelConfig, p, x, *, pos, k_pool, v_pool, table,
                      write_pages, write_offsets, lora=None):
    """Speculative-verify attention of every slot on the page pool: row b's
    C candidate tokens sit at positions pos[b] + c and attend every key up
    to their own position (causal within the candidates, full over the
    row's filled context) -- the paged form of the JAX `attn_chunk_apply`
    with a per-row start.

    x: (B, C, d); pos (B,) int32; table (B, nb) int32 page tables; the
    candidates' K/V is written in place at pool[write_pages[b, c],
    write_offsets[b, c]] before kernel K4 reads the context: a candidate in
    a sink block of the row's view (a dead row, or past the row's pages)
    is written to the row's scratch page for that block, which the table
    maps in its place, and one past the view, where the JAX package drops
    the write, to the trash page (`cache_ops.sink_plan`). `lora`: the
    hybrid family's adapter. Returns (B, C, d)."""
    B, C, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        q_pos = pos.reshape(B, 1) + torch.arange(C, device=x.device, dtype=pos.dtype)
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k.to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v.to(v_pool.dtype)
    # K4 reads q and writes its output in (B, C, H, D): on the card both
    # transposes are views, and no copy kernel runs around the launch
    out = _k4.paged_verify_attention(q.transpose(1, 2), k_pool, v_pool, table, pos)
    out = out.transpose(1, 2).reshape(B, C, nq, hd)
    return _out_proj(p, out, lora)


# ------------------------------------------------------------ slab KV ------
# A slab layer is (B, Smax, Hkv, hd). The model writes new K/V into it in
# place (the JAX package returns an updated copy); rows and positions the
# JAX scatter drops are dropped here too, never clamped or written out of
# bounds.


def cache_write(cache, new, pos):
    """Write one token's K/V (new (B, 1, Hkv, hd)) into a slab layer in
    place at `pos`: a 0-d tensor -- every row at the same position, clamped
    into the cache as `lax.dynamic_update_slice` clamps it -- or per-row
    positions (B,), where a row at or past Smax is dropped, as the JAX
    scatter drops it (a slot that is not live keeps advancing its
    position). No host synchronisation."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    val = new[:, 0].to(cache.dtype)
    if pos.ndim == 0:
        cache[rows, pos.clamp(0, S - 1).long().expand(B)] = val
        return cache
    idx = pos.long()
    ok = (idx < S).reshape((B,) + (1,) * (val.ndim - 1))
    idx = idx.clamp(max=S - 1)
    cache[rows, idx] = torch.where(ok, val, cache[rows, idx])
    return cache


def cache_write_chunk(cache, new, start):
    """Write a C-token chunk's K/V (new (B, C, Hkv, hd)) into a slab layer
    in place at positions [start, start+C). `start` is an int or 0-d
    tensor (every row shares the offset, clamped so the chunk fits, as
    `lax.dynamic_update_slice` clamps it) or per-row (B,) (batched
    speculative verification): then positions at or past Smax are dropped,
    as JAX's `mode="drop"` scatter drops them -- a verify chunk near the
    bound must never be clamped backward over valid earlier K/V."""
    B, C = new.shape[:2]
    S = cache.shape[1]
    val = new.to(cache.dtype)
    if not torch.is_tensor(start) or start.ndim == 0:
        s = min(max(int(start), 0), S - C)
        cache[:, s:s + C] = val
        return cache
    pos = start.long()[:, None] + torch.arange(C, device=cache.device)[None, :]
    ok = pos < S
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, C)
    cache[rows[ok], pos[ok]] = val[ok]
    return cache


def slab_page_size(max_len: int) -> int:
    """Page size of the slab's page-pool view: the largest divisor of
    max_len not above 64, which K2's shared-memory check accepts for every
    head_dim up to 256."""
    return max(d for d in range(1, min(64, max_len) + 1) if max_len % d == 0)


def slab_pages(layer, ps: int):
    """A slab layer (B, Smax, Hkv, hd) seen as a page pool (B*Smax/ps, ps,
    Hkv, hd): the same bytes, no copy. Row b's table is b*nb + arange(nb)
    (`slab_tables`)."""
    B, S = layer.shape[:2]
    return layer.view((B * (S // ps), ps) + tuple(layer.shape[2:]))


def slab_tables(B: int, S: int, ps: int, device):
    """(B, S/ps) int32 page tables of the slab's page-pool view."""
    nb = S // ps
    return torch.arange(B * nb, dtype=torch.int32, device=device).reshape(B, nb)


def attn_apply_slab(cfg: ModelConfig, p, x, *, k_cache, v_cache, tables, lora=None):
    """Causal self-attention of a full prefill from position 0 (the JAX
    `attn_apply` of `prefill`), writing the K/V into slab layers. x
    (B, S, d); caches (B, Smax, Hkv, hd) of this layer, written in place at
    [0, S); tables (B, Smax/ps) from `slab_tables`. Each row runs kernel K2
    over its slab seen as pages, the whole prompt as one chunk. Returns
    (B, S, d)."""
    B, S, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        q = apply_rope(q, positions[None], cfg.rope_theta)
        k = apply_rope(k, positions[None], cfg.rope_theta)
    cache_write_chunk(k_cache, k, 0)
    cache_write_chunk(v_cache, v, 0)
    ps = k_cache.shape[1] // tables.shape[1]
    kp, vp = slab_pages(k_cache, ps), slab_pages(v_cache, ps)
    out = torch.stack([_k2.chunk_prefill_attention(q[b], kp, vp, tables[b], 0)
                       for b in range(B)])
    out = out.reshape(B, S, nq, hd)
    return _out_proj(p, out, lora)


def attn_decode_apply_slab(cfg: ModelConfig, p, x, *, pos, k_cache, v_cache, lora=None):
    """Single-token decode on slab layers (the JAX `attn_decode_apply`).
    x (B, 1, d); pos a 0-d tensor or per-row (B,) int32; the new K/V is
    written at pos (`cache_write`) before kernel K5 attends positions
    < pos + 1. Returns (B, 1, d)."""
    B, S, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        pp = pos.reshape(-1, 1).expand(B, S)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    cache_write(k_cache, k, pos)
    cache_write(v_cache, v, pos)
    out = _k1.decode_attention(q[:, 0], k_cache, v_cache, pos + 1)
    out = out.reshape(B, S, nq, hd)
    return _out_proj(p, out, lora)


def attn_chunk_apply_slab(cfg: ModelConfig, p, x, *, start, k_cache, v_cache, tables, lora=None):
    """Speculative-verify attention on slab layers (the JAX
    `attn_chunk_apply` with a per-row start): row b's C candidates sit at
    positions start[b] + c, are written there (positions at or past Smax
    dropped, `cache_write_chunk`) and attend every key up to their own
    position through kernel K4 over the slab seen as pages. x (B, C, d);
    start (B,) int32; tables (B, Smax/ps). Returns (B, C, d)."""
    B, C, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, lora)
    if cfg.use_rope:
        q_pos = start.reshape(B, 1) + torch.arange(C, device=x.device, dtype=start.dtype)
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    cache_write_chunk(k_cache, k, start)
    cache_write_chunk(v_cache, v, start)
    ps = k_cache.shape[1] // tables.shape[1]
    out = _k4.paged_verify_attention(q.transpose(1, 2), slab_pages(k_cache, ps),
                                     slab_pages(v_cache, ps), tables, start)
    out = out.transpose(1, 2).reshape(B, C, nq, hd)
    return _out_proj(p, out, lora)


# -------------------------------------------- encoder-decoder (whisper) ----
# The encoder's self-attention and the decoder's cross-attention see every
# key. Kernel K2's non-causal form (`flash_attention.bidirectional_attention`)
# runs the encoder over its frames and a chunk's, a verify round's or a
# whole prompt's queries over the cross K/V; kernel K5 runs a decode step's
# one query a row over it, at length encoder_seq.


def attn_apply_bidirectional(cfg: ModelConfig, p, x):
    """The encoder's self-attention (the JAX `attn_apply(causal=False)`):
    every position attends every position (no rope: the family's configs
    use learned and fixed positions). x (B, S, d) -> (B, S, d)."""
    q, k, v = _project_qkv(cfg, p, x)
    out = _k2.bidirectional_attention(q, k.contiguous(), v.contiguous(), k.shape[1])
    return _out_proj(p, out)


def cross_kv(p, enc_out):
    """A decoder layer's cross K/V of the encoder output (B, S, d): each
    (B, S, Hkv, hd), without bias, as the JAX package projects them."""
    return (torch.einsum("bsd,dhe->bshe", enc_out, p["wk"]).contiguous(),
            torch.einsum("bsd,dhe->bshe", enc_out, p["wv"]).contiguous())


def _cross_query(cfg: ModelConfig, p, x):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def cross_attn_apply(cfg: ModelConfig, p, x, *, ck, cv):
    """Cross-attention of C queries a row over that row's cross K/V (the
    JAX `attn_chunk_apply(cross=True)` and `attn_apply(kv_override=)`):
    x (B, C, d); ck, cv (B, S, Hkv, hd), contiguous. Every query sees all S
    keys. Returns (B, C, d)."""
    out = _k2.bidirectional_attention(_cross_query(cfg, p, x), ck, cv, ck.shape[1])
    return _out_proj(p, out)


def cross_decode_apply(cfg: ModelConfig, p, x, *, ck, cv):
    """A decode step's cross-attention (the JAX `attn_decode_apply(cross=
    True)`): x (B, 1, d), one query a row over its cross K/V ck, cv (B, S,
    Hkv, hd) at length S. Returns (B, 1, d)."""
    q = _cross_query(cfg, p, x)
    out = _k1.decode_attention(q[:, 0], ck, cv, ck.shape[1])
    return _out_proj(p, out[:, None])


# ------------------------------------------------------------------ MLA ----
# DeepSeek-V2's multi-head latent attention. The cache holds, per token,
# the normed compressed KV c_kv (r = kv_lora_rank) and the shared rotary
# key k_rope (qk_rope_dim). Decode and chunks run the absorbed form: w_uk
# folds into the query and w_uv into the context, so the 16 heads attend
# one compressed key of width r + rd and read V = c_kv. Op order as the
# JAX package's: q_abs in the model dtype, both score products in float32
# (upcast operands, as `preferred_element_type=jnp.float32`), the scale,
# the -inf mask, a float32 softmax, probabilities cast to the cache dtype
# before the context product, then w_uv and wo.


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def chunk_positions(start, B: int, C: int, device):
    """(B, C) query positions of a chunk at `start` (an int, a 0-d tensor
    or per-row (B,))."""
    s = torch.as_tensor(start, device=device).reshape(-1, 1).long()
    return (s + torch.arange(C, device=device)[None, :]).expand(B, C)


def mla_project(cfg: ModelConfig, p, x, positions):
    """Shared query and compressed-KV projections. x (B, S, d); positions
    broadcastable to (B, S). Returns q_nope (B, S, H, nd), q_rope (B, S,
    H, rd), c_kv (B, S, r), k_rope (B, S, rd)."""
    nd, r = cfg.qk_nope_dim, cfg.kv_lora_rank
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., r:][..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(cfg: ModelConfig, p, x, *, positions):
    """Full-sequence causal MLA in the non-absorbed form (the slab's
    whole-prompt prefill): per-head K = [c_kv w_uk, k_rope] (nd + rd) and
    V = c_kv w_uv (vd). Returns (out (B, S, d), c_kv, k_rope)."""
    B, S, _ = x.shape
    H, vd, rd = cfg.n_heads, cfg.v_head_dim, cfg.qk_rope_dim
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    out = sdpa(q[:, :, :, None, :], k, v, causal=True, scale=_mla_scale(cfg))
    out = out.reshape(B, S, H, vd)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), c_kv, k_rope


def _mla_attend(cfg: ModelConfig, p, q_nope, q_rope, ckv, krope, q_pos):
    """Absorbed attention of queries at q_pos (B, C) over a compressed
    cache (B, T, r) / (B, T, rd): keys at positions <= the query's own."""
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
    s = s + torch.einsum("bshe,bte->bhst", q_rope.float(), krope.float())
    s = s * _mla_scale(cfg)
    ok = torch.arange(ckv.shape[1], device=ckv.device)[None, None, :] <= q_pos[:, :, None]
    s = s.masked_fill(~ok[:, None], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", pr.to(ckv.dtype), ckv)
    out = torch.einsum("bshr,rhe->bshe", ctx, p["w_uv"])
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def mla_decode_apply_slab(cfg: ModelConfig, p, x, *, pos, ckv_cache, krope_cache):
    """Single-token MLA decode on slab layers (the JAX `mla_decode_apply`).
    x (B, 1, d); pos a 0-d tensor or per-row (B,); the token's c_kv/k_rope
    are written at pos (`cache_write`: clamped, or dropped past the slab
    per row) before it attends positions <= pos. Returns (B, 1, d)."""
    B, S, _ = x.shape
    pp = pos.reshape(-1, 1).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, pp)
    cache_write(ckv_cache, c_kv, pos)
    cache_write(krope_cache, k_rope, pos)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv_cache, krope_cache, pp)


def mla_chunk_apply_slab(cfg: ModelConfig, p, x, *, start, ckv_cache, krope_cache):
    """C-token MLA chunk on slab layers (the JAX `mla_chunk_apply`): the
    chunk's compressed KV is written at [start, start+C) (`cache_write_chunk`:
    a shared start clamped, per-row (B,) starts dropped past the slab) and
    each query attends positions <= its own. Returns (B, C, d)."""
    B, C, _ = x.shape
    q_pos = chunk_positions(start, B, C, x.device)
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, q_pos)
    cache_write_chunk(ckv_cache, c_kv, start)
    cache_write_chunk(krope_cache, k_rope, start)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv_cache, krope_cache, q_pos)


def page_view(pool, table):
    """Each row's context gathered through its page table, as the JAX
    package's `cache_ops.gather_page_views`: pool (P, ps, *tail), table
    (B, nb) -> a (B, nb * ps, *tail) copy."""
    g = pool[table.long()]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))


def write_view_blocks(pool, view, blocks, ids):
    """Write blocks (B, n) of each row's `page_view` back into the pool's
    pages ids (B, n), in place, as the JAX engine's page scatter: where a
    page id repeats (only the sink does: dead rows and blocks past a row's
    pages), the last (row, block) in row-major order wins, which is what
    the JAX CPU scatter leaves there. Every duplicate carries that block,
    so the write is deterministic on the card too. Dead rows read the sink
    back, and with MoE a dead row's tokens compete for expert capacity, so
    its contents are part of the result."""
    ps = pool.shape[1]
    B = view.shape[0]
    tail = tuple(view.shape[2:])
    rows = torch.arange(B, device=view.device)[:, None].expand_as(blocks)
    pages = view.reshape((B, -1, ps) + tail)[rows, blocks].reshape((-1, ps) + tail)
    flat = ids.reshape(-1).long()
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.where(flat[None, :] == flat[:, None], order[None, :], -1).amax(1)
    pool[flat] = pages[last].to(pool.dtype)


def mla_decode_apply(cfg: ModelConfig, p, x, *, pos, ckv_pool, krope_pool, table,
                     write_pages):
    """Single-token MLA decode of every slot on the page pool. Pools (P, ps,
    r) / (P, ps, rd) of this layer; table (B, nb) page tables; pos (B,);
    write_pages (B,) the page holding pos (the sink for a dead row). Each
    row attends its gathered view with the token written in, and the view
    block holding pos (clamped into the view) goes back to write_pages.
    Returns (B, 1, d)."""
    ps = ckv_pool.shape[1]
    ckv, kr = page_view(ckv_pool, table), page_view(krope_pool, table)
    out = mla_decode_apply_slab(cfg, p, x, pos=pos, ckv_cache=ckv, krope_cache=kr)
    blocks = (pos.long() // ps).clamp(max=table.shape[1] - 1)[:, None]
    ids = write_pages.reshape(-1, 1)
    write_view_blocks(ckv_pool, ckv, blocks, ids)
    write_view_blocks(krope_pool, kr, blocks, ids)
    return out


def mla_chunk_apply(cfg: ModelConfig, p, x, *, start: int, ckv_pool, krope_pool, ctx_ids):
    """MLA prefill chunk of one sequence on the page pool: x (1, C, d) at
    positions [start, start+C); ctx_ids (n_ctx,) the sequence's page table.
    The view's blocks [b0, b0 + nb) that the padded chunk can dirty go back
    to their pages (the sink past the sequence's pages), with nb and b0 as
    the JAX engine's chunk scatter. Returns (1, C, d)."""
    ps = ckv_pool.shape[1]
    C, n_ctx = x.shape[1], ctx_ids.shape[0]
    table = ctx_ids[None]
    ckv, kr = page_view(ckv_pool, table), page_view(krope_pool, table)
    out = mla_chunk_apply_slab(cfg, p, x, start=start, ckv_cache=ckv, krope_cache=kr)
    nb = (C + ps - 2) // ps + 1 if ps > 1 else C
    b0 = min(start // ps, n_ctx - nb)
    blocks = torch.arange(b0, b0 + nb, device=x.device)[None]
    ids = table[:, b0:b0 + nb]
    write_view_blocks(ckv_pool, ckv, blocks, ids)
    write_view_blocks(krope_pool, kr, blocks, ids)
    return out


def mla_verify_apply(cfg: ModelConfig, p, x, *, pos, ckv_pool, krope_pool, table,
                     block0s):
    """Speculative-verify MLA of every slot on the page pool: row b's C
    candidates sit at pos[b] + c (per-row start; positions past the view
    dropped) and attend its gathered view. Blocks [block0s[b], block0s[b] +
    nb) of each view go back to the row's pages (the sink past them, and
    for a dead row), as the JAX engine's verify scatter. Returns (B, C, d)."""
    ps = ckv_pool.shape[1]
    C = x.shape[1]
    ckv, kr = page_view(ckv_pool, table), page_view(krope_pool, table)
    out = mla_chunk_apply_slab(cfg, p, x, start=pos, ckv_cache=ckv, krope_cache=kr)
    nb = (C + ps - 2) // ps + 1 if ps > 1 else C
    blocks = block0s.long()[:, None] + torch.arange(nb, device=x.device)[None, :]
    ids = table.long().gather(1, blocks)
    write_view_blocks(ckv_pool, ckv, blocks, ids)
    write_view_blocks(krope_pool, kr, blocks, ids)
    return out


# ------------------------------------------------------------------ MoE ----


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: capacity_factor x k x T / E, rounded
    up to a multiple of 8, at least 8."""
    C = int(math.ceil(cfg.capacity_factor * cfg.moe_top_k * T / cfg.n_experts))
    return max(8, -(-C // 8) * 8)


def moe_apply(cfg: ModelConfig, p, x):
    """Capacity-limited top-k MoE with gather/scatter dispatch (the JAX
    `moe_apply`, ungrouped). x (B, S, d) -> (B, S, d).

    Every token of the call counts toward capacity (C from T = B * S, pad
    positions and dead rows included), and assignments are numbered in
    (token, rank) order: an expert's slots go to its first C assignments
    and later ones are dropped (GShard-style), so tokens of one call
    interact. Kernel K6 takes the router logits in the model dtype and
    computes the gating and that numbering in one launch: each
    assignment's slot (e * C + pos, or the drop slot E * C) and its kept
    weight. Each token's k weighted expert rows are summed in
    rank order from zeros in the model dtype -- the JAX CPU scatter-add's
    order -- and not with `index_add_`, whose atomics on the card sum in an
    order that changes from run to run."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    T, E, K = B * S, cfg.n_experts, cfg.moe_top_k
    C = moe_capacity(cfg, T)
    _, _, slot, kept = _k6.moe_gating(x2 @ p["router"], K, C)
    xe = x2.new_zeros((E * C + 1, d))
    # each token's row once a rank; kept slots are distinct, the drop slot is cut
    xe[slot] = x2[:, None, :].expand(T, K, d).reshape(T * K, d)
    xe = xe[:E * C].reshape(E, C, d)
    act = activation_fn(cfg.activation)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    back = ye_flat[slot] * kept[:, None].to(ye.dtype)
    back = back.reshape(T, K, d)
    y = x2.new_zeros((T, d))
    for j in range(K):
        y = y + back[:, j]
    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (act(x2 @ sp["w_gate"]) * (x2 @ sp["w_up"])) @ sp["w_down"]
    return y.reshape(B, S, d)
