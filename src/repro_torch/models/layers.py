"""Transformer layers in PyTorch (counterpart of `repro.models.layers`).

Plain functions on tensors and nested dicts of parameters, laid out as in
the JAX package (q/k/v projections (d, heads, head_dim), attention tensors
(B, S, H, D)). The served path's subset and training's full-sequence
forms are ported: dense attention (with the hybrid family's
per-application LoRA adapters on q, k, v and the output) and MLP, and
DeepSeek-V2's MLA attention and capacity-limited MoE.

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

Serving and training (the full-sequence `attn_apply`, `moe_apply(
return_aux=True)`) share these functions: K2, its non-causal form and K6
run through their autograd forms (`kernels.autograd`), which call the
kernels' wrappers directly where no input records a gradient.

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

from repro_torch.kernels import autograd as _kag
from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import flash_attention as _k2
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


# ------------------------------------------------------- mesh regions ----


def _region(tp, out_name: str, dim: int) -> bool:
    """Whether a block runs as a column-parallel region on this mesh rank
    with a gradient: its row-parallel product `out_name` holds dim `dim`
    over `model` and sums over it, and autograd records. Its input (and its
    parameters replicated over `model`) then enter through
    `MeshRank.model_in`, whose backward sums the ranks' partial gradients;
    serving, which records none, skips it."""
    return tp is not None and torch.is_grad_enabled() and tp.on_model(out_name, dim)


# ------------------------------------------------------------------ mlp ----


def mlp_apply(cfg: ModelConfig, p, x, tp=None):
    """The MLP; on a mesh (`tp`, a `distributed.sharding.MeshRank`) with
    this rank's columns of w_gate/w_up/w_in and rows of w_down, whose
    partial products are summed over `model` (a column-parallel region
    with a gradient, `_region`)."""
    if _region(tp, "mlp/w_down", 0):
        x = tp.model_in(x)
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_in"])
    y = h @ p["w_down"]
    if tp is not None and tp.on_model("mlp/w_down", 0):
        y = tp.model_sum(y)
    return y


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


def _lora_b(tp, lora, name: str, proj: str, inside: bool = False):
    """The adapter's b_* for a projection's heads. On a mesh b_* (r, heads
    x hd) has its columns over `model` where they divide: the rank's heads
    where the projection's heads are over `model` too, and otherwise a
    split inside a head, which is gathered whole (and, `inside` a
    column-parallel region with a gradient, its gradient summed over
    `model` before the rank's slice)."""
    b = lora[name]
    if tp is not None and tp.on_model(name, 1) and not tp.on_model(proj, 1):
        b = tp.model_cat(b)
        if inside:
            b = tp.model_in(b)
    return b


_LORA_IN = ("a_q", "a_k", "a_v", "b_q", "b_k", "b_v")


def _project_qkv(cfg: ModelConfig, p, x, lora=None, tp=None):
    """q, k, v (B, S, heads, hd) of x (B, S, d); with `lora` (one
    application's adapter, the hybrid family's shared blocks) the low-rank
    deltas (x a) b are added before the bias and the q/k norms, as the JAX
    package adds them. On a mesh (`tp`) the heads are the rank's where the
    weights hold them so; where wo's heads are over `model` and autograd
    records, the projections are a column-parallel region (`_region`):
    x, the leaves replicated over `model` and the adapter's inputs enter
    through `MeshRank.model_in`."""
    inside = _region(tp, "attn/wo", 0)
    if inside:
        x, p = tp.model_in(x), tp.region(p, "attn")
        if lora is not None:
            lora = tp.region(lora, "", _LORA_IN)
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if lora is not None:
        q = q + ((x @ lora["a_q"]) @ _lora_b(tp, lora, "b_q", "attn/wq", inside)
                 ).reshape(q.shape)
        k = k + ((x @ lora["a_k"]) @ _lora_b(tp, lora, "b_k", "attn/wk", inside)
                 ).reshape(k.shape)
        v = v + ((x @ lora["a_v"]) @ _lora_b(tp, lora, "b_v", "attn/wv", inside)
                 ).reshape(v.shape)
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(p, out, lora=None, tp=None):
    """The output projection of the attention's heads (B, S, H, hd), plus
    the adapter's delta on it, out + (out a_o) b_o, when `lora` is given.
    On a mesh (`tp`) the heads are this rank's, and where wo's heads are
    over `model` the partial products are summed over it."""
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    if tp is not None and tp.on_model("attn/wo", 0):
        out = tp.model_sum(out)
    if lora is not None:
        out = out + (out @ lora["a_o"]) @ lora["b_o"]
    return out


def _rank_heads(cfg: ModelConfig, q, n_kv: int, tp, dim: int = 1):
    """A kernel's query for this rank's query heads, on `dim` of q, over a
    pool of n_kv KV heads, and the map of the kernel's output back to those
    heads. Off a mesh, and where the pool's heads are the rank's KV heads
    (both split over `model`, or neither), that is q itself. Where the
    query heads are split and the pool keeps every KV head (n_kv_heads
    does not divide the `model` size, `pool_specs`), each local head i sits
    in its own KV head's group of a wider query, kv(i) * h + i, and reads
    that head; the other entries are zeros whose outputs are dropped."""
    h = q.shape[dim]
    if tp is None or h * cfg.n_kv_heads == n_kv * cfg.n_heads:
        return q, lambda out: out
    G = cfg.n_heads // cfg.n_kv_heads
    local = torch.arange(h, device=q.device)
    idx = ((tp.model_rank * h + local) // G) * h + local
    shape = list(q.shape)
    shape[dim] = n_kv * h
    wide = q.new_zeros(shape).index_copy_(dim, idx, q)
    return wide, lambda out: out.index_select(dim, idx)


def _whole_heads(tp, proj: str, t):
    """t (B, S, heads, hd) of projection `proj` with every head on every
    rank: gathered over `model` where the weight holds the rank's heads."""
    return tp.model_cat_dim(t, 2) if tp is not None and tp.on_model(proj, 1) else t


def _rank_kv(cfg: ModelConfig, q, k_layer, v_layer, tp, dim: int = 2):
    """This rank's query heads q (on `dim`) against the KV heads they read,
    where the query heads are over `model` and the slab layers (B, S, Hkv,
    hd) keep every KV head. The rank's h heads from head f = r * h read KV
    heads [a, b) (a = f // G, b = (f + h - 1) // G + 1, G = H / Hkv): the
    layers keep those heads (a copy unless they are all), and the kernel's
    query is q itself where its heads read them in the kernel's grouping
    (all one KV head, or whole groups), else q widened to the (b - a) G
    heads of those groups, the other entries zeros whose outputs are
    dropped -- never more heads than the whole query. Off a mesh, and
    where q holds every head, that is q and the layers as they are.
    Returns (q', k', v', back), back(out) the rank's heads of the output."""
    h = q.shape[dim]
    if tp is None or h == cfg.n_heads:
        return q, k_layer, v_layer, lambda out: out
    G = cfg.n_heads // cfg.n_kv_heads
    first = tp.model_rank * h
    a, b = first // G, (first + h - 1) // G + 1
    if (a, b) != (0, k_layer.shape[2]):
        k_layer = k_layer[:, :, a:b].contiguous()
        v_layer = v_layer[:, :, a:b].contiguous()
    if b - a == 1 or h % G == 0:
        return q, k_layer, v_layer, lambda out: out
    idx = first - a * G + torch.arange(h, device=q.device)
    shape = list(q.shape)
    shape[dim] = (b - a) * G
    wide = q.new_zeros(shape).index_copy_(dim, idx, q)
    return wide, k_layer, v_layer, lambda out: out.index_select(dim, idx)


def _rank_out(tp, out):
    """The rank's heads of an attention output (B, S, H, hd) computed for
    every head, where wo holds the rank's heads."""
    return tp.model_slice(out, 2) if tp is not None and tp.on_model("attn/wo", 0) else out


def _seq_whole(tp, layer):
    """A slab layer (B, S_loc, ...) whole: where its sequence is over
    `model` (`MeshRank.seq_split`), the ranks' shards gathered, and the
    function that writes the rank's part of a whole layer back into it."""
    if tp is None or not tp.seq_split:
        return layer, lambda whole: None
    return tp.model_cat_dim(layer, 1), lambda whole: layer.copy_(tp.model_slice(whole, 1))


def _rows_kv(tp, k, v, B: int):
    """Every row's K and V from this rank's rows (`MeshRank.rows_cat`), in
    one all-gather."""
    kv = tp.rows_cat(torch.cat([k, v], dim=-1), B)
    return kv.split(k.shape[-1], dim=-1)


def attn_chunk_apply(cfg: ModelConfig, p, x, *, start: int, k_pool, v_pool,
                     ctx_ids, write_pages, write_offsets, lora=None, tp=None):
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
    `lora`: the hybrid family's adapter of this application. On a mesh
    (`tp`, a `distributed.sharding.MeshRank`) the weights hold this rank's
    heads, the pools its head shard, and every rank runs the chunk.
    Returns (1, C, d).
    """
    B, C, _ = x.shape
    q_pos = start + torch.arange(C, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        q = apply_rope(q, q_pos[None], cfg.rope_theta)
        k = apply_rope(k, q_pos[None], cfg.rope_theta)
    k_pool[write_pages, write_offsets] = k[0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[0].to(v_pool.dtype)
    qk, back = _rank_heads(cfg, q[0], k_pool.shape[2], tp)
    out = back(_k2.chunk_prefill_attention(qk, k_pool, v_pool, ctx_ids, start))
    out = out.reshape(1, C, q.shape[2], q.shape[3])
    return _out_proj(p, out, lora, tp)


def attn_decode_apply(cfg: ModelConfig, p, x, *, pos, k_pool, v_pool, table,
                      write_pages, write_offsets, lora=None, tp=None):
    """Single-token decode of every slot on the page pool. x: (B, 1, d);
    pos (B,) int32 per-row positions; table (B, nb) int32 page tables;
    the new K/V lands at pool[write_pages[b], write_offsets[b]] before
    kernel K1 attends positions < pos+1. A dead row's table is the sink
    except the block it writes, which is its own scratch page, and a write
    at or past nb * ps (which JAX drops) goes to the trash page
    (`cache_ops.sink_plan`). `lora`: the hybrid family's adapter. On a
    mesh (`tp`) x, pos and table are this rank's rows (`MeshRank.rows`)
    and its heads; write_pages and write_offsets are every row's, and the
    rows' K/V is all-gathered over `data` and written on every rank (the
    pool replicates over `data`). Returns (B, 1, d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        pp = pos.reshape(B, 1)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    if tp is not None:
        k, v = _rows_kv(tp, k, v, write_pages.shape[0])
    k_pool[write_pages, write_offsets] = k[:, 0].to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v[:, 0].to(v_pool.dtype)
    qk, back = _rank_heads(cfg, q[:, 0], k_pool.shape[2], tp)
    out = back(_k1.paged_decode_attention(qk, k_pool, v_pool, table, pos + 1))
    out = out.reshape(B, S, q.shape[2], q.shape[3])
    return _out_proj(p, out, lora, tp)


def attn_verify_apply(cfg: ModelConfig, p, x, *, pos, k_pool, v_pool, table,
                      write_pages, write_offsets, lora=None, tp=None):
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
    hybrid family's adapter. On a mesh (`tp`) as `attn_decode_apply`: this
    rank's rows and heads, every row's K/V written. Returns (B, C, d)."""
    B, C, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        q_pos = pos.reshape(B, 1) + torch.arange(C, device=x.device, dtype=pos.dtype)
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    if tp is not None:
        k, v = _rows_kv(tp, k, v, write_pages.shape[0])
    k_pool[write_pages, write_offsets] = k.to(k_pool.dtype)
    v_pool[write_pages, write_offsets] = v.to(v_pool.dtype)
    # K4 reads q and writes its output in (B, C, H, D): on the card both
    # transposes are views, and no copy kernel runs around the launch
    qk, back = _rank_heads(cfg, q.transpose(1, 2), k_pool.shape[2], tp)
    out = back(_k4.paged_verify_attention(qk, k_pool, v_pool, table, pos))
    out = out.transpose(1, 2).reshape(B, C, q.shape[2], q.shape[3])
    return _out_proj(p, out, lora, tp)


# ------------------------------------------------------------ slab KV ------
# A slab layer is (B, Smax, Hkv, hd). The model writes new K/V into it in
# place (the JAX package returns an updated copy); rows and positions the
# JAX scatter drops are dropped here too, never clamped or written out of
# bounds.


def cache_write(cache, new, pos, n_shards: int = 1, shard: int = 0):
    """Write one token's K/V (new (B, 1, Hkv, hd)) into a slab layer in
    place at `pos`: a 0-d tensor -- every row at the same position, clamped
    into the cache as `lax.dynamic_update_slice` clamps it -- or per-row
    positions (B,), where a row at or past Smax is dropped, as the JAX
    scatter drops it (a slot that is not live keeps advancing its
    position). With `n_shards` > 1 the layer is shard `shard` of a
    sequence cut in n_shards equal parts (a slab over `model`): a position
    is global, and one outside the shard is not written here. No host
    synchronisation."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    val = new[:, 0].to(cache.dtype)
    if pos.ndim == 0 and n_shards == 1:
        cache[rows, pos.clamp(0, S - 1).long().expand(B)] = val
        return cache
    if pos.ndim == 0:
        pos = pos.clamp(0, S * n_shards - 1).expand(B)
    idx = pos.long() - shard * S
    ok = ((idx >= 0) & (idx < S)).reshape((B,) + (1,) * (val.ndim - 1))
    idx = idx.clamp(0, S - 1)
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


def attn_apply_slab(cfg: ModelConfig, p, x, *, k_cache, v_cache, tables, lora=None,
                    tp=None):
    """Causal self-attention of a full prefill from position 0 (the JAX
    `attn_apply` of `prefill`), writing the K/V into slab layers. x
    (B, S, d); caches (B, Smax, Hkv, hd) of this layer, written in place at
    [0, S); tables (B, Smax/ps) from `slab_tables`. Each row runs kernel K2
    over its slab seen as pages, the whole prompt as one chunk. On a mesh
    (`tp`) the slab holds every KV head and, where `tp.seq_split`, the
    rank's part of the sequence: every head's k/v is gathered, the layer's
    shards are gathered whole for the write, the rank's part goes back, and
    K2 runs the rank's query heads over the KV heads they read
    (`_rank_kv`). Returns (B, S, d)."""
    q, k, v = _project_from0(cfg, p, x, lora, tp)
    k, v = _whole_heads(tp, "attn/wk", k), _whole_heads(tp, "attn/wv", v)
    kc, k_back = _seq_whole(tp, k_cache)
    vc, v_back = _seq_whole(tp, v_cache)
    cache_write_chunk(kc, k, 0)
    cache_write_chunk(vc, v, 0)
    k_back(kc)
    v_back(vc)
    return _attend_slab(cfg, p, q, kc, vc, tables, lora, tp)


def _whole_qkv(tp, q, k, v):
    """q, k, v with every head on every rank (`_whole_heads`)."""
    return (_whole_heads(tp, "attn/wq", q), _whole_heads(tp, "attn/wk", k),
            _whole_heads(tp, "attn/wv", v))


def _project_from0(cfg: ModelConfig, p, x, lora=None, tp=None):
    """q, k, v of x (B, S, d) at positions 0..S-1, rotated where the config
    uses rope."""
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        positions = torch.arange(x.shape[1], device=x.device)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend_slab(cfg: ModelConfig, p, q, k_layer, v_layer, tables, lora=None, tp=None,
                 rank_kv=True):
    """Each row's queries q (B, S, H, hd) from position 0 through kernel K2
    (its autograd form) over the row's K/V of slab layers (B, Smax, Hkv,
    hd) seen as pages, one launch a row, then the output projection. On a
    mesh q holds the rank's heads, which read their KV heads (`_rank_kv`;
    `rank_kv` False: the layers already hold the rank's KV heads)."""
    B, S = q.shape[:2]
    back = lambda out: out  # noqa: E731
    if rank_kv:
        q, k_layer, v_layer, back = _rank_kv(cfg, q, k_layer, v_layer, tp)
    ps = k_layer.shape[1] // tables.shape[1]
    kp, vp = slab_pages(k_layer, ps), slab_pages(v_layer, ps)
    out = torch.stack([_kag.chunk_prefill_attention(q[b], kp, vp, tables[b], 0)
                       for b in range(B)])
    out = back(out.reshape(B, S, q.shape[2], cfg.resolved_head_dim))
    return _out_proj(p, out, lora, tp)


def attn_decode_apply_slab(cfg: ModelConfig, p, x, *, pos, k_cache, v_cache, lora=None,
                           attn_impl=None, tp=None):
    """Single-token decode on slab layers (the JAX `attn_decode_apply`).
    x (B, 1, d); pos a 0-d tensor or per-row (B,) int32; the new K/V is
    written at pos (`cache_write`) before kernel K5 attends positions
    < pos + 1. `attn_impl(q (B, 1, Hkv, G, hd), k_cache, v_cache, length)`
    replaces K5 where given (the sequence-sharded combine of
    `distributed.decode`). On a mesh (`tp`) every head's q/k/v is gathered
    (the slab holds every KV head) and the kernel runs every query head:
    it reads each KV head of the layer once whichever query heads read it,
    so the rank's heads alone would save no KV bytes without copying their
    KV heads out of the layer. Where `tp.seq_split` the layers are the
    rank's sequence shard, the token is written only by the rank that holds
    its position, and `attn_impl` is the combine. Returns (B, 1, d)."""
    B, S, _ = x.shape
    nq, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        pp = pos.reshape(-1, 1).expand(B, S)
        q = apply_rope(q, pp, cfg.rope_theta)
        k = apply_rope(k, pp, cfg.rope_theta)
    q, k, v = _whole_qkv(tp, q, k, v)
    shards = (1, 0) if tp is None else tp.seq_shards
    cache_write(k_cache, k, pos, *shards)
    cache_write(v_cache, v, pos, *shards)
    if attn_impl is not None:
        nkv = k_cache.shape[2]
        out = attn_impl(q.reshape(B, S, nkv, nq // nkv, hd), k_cache, v_cache, pos + 1)
    else:
        out = _k1.decode_attention(q[:, 0], k_cache, v_cache, pos + 1)
    out = out.reshape(B, S, nq, hd)
    return _out_proj(p, _rank_out(tp, out), lora, tp)


def attn_chunk_apply_slab(cfg: ModelConfig, p, x, *, start, k_cache, v_cache, tables, lora=None,
                          tp=None):
    """Speculative-verify attention on slab layers (the JAX
    `attn_chunk_apply` with a per-row start): row b's C candidates sit at
    positions start[b] + c, are written there (positions at or past Smax
    dropped, `cache_write_chunk`) and attend every key up to their own
    position through kernel K4 over the slab seen as pages. x (B, C, d);
    start (B,) int32; tables (B, Smax/ps). On a mesh (`tp`) as
    `attn_apply_slab`: every KV head, the layer gathered whole where its
    sequence is over `model`, and K4 over the rank's query heads. Returns
    (B, C, d)."""
    B, C, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, lora, tp)
    if cfg.use_rope:
        q_pos = start.reshape(B, 1) + torch.arange(C, device=x.device, dtype=start.dtype)
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    k, v = _whole_heads(tp, "attn/wk", k), _whole_heads(tp, "attn/wv", v)
    kc, k_back = _seq_whole(tp, k_cache)
    vc, v_back = _seq_whole(tp, v_cache)
    cache_write_chunk(kc, k, start)
    cache_write_chunk(vc, v, start)
    k_back(kc)
    v_back(vc)
    q, kl, vl, back = _rank_kv(cfg, q, kc, vc, tp)
    ps = kl.shape[1] // tables.shape[1]
    out = _k4.paged_verify_attention(q.transpose(1, 2), slab_pages(kl, ps),
                                     slab_pages(vl, ps), tables, start)
    out = back(out.transpose(1, 2).reshape(B, C, q.shape[2], cfg.resolved_head_dim))
    return _out_proj(p, out, lora, tp)


# -------------------------------------------- encoder-decoder (whisper) ----
# The encoder's self-attention and the decoder's cross-attention see every
# key. Kernel K2's non-causal form (`flash_attention.bidirectional_attention`)
# runs the encoder over its frames and a chunk's, a verify round's or a
# whole prompt's queries over the cross K/V; kernel K5 runs a decode step's
# one query a row over it, at length encoder_seq.


def attn_apply_bidirectional(cfg: ModelConfig, p, x, tp=None):
    """The encoder's self-attention (the JAX `attn_apply(causal=False)`):
    every position attends every position (no rope: the family's configs
    use learned and fixed positions). x (B, S, d) -> (B, S, d). On a mesh
    (`tp`) over the rank's heads, summed over `model` after wo."""
    q, k, v = _project_qkv(cfg, p, x, tp=tp)
    qk, back = _rank_heads(cfg, q, k.shape[2], tp, dim=2)
    out = back(_kag.bidirectional_attention(qk, k.contiguous(), v.contiguous(), k.shape[1]))
    return _out_proj(p, out, tp=tp)


def cross_kv(p, enc_out):
    """A decoder layer's cross K/V of the encoder output (B, S, d): each
    (B, S, Hkv, hd), without bias, as the JAX package projects them."""
    return (torch.einsum("bsd,dhe->bshe", enc_out, p["wk"]).contiguous(),
            torch.einsum("bsd,dhe->bshe", enc_out, p["wv"]).contiguous())


def _cross_query(cfg: ModelConfig, p, x):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def cross_attn_apply(cfg: ModelConfig, p, x, *, ck, cv, tp=None):
    """Cross-attention of C queries a row over that row's cross K/V (the
    JAX `attn_chunk_apply(cross=True)` and `attn_apply(kv_override=)`):
    x (B, C, d); ck, cv (B, S, Hkv, hd), contiguous. Every query sees all S
    keys. On a mesh (`tp`) ck/cv hold the rank's heads (`cache_specs`) and
    the queries are the rank's, summed over `model` after wo. Returns
    (B, C, d)."""
    qk, back = _rank_heads(cfg, _cross_query(cfg, p, x), ck.shape[2], tp, dim=2)
    out = back(_kag.bidirectional_attention(qk, ck, cv, ck.shape[1]))
    return _out_proj(p, out, tp=tp)


def cross_attn_apply_full(cfg: ModelConfig, p, x, enc, tp=None):
    """Training's cross-attention of a decoder layer over the encoder
    output enc (B, S_enc, d): its cross K/V (`cross_kv`) and
    `cross_attn_apply`, with a gradient for enc too. On a mesh with a
    gradient it is one column-parallel region (`_region`): x, enc and the
    leaves replicated over `model` enter through `MeshRank.model_in`."""
    if _region(tp, "attn/wo", 0):
        x, enc, p = tp.model_in(x), tp.model_in(enc), tp.region(p, "attn")
    ck, cv = cross_kv(p, enc)
    return cross_attn_apply(cfg, p, x, ck=ck, cv=cv, tp=tp)


def cross_decode_apply(cfg: ModelConfig, p, x, *, ck, cv, tp=None):
    """A decode step's cross-attention (the JAX `attn_decode_apply(cross=
    True)`): x (B, 1, d), one query a row over its cross K/V ck, cv (B, S,
    Hkv, hd) at length S; on a mesh as `cross_attn_apply`. Returns
    (B, 1, d)."""
    qk, back = _rank_heads(cfg, _cross_query(cfg, p, x)[:, 0], ck.shape[2], tp)
    out = back(_k1.decode_attention(qk, ck, cv, ck.shape[1]))
    return _out_proj(p, out[:, None], tp=tp)


# ------------------------------------------------- full sequence (training) --


def attn_apply(cfg: ModelConfig, p, x, *, lora=None, tp=None):
    """Causal self-attention over a whole sequence from position 0 (the
    JAX `attn_apply`, which training's `forward` runs), with a gradient:
    q, k, v projected (`lora`, the bias, the q/k norms) and rotated at
    positions 0..S-1, then kernel K2 over each row's K/V seen as pages, as
    `attn_apply_slab` runs it without the cache. x (B, S, d) -> (B, S, d).
    The encoder and cross-attention are `attn_apply_bidirectional` and
    `cross_attn_apply_full`. The JAX package switches to
    `blockwise_attention` past 2,048 positions, a memory bound of its XLA
    path; K2 is that function here, so it is not ported. On a mesh (`tp`)
    over the rank's heads (its query heads over the KV heads they read,
    `_rank_kv`, where the KV heads stay whole), summed over `model`."""
    B, S, _ = x.shape
    q, k, v = _project_from0(cfg, p, x, lora, tp)
    tables = slab_tables(B, S, slab_page_size(S), x.device)
    rank_kv = tp is None or not tp.on_model("attn/wk", 1)
    return _attend_slab(cfg, p, q, k.contiguous(), v.contiguous(), tables, lora, tp, rank_kv)


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


def mla_apply(cfg: ModelConfig, p, x, *, positions, tp=None):
    """Full-sequence causal MLA in the non-absorbed form (the slab's
    whole-prompt prefill): per-head K = [c_kv w_uk, k_rope] (nd + rd) and
    V = c_kv w_uv (vd). On a mesh (`tp`) over the rank's heads, summed over
    `model` after wo: with a gradient a column-parallel region
    (`_region`), x and w_dkv and kv_norm entering through
    `MeshRank.model_in`. Returns (out (B, S, d), c_kv, k_rope)."""
    if _region(tp, "attn/wo", 0):
        x, p = tp.model_in(x), tp.region(p, "attn")
    B, S, _ = x.shape
    vd, rd = cfg.v_head_dim, cfg.qk_rope_dim
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, positions)
    H = q_nope.shape[2]
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    out = sdpa(q[:, :, :, None, :], k, v, causal=True, scale=_mla_scale(cfg))
    out = torch.einsum("bshe,hed->bsd", out.reshape(B, S, H, vd), p["wo"])
    if tp is not None and tp.on_model("attn/wo", 0):
        out = tp.model_sum(out)
    return out, c_kv, k_rope


def _mla_attend(cfg: ModelConfig, p, q_nope, q_rope, ckv, krope, q_pos, tp=None):
    """Absorbed attention of queries at q_pos (B, C) over a compressed
    cache (B, T, r) / (B, T, rd): keys at positions <= the query's own. On
    a mesh (`tp`) the heads are the rank's, summed over `model` after wo."""
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
    s = s + torch.einsum("bshe,bte->bhst", q_rope.float(), krope.float())
    s = s * _mla_scale(cfg)
    ok = torch.arange(ckv.shape[1], device=ckv.device)[None, None, :] <= q_pos[:, :, None]
    s = s.masked_fill(~ok[:, None], float("-inf"))
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", pr.to(ckv.dtype), ckv)
    out = torch.einsum("bshr,rhe->bshe", ctx, p["w_uv"])
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    return tp.model_sum(out) if tp is not None and tp.on_model("attn/wo", 0) else out


def mla_decode_apply_slab(cfg: ModelConfig, p, x, *, pos, ckv_cache, krope_cache, tp=None):
    """Single-token MLA decode on slab layers (the JAX `mla_decode_apply`).
    x (B, 1, d); pos a 0-d tensor or per-row (B,); the token's c_kv/k_rope
    are written at pos (`cache_write`: clamped, or dropped past the slab
    per row) before it attends positions <= pos. On a mesh (`tp`) the
    layers are gathered whole where their sequence is over `model`, and
    the rank's part goes back after the write. Returns (B, 1, d)."""
    B, S, _ = x.shape
    pp = pos.reshape(-1, 1).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, pp)
    ckv, ckv_back = _seq_whole(tp, ckv_cache)
    kr, kr_back = _seq_whole(tp, krope_cache)
    cache_write(ckv, c_kv, pos)
    cache_write(kr, k_rope, pos)
    ckv_back(ckv)
    kr_back(kr)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv, kr, pp, tp)


def mla_chunk_apply_slab(cfg: ModelConfig, p, x, *, start, ckv_cache, krope_cache, tp=None):
    """C-token MLA chunk on slab layers (the JAX `mla_chunk_apply`): the
    chunk's compressed KV is written at [start, start+C) (`cache_write_chunk`:
    a shared start clamped, per-row (B,) starts dropped past the slab) and
    each query attends positions <= its own. On a mesh as
    `mla_decode_apply_slab`. Returns (B, C, d)."""
    B, C, _ = x.shape
    q_pos = chunk_positions(start, B, C, x.device)
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, q_pos)
    ckv, ckv_back = _seq_whole(tp, ckv_cache)
    kr, kr_back = _seq_whole(tp, krope_cache)
    cache_write_chunk(ckv, c_kv, start)
    cache_write_chunk(kr, k_rope, start)
    ckv_back(ckv)
    kr_back(kr)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv, kr, q_pos, tp)


def page_view(pool, table):
    """Each row's context gathered through its page table, as the JAX
    package's `cache_ops.gather_page_views`: pool (P, ps, *tail), table
    (B, nb) -> a (B, nb * ps, *tail) copy."""
    g = pool[table.long()]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))


def _latent_view(tp, pool, table, full: int):
    """A `page_view` of one MLA pool, whole: on a mesh whose pool holds the
    rank's part of its last dim (the latent rank r, or the rope dim:
    `pool_specs`), the parts gathered over `model` -- every head's scores
    sum over all of r. Returns (view, rank), rank(view) the rank's part of
    a whole view, to write back."""
    view = page_view(pool, table)
    if tp is None or view.shape[-1] == full:
        return view, lambda v: v
    return tp.model_cat(view), lambda v: tp.model_slice(v, v.ndim - 1)


def _latent_views(cfg: ModelConfig, ckv_pool, krope_pool, table, tp):
    ckv, ckv_rank = _latent_view(tp, ckv_pool, table, cfg.kv_lora_rank)
    kr, kr_rank = _latent_view(tp, krope_pool, table, cfg.qk_rope_dim)
    return ckv, kr, lambda c, k: (ckv_rank(c), kr_rank(k))


def write_view_blocks(pool, view, blocks, ids):
    """Write blocks (B, n) of each row's `page_view` back into the pool's
    pages ids (B, n), in place, as the JAX engine's page scatter: where a
    page id repeats (only the sink does: dead rows and blocks past a row's
    pages), the last (row, block) in row-major order wins, which is what
    the JAX CPU scatter leaves there. Every duplicate carries that block,
    so the write is deterministic on the card too. Dead rows read the sink
    back, and with MoE a dead row's tokens compete for expert capacity, so
    its contents are part of the result."""
    _write_pages(pool, _view_pages(view, blocks, pool.shape[1]), ids)


def _view_pages(view, blocks, ps: int):
    """Blocks (B, n) of each row's view (B, n_ctx, ...): (B, n, ps, ...)."""
    B = view.shape[0]
    rows = torch.arange(B, device=view.device)[:, None].expand_as(blocks)
    return view.reshape((B, -1, ps) + tuple(view.shape[2:]))[rows, blocks]


def _write_pages(pool, pages, ids):
    flat = ids.reshape(-1).long()
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.where(flat[None, :] == flat[:, None], order[None, :], -1).amax(1)
    pool[flat] = pages.reshape((-1,) + tuple(pages.shape[2:]))[last].to(pool.dtype)


def _write_latent(tp, B: int, ckv_pool, krope_pool, ckv, kr, blocks, ids):
    """`write_view_blocks` of both MLA pools from views of this rank's rows.
    Where the rank runs its rows of the B (`MeshRank.rows`: the dense and
    vlm families on `data` > 1), every row's blocks and page ids are first
    all-gathered over `data`, as the dense paged path gathers K/V
    (`_rows_kv`): the pools replicate over `data`, so every rank writes
    every row's blocks, in the JAX scatter's row order."""
    ps = ckv_pool.shape[1]
    pc, pk = _view_pages(ckv, blocks, ps), _view_pages(kr, blocks, ps)
    if tp is not None and ckv.shape[0] != B:
        pc, pk, ids = (tp.rows_cat(t, B) for t in (pc, pk, ids.contiguous()))
    _write_pages(ckv_pool, pc, ids)
    _write_pages(krope_pool, pk, ids)


def mla_decode_apply(cfg: ModelConfig, p, x, *, pos, ckv_pool, krope_pool, table,
                     write_pages, tp=None):
    """Single-token MLA decode of every slot on the page pool. Pools (P, ps,
    r) / (P, ps, rd) of this layer; table (B, nb) page tables; pos (B,);
    write_pages (B,) the page holding pos (the sink for a dead row). Each
    row attends its gathered view with the token written in, and the view
    block holding pos (clamped into the view) goes back to write_pages. On
    a mesh (`tp`) the views are whole (`_latent_views`), the heads the
    rank's, the rows the rank's (`MeshRank.rows`), and each rank writes
    back its part of r of every row's block (`_write_latent`). Returns
    (B, 1, d)."""
    ps = ckv_pool.shape[1]
    ckv, kr, rank = _latent_views(cfg, ckv_pool, krope_pool, table, tp)
    out = mla_decode_apply_slab(cfg, p, x, pos=pos, ckv_cache=ckv, krope_cache=kr, tp=tp)
    blocks = (pos.long() // ps).clamp(max=table.shape[1] - 1)[:, None]
    B = write_pages.shape[0]
    ids = write_pages[tp.rows(B) if tp is not None else slice(None)].reshape(-1, 1)
    ckv, kr = rank(ckv, kr)
    _write_latent(tp, B, ckv_pool, krope_pool, ckv, kr, blocks, ids)
    return out


def mla_chunk_apply(cfg: ModelConfig, p, x, *, start: int, ckv_pool, krope_pool, ctx_ids,
                    tp=None):
    """MLA prefill chunk of one sequence on the page pool: x (1, C, d) at
    positions [start, start+C); ctx_ids (n_ctx,) the sequence's page table.
    The view's blocks [b0, b0 + nb) that the padded chunk can dirty go back
    to their pages (the sink past the sequence's pages), with nb and b0 as
    the JAX engine's chunk scatter. On a mesh as `mla_decode_apply`.
    Returns (1, C, d)."""
    ps = ckv_pool.shape[1]
    C, n_ctx = x.shape[1], ctx_ids.shape[0]
    table = ctx_ids[None]
    ckv, kr, rank = _latent_views(cfg, ckv_pool, krope_pool, table, tp)
    out = mla_chunk_apply_slab(cfg, p, x, start=start, ckv_cache=ckv, krope_cache=kr, tp=tp)
    nb = (C + ps - 2) // ps + 1 if ps > 1 else C
    b0 = min(start // ps, n_ctx - nb)
    blocks = torch.arange(b0, b0 + nb, device=x.device)[None]
    ids = table[:, b0:b0 + nb]
    ckv, kr = rank(ckv, kr)
    _write_latent(tp, 1, ckv_pool, krope_pool, ckv, kr, blocks, ids)
    return out


def mla_verify_apply(cfg: ModelConfig, p, x, *, pos, ckv_pool, krope_pool, table,
                     block0s, tp=None):
    """Speculative-verify MLA of every slot on the page pool: row b's C
    candidates sit at pos[b] + c (per-row start; positions past the view
    dropped) and attend its gathered view. Blocks [block0s[b], block0s[b] +
    nb) of each view go back to the row's pages (the sink past them, and
    for a dead row), as the JAX engine's verify scatter. On a mesh as
    `mla_decode_apply`. Returns (B, C, d)."""
    ps = ckv_pool.shape[1]
    C = x.shape[1]
    ckv, kr, rank = _latent_views(cfg, ckv_pool, krope_pool, table, tp)
    out = mla_chunk_apply_slab(cfg, p, x, start=pos, ckv_cache=ckv, krope_cache=kr, tp=tp)
    nb = (C + ps - 2) // ps + 1 if ps > 1 else C
    B = block0s.shape[0]
    block0s = block0s[tp.rows(B) if tp is not None else slice(None)]
    blocks = block0s.long()[:, None] + torch.arange(nb, device=x.device)[None, :]
    ids = table.long().gather(1, blocks)
    ckv, kr = rank(ckv, kr)
    _write_latent(tp, B, ckv_pool, krope_pool, ckv, kr, blocks, ids)
    return out


# ------------------------------------------------------------------ MoE ----

_MOE_GROUPS = 0  # >1: grouped-local dispatch (expert-parallel layouts)


def set_moe_groups(g):
    """The grouped dispatch's group count, as the JAX package's
    `set_moe_groups` (a module-level setting both packages read the same
    way): G > 1 dispatches each of G contiguous groups of B S / G tokens on
    its own where G divides B S; 0 or 1 dispatches every token of the call
    together."""
    global _MOE_GROUPS
    _MOE_GROUPS = int(g)


def moe_groups(T: int):
    """The dispatch groups of T tokens under `set_moe_groups`: G where
    G > 1 divides T, else None (ungrouped, the JAX package's fallback)."""
    G = _MOE_GROUPS
    return G if G > 1 and T % G == 0 else None


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: capacity_factor x k x T / E, rounded
    up to a multiple of 8, at least 8."""
    C = int(math.ceil(cfg.capacity_factor * cfg.moe_top_k * T / cfg.n_experts))
    return max(8, -(-C // 8) * 8)


def moe_apply(cfg: ModelConfig, p, x, *, return_aux=False, tp=None, groups=None):
    """Capacity-limited top-k MoE with gather/scatter dispatch (the JAX
    `moe_apply`). x (B, S, d) -> (B, S, d), and with `return_aux` (the
    training forward) also the Switch load-balance loss E sum_e f_e P_e,
    f_e the share of tokens whose first expert is e and P_e the mean of the
    full router softmax, computed in plain PyTorch beside K6 (which returns
    only the top k). The gating runs through K6's autograd form, so in
    training the kept weights carry the router's gradient.

    Ungrouped, every token of the call counts toward capacity (C from T =
    B * S, pad positions and dead rows included), and assignments are
    numbered in (token, rank) order: an expert's slots go to its first C
    assignments and later ones are dropped (GShard-style), so tokens of
    one call interact. Kernel K6 takes the router logits in the model
    dtype and computes the gating and that numbering in one launch: each
    assignment's slot (e * C + pos, or the drop slot E * C) and its kept
    weight. Each token's k weighted expert rows are summed in rank order
    from zeros in the model dtype -- the JAX CPU scatter-add's order -- and
    not with `index_add_`, whose atomics on the card sum in an order that
    changes from run to run.

    Grouped (`groups` G >= 1; None reads `moe_groups(B S)` under
    `set_moe_groups`, 0 is ungrouped; the JAX
    `jax.vmap(_moe_dispatch_group)`): the tokens are G contiguous
    groups of T / G, each numbered against its own capacity
    moe_capacity(cfg, T / G) by K6's grouped launch (one launch for all
    groups), with a dispatch buffer a group; the shared experts run over
    all tokens and aux is 0, as in the JAX package. A mesh rank that holds
    whole groups passes its own count (`MeshRank.train_rows`), even 1.

    On a mesh (`tp`) every rank runs every row of the call (ungrouped, the
    moe family's rows replicate over `data`), so K6 numbers the same
    assignments as on one card; the experts' products run on the rank's
    columns of w_gate/w_up and rows of w_down (and the shared experts'),
    summed over `model`, each a column-parallel region with a gradient
    (`_region`)."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    T, E, K = B * S, cfg.n_experts, cfg.moe_top_k
    G = moe_groups(T) if groups is None else groups
    Gn = max(G or 1, 1)
    C = moe_capacity(cfg, T // Gn)
    logits = x2 @ p["router"]
    _, idx, slot, kept = _kag.moe_gating(logits, K, C, Gn)
    # group g's slots index its own buffer of E * C + 1 rows (the last its drop slot)
    span = E * C + 1
    gslot = slot + (torch.arange(T * K, device=slot.device) // (T // Gn * K)) * span \
        if Gn > 1 else slot
    xe = x2.new_zeros((Gn * span, d))
    # each token's row once a rank; kept slots are distinct, the drop slots are cut
    xe[gslot] = x2[:, None, :].expand(T, K, d).reshape(T * K, d)
    xe = xe.reshape(Gn, span, d)[:, :E * C].reshape(Gn, E, C, d)
    xe = xe.transpose(0, 1).reshape(E, Gn * C, d)
    if _region(tp, "moe/w_down", 1):
        xe = tp.model_in(xe)
    act = activation_fn(cfg.activation)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    if tp is not None and tp.on_model("moe/w_down", 1):
        ye = tp.model_sum(ye)
    ye = ye.reshape(E, Gn, C, d).transpose(0, 1).reshape(Gn, E * C, d)
    ye_flat = torch.cat([ye, ye.new_zeros((Gn, 1, d))], dim=1).reshape(Gn * span, d)
    back = ye_flat[gslot] * kept[:, None].to(ye.dtype)
    back = back.reshape(T, K, d)
    y = x2.new_zeros((T, d))
    for j in range(K):
        y = y + back[:, j]
    if cfg.n_shared_experts:
        sp, xs = p["shared"], x2
        if _region(tp, "shared/w_down", 0):
            xs = tp.model_in(xs)
        ys = (act(xs @ sp["w_gate"]) * (xs @ sp["w_up"])) @ sp["w_down"]
        if tp is not None and tp.on_model("shared/w_down", 0):
            ys = tp.model_sum(ys)
        y = y + ys
    y = y.reshape(B, S, d)
    if not return_aux:
        return y
    if G:
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    frac_tokens = F.one_hot(idx[:, 0].long(), E).float().mean(dim=0)
    frac_probs = torch.softmax(logits.float(), dim=-1).mean(dim=0)
    return y, E * (frac_tokens * frac_probs).sum()
