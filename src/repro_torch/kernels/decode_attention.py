"""K1: paged decode attention on the shared KV page pool, and K5:
flash-decoding over a dense per-row cache (the slab layout). The JAX
module holds both TPU kernels too. This module also plans the key spans
of the paged-attention core that K1, K2, K4 and K5 share (`plan_spans`).

K1 replaces `repro.kernels.decode_attention.paged_decode_attention_pallas`
(src/repro/kernels/decode_attention.py:101). CUDA source:
`csrc/paged_decode_attention.cu`, on the core `csrc/paged_attention.cuh`.

Bound on the H100: device-memory bytes. Each (row, KV head) reads its
`length` positions of K and V once (bf16, 2 x 128 x 2 bytes per position
at qwen2.5-3b width) for the G = 8 query heads that share it, i.e. 8
flops per byte it reads -- far under the ~295 flop/byte ridge -- so the
least time is the KV bytes over 3.35 TB/s. Design: the core with one query
position per row. A row's G query heads form one 16-row tile of tensor-
core products (bf16 in, fp32 accumulate; P kept to ~16 bits as two bf16
halves), the block's four warps each take a quarter of every 64-position
K/V tile, which cp.async stages in bf16 through the page table while the
previous tile is multiplied, and the row's keys are split into spans over
blocks (`plan_spans`), merged by a second kernel, so the 8 (row, KV head)
pairs of a full-width decode step spread over the 132 SMs. float32 inputs
take the same blocks with the products in fp32 FMA. Nothing is gathered
into a dense copy of the cache, which is the copy the JAX engine's gather +
jnp path pays.

Semantics: positions >= lengths[b] are masked; the walk is bounded by the
table width (a dead slot's length keeps growing while its table row is
all sink pages); a row with lengths[b] == 0 sees no key and returns zeros
(the Pallas kernel, whose mask value is a finite -1e30, would return the
mean of V over the table instead; the engine never issues a zero length).

K5 replaces `repro.kernels.decode_attention.decode_attention_pallas`
(src/repro/kernels/decode_attention.py:274, body `_kernel` :24). CUDA
source: `csrc/dense_decode_attention.cu`, on the core
`csrc/paged_attention.cuh`. It serves every decode step of
the slab layout and of the draft model. The slab engine passes per-row
lengths (pos + 1), so K5 takes lengths (B,) int32 where the Pallas kernel
takes a scalar; the wrapper broadcasts a scalar.

Bound on the H100: device-memory bytes, as K1: the K/V bytes of
min(length, S) positions per (row, KV head), read once for its G query
heads, over 3.35 TB/s. Design: K1's launch on the core without a page
table -- the slab is B pages of S positions, row b's page is b (the
core's identity layout, so no table is made per call) -- planned by
`plan_spans(G, B * Hkv, S)`: at G = 8 one 16-row tensor-core tile a
(row, KV head, span), four key groups. The walk is bounded by S (a slot
that is not live keeps advancing its position, so its length can pass
S); a zero length gives zeros, as K1.

K5s is K5 on one shard of a sequence-sharded slab, the per-shard leaf of
`repro_torch.distributed.decode` (the counterpart of the jnp body of
`repro.distributed.decode._partial_attn`, which has no Pallas kernel):
`decode_attention_stats(q, k_shard, v_shard, lengths, start)` returns the
float32 softmax statistics (m, l, acc) of the shard's keys, which the
caller combines across shards. CUDA source:
`csrc/dense_decode_attention_stats.cu`, on K5's core: its C entry runs
the core on the shard with the row limit lengths - start and sends every
span, one span's too, through the shared merge kernel in its statistics
mode, which writes the merged (m, l, acc) in place of acc / l. Bound: as
K5, the shard's visible K/V bytes; its outputs are (B, H, D + 2) float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

KEY_TILE = 64          # key positions per staged tile (paged_attention.cuh's kPaKeyTile)
BLOCK_ROWS = 64        # query rows per block when each of its 4 warps owns 16 (kPaRows)
TARGET_BLOCKS = 264    # two blocks per SM of the H100's 132

launches = 0


class SpanPlan(NamedTuple):
    """How the paged-attention core splits one launch: `key_groups` (1 or
    4) key shares per block, which the block combines, and `nsplit` spans
    of `span` key positions, one partial state each per query row in the
    workspace."""
    key_groups: int
    nsplit: int
    span: int


def plan_spans(rows: int, groups: int, n_keys: int) -> SpanPlan:
    """The launch plan of the paged-attention core (K1, K2, K4, K5).
    `rows`: query rows per (sequence, KV head), G x C; `groups`: sequences
    x KV heads; `n_keys`: the key positions the walk may visit (K1 and K4
    nb * ps, K5 S, K2 start + C). When one 16-row MMA tile holds all rows
    (decode), the block's four warps split each key tile (key_groups 4),
    else each owns 16 rows of a 64-row tile. Spans are whole key tiles, as
    many as bring the blocks to TARGET_BLOCKS (no more than there are
    tiles), and the last one starts before n_keys -- the C entry points
    refuse any other plan."""
    key_groups = 4 if rows <= 16 else 1
    qtiles = -(-rows // (BLOCK_ROWS // key_groups))
    tiles = -(-n_keys // KEY_TILE)
    nsplit = max(1, min(tiles, -(-TARGET_BLOCKS // (groups * qtiles))))
    span_tiles = -(-tiles // nsplit)
    return SpanPlan(key_groups, -(-tiles // span_tiles), span_tiles * KEY_TILE)


def _aligned(t) -> bool:
    """The core copies rows 16 bytes at a time."""
    return t.data_ptr() % 16 == 0


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """Plain PyTorch version: what the JAX engine computes -- gather the
    table's pages into a dense view, then the model's masked attention
    (`repro_torch.models.layers.decode_attention`). q (B, H, D); pools
    (P, ps, Hkv, D); page_table (B, nb) int32; lengths (B,) int32 ->
    (B, H, D); a row with no visible key gives zeros."""
    from repro_torch.models.layers import decode_attention  # layers imports us
    B, H, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    S = page_table.shape[1] * ps
    tbl = page_table.long()
    kg = k_pool[tbl].reshape(B, S, Hkv, D)
    vg = v_pool[tbl].reshape(B, S, Hkv, D)
    out = decode_attention(q.reshape(B, 1, Hkv, H // Hkv, D), kg, vg, lengths.long())
    seen = (lengths > 0).reshape(B, 1, 1, 1, 1)
    return torch.where(seen, out, torch.zeros_like(out)).reshape(B, H, D).to(q.dtype)


def _check_paged(fn, q, k_pool, v_pool, page_table, rows, rows_name):
    """What the core requires of a paged launch (K1, K4): q (B, ..., H, D)
    contiguous, pools (P, ps, Hkv, D) in q's dtype, int32 page_table
    (B, nb) and per-row `rows` (B,), all on q's device; rows of whole
    16-byte chunks; pools on 16-byte boundaries. Raises where it would
    refuse."""
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), (rows_name, rows)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{fn}: pools must share q's dtype")
    if page_table.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError(f"{fn}: page_table/{rows_name} must be int32")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"{fn}: pools {tuple(k_pool.shape)}")
    Hkv = k_pool.shape[2]
    if page_table.ndim != 2 or page_table.shape[0] != B or rows.shape != (B,):
        raise ValueError(f"{fn}: page_table (B, nb), {rows_name} (B,)")
    _check_rows(fn, q, H, Hkv, D)
    if not (_aligned(k_pool) and _aligned(v_pool)):
        raise ValueError(f"{fn}: pools must start on a 16-byte boundary")


def _check_rows(fn, q, H: int, Hkv: int, D: int) -> None:
    """The core's limits on heads and head width: whole KV groups, D <= 256
    in whole 16-byte chunks (8 bf16 or 4 float32 values)."""
    if H % Hkv or D > 256 or D % (16 // q.element_size()):
        raise ValueError(f"{fn}: unsupported H={H} Hkv={Hkv} D={D} "
                         f"({q.dtype} rows must be whole 16-byte chunks)")


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """q (B, H, D); pools (P, ps, Hkv, D) in q's dtype; page_table (B, nb)
    int32 page ids (< P); lengths (B,) int32 -> (B, H, D) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: device {q.device}")
    q = q.contiguous()
    if not _aligned(q):
        q = q.clone()
    _check_paged("paged_decode_attention", q, k_pool, v_pool, page_table, lengths, "lengths")
    B, H, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0 or nb == 0:
        return out.zero_()
    plan = plan_spans(H // Hkv, B * Hkv, nb * ps)
    ws = torch.empty((B * H * plan.nsplit * (D + 2),), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, Hkv, D, ps, nb,
        plan.key_groups, plan.nsplit, plan.span,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "paged_decode_attention")
    launches += 1
    return out


# ------------------------------------------------------------------ K5 --

dense_launches = 0


def _lengths_vector(lengths, B: int, device) -> torch.Tensor:
    """A scalar length (int or 0-d tensor) broadcast to (B,) int32."""
    t = torch.as_tensor(lengths, device=device)
    if t.ndim == 0:
        t = t.reshape(1).expand(B)
    return t.to(torch.int32).contiguous()


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """Plain PyTorch version: the model's masked softmax
    (`repro_torch.models.layers.decode_attention`, the port of the jnp
    `layers.decode_attention` the JAX model runs). q (B, H, D); caches
    (B, S, Hkv, D); lengths int or (B,) int32 -> (B, H, D); a row with no
    visible key gives zeros."""
    from repro_torch.models.layers import decode_attention  # layers imports us
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    lens = _lengths_vector(lengths, B, q.device)
    out = decode_attention(q.reshape(B, 1, Hkv, H // Hkv, D), k_cache, v_cache, lens.long())
    seen = (lens > 0).reshape(B, 1, 1, 1, 1)
    return torch.where(seen, out, torch.zeros_like(out)).reshape(B, H, D).to(q.dtype)


def _check_dense(q, k_cache, v_cache, lengths):
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q dtype {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: caches must share q's dtype")
    if q.ndim != 3:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, want (B, H, D)")
    B, H, D = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D or k_cache.shape[1] == 0:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}")
    _check_rows("decode_attention", q, H, k_cache.shape[2], D)
    if not (_aligned(k_cache) and _aligned(v_cache)):
        raise ValueError("decode_attention: caches must start on a 16-byte boundary")


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, H, D); caches (B, S, Hkv, D) in q's dtype; lengths int, 0-d or
    (B,) int32 (broadcast) -> (B, H, D) in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global dense_launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: device {q.device}")
    q = q.contiguous()
    if not _aligned(q):
        q = q.clone()
    B, H, D = q.shape
    lens = _lengths_vector(lengths, B, q.device)
    _check_dense(q, k_cache, v_cache, lens)
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    # the core over the slab as B pages of S positions, without a table
    plan = plan_spans(H // Hkv, B * Hkv, S)
    ws = torch.empty((B * H * plan.nsplit * (D + 2),), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_dense_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), B, S, H, Hkv, D, plan.key_groups, plan.nsplit,
        plan.span, _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "decode_attention")
    dense_launches += 1
    return out


# ----------------------------------------------------------------- K5s --

stats_launches = 0


def decode_attention_stats_plain(q, k_shard, v_shard, lengths, start: int):
    """Plain PyTorch version: one shard's masked softmax statistics. q (B,
    H, D); shards (B, S, Hkv, D) holding global positions [start, start +
    S); lengths int or (B,) global lengths. Returns float32 m (B, H), the
    max of the scaled scores; l (B, H), the sum of exp(score - m); acc
    (B, H, D), the exp-weighted sum of V. A row whose length ends at or
    before `start` gets m = -inf, l = 0 and acc = 0."""
    B, H, D = q.shape
    S, Hkv = k_shard.shape[1], k_shard.shape[2]
    G = H // Hkv
    lens = _lengths_vector(lengths, B, q.device).long()
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_shard.float()) * D ** -0.5
    pos = start + torch.arange(S, device=q.device)
    ok = (pos[None, :] < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(ok, torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_shard.float())
    return m.reshape(B, H), p.sum(dim=-1).reshape(B, H), acc.reshape(B, H, D)


def decode_attention_stats(q, k_shard, v_shard, lengths, start: int):
    """q (B, H, D); shards (B, S, Hkv, D) in q's dtype, positions [start,
    start + S) of the sequence; lengths int, 0-d or (B,) int32 (broadcast);
    start an int >= 0 -> float32 (m (B, H), l (B, H), acc (B, H, D)). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global stats_launches
    if q.device.type == "cpu":
        return decode_attention_stats_plain(q, k_shard, v_shard, lengths, start)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_stats: device {q.device}")
    if int(start) < 0:
        raise ValueError(f"decode_attention_stats: start {start}")
    q = q.contiguous()
    if not _aligned(q):
        q = q.clone()
    B, H, D = q.shape
    lens = _lengths_vector(lengths, B, q.device)
    _check_dense(q, k_shard, v_shard, lens)
    S, Hkv = k_shard.shape[1], k_shard.shape[2]
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return ml[..., 0], ml[..., 1], acc
    plan = plan_spans(H // Hkv, B * Hkv, S)
    ws = torch.empty((B * H * plan.nsplit * (D + 2),), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_dense_decode_attention_stats(
        q.data_ptr(), k_shard.data_ptr(), v_shard.data_ptr(), lens.data_ptr(),
        ml.data_ptr(), acc.data_ptr(), ws.data_ptr(), B, S, H, Hkv, D, int(start),
        plan.key_groups, plan.nsplit, plan.span,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "decode_attention_stats")
    stats_launches += 1
    return ml[..., 0], ml[..., 1], acc
