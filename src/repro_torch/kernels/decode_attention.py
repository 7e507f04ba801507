"""K1: paged decode attention on the shared KV page pool.

Replaces `repro.kernels.decode_attention.paged_decode_attention_pallas`
(src/repro/kernels/decode_attention.py:101). CUDA source:
`csrc/paged_decode_attention.cu`.

Bound on the H100: device-memory bytes. Each (row, KV head) reads its
`length` positions of K and V once (bf16, 2 x 128 x 2 bytes per position
at qwen2.5-3b width) for the G = 8 query heads that share it, i.e. 8
flops per byte it reads -- far under the ~295 flop/byte ridge -- so the
least time is the KV bytes over 3.35 TB/s. Design: one block per (row, KV head) with one warp
per query head of the GQA group, so each page's K/V tile crosses from
device memory into shared memory once for all G heads that share it
(G = 8 at full width); scores and the online softmax stay in registers in
fp32; nothing is gathered into a dense copy of the cache, which is the
copy the JAX engine's gather + jnp path pays.

Semantics: positions >= lengths[b] are masked; the page loop is bounded by
the table width (a dead slot's length keeps growing while its table row is
all sink pages); a row with lengths[b] == 0 sees no key and returns zeros
(the Pallas kernel, whose mask value is a finite -1e30, would return the
mean of V over the table instead; the engine never issues a zero length).
"""
from __future__ import annotations

import torch

from . import _build

SMEM_LIMIT = 227 * 1024

launches = 0


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


def _check(q, k_pool, v_pool, page_table, lengths):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} is not contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_decode_attention: q dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: pools must share q's dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table/lengths must be int32")
    B, H, D = q.shape
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"paged_decode_attention: pools {tuple(k_pool.shape)}")
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    if page_table.ndim != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode_attention: page_table (B, nb), lengths (B,)")
    if H % Hkv or H // Hkv > 32 or D > 256 or 2 * ps * D * 4 > SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: unsupported H={H} Hkv={Hkv} "
                         f"D={D} ps={ps}")


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
    _check(q, k_pool, v_pool, page_table, lengths)
    B, H, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0 or page_table.shape[1] == 0:
        return out.zero_()
    lib = _build.library()
    rc = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D, ps, page_table.shape[1],
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "paged_decode_attention")
    launches += 1
    return out
