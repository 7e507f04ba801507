"""K2: causal chunk-prefill attention over the paged KV pool.

Replaces `repro.kernels.flash_attention.flash_attention_pallas`
(src/repro/kernels/flash_attention.py:71) in the form the serving engine's
chunked prefill needs: a query offset `start` and context read through a
page table. CUDA source: `csrc/chunk_prefill_attention.cu`.

Bound on the H100: close to the ridge. A 32-token chunk of qwen2.5-3b
(16 query heads, 2 KV heads, head_dim 128) does 4 x 16 x 128 flops per
(query, visible key) pair and reads 2 x 2 x 128 x 2 bytes per visible
position: at most ~256 flops per byte, just under the ~295 flop/byte bf16
ridge, so the visible K/V bytes over 3.35 TB/s bind, narrowly. Design:
one block per (query head, 16-row query tile), one warp per query row;
each page's K/V tile is staged in shared memory once for the whole tile,
only the pages some row of the tile can see are visited (the TPU kernel's
diagonal skip), scores and the online softmax stay in fp32 registers, and
nothing is gathered into a dense context copy. The products run on the
CUDA cores, not the tensor cores (wgmma): simple first, fast later.
"""
from __future__ import annotations

import torch

from . import _build
from .decode_attention import SMEM_LIMIT

launches = 0


def chunk_prefill_attention_plain(q, k_pool, v_pool, ctx_table, start: int):
    """Plain PyTorch version: what the JAX engine computes -- gather the
    context pages into a dense view, then causal attention with the query
    offset (`repro_torch.models.layers.sdpa(..., q_offset=start)`).
    q (C, H, D); pools (P, ps, Hkv, D); ctx_table (n_ctx,) int32; query row
    i sits at position start + i -> (C, H, D)."""
    from repro_torch.models.layers import sdpa     # layers imports this module
    C, H, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    S = ctx_table.shape[0] * ps
    tbl = ctx_table.long()
    kg = k_pool[tbl].reshape(1, S, Hkv, D)
    vg = v_pool[tbl].reshape(1, S, Hkv, D)
    out = sdpa(q.reshape(1, C, Hkv, H // Hkv, D), kg, vg, causal=True, q_offset=start)
    return out.reshape(C, H, D).to(q.dtype)


def chunk_prefill_attention(q, k_pool, v_pool, ctx_table, start: int):
    """q (C, H, D) at positions start .. start+C-1; pools (P, ps, Hkv, D)
    in q's dtype, the chunk's own K/V already written; ctx_table (n_ctx,)
    int32 page ids (< P) covering positions up to start+C-1 -> (C, H, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return chunk_prefill_attention_plain(q, k_pool, v_pool, ctx_table, start)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_prefill_attention: device {q.device}")
    q = q.contiguous()
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("ctx_table", ctx_table)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"chunk_prefill_attention: {name} must be a contiguous "
                             f"tensor on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"chunk_prefill_attention: dtypes {q.dtype}/{k_pool.dtype}")
    if ctx_table.dtype != torch.int32 or ctx_table.ndim != 1:
        raise TypeError("chunk_prefill_attention: ctx_table must be (n_ctx,) int32")
    C, H, D = q.shape
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"chunk_prefill_attention: pools {tuple(k_pool.shape)}")
    _, ps, Hkv, _ = k_pool.shape
    n_ctx = ctx_table.shape[0]
    if H % Hkv or D > 256 or 2 * ps * D * 4 > SMEM_LIMIT or start < 0 \
            or start + C > n_ctx * ps:
        raise ValueError(f"chunk_prefill_attention: unsupported H={H} Hkv={Hkv} "
                         f"D={D} ps={ps} start={start} C={C} n_ctx={n_ctx}")
    out = torch.empty_like(q)
    if C == 0:
        return out
    lib = _build.library()
    rc = lib.repro_chunk_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ctx_table.data_ptr(),
        out.data_ptr(), C, H, Hkv, D, ps, n_ctx, int(start),
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "chunk_prefill_attention")
    launches += 1
    return out
