"""K2: causal chunk-prefill attention over the paged KV pool, and K2's
non-causal form over a dense per-row K/V (`bidirectional_attention`).

Replaces `repro.kernels.flash_attention.flash_attention_pallas`
(src/repro/kernels/flash_attention.py:71) in the form the serving engine's
chunked prefill needs: a query offset `start` and context read through a
page table. CUDA source: `csrc/chunk_prefill_attention.cu`, on the
paged-attention core `csrc/paged_attention.cuh` that K1 shares.

Bound on the H100: close to the ridge. A 32-token chunk of qwen2.5-3b
(16 query heads, 2 KV heads, head_dim 128) does 4 x 16 x 128 flops per
(query, visible key) pair and reads 2 x 2 x 128 x 2 bytes per visible
position: at most ~256 flops per byte, just under the ~295 flop/byte bf16
ridge, so the visible K/V bytes over 3.35 TB/s bind, narrowly; a whole
prompt from position 0 (the slab layout's prefill) is bound by the tensor
cores. Design: the core with one sequence. The 8 query heads x C positions
of a KV head are packed into 64-row tiles (4 warps x 16 rows, rows that
share a position side by side), so each 64-position K/V tile is staged in
shared memory once for all 8 heads that read it, by cp.async in bf16
through the page table while the previous tile is multiplied; both
products run on the tensor cores (bf16 in, fp32 accumulate, P kept to ~16
bits as two bf16 halves); the key positions are split into spans over
blocks (`decode_attention.plan_spans`) and merged by a second kernel; a
tile skips the spans past its last row and a warp the keys past its rows
(the TPU kernel's diagonal skip). float32 inputs take the same blocks with
the products in fp32 FMA. Nothing is gathered into a dense context copy.

The non-causal form, `flash_attention_pallas(causal=False)`, serves the
encoder-decoder family: the encoder's self-attention over its frames and
the decoder's cross-attention over the encoder's K/V in chunks, verify
rounds and whole-prompt prefill. CUDA source: `csrc/
bidirectional_attention.cu`, on the same core. Every query row sees every
key < n_keys, so the core's causal limit is replaced by n_keys; the K/V
is a dense (B, Skv, Hkv, D) tensor, which the core reads in its identity
layout (row b's keys are one page of Skv), and a (batch, KV head)'s G x Sq
query rows are packed into its 64-row tiles. Bound on the H100: the
tensor cores for the encoder (1,500 queries over 1,500 keys, ~750 flops a
byte), the K/V bytes for a cross-attention chunk or verify round (C x G
queries a key: 128 or 5).

The encoder's launch, and every bf16 launch at D 64 with at least
SM90_MIN_ROWS query rows a query head, takes a second CUDA kernel designed
for Hopper instead, `csrc/bidirectional_attention_sm90.cu`: TMA loads into
a ring of 128-key tiles, both products on `wgmma`, one CTA per (batch,
query head, 192 query rows) with no key split. `bidirectional_route` is
the rule between the two kernels: by shape, not a fallback.
"""
from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES

from . import _build
from .decode_attention import _aligned, plan_spans

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
    if q.device.type in PLAIN_DEVICES:
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
    if H % Hkv or D > 256 or D % (16 // q.element_size()) or start < 0 \
            or start + C > n_ctx * ps:
        raise ValueError(f"chunk_prefill_attention: unsupported H={H} Hkv={Hkv} "
                         f"D={D} ps={ps} start={start} C={C} n_ctx={n_ctx} ({q.dtype} "
                         f"rows must be whole 16-byte chunks)")
    if not (_aligned(k_pool) and _aligned(v_pool)):
        raise ValueError("chunk_prefill_attention: pools must start on a 16-byte boundary")
    if not _aligned(q):
        q = q.clone()
    out = torch.empty_like(q)
    if C == 0:
        return out
    start = int(start)
    plan = plan_spans((H // Hkv) * C, Hkv, start + C)
    ws = torch.empty((C * H * plan.nsplit * (D + 2),), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.repro_chunk_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ctx_table.data_ptr(),
        out.data_ptr(), ws.data_ptr(), C, H, Hkv, D, ps, n_ctx, start,
        plan.key_groups, plan.nsplit, plan.span,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "chunk_prefill_attention")
    launches += 1
    return out


# ------------------------------------------------------ non-causal form --

bidirectional_launches = 0          # every launch of the non-causal form, either kernel
bidirectional_sm90_launches = 0     # those on the Hopper kernel

SM90_D = 64             # the head width the Hopper kernel takes (one 128-byte row)
SM90_Q_TILE = 192       # query rows a CTA: three consumer warpgroups of 64
SM90_KEY_TILE = 128     # keys a TMA stage
# Query rows a query head from which the Hopper kernel is the faster. On an
# H100 (700 W) over whisper's 1,500 cross keys, 16 query heads over 16 and
# over 4, it took 0.0202-0.0211 ms at every Sq from 128 to 1,024 (one wave
# of CTAs); the core 0.0187-0.0193 at Sq 192 and 0.0216-0.0224 at 224, the
# first measured Sq where it is the slower at both groups
# (`tools/kernel_ab.py --kernel K2nc`'s sweep; PERF.md §6).
SM90_MIN_ROWS = 224


def bidirectional_route(dtype, B, Sq, H, Hkv, D) -> str:
    """The kernel that runs a launch of the non-causal form: "sm90" (the
    Hopper kernel, `csrc/bidirectional_attention_sm90.cu`) for bf16 at D =
    SM90_D with Sq >= SM90_MIN_ROWS query rows a query head, the
    tensor-core-bound shapes (whisper's encoder, a slab prompt's
    whole-prompt cross-attention); "core" (the paged-attention core,
    `csrc/bidirectional_attention.cu`) for the rest: float32, other head
    widths, and the bytes-bound cross-attention chunks and verify rounds,
    whose few query rows a key the core splits over key spans. The rule
    reads Sq, not G x Sq: the Hopper kernel tiles each query head's rows on
    its own and reads the K/V once for each, where the core packs a KV
    head's G x Sq rows into its tiles."""
    if dtype == torch.bfloat16 and D == SM90_D and Sq >= SM90_MIN_ROWS:
        return "sm90"
    return "core"


def bidirectional_attention_plain(q, k, v, n_keys: int):
    """Plain PyTorch version: the JAX package's dense attention without a
    causal mask (`repro_torch.models.layers.sdpa(..., causal=False,
    kv_len=n_keys)`): float32 scores times the scale, a float32 softmax,
    probabilities cast to V's dtype. q (B, Sq, H, D); k, v (B, Skv, Hkv,
    D) -> (B, Sq, H, D)."""
    from repro_torch.models.layers import sdpa     # layers imports this module
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    out = sdpa(q.reshape(B, Sq, Hkv, H // Hkv, D), k, v, causal=False, kv_len=n_keys)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def bidirectional_attention(q, k, v, n_keys: int):
    """q (B, Sq, H, D); k, v (B, Skv, Hkv, D) in q's dtype, contiguous;
    every query sees the keys at positions < n_keys (1 <= n_keys <= Skv)
    -> (B, Sq, H, D). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type in PLAIN_DEVICES:
        return bidirectional_attention_plain(q, k, v, n_keys)
    if q.device.type != "cuda":
        raise ValueError(f"bidirectional_attention: device {q.device}")
    q = q.contiguous()
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"bidirectional_attention: {name} must be a contiguous "
                             f"tensor on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"bidirectional_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"bidirectional_attention: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n_keys = int(n_keys)
    if H % Hkv or D > 256 or D % (16 // q.element_size()) or not 1 <= n_keys <= Skv:
        raise ValueError(f"bidirectional_attention: unsupported H={H} Hkv={Hkv} D={D} "
                         f"n_keys={n_keys} Skv={Skv} ({q.dtype} rows must be whole "
                         f"16-byte chunks)")
    if not (_aligned(k) and _aligned(v)):
        raise ValueError("bidirectional_attention: k and v must start on a 16-byte boundary")
    if not _aligned(q):
        q = q.clone()
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    if bidirectional_route(q.dtype, B, Sq, H, Hkv, D) == "sm90":
        _launch_sm90(q, k, v, out, n_keys)
    else:
        _launch_core(q, k, v, out, n_keys)
    return out


def _launch_core(q, k, v, out, n_keys: int) -> None:
    """The paged-attention core's launch (checked inputs, out allocated)."""
    global bidirectional_launches
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    plan = plan_spans((H // Hkv) * Sq, B * Hkv, n_keys)
    ws = torch.empty((B * Sq * H * plan.nsplit * (D + 2),), dtype=torch.float32,
                     device=q.device)
    rc = _build.library().repro_bidirectional_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, Sq, Skv, H, Hkv, D, n_keys, plan.key_groups, plan.nsplit, plan.span,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "bidirectional_attention")
    bidirectional_launches += 1


def _launch_sm90(q, k, v, out, n_keys: int) -> None:
    """The Hopper kernel's launch (checked bf16 inputs at D = SM90_D, out
    allocated)."""
    global bidirectional_launches, bidirectional_sm90_launches
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rc = _build.library().repro_bidirectional_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, D,
        n_keys, _build.stream_handle(q.device))
    _build.check(rc, "bidirectional_attention (sm90)")
    bidirectional_launches += 1
    bidirectional_sm90_launches += 1
