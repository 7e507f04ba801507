"""K4: paged verify attention (speculative decoding) on the shared KV page
pool.

Replaces `repro.kernels.decode_attention.paged_verify_attention_pallas`
(src/repro/kernels/decode_attention.py:185). CUDA source:
`csrc/paged_verify_attention.cu`.

Every row scores its C candidate tokens (the pending token plus up to k
drafts, already written to the row's pages at [starts[b], starts[b] + C))
in one pass: candidate c attends the keys at kv_pos <= starts[b] + c that
the row's page table maps -- the batched generalisation of K1 from C = 1.

Bound on the H100: device-memory bytes. Each (row, KV head) reads at most
starts[b] + C positions of K and V once for its G x C query rows (8 x 5 =
40 at qwen2.5-3b width with k = 4), about 40 flops per byte it reads, far
under the ~295 flop/byte bf16 ridge. Design: the flash-decoding split --
one block per (row, KV head, span of key positions) serving all G x C
query rows from each K/V tile staged in shared memory once, keys walked
in 64-position tiles looked up through the page table position by
position (any page size, unaligned starts), scores and the online softmax
in fp32; a second kernel merges the spans. The wrapper picks the number
of spans so that the launch has about two blocks per SM of the H100.
"""
from __future__ import annotations

import torch

from . import _build

MAX_HEAD_DIM = 256
KEY_TILE = 64          # key positions per shared-memory tile (the .cu's kVerifyTile)
TARGET_BLOCKS = 264    # two blocks per SM of the H100's 132

launches = 0


def paged_verify_attention_plain(q, k_pool, v_pool, page_table, starts):
    """Plain PyTorch version, the port of `paged_verify_attention_ref`:
    gather the table's pages into dense rows, then causal masked attention
    from each row's start. q (B, H, C, D); pools (P, ps, Hkv, D);
    page_table (B, nb) int32; starts (B,) int32 -> (B, H, C, D)."""
    B, H, C, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    S = page_table.shape[1] * ps
    tbl = page_table.long()
    kg = k_pool[tbl].reshape(B, S, Hkv, D)
    vg = v_pool[tbl].reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, H // Hkv, C, D)
    s = torch.einsum("bhgcd,bshd->bhgcs", qg.float(), kg.float()) * (D ** -0.5)
    q_pos = starts.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    ok = torch.arange(S, device=q.device)[None, None, :] <= q_pos[:, :, None]
    s = s.masked_fill(~ok[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgcs,bshd->bhgcd", p.to(vg.dtype), vg)
    return out.reshape(B, H, C, D).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, starts):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("starts", starts)):
        if t.device != dev:
            raise ValueError(f"paged_verify_attention: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_verify_attention: {name} is not contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_verify_attention: q dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_verify_attention: pools must share q's dtype")
    if page_table.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("paged_verify_attention: page_table/starts must be int32")
    if q.ndim != 4:
        raise ValueError(f"paged_verify_attention: q {tuple(q.shape)}, want (B, H, C, D)")
    B, H, C, D = q.shape
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"paged_verify_attention: pools {tuple(k_pool.shape)}")
    Hkv = k_pool.shape[2]
    if page_table.ndim != 2 or page_table.shape[0] != B or page_table.shape[1] == 0 \
            or starts.shape != (B,):
        raise ValueError("paged_verify_attention: page_table (B, nb > 0), starts (B,)")
    if H % Hkv or D > MAX_HEAD_DIM:
        raise ValueError(f"paged_verify_attention: unsupported H={H} Hkv={Hkv} D={D}")


def paged_verify_attention(q, k_pool, v_pool, page_table, starts):
    """q (B, H, C, D); pools (P, ps, Hkv, D) in q's dtype; page_table
    (B, nb) int32 page ids (< P); starts (B,) int32 -> (B, H, C, D) in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pool, v_pool, page_table, starts)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: device {q.device}")
    q = q.contiguous()
    _check(q, k_pool, v_pool, page_table, starts)
    B, H, C, D = q.shape
    _, ps, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    nb = page_table.shape[1]
    # split the key walk into spans of whole tiles, enough to fill the card
    tiles = -(-nb * ps // KEY_TILE)
    nsplit = max(1, min(tiles, -(-TARGET_BLOCKS // (B * Hkv))))
    ws = torch.empty((B * H * C * nsplit * (D + 2),), dtype=torch.float32,
                     device=q.device)
    lib = _build.library()
    rc = lib.repro_paged_verify_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        starts.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, Hkv, C, D, ps, nb,
        nsplit, _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "paged_verify_attention")
    launches += 1
    return out
