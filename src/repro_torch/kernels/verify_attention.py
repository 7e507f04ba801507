"""K4: paged verify attention (speculative decoding) on the shared KV page
pool.

Replaces `repro.kernels.decode_attention.paged_verify_attention_pallas`
(src/repro/kernels/decode_attention.py:185). CUDA source:
`csrc/paged_verify_attention.cu`, on the paged-attention core
`csrc/paged_attention.cuh` that K1, K2 and K5 share.

Every row scores its C candidate tokens (the pending token plus up to k
drafts, already written to the row's pages at [starts[b], starts[b] + C))
in one pass: candidate c attends the keys at kv_pos <= starts[b] + c that
the row's page table maps -- the batched generalisation of K1 from C = 1.

Bound on the H100: device-memory bytes. Each (row, KV head) reads at most
starts[b] + C positions of K and V once for its G x C query rows (8 x 5 =
40 at qwen2.5-3b width with k = 4), about 40 flops per byte it reads, far
under the ~295 flop/byte bf16 ridge. Design: the core with C query
positions a row, each row's base at its start: the G x C rows of a
(row, KV head) packed position-major into a 64-row tensor-core tile (bf16
in, fp32 accumulate; P kept to ~16 bits as two bf16 halves), each
64-position K/V tile staged once for all of them by cp.async through the
page table, the keys split into spans over blocks (`plan_spans`) and
merged by a second kernel. float32 inputs take the same blocks with the
products in fp32 FMA. The kernel reads q and writes its output in
(B, C, H, D), the order the model's projection gives, so the engine's
transposed view crosses the wrapper without a copy either way.
"""
from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES

from . import _build
from .decode_attention import _aligned, _check_paged, plan_spans

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


def paged_verify_attention(q, k_pool, v_pool, page_table, starts):
    """q (B, H, C, D); pools (P, ps, Hkv, D) in q's dtype; page_table
    (B, nb) int32 page ids (< P); starts (B,) int32 -> (B, H, C, D) in q's
    dtype, a transposed view of a (B, C, H, D) tensor on CUDA. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global launches
    if q.device.type in PLAIN_DEVICES:
        return paged_verify_attention_plain(q, k_pool, v_pool, page_table, starts)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: device {q.device}")
    if q.ndim != 4:
        raise ValueError(f"paged_verify_attention: q {tuple(q.shape)}, want (B, H, C, D)")
    qc = q.transpose(1, 2).contiguous()     # (B, C, H, D): no copy for the engine's view
    if not _aligned(qc):
        qc = qc.clone()
    _check_paged("paged_verify_attention", qc, k_pool, v_pool, page_table, starts, "starts")
    B, C, H, D = qc.shape
    _, ps, Hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    if nb == 0:
        raise ValueError("paged_verify_attention: page_table (B, nb > 0)")
    out = torch.empty_like(qc)
    if B == 0 or C == 0:
        return out.transpose(1, 2)
    plan = plan_spans((H // Hkv) * C, B * Hkv, nb * ps)
    ws = torch.empty((B * C * H * plan.nsplit * (D + 2),), dtype=torch.float32,
                     device=q.device)
    lib = _build.library()
    rc = lib.repro_paged_verify_attention(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        starts.data_ptr(), out.data_ptr(), ws.data_ptr(), B, C, H, Hkv, D, ps, nb,
        plan.key_groups, plan.nsplit, plan.span,
        _build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
        _build.stream_handle(q.device))
    _build.check(rc, "paged_verify_attention")
    launches += 1
    return out.transpose(1, 2)
