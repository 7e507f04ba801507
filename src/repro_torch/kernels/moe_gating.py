"""K6: MoE router gating -- softmax, top-k, renormalise -- fused with the
capacity numbering of the dispatch.

Replaces `repro.kernels.moe_gating.moe_gating_pallas` (src/repro/kernels/
moe_gating.py:47), the function the JAX model's `moe_apply` computes
inline (`softmax -> lax.top_k -> w / max(sum w, 1e-9)`), and, given a
capacity, the numbering `moe_apply` computes after it (src/repro/models/
layers.py:649-654): each assignment's slot `e C + pos` or the drop slot
`E C`, and its kept weight `w keep`. CUDA source: `csrc/moe_gating.cu`.

Bound on the H100: bytes, and far below a microsecond (~30 KB at T = 128,
E = 64, k = 6), so a launch costs what launching costs; the gain is the
~10 launches of the numbering it takes over. Design: one warp per token
row, k rounds of a warp arg-max with ties to the lower index; the rows
spread over a thread-block cluster whose blocks number their assignments
and exchange per-expert totals through distributed shared memory; see the
source. `gating_plan` is the launch plan.

The order of the k indices is part of the result: descending probability,
the lowest expert index first on equal probabilities (`lax.top_k`'s
order). Router logits formed in bf16 tie often, and the dispatch numbers
assignments in (token, rank) order, so the rank decides which assignment
a full expert drops.

Grouped (`groups=G`, the grouped dispatch of `moe_apply`, the JAX
`jax.vmap(_moe_dispatch_group)` at src/repro/models/layers.py:621-634):
the T rows are G contiguous groups of T / G rows, each numbered against
its own capacity with group-local slots (e C + pos, or the drop slot E C),
in one launch over a (cs, G) grid, a cluster a group. `MAX_ASSIGNMENTS`
caps a group's T / G x k.

`moe_gating` runs the kernel on a CUDA tensor and `moe_gating_plain` on a
CPU tensor; `launches` counts kernel launches, `grouped_launches` those of
them over more than one group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

MAX_EXPERTS = 256
MAX_CLUSTER = 8             # blocks a cluster, the portable size
ROWS_PER_BLOCK = 16         # rows a block until all MAX_CLUSTER blocks are used
MAX_ASSIGNMENTS = 1 << 17   # T x k a group: a block's expert bytes in shared memory

launches = 0
grouped_launches = 0


class GatingPlan(NamedTuple):
    cs: int            # blocks, one cluster
    per: int           # token rows a block
    threads: int       # threads a block: a warp a row, at most 1,024


def gating_plan(T: int) -> GatingPlan:
    """cs = min(8, ceil(T / 16)) blocks of per = ceil(T / cs) rows, a warp
    a row up to 32 warps (a warp walks ceil(per / 32) rows beyond)."""
    cs = min(MAX_CLUSTER, -(-T // ROWS_PER_BLOCK))
    per = -(-T // cs)
    return GatingPlan(cs, per, min(1024, 32 * per))


def number_assignments(w: torch.Tensor, idx: torch.Tensor, E: int, capacity: int):
    """The dispatch numbering of `moe_apply`, as the JAX model writes it:
    assignments in (token, rank) order, pos = the count of earlier ones to
    the same expert, keep = pos < C. Returns (slot (T k,) int64: e C + pos,
    or E C when dropped; kept (T k,) float32: w keep)."""
    flat_e = idx.reshape(-1).long()
    pos = (F.one_hot(flat_e, E).cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    return torch.where(keep, flat_e * capacity + pos, E * capacity), w.reshape(-1) * keep


def moe_gating_plain(logits: torch.Tensor, k: int, capacity: int | None = None,
                     groups: int = 1):
    """Plain PyTorch version, as `repro.kernels.ref.moe_gating_ref`: a
    float32 softmax, a stable descending sort cut to k (equal
    probabilities keep the lower index first; `torch.topk` leaves their
    order unspecified), the weights clamped at 0 and divided by
    max(their sum, 1e-9), summed in rank order as the kernel sums them.
    Returns (weights (T, k) float32, indices (T, k) int32), and with a
    capacity also `number_assignments`' (slot, kept). With `groups` G > 1
    it runs group by group on the G contiguous groups of T / G rows, and
    each group's slots are its own (the layout of the JAX vmap over the
    groups, flattened)."""
    if groups > 1:
        parts = [moe_gating_plain(g, k, capacity) for g in logits.chunk(groups)]
        return tuple(torch.cat(outs) for outs in zip(*parts))
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = w[:, :k].clamp(min=0.0)
    total = w[:, 0]
    for j in range(1, k):
        total = total + w[:, j]
    w, idx = w / total.clamp(min=1e-9)[:, None], idx[:, :k].to(torch.int32)
    if capacity is None:
        return w, idx
    return (w, idx, *number_assignments(w, idx, logits.shape[1], capacity))


def moe_gating(logits: torch.Tensor, k: int, capacity: int | None = None, groups: int = 1):
    """logits (T, E) float32 or bfloat16 -> (weights (T, k) float32,
    indices (T, k) int32), and with a capacity C also (slot (T k,) int64,
    kept (T k,) float32) as `number_assignments`, each of the `groups`
    contiguous groups of T / G rows numbered on its own. CPU tensors take
    the plain version; CUDA tensors launch the kernel (one launch for all
    groups) or raise."""
    global launches, grouped_launches
    if logits.ndim != 2:
        raise ValueError(f"moe_gating: logits must be (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= E:
        raise ValueError(f"moe_gating: need 1 <= k <= E <= {MAX_EXPERTS}, got k={k}, E={E}")
    if capacity is not None and capacity < 1:
        raise ValueError(f"moe_gating: capacity must be >= 1, got {capacity}")
    if groups < 1 or T % groups:
        raise ValueError(f"moe_gating: {groups} groups must divide the {T} rows")
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, k, capacity, groups)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moe_gating takes float32 or bfloat16 logits, got {logits.dtype}")
    if T // groups * k > MAX_ASSIGNMENTS:
        raise ValueError(f"moe_gating: T / G x k = {T // groups * k} assignments a group, "
                         f"at most {MAX_ASSIGNMENTS}")
    logits = logits.contiguous()
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    numbered = capacity is not None
    slot = torch.empty((T * k,), dtype=torch.int64, device=dev) if numbered else None
    kept = torch.empty((T * k,), dtype=torch.float32, device=dev) if numbered else None
    if T:
        plan = gating_plan(T // groups)
        rc = _build.library().repro_moe_gating(
            logits.data_ptr(), _build.DTYPE_CODES[str(logits.dtype).removeprefix("torch.")],
            w.data_ptr(), idx.data_ptr(), slot.data_ptr() if numbered else None,
            kept.data_ptr() if numbered else None, T, E, k, capacity or 0, plan.cs, plan.per,
            plan.threads, groups, _build.stream_handle(dev))
        _build.check(rc, "moe_gating")
        launches += 1
        grouped_launches += groups > 1
    return (w, idx, slot, kept) if numbered else (w, idx)
