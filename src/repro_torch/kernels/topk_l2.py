"""K3: fused L2 distance + ascending top-k (QUEST index retrieval).

Replaces `repro.kernels.topk_l2.topk_l2_pallas` (src/repro/kernels/
topk_l2.py:55). CUDA source: `csrc/topk_l2.cu`.

Bound on the H100: bytes, and tiny. At the retriever's shapes (N ~ 300
segments, D = 256, k = N, a few probes per document) the distance pass is
~0.1 MFLOP and ~0.3 MB, far below a microsecond of either roofline, so
latency decides. Design (see the source): a query row's database rows are
spread over a thread-block cluster of up to 8 blocks, each computing d^2
of its slice with several rows' loads in flight; the blocks exchange
slices through distributed shared memory, and each ranks its slice by
counting, for every element, the (d^2, index) pairs that come before it
-- exact, deterministic, no sort stages. Above CLUSTER_MAX_N rows a
distance kernel writes an (M, N) scratch and a rank kernel ranks spans of
RANK_SPAN elements. `topk_plan` is the launch plan.

The kernel writes distances and indices into one (2, M, k) float32 buffer
(the indices as int32 bits), so a caller that wants both on the host
copies once (`topk_l2_packed`, used by `ops.topk_l2`).

`topk_l2` runs the kernel on a CUDA tensor and `topk_l2_plain` on a CPU
tensor; `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import PLAIN_DEVICES

from . import _build

MAX_N = 16384          # database rows a call
CLUSTER_MAX_N = 2048   # rows one cluster ranks (csrc: kClusterMaxN)
MAX_CLUSTER = 8        # blocks a cluster, the portable size
RANK_SPAN = 128        # elements a block ranks above CLUSTER_MAX_N (kRankSpan)

launches = 0


class TopkPlan(NamedTuple):
    cs: int            # blocks a query row (a cluster); 0 above CLUSTER_MAX_N
    per: int           # database rows a block computes and ranks
    threads: int       # threads a block


def topk_plan(N: int) -> TopkPlan:
    """The launch plan for N database rows: at most CLUSTER_MAX_N, a
    cluster of cs = min(8, ceil(N / 32)) blocks of per = ceil(N / cs) rows,
    a warp a row up to 32 warps (the rows' loads then go out in one group);
    above it, the two-kernel shape with RANK_SPAN elements a rank block."""
    if N > CLUSTER_MAX_N:
        return TopkPlan(0, RANK_SPAN, 1024)
    cs = min(MAX_CLUSTER, -(-N // 32))
    per = -(-N // cs)
    return TopkPlan(cs, per, min(1024, 32 * per))


def topk_l2_plain(db: torch.Tensor, q: torch.Tensor, k: int):
    """Plain PyTorch version, as `repro.kernels.ref.topk_l2_ref`:
    direct d^2 = sum (q - db)^2, stable ascending sort (lowest index first
    on ties), first k. Returns (dists (M, k) float32, idx (M, k) int32)."""
    db = db.to(torch.float32)
    q = q.to(torch.float32)
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    d2s, idx = torch.sort(d2, dim=1, stable=True)
    return (torch.sqrt(torch.clamp(d2s[:, :k], min=0.0)),
            idx[:, :k].to(torch.int32))


def topk_l2_packed(db: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """db (N, D) float32, q (M, D) float32 -> one (2, M, k) float32 tensor:
    [0] the distances, [1] the indices' int32 bits (`.view(torch.int32)`),
    ascending. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    global launches
    if q.device == db.device and db.device.type in PLAIN_DEVICES:
        d, i = topk_l2_plain(db, q, k)
        return torch.stack([d, i.view(torch.float32)])
    if db.device.type != "cuda" or q.device != db.device:
        raise ValueError(f"topk_l2: db on {db.device}, q on {q.device}")
    if db.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"topk_l2 takes float32, got {db.dtype}/{q.dtype}")
    if db.ndim != 2 or q.ndim != 2 or db.shape[1] != q.shape[1]:
        raise ValueError(f"topk_l2: shapes {tuple(db.shape)} / {tuple(q.shape)}")
    N, D = db.shape
    M = q.shape[0]
    if not 1 <= k <= N or N > MAX_N:
        raise ValueError(f"topk_l2: need 1 <= k <= N <= {MAX_N}, got k={k}, N={N}")
    db, q = db.contiguous(), q.contiguous()
    out = torch.empty((2, M, k), dtype=torch.float32, device=db.device)
    if M == 0:
        return out
    plan = topk_plan(N)
    scratch = None if plan.cs else torch.empty((M, N), dtype=torch.float32, device=db.device)
    rc = _build.library().repro_topk_l2(
        db.data_ptr(), q.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), M, N, D, k, plan.cs, plan.per,
        plan.threads, _build.stream_handle(db.device))
    _build.check(rc, "topk_l2")
    launches += 1
    return out


def topk_l2(db: torch.Tensor, q: torch.Tensor, k: int):
    """db (N, D) float32, q (M, D) float32 -> (dists (M, k), idx (M, k)
    int32), ascending. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise; on the card both are views of one buffer."""
    if q.device == db.device and db.device.type in PLAIN_DEVICES:
        return topk_l2_plain(db, q, k)
    out = topk_l2_packed(db, q, k)
    return out[0], out[1].view(torch.int32)
