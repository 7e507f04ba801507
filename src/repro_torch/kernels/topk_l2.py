"""K3: fused L2 distance + ascending top-k (QUEST index retrieval).

Replaces `repro.kernels.topk_l2.topk_l2_pallas` (src/repro/kernels/
topk_l2.py:55). CUDA source: `csrc/topk_l2.cu`.

Bound on the H100: tiny. At the retriever's shapes (N ~ 300 segments,
D = 256, k = N, a few probes per document) the distance pass is ~0.1
MFLOP and ~0.3 MB, far below a microsecond of either roofline, so the
launch itself dominates. Design: one block per query row computes the
whole distance row into shared memory (warps over rows, lanes over D,
coalesced) and bitonic-sorts it there -- one launch, one read of the
database, no (M, N) distance matrix in device memory. The wrapper caps N
at what one block's shared memory holds; `ExactIndex` switches to IVF at
2048 rows, so the main path never comes near it.

`topk_l2` runs the kernel on a CUDA tensor and `topk_l2_plain` on a CPU
tensor; `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

MAX_N = 16384          # (d^2, idx) pairs of one row in shared memory

launches = 0


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


def topk_l2(db: torch.Tensor, q: torch.Tensor, k: int):
    """db (N, D) float32, q (M, D) float32 -> (dists (M, k), idx (M, k)
    int32), ascending. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global launches
    if db.device.type == "cpu" and q.device.type == "cpu":
        return topk_l2_plain(db, q, k)
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
    out_d = torch.empty((M, k), dtype=torch.float32, device=db.device)
    out_i = torch.empty((M, k), dtype=torch.int32, device=db.device)
    if M == 0:
        return out_d, out_i
    lib = _build.library()
    rc = lib.repro_topk_l2(db.data_ptr(), q.data_ptr(), out_d.data_ptr(),
                           out_i.data_ptr(), M, N, D, k,
                           _build.stream_handle(db.device))
    _build.check(rc, "topk_l2")
    launches += 1
    return out_d, out_i
