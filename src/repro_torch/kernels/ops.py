"""Array-level entry points of the kernel layer (counterpart of
`repro.kernels.ops`).

There is no backend switch: the device of the data decides. The index
layer holds numpy arrays; `topk_l2` moves them to the index's device, runs
K3 there (its plain version on the CPU), and hands numpy back.
"""
from __future__ import annotations

import numpy as np
import torch

from . import topk_l2 as _k3


def topk_l2(db, q, k: int, *, device):
    """Top-k nearest (L2) database rows per query. db: (N, D) array or
    float32 tensor, q: (M, D). Returns numpy (dists (M, k) float32,
    idx (M, k) int32), ascending, lowest index first on ties."""
    db_t = torch.as_tensor(np.asarray(db, np.float32) if not torch.is_tensor(db)
                           else db, dtype=torch.float32, device=device)
    q_t = torch.as_tensor(np.asarray(q, np.float32), dtype=torch.float32,
                          device=device)
    dists, idx = _k3.topk_l2(db_t, q_t, k)
    return dists.cpu().numpy(), idx.cpu().numpy()
