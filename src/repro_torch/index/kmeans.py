"""K-means in PyTorch (evidence clustering, paper §4.2; also the IVF coarse
quantizer); counterpart of `repro.index.kmeans`. k-means++ init (numpy,
deterministic) + Lloyd iterations on `device`."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((x[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1)
        tot = d2.sum()
        if tot <= 1e-12:
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / tot)])
    return np.stack(centers)


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor):
    d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)          # (n, k)
    assign = torch.argmin(d2, dim=1)          # first minimum, as jnp.argmin
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(x.dtype)
    counts = onehot.sum(0)
    sums = onehot.T @ x
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1), centers)
    return new, assign


def kmeans(x: np.ndarray, k: int, *, iters: int = 25, seed: int = 0,
           device=None):
    """Returns (centers (k,d), assignments (n,) int32). Deterministic."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n == 0:
        return np.zeros((0, x.shape[1] if x.ndim == 2 else 0), np.float32), np.zeros((0,), np.int32)
    dev = resolve_device(device)
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centers = torch.from_numpy(_kmeanspp_init(x, k, rng)).to(dev)
    xt = torch.tensor(x, device=dev)
    assign = None
    for _ in range(iters):
        centers, assign = _lloyd_step(xt, centers)
    return centers.cpu().numpy(), assign.to(torch.int32).cpu().numpy()
