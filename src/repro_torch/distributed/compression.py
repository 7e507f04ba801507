"""Pod-axis int8 gradient compression with error feedback (counterpart of
`repro.distributed.compression`; DESIGN.md §6).

Multi-pod data parallelism syncs gradients across the slow inter-pod links.
`make_pod_grad_sync` returns a grad_transform for `make_train_step` that,
on the `pod` axis's process group:
  1. blockwise-int8 quantizes each gradient (`training.optim._q8`, blocks
     of Q_BLOCK along the last dim),
  2. all-reduces the dequantized payload over `pod` and divides by the pod
     count,
  3. returns the mean; `compressed_pod_mean` also returns each leaf's
     local quantization error, the error-feedback residual.
Scalars, a last dim not divisible by the block and leaves of fewer than 4
blocks are sent in float32, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.optim import _dq8, _q8
from repro_torch.tree import like, map_leaves

Q_BLOCK = 256


def _exempt(g) -> bool:
    return g.ndim == 0 or g.shape[-1] % Q_BLOCK or g.numel() < 4 * Q_BLOCK


def _mean(x, group):
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / dist.get_world_size(group)


def pod_all_mean(tree, group=None):
    """The mean of every leaf over `group` (the pod axis's process group;
    default the world)."""
    return map_leaves(lambda keys, index, x: _mean(x.float(), group), tree)


def compressed_pod_mean(grads, group=None):
    """Int8 all-reduce over `group`: quantize -> all-reduce the dequantized
    value -> divide. Returns (mean_grads, residual), residual the local
    quantization error (zeros for an exempt leaf)."""
    means, resids = [], []

    def one(keys, index, g):
        g = g.float()
        if _exempt(g):
            means.append(_mean(g.clone(), group))
            resids.append(torch.zeros_like(g))
            return g
        local_dq = _dq8(*_q8(g, Q_BLOCK), Q_BLOCK)
        resids.append(g - local_dq)
        means.append(_mean(local_dq, group))
        return g

    map_leaves(one, grads)
    return like(grads, means), like(grads, resids)


def make_pod_grad_sync(mesh, *, compress: bool = True):
    """grad_transform hook for multi-pod training: None without a `pod`
    axis; else a function of the gradient tree (the parameters' structure)
    that syncs it over the `pod` subgroup, compressed or in float32."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return None
    group = mesh.get_group("pod")

    def transform(grads):
        if compress:
            mean, _ = compressed_pod_mean(grads, group)
            return mean
        return pod_all_mean(grads, group)

    return transform
