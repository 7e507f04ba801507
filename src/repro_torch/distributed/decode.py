"""Sequence-sharded decode attention: flash-decoding as a collective
(counterpart of `repro.distributed.decode`).

The KV cache's sequence dim is sharded over the `model` axis. Each rank
computes attention over its local KV shard, producing partial
(max m, denom l, weighted-sum acc); the cross-shard combine is three small
collectives on the axis's process group:

    m*   = all_reduce(MAX, m)
    l*   = all_reduce(SUM, l * exp(m - m*))
    out  = all_reduce(SUM, acc * exp(m - m*)) / max(l*, 1e-30)

The wire carries O(B*H*head_dim) -- independent of S. A fully masked row
(length 0) gives zeros, as in the JAX package.

Composition: `make_seq_sharded_decode_attn(mesh)` returns an attn_impl for
`models.decode_step_slab` / `layers.attn_decode_apply_slab`. The JAX body
is jnp, not a Pallas kernel, so the per-shard leaf here is plain PyTorch;
a K5 variant that returns its softmax statistics would take its place
(ROADMAP, later kernel work).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group, axis_names, axis_rank, axis_size


def _partial_attn(group, idx, q, k_shard, v_shard, length):
    """Local partial attention + combine. q: (B,1,Hkv,G,hd), this rank's
    batch rows; k/v_shard: (B, S_loc, Hkv, hd) = this rank's sequence
    shard, number `idx` of the sharded sequence dim; length: an int, a 0-d
    tensor or (B,)."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    s_loc = k_shard.shape[1]
    start = idx * s_loc
    s = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k_shard.float()) * scale
    pos = start + torch.arange(s_loc, device=q.device)
    lengthv = torch.as_tensor(length, device=q.device)
    ok = (pos[None, :] < lengthv[:, None]) if lengthv.ndim else (pos < lengthv)[None, :]
    s = s.masked_fill(~ok[:, None, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqs,bshd->bhgqd", p.to(v_shard.dtype), v_shard).contiguous()
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return torch.movedim(out, 3, 1)          # (B,1,Hkv,G,hd)


def make_seq_sharded_decode_attn(mesh, axis="model", batch_axis: str | None = "data"):
    """attn_impl for models.decode_step_slab / layers.attn_decode_apply_slab.

    Each rank holds the cache shard P(batch_axis, axis, None, None) of
    (B, S, Hkv, hd) and its batch rows of q; `axis` may be a tuple for
    combined-axis sequence sharding (ws2d layout: batch replicated, S over
    (data, model)), ranked major to minor. `batch_axis` names the axis
    the rows are split over, as in the JAX signature; each rank passes its
    own rows (and their lengths), so the split needs no collective. Every
    rank makes this call (a group over several axes is made
    collectively)."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    if not all(a in axis_names(mesh) for a in axes):
        raise ValueError(f"axes {axes} are not all axes of the mesh {axis_names(mesh)}")
    group = axes_group(mesh, axes)
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + axis_rank(mesh, a)

    def attn(q, k_cache, v_cache, length):
        return _partial_attn(group, idx, q, k_cache, v_cache, length)

    return attn
