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
`models.decode_step_slab` / `layers.attn_decode_apply_slab`; the serving
engine plugs it in on a mesh whose slab shards the sequence. The per-shard
leaf is kernel K5s (`kernels.decode_attention.decode_attention_stats`):
on a CUDA tensor K5's core over the shard, merged into the shard's float32
(m, l, acc); on a CPU tensor its plain version.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import decode_attention as _k5
from repro_torch.launch.mesh import axes_group, axis_names, axis_rank, axis_size


def _partial_attn(group, idx, q, k_shard, v_shard, length):
    """Local partial attention + combine. q: (B,1,Hkv,G,hd), this rank's
    batch rows; k/v_shard: (B, S_loc, Hkv, hd) = this rank's sequence
    shard, number `idx` of the sharded sequence dim; length: an int, a 0-d
    tensor or (B,). The shard's statistics come from K5s, relative to its
    own max; the combine rescales them to the global max. Returns
    (B,1,Hkv,G,hd) in the cache's dtype."""
    B, _, Hkv, G, hd = q.shape
    m, l, acc = _k5.decode_attention_stats(q.reshape(B, Hkv * G, hd), k_shard, v_shard,
                                           length, idx * k_shard.shape[1])
    m_star = m.clone()
    dist.all_reduce(m_star, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m_star), m_star, torch.zeros_like(m_star))
    w = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
    l = l * w
    acc = acc * w[..., None]
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    # times the reciprocal, as K5's merge kernel divides: on one shard the
    # weights are exp(0) = 1 and the output is K5's, bit for bit
    out = (acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]).to(v_shard.dtype)
    return out.reshape(B, 1, Hkv, G, hd)


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
