"""GPipe-style pipeline parallelism over the `pod` axis (counterpart of
`repro.distributed.pipeline`; DESIGN.md §4).

Alternative use of the multi-pod mesh: instead of cross-pod data
parallelism (one gradient all-reduce over the slow inter-pod links every
step), split the layer stack into `n_stages = pod` contiguous stages and
stream microbatches through with ring hand-offs -- the only cross-pod
traffic is one activation tensor per microbatch per boundary.

Schedule: classic GPipe (fill/steady/drain) over `n_micro + n_stages - 1`
ticks. Each rank runs its own stage; a tick's hand-off is one
`batch_isend_irecv` pair on the axis's process group (send to the next
stage, receive from the previous), and the last stage's outputs are
broadcast to every stage by an all-reduce of the masked outputs.

Bubble fraction = (n_stages - 1) / (n_micro + n_stages - 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_names, axis_rank, axis_size


def _ring_peers(mesh, axis: str, idx: int, n: int) -> tuple:
    """Global ranks of the previous and the next stage of this rank."""
    names = axis_names(mesh)
    d = names.index(axis)
    me = [int(mesh.get_local_rank(a)) for a in names]

    def at(i):
        c = list(me)
        c[d] = i % n
        return int(mesh.mesh[tuple(c)])
    return at(idx - 1), at(idx + 1)


def pipeline_forward(mesh, stage_fn, n_micro: int, *, axis: str = "pod"):
    """Builds fwd(stage_params, x_micro) running `stage_fn` as a pipeline.

    stage_fn(stage_params, x) -> y : one stage's computation (same shape in
    and out -- e.g. a slice of transformer layers on the residual stream).
    stage_params: a tree whose leaves have a leading `n_stages` dim (each
    rank uses its own row) or a leading dim of 1 (the rank's own stage);
    x_micro: (n_micro, mb, ...) microbatched input (the same on every rank;
    stage 0 consumes it).

    Returns out: (n_micro, mb, ...) -- the last stage's outputs, on every
    rank of the axis."""
    n_stages = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    idx = axis_rank(mesh, axis)
    prev, nxt = _ring_peers(mesh, axis, idx, n_stages)

    def own(tree):
        if isinstance(tree, dict):
            return {k: own(v) for k, v in tree.items()}
        return tree[idx] if tree.shape[0] == n_stages else tree[0]

    def fwd(stage_params, x_micro):
        params = own(stage_params)
        mb_shape = x_micro.shape[1:]
        inbuf = torch.zeros(mb_shape, dtype=x_micro.dtype, device=x_micro.device)
        outs = torch.zeros((n_micro,) + mb_shape, dtype=x_micro.dtype,
                           device=x_micro.device)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (when valid); others use inbuf
            x = x_micro[t if t < n_micro else 0] if idx == 0 else inbuf
            y = stage_fn(params, x).contiguous()
            # my microbatch id at this tick: t - idx; the last stage stores it
            my_mb = t - idx
            if 0 <= my_mb < n_micro and idx == n_stages - 1:
                outs[my_mb] = y.to(outs.dtype)
            # hand off to the next stage (ring; last -> 0 ignored)
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y, nxt, group),
                   dist.P2POp(dist.irecv, recv, prev, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            inbuf = recv
        # broadcast final-stage outputs to every stage
        outs = outs * float(idx == n_stages - 1)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return fwd


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
