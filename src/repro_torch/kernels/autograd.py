"""Gradients for the kernels on the training path: K2 (causal chunk
attention over pages), K2's non-causal form, K6 (MoE gating with the
dispatch numbering) and K7 (the Mamba1 selective scan).

The JAX package trains by differentiating plain `jnp` code with
`jax.value_and_grad`; it has no `custom_vjp` and no backward Pallas kernel,
so there is no backward kernel to port. Here each kernel has one
`torch.autograd.Function`: its forward launches the hand-written kernel
through the kernel's wrapper (which counts the launch), and its backward is
the gradient of the kernel's plain version, recomputed from the saved
inputs under `torch.enable_grad()` with `torch.autograd.grad`.

The backward by recomputation is a stand-in, to be replaced by a
hand-written backward kernel (ROADMAP.md, kernel work after the port): it
runs the plain version's forward and backward on the card, and holds the
saved inputs instead of the kernel's softmax statistics.

A CPU tensor goes through the wrapper straight to the plain version, with
PyTorch's own autograd; a CUDA tensor always goes to the kernel. Where
no input records a gradient (the serving paths: their parameters take
none) the functions call the wrappers directly, so serving and training
share one code path. Nothing catches a failed build or launch.
"""
from __future__ import annotations

import torch

from repro_torch.device import PLAIN_DEVICES

from . import flash_attention as _k2
from . import moe_gating as _k6
from . import ssm_scan as _k7


def _plain_grads(plain, inputs, needs, out_grads):
    """The gradients of plain(*inputs) with respect to the inputs flagged in
    `needs`, given the gradients of its outputs (None for an output that
    takes none); None for the other inputs."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) if torch.is_tensor(x) else x
              for x, n in zip(inputs, needs)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, out_grads)
                 if g is not None and torch.is_tensor(o) and o.requires_grad]
        wrt = [x for x, n in zip(xs, needs) if n]
        got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                  allow_unused=True) if wrt and pairs else [None] * len(wrt)
    got = iter(got)
    return tuple(next(got) if n else None for n in needs)


class _ChunkPrefill(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_pool, v_pool, ctx_table, start):
        ctx.save_for_backward(q, k_pool, v_pool, ctx_table)
        ctx.start = start
        return _k2.chunk_prefill_attention(q, k_pool, v_pool, ctx_table, start)

    @staticmethod
    def backward(ctx, g):
        q, k_pool, v_pool, ctx_table = ctx.saved_tensors

        def plain(q, k, v):
            return _k2.chunk_prefill_attention_plain(q, k, v, ctx_table, ctx.start)
        return _plain_grads(plain, (q, k_pool, v_pool), ctx.needs_input_grad[:3],
                            (g,)) + (None, None)


class _Bidirectional(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_keys):
        ctx.save_for_backward(q, k, v)
        ctx.n_keys = n_keys
        return _k2.bidirectional_attention(q, k, v, n_keys)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors

        def plain(q, k, v):
            return _k2.bidirectional_attention_plain(q, k, v, ctx.n_keys)
        return _plain_grads(plain, (q, k, v), ctx.needs_input_grad[:3], (g,)) + (None,)


class _Gating(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k, capacity, groups):
        w, idx, slot, kept = _k6.moe_gating(logits, k, capacity, groups)
        ctx.save_for_backward(logits)
        ctx.k, ctx.capacity, ctx.groups = k, capacity, groups
        ctx.mark_non_differentiable(idx, slot)
        return w, idx, slot, kept

    @staticmethod
    def backward(ctx, g_w, _g_idx, _g_slot, g_kept):
        (logits,) = ctx.saved_tensors

        def plain(logits):
            return _k6.moe_gating_plain(logits, ctx.k, ctx.capacity, ctx.groups)
        return _plain_grads(plain, (logits,), ctx.needs_input_grad[:1],
                            (g_w, None, None, g_kept)) + (None, None, None)


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, D, h0):
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, D, h0)
        return _k7.ssm_scan(x, dt, A, B_mat, C_mat, D, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        return _plain_grads(_k7.ssm_scan_plain, ctx.saved_tensors, ctx.needs_input_grad,
                            (g_y, g_h))


def _direct(*xs) -> bool:
    """Whether the call goes straight to the kernel's wrapper: CPU tensors
    (the plain version, with PyTorch's autograd) or no input that records a
    gradient."""
    return xs[0].device.type in PLAIN_DEVICES or not (
        torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in xs))


def chunk_prefill_attention(q, k_pool, v_pool, ctx_table, start: int):
    """`flash_attention.chunk_prefill_attention` with a gradient for q and
    the pools."""
    if _direct(q, k_pool, v_pool):
        return _k2.chunk_prefill_attention(q, k_pool, v_pool, ctx_table, start)
    return _ChunkPrefill.apply(q, k_pool, v_pool, ctx_table, start)


def bidirectional_attention(q, k, v, n_keys: int):
    """`flash_attention.bidirectional_attention` with a gradient for q, k
    and v."""
    if _direct(q, k, v):
        return _k2.bidirectional_attention(q, k, v, n_keys)
    return _Bidirectional.apply(q, k, v, n_keys)


def moe_gating(logits, k: int, capacity: int, groups: int = 1):
    """`moe_gating.moe_gating` with a capacity (and `groups`, the grouped
    launch): (weights, indices, slots, kept weights), the weights and kept
    weights with a gradient for the logits; the indices and slots are
    integers and carry none."""
    if _direct(logits):
        return _k6.moe_gating(logits, k, capacity, groups)
    return _Gating.apply(logits, k, capacity, groups)


def ssm_scan(x, dt, A, B_mat, C_mat, D, h0=None):
    """`ssm_scan.ssm_scan` without the per-position states: (y, h_final),
    with a gradient for every input."""
    if _direct(x, dt, A, B_mat, C_mat, D, h0):
        return _k7.ssm_scan(x, dt, A, B_mat, C_mat, D, h0)
    return _Scan.apply(x, dt, A, B_mat, C_mat, D, h0)
