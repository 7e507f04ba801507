"""K6: MoE router gating -- softmax, top-k, renormalise.

Replaces `repro.kernels.moe_gating.moe_gating_pallas` (src/repro/kernels/
moe_gating.py:47), the function the JAX model's `moe_apply` computes
inline (`softmax -> lax.top_k -> w / max(sum w, 1e-9)`). CUDA source:
`csrc/moe_gating.cu`.

Bound on the H100: bytes, and far below a microsecond (T x E float32
logits in, T x k weights and indices out: ~39 KB at T = 128, E = 64,
k = 6), so a launch costs what launching costs. Design: one warp per token
row, k rounds of a warp arg-max with ties to the lower index, the picks
kept in registers; see the source.

The order of the k indices is part of the result: descending probability,
the lowest expert index first on equal probabilities (`lax.top_k`'s
order). Router logits formed in bf16 tie often, and the MoE dispatch
numbers assignments in (token, rank) order, so the rank decides which
assignment a full expert drops.

`moe_gating` runs the kernel on a CUDA tensor and `moe_gating_plain` on a
CPU tensor; `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

MAX_EXPERTS = 256

launches = 0


def moe_gating_plain(logits: torch.Tensor, k: int):
    """Plain PyTorch version, as `repro.kernels.ref.moe_gating_ref`: a
    float32 softmax, a stable descending sort cut to k (equal
    probabilities keep the lower index first; `torch.topk` leaves their
    order unspecified), the weights clamped at 0 and divided by
    max(their sum, 1e-9), summed in rank order as the kernel sums them.
    Returns (weights (T, k) float32, indices (T, k) int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = w[:, :k].clamp(min=0.0)
    total = w[:, 0]
    for j in range(1, k):
        total = total + w[:, j]
    return w / total.clamp(min=1e-9)[:, None], idx[:, :k].to(torch.int32)


def moe_gating(logits: torch.Tensor, k: int):
    """logits (T, E) float32 -> (weights (T, k) float32, indices (T, k)
    int32). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    global launches
    if logits.ndim != 2:
        raise ValueError(f"moe_gating: logits must be (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= E:
        raise ValueError(f"moe_gating: need 1 <= k <= E <= {MAX_EXPERTS}, got k={k}, E={E}")
    if logits.device.type == "cpu":
        return moe_gating_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_gating takes float32 logits, got {logits.dtype}")
    logits = logits.contiguous()
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, idx
    rc = _build.library().repro_moe_gating(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                                           T, E, k, _build.stream_handle(logits.device))
    _build.check(rc, "moe_gating")
    launches += 1
    return w, idx
