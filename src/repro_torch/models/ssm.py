"""Mamba1 blocks in PyTorch (counterpart of `repro.models.ssm`, its Mamba1
half; Mamba2/SSD waits for zamba2, ROADMAP.md Queue 1).

Plain functions on tensors and a dict of parameters with the JAX package's
names and shapes: in_proj (d, 2 di), conv_w (K, di), conv_b (di), x_proj
(di, r + 2N), dt_proj (r, di), dt_bias (di), A_log (di, N), D (di),
out_proj (di, d). Caches as the JAX package keeps them: the conv window
(B, K-1, di) of raw pre-conv inputs in the model dtype, the scan state
(B, di, N) in float32.

The selective scan of chunked prefill, whole-prompt prefill and verify
runs kernel K7 (`kernels.ssm_scan`), which also takes a carried state and
writes the per-position states a verify round rolls back to. The one-token
decode step stays plain tensor ops in the JAX op order: it forms dt * x in
the model dtype before the float32 cast, where the scan casts first, so in
bfloat16 the two round differently and routing decode through K7 would
change the result.

The causal depthwise conv is an explicit sum of K shifted products in
float32, not `F.conv1d`: cuDNN would run a float32 conv in TF32 by default,
and the sum should not depend on the library. The decode step's conv sums
the same products in the same order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssm_scan as _k7

from .config import ModelConfig


def causal_depthwise_conv(x, w, b):
    """x (B, S, C); w (K, C); b (C) -> (B, S, C): out[t] = sum_k
    x[t - K + 1 + k] * w[k] + b over a zero history."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)).float()
    wf = w.float()
    acc = xp[:, 0:S] * wf[0]
    for k in range(1, K):
        acc = acc + xp[:, k:k + S] * wf[k]
    return acc.to(x.dtype) + b


def conv_step(conv_state, x_t, w, b):
    """One decode step of the causal conv. conv_state (B, K-1, C) raw
    inputs; x_t (B, C). Returns (new window (B, K-1, C), y (B, C))."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)      # (B, K, C)
    wf = w.float()
    acc = window[:, 0].float() * wf[0]
    for k in range(1, w.shape[0]):
        acc = acc + window[:, k].float() * wf[k]
    return window[:, 1:], acc.to(x_t.dtype) + b


def mamba1_init(cfg: ModelConfig, generator: torch.Generator, device, dtype) -> dict:
    """Random Mamba1 parameters with the distributions of the JAX
    `mamba1_init`, drawn in float32 on `device` and cast to `dtype`: normal
    * 0.02 projections (dt_proj * r^-1/2, out_proj / sqrt(2L)), a zero conv
    bias, dt_bias the inverse softplus of a log-uniform draw in [1e-3,
    1e-1], A_log = log(1..N) per channel, D ones."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r, K = cfg.resolved_dt_rank, cfg.ssm_conv
    f32 = torch.float32

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device, dtype=f32).mul_(std)

    u = torch.rand((di,), generator=generator, device=device, dtype=f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p = {
        "in_proj": normal((d, 2 * di), 0.02),
        "conv_w": normal((K, di), 0.02),
        "conv_b": torch.zeros((di,), device=device, dtype=f32),
        "x_proj": normal((di, r + 2 * N), 0.02),
        "dt_proj": normal((r, di), r ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "A_log": torch.log(torch.arange(1, N + 1, device=device, dtype=f32)).expand(di, N),
        "D": torch.ones((di,), device=device, dtype=f32),
        "out_proj": normal((di, d), 0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    return {k: v.to(dtype).contiguous() for k, v in p.items()}


def _mamba1_ssm_inputs(cfg: ModelConfig, p, x):
    """x (B, S, d) -> (x_in, z), each (B, S, di)."""
    xz = x @ p["in_proj"]
    return xz[..., :cfg.d_inner], xz[..., cfg.d_inner:]


def _mamba1_scan_params(cfg: ModelConfig, p, x_conv):
    """dt (B, S, di) in the model dtype, A (di, N) float32, and B, C
    (B, S, N) contiguous, as K7 takes them."""
    N, r = cfg.ssm_state, cfg.resolved_dt_rank
    proj = x_conv @ p["x_proj"]
    dt_raw, B_mat, C_mat = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return dt, A, B_mat.contiguous(), C_mat.contiguous()


def mamba1_scan(x, dt, A, B_mat, C_mat, D, h0=None):
    """The selective scan (JAX `mamba1_scan_ref`) through kernel K7, from
    h0 (B, di, N) float32 or zeros. Returns (y (B, S, di) in x's dtype,
    h_final (B, di, N) float32)."""
    return _k7.ssm_scan(x, dt, A, B_mat, C_mat, D, h0)


def mamba1_scan_states(x, dt, A, B_mat, C_mat, D, h0=None, states=None):
    """`mamba1_scan` that also returns the state after every position
    (JAX `mamba1_scan_states`), written by K7 into `states` (a (B, S, di,
    N) float32 buffer, allocated when None). Returns (y, states); states[:,
    j] is the final state of a scan over the first j + 1 positions, the same
    arithmetic."""
    if states is None:
        Bsz, S, di = x.shape
        states = torch.empty((Bsz, S, di, A.shape[-1]), dtype=torch.float32,
                             device=x.device)
    y, _ = _k7.ssm_scan(x, dt, A, B_mat, C_mat, D, h0, states)
    return y, states


def _out(p, y, z):
    return (y * F.silu(z)) @ p["out_proj"]


def mamba1_decode(cfg: ModelConfig, p, x_t, *, conv_state, ssm_state):
    """x_t (B, 1, d); conv_state (B, K-1, di); ssm_state (B, di, N) float32.
    Returns (out (B, 1, d), conv_state, ssm_state), new tensors."""
    x_in, z = _mamba1_ssm_inputs(cfg, p, x_t)
    conv_state, xc = conv_step(conv_state, x_in[:, 0], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)[:, None, :]
    dt, A, B_mat, C_mat = _mamba1_scan_params(cfg, p, xc)
    da = torch.exp(dt[:, 0, :, None].float() * A)
    ssm_state = da * ssm_state + (dt[:, 0] * xc[:, 0])[..., None].float() \
        * B_mat[:, 0, None, :].float()
    y = (ssm_state * C_mat[:, 0, None, :].float()).sum(-1)
    y = (y + xc[:, 0].float() * p["D"]).to(x_t.dtype)[:, None, :]
    return _out(p, y, z), conv_state, ssm_state


def _chunk_inputs(cfg: ModelConfig, p, x, conv_state):
    """The carried conv window prepended to the chunk's raw inputs, so the
    causal conv sees the true history. Returns (x_cat (B, K-1+C, di), xc,
    z, dt, A, B, C)."""
    K = p["conv_w"].shape[0]
    x_in, z = _mamba1_ssm_inputs(cfg, p, x)
    x_cat = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    xc = F.silu(causal_depthwise_conv(x_cat, p["conv_w"], p["conv_b"])[:, K - 1:])
    return (x_cat, xc, z) + _mamba1_scan_params(cfg, p, xc)


def mamba1_chunk(cfg: ModelConfig, p, x, *, conv_state, ssm_state, length=None):
    """Advance conv and scan state through a C-token chunk (chunked
    prefill). x (B, C, d); `length` the true token count of a right-padded
    chunk: dt = 0 past it freezes the scan state, and the conv tail is cut
    at the real boundary. Returns (out, conv_state, ssm_state)."""
    K = p["conv_w"].shape[0]
    x_cat, xc, z, dt, A, B_mat, C_mat = _chunk_inputs(cfg, p, x, conv_state)
    if length is not None:
        dt = dt * (torch.arange(x.shape[1], device=x.device) < length)[None, :, None]
    y, h = mamba1_scan(xc, dt, A, B_mat, C_mat, p["D"], h0=ssm_state)
    tail = x_cat[:, -(K - 1):] if length is None else x_cat[:, length:length + K - 1]
    return _out(p, y, z), tail, h


def mamba1_chunk_states(cfg: ModelConfig, p, x, *, conv_state, ssm_state, states=None):
    """`mamba1_chunk` for speculative verification: every position's
    output and state. Returns (out (B, C, d), x_cat (B, K-1+C, di), h_all
    (B, C, di, N)); after keeping j tokens the conv window is x_cat[:,
    j:j+K-1] and the scan state h_all[:, j-1]."""
    x_cat, xc, z, dt, A, B_mat, C_mat = _chunk_inputs(cfg, p, x, conv_state)
    y, hs = mamba1_scan_states(xc, dt, A, B_mat, C_mat, p["D"], h0=ssm_state,
                               states=states)
    return _out(p, y, z), x_cat, hs
