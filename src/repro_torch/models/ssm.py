"""Mamba1 and Mamba2 blocks in PyTorch (counterpart of `repro.models.ssm`).

Plain functions on tensors and a dict of parameters with the JAX package's
names and shapes. Mamba1: in_proj (d, 2 di), conv_w (K, di), conv_b (di),
x_proj (di, r + 2N), dt_proj (r, di), dt_bias (di), A_log (di, N), D (di),
out_proj (di, d). Caches as the JAX package keeps them: the conv window
(B, K-1, di) of raw pre-conv inputs in the model dtype, the scan state
(B, di, N) in float32.

Mamba2 (zamba2's trunk; `mamba2_*`): in_proj (d, 2 di + 2N + h) giving z,
the conv input xBC (di + 2N: x, then one group's B and C) and dt (h),
conv_w (K, di + 2N), conv_b, dt_bias (h), A_log (h), D (h), norm_w (di),
out_proj (di, d); h = di / p heads of p channels share one scalar decay a
step. Caches: the conv window (B, K-1, di + 2N) in the model dtype and
the state (B, h, p, N) in float32. Chunked and whole-prompt prefill run
the SSD matrix form (`mamba2_ssd`, the JAX `mamba2_ssd_ref`); the decode
step and the verify forward step the recurrence one position at a time
with the same step function (`_mamba2_step`), so a verify checkpoint is
bit for bit the state sequential decode reaches, as in the JAX package.
All of Mamba2 is plain tensor ops: the JAX package has no TPU kernel for
it, so there is none to port.

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

from repro_torch.kernels import autograd as _kag
from repro_torch.kernels import ssm_scan as _k7

from .config import ModelConfig
from .layers import rms_norm


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
    """x (B, S, d) -> (x_in, z), each (B, S, di). On a mesh in_proj holds
    the rank's channels of both halves side by side
    (`distributed.sharding.shard_params`), so the halves split evenly."""
    xz = x @ p["in_proj"]
    return xz.chunk(2, dim=-1)


def _mamba1_scan_params(cfg: ModelConfig, p, x_conv, tp=None):
    """dt (B, S, di) in the model dtype, A (di, N) float32, and B, C
    (B, S, N) contiguous, as K7 takes them. On a mesh (`tp`) x_conv holds
    the rank's channels and x_proj their rows, so the projection is summed
    over `model`; dt, A and the scan stay on the rank's channels."""
    N, r = cfg.ssm_state, cfg.resolved_dt_rank
    proj = x_conv @ p["x_proj"]
    if tp is not None and tp.on_model("mamba/x_proj", 0):
        # the sum's whole result feeds the rank's channels again: a
        # column-parallel region's entry with a gradient
        proj = tp.model_in(tp.model_sum(proj))
    dt_raw, B_mat, C_mat = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return dt, A, B_mat.contiguous(), C_mat.contiguous()


def mamba1_scan(x, dt, A, B_mat, C_mat, D, h0=None):
    """The selective scan (JAX `mamba1_scan_ref`) through kernel K7, from
    h0 (B, di, N) float32 or zeros. Returns (y (B, S, di) in x's dtype,
    h_final (B, di, N) float32), with a gradient for every input (K7's
    autograd form)."""
    return _kag.ssm_scan(x, dt, A, B_mat, C_mat, D, h0)


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


def _out(p, y, z, tp=None):
    out = (y * F.silu(z)) @ p["out_proj"]
    if tp is not None and tp.on_model("mamba/out_proj", 0):
        out = tp.model_sum(out)
    return out


def mamba1_apply(cfg: ModelConfig, p, x, tp=None):
    """A whole sequence through the Mamba1 block from a zero history, with
    a gradient (the JAX `mamba1_apply`, which training's `forward` runs):
    the causal conv, SiLU, the selective scan (`mamba1_scan`), the gate and
    the output projection. x (B, S, d) -> (B, S, d). On a mesh (`tp`) on
    the rank's channels, x entering the column-parallel in_proj through
    `MeshRank.model_in` where autograd records."""
    if tp is not None and torch.is_grad_enabled() and tp.on_model("mamba/out_proj", 0):
        x = tp.model_in(x)
    x_in, z = _mamba1_ssm_inputs(cfg, p, x)
    xc = F.silu(causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, A, B_mat, C_mat = _mamba1_scan_params(cfg, p, xc, tp)
    y, _ = mamba1_scan(xc, dt, A, B_mat, C_mat, p["D"])
    return _out(p, y, z, tp)


def mamba1_decode(cfg: ModelConfig, p, x_t, *, conv_state, ssm_state, tp=None):
    """x_t (B, 1, d); conv_state (B, K-1, di); ssm_state (B, di, N) float32.
    Returns (out (B, 1, d), conv_state, ssm_state), new tensors. On a mesh
    (`tp`) di is the rank's channels, as the state's."""
    x_in, z = _mamba1_ssm_inputs(cfg, p, x_t)
    conv_state, xc = conv_step(conv_state, x_in[:, 0], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)[:, None, :]
    dt, A, B_mat, C_mat = _mamba1_scan_params(cfg, p, xc, tp)
    da = torch.exp(dt[:, 0, :, None].float() * A)
    ssm_state = da * ssm_state + (dt[:, 0] * xc[:, 0])[..., None].float() \
        * B_mat[:, 0, None, :].float()
    y = (ssm_state * C_mat[:, 0, None, :].float()).sum(-1)
    y = (y + xc[:, 0].float() * p["D"]).to(x_t.dtype)[:, None, :]
    return _out(p, y, z, tp), conv_state, ssm_state


def _chunk_inputs(cfg: ModelConfig, p, x, conv_state, tp=None):
    """The carried conv window prepended to the chunk's raw inputs, so the
    causal conv sees the true history. Returns (x_cat (B, K-1+C, di), xc,
    z, dt, A, B, C)."""
    K = p["conv_w"].shape[0]
    x_in, z = _mamba1_ssm_inputs(cfg, p, x)
    x_cat = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    xc = F.silu(causal_depthwise_conv(x_cat, p["conv_w"], p["conv_b"])[:, K - 1:])
    return (x_cat, xc, z) + _mamba1_scan_params(cfg, p, xc, tp)


def mamba1_chunk(cfg: ModelConfig, p, x, *, conv_state, ssm_state, length=None, tp=None):
    """Advance conv and scan state through a C-token chunk (chunked
    prefill). x (B, C, d); `length` the true token count of a right-padded
    chunk: dt = 0 past it freezes the scan state, and the conv tail is cut
    at the real boundary. Returns (out, conv_state, ssm_state)."""
    K = p["conv_w"].shape[0]
    x_cat, xc, z, dt, A, B_mat, C_mat = _chunk_inputs(cfg, p, x, conv_state, tp)
    if length is not None:
        dt = dt * (torch.arange(x.shape[1], device=x.device) < length)[None, :, None]
    y, h = mamba1_scan(xc, dt, A, B_mat, C_mat, p["D"], h0=ssm_state)
    tail = x_cat[:, -(K - 1):] if length is None else x_cat[:, length:length + K - 1]
    return _out(p, y, z, tp), tail, h


def mamba1_chunk_states(cfg: ModelConfig, p, x, *, conv_state, ssm_state, states=None,
                        tp=None):
    """`mamba1_chunk` for speculative verification: every position's
    output and state. Returns (out (B, C, d), x_cat (B, K-1+C, di), h_all
    (B, C, di, N)); after keeping j tokens the conv window is x_cat[:,
    j:j+K-1] and the scan state h_all[:, j-1]."""
    x_cat, xc, z, dt, A, B_mat, C_mat = _chunk_inputs(cfg, p, x, conv_state, tp)
    y, hs = mamba1_scan_states(xc, dt, A, B_mat, C_mat, p["D"], h0=ssm_state,
                               states=states)
    return _out(p, y, z, tp), x_cat, hs


# ------------------------------------------------------------- mamba 2 -----


def mamba2_init(cfg: ModelConfig, generator: torch.Generator, device, dtype) -> dict:
    """Random Mamba2 parameters with the distributions of the JAX
    `mamba2_init`, drawn in float32 on `device` and cast to `dtype`: normal
    * 0.02 in_proj and conv_w (out_proj / sqrt(2L)), a zero conv bias,
    dt_bias the inverse softplus of a log-uniform draw in [1e-3, 1e-1] a
    head, A_log = log(1..h), D and norm_w ones."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, K = cfg.n_ssm_heads, cfg.ssm_conv
    f32 = torch.float32

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device, dtype=f32).mul_(std)

    u = torch.rand((h,), generator=generator, device=device, dtype=f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p = {
        "in_proj": normal((d, 2 * di + 2 * N + h), 0.02),
        "conv_w": normal((K, di + 2 * N), 0.02),
        "conv_b": torch.zeros((di + 2 * N,), device=device, dtype=f32),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "A_log": torch.log(torch.arange(1, h + 1, device=device, dtype=f32)),
        "D": torch.ones((h,), device=device, dtype=f32),
        "norm_w": torch.ones((di,), device=device, dtype=f32),
        "out_proj": normal((di, d), 0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    return {k: v.to(dtype).contiguous() for k, v in p.items()}


def _mamba2_proj(cfg: ModelConfig, p, x):
    """x (B, S, d) -> z (B, S, di), the raw conv input xBC (B, S, di + 2N)
    and dt_raw (B, S, h)."""
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]


def _mamba2_split(cfg: ModelConfig, xc):
    """The conv output (B, S, di + 2N) -> x (B, S, di), B and C (B, S, N)."""
    di, N = cfg.d_inner, cfg.ssm_state
    return xc[..., :di], xc[..., di:di + N], xc[..., di + N:]


def mamba2_ssd(x, dt, A, B_mat, C_mat, D, *, chunk: int, h0=None):
    """The SSD chunked scan in its matrix form (JAX `mamba2_ssd_ref`). x
    (B, S, h, p); dt (B, S, h); A (h,) float32; B_mat, C_mat (B, S, N) (one
    group); D (h,); h0 (B, h, p, N) or zeros. The sequence is cut into
    chunks of min(chunk, S), zero-padded at the end (dt = 0 there: decay 1,
    no input, so the state is kept). Within a chunk, y = (C B^T * decay *
    dt) x; across chunks the carried state. Returns (y (B, S, h, p) in x's
    dtype, h_final (B, h, p, N) float32)."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x, dt, B_mat, C_mat = (F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
                               for a in (x, dt, B_mat, C_mat))
    S_pad = S + pad
    nc = S_pad // c
    xr = x.reshape(Bsz, nc, c, H, P).float()
    dtr = dt.reshape(Bsz, nc, c, H).float()
    Br = B_mat.reshape(Bsz, nc, c, N).float()
    Cr = C_mat.reshape(Bsz, nc, c, N).float()

    Lc = torch.cumsum(dtr * A, dim=2)                          # (B, nc, c, h)
    # intra-chunk: M[t, j] = exp(L_t - L_j) (C_t . B_j) dt_j for j <= t
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]        # (B, nc, c, c, h)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bnce,bnje->bncj", Cr, Br)
    M = CB[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bncjh,bnjhp->bnchp", M, xr)

    # chunk summaries: S_n = sum_j exp(L_end - L_j) dt_j B_j x_j
    seg = torch.exp(Lc[:, :, -1:, :] - Lc)
    states = torch.einsum("bnch,bnce,bnchp->bnhpe", seg * dtr, Br, xr)
    chunk_decay = torch.exp(Lc[:, :, -1, :])                   # (B, nc, h)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    before = []
    for n in range(nc):
        before.append(h)
        h = chunk_decay[:, n, :, None, None] * h + states[:, n]
    h_before = torch.stack(before, dim=1)                      # (B, nc, h, p, N)

    # inter-chunk: y_t += C_t . (exp(L_t) h_in)
    y_inter = torch.einsum("bnce,bnch,bnhpe->bnchp", Cr, torch.exp(Lc), h_before)
    y = (y_intra + y_inter).reshape(Bsz, S_pad, H, P) + \
        xr.reshape(Bsz, S_pad, H, P) * D[:, None]
    return y[:, :S].to(x.dtype), h


def _mamba2_out(cfg: ModelConfig, p, y, z):
    """The gated norm and output projection: rms_norm(y silu(z)) out_proj."""
    return rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps) @ p["out_proj"]


def mamba2_apply(cfg: ModelConfig, p, x):
    """A whole sequence through the Mamba2 block from a zero history (the
    JAX `mamba2_apply`, which training's `forward` runs): the causal conv,
    SiLU, the SSD matrix form (`mamba2_ssd`, plain tensor ops), the gated
    norm and the output projection. x (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    z, xbc, dt_raw = _mamba2_proj(cfg, p, x)
    xbc = F.silu(causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"]))
    x_in, B_mat, C_mat = _mamba2_split(cfg, xbc)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = mamba2_ssd(x_in.reshape(B, S, cfg.n_ssm_heads, cfg.mamba_headdim), dt, A,
                      B_mat, C_mat, p["D"], chunk=cfg.ssm_chunk)
    return _mamba2_out(cfg, p, y.reshape(B, S, cfg.d_inner), z)


def _mamba2_chunk_inputs(cfg: ModelConfig, p, x, conv_state):
    """The carried conv window prepended to the chunk's raw conv inputs.
    Returns (x_cat (B, K-1+C, di+2N), z, x (B, C, h, p), B, C, dt (B, C, h)
    in the model dtype, A (h,) float32)."""
    K = p["conv_w"].shape[0]
    z, xbc_raw, dt_raw = _mamba2_proj(cfg, p, x)
    x_cat = torch.cat([conv_state.to(xbc_raw.dtype), xbc_raw], dim=1)
    xc = F.silu(causal_depthwise_conv(x_cat, p["conv_w"], p["conv_b"])[:, K - 1:])
    x_in, B_mat, C_mat = _mamba2_split(cfg, xc)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    Bsz, C = x.shape[:2]
    x_in = x_in.reshape(Bsz, C, cfg.n_ssm_heads, cfg.mamba_headdim)
    return x_cat, z, x_in, B_mat, C_mat, dt, A


def mamba2_chunk(cfg: ModelConfig, p, x, *, conv_state, ssm_state, length=None):
    """Advance conv and SSD state through a C-token chunk (chunked prefill,
    and the slab's whole prompt from a zero state). x (B, C, d); conv_state
    (B, K-1, di+2N); ssm_state (B, h, p, N) float32; `length` the true
    token count of a right-padded chunk: dt = 0 past it keeps the state,
    and the conv tail is cut at the real boundary. Returns (out (B, C, d),
    conv_state, ssm_state)."""
    K = p["conv_w"].shape[0]
    x_cat, z, x_in, B_mat, C_mat, dt, A = _mamba2_chunk_inputs(cfg, p, x, conv_state)
    C = x.shape[1]
    if length is not None:
        dt = dt * (torch.arange(C, device=x.device) < length)[None, :, None]
    y, h = mamba2_ssd(x_in, dt, A, B_mat, C_mat, p["D"], chunk=cfg.ssm_chunk, h0=ssm_state)
    tail = x_cat[:, -(K - 1):] if length is None else x_cat[:, length:length + K - 1]
    return _mamba2_out(cfg, p, y.reshape(x.shape[0], C, cfg.d_inner), z), tail, h


def _mamba2_step(h, x_t, dt_t, B_t, C_t, A):
    """One step of the recurrence, float32: h (B, h, p, N), x_t (B, h, p),
    dt_t (B, h), B_t, C_t (B, N). Returns (h, y_t (B, h, p)) without the D
    skip."""
    da = torch.exp(dt_t * A)
    h = da[..., None, None] * h + (dt_t[:, :, None] * x_t)[..., None] * B_t[:, None, None, :]
    return h, (h * C_t[:, None, None, :]).sum(-1)


def mamba2_scan_states(x, dt, A, B_mat, C_mat, D, h0=None, states=None):
    """The sequential Mamba2 recurrence with the state after every position
    (JAX `mamba2_scan_states`): the decode step's arithmetic
    (`_mamba2_step`), not the SSD form, so the checkpoints are the states
    sequential decode reaches. x (B, S, h, p); dt (B, S, h); A (h,); B, C
    (B, S, N); `states` a (B, S, h, p, N) float32 buffer to fill (allocated
    when None). Returns (y (B, S, h, p) in x's dtype, states)."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    if states is None:
        states = torch.empty((Bsz, S, H, P, N), dtype=torch.float32, device=x.device)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), B_mat.float(), C_mat.float()
    ys = []
    for t in range(S):
        h, y_t = _mamba2_step(h, xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t], A)
        states[:, t] = h
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + xf * D[:, None]
    return y.to(x.dtype), states


def mamba2_chunk_states(cfg: ModelConfig, p, x, *, conv_state, ssm_state, states=None):
    """`mamba2_chunk` for speculative verification, through the sequential
    recurrence: every position's output and state. Returns (out (B, C, d),
    x_cat (B, K-1+C, di+2N), h_all (B, C, h, p, N), written into `states`
    when given); after keeping j tokens the conv window is x_cat[:,
    j:j+K-1] and the state h_all[:, j-1]."""
    x_cat, z, x_in, B_mat, C_mat, dt, A = _mamba2_chunk_inputs(cfg, p, x, conv_state)
    y, hs = mamba2_scan_states(x_in, dt, A, B_mat, C_mat, p["D"], h0=ssm_state,
                               states=states)
    return _mamba2_out(cfg, p, y.reshape(x.shape[0], x.shape[1], cfg.d_inner), z), x_cat, hs


def mamba2_decode(cfg: ModelConfig, p, x_t, *, conv_state, ssm_state):
    """x_t (B, 1, d); conv_state (B, K-1, di+2N); ssm_state (B, h, p, N)
    float32. Returns (out (B, 1, d), conv_state, ssm_state), new tensors."""
    B = x_t.shape[0]
    z, xbc, dt_raw = _mamba2_proj(cfg, p, x_t)
    conv_state, xc = conv_step(conv_state, xbc[:, 0], p["conv_w"], p["conv_b"])
    x_in, B_mat, C_mat = _mamba2_split(cfg, F.silu(xc))
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"]).float()          # (B, h)
    A = -torch.exp(p["A_log"].float())
    xh = x_in.reshape(B, cfg.n_ssm_heads, cfg.mamba_headdim).float()
    ssm_state, y = _mamba2_step(ssm_state, xh, dt, B_mat.float(), C_mat.float(), A)
    y = (y + xh * p["D"][:, None]).reshape(B, 1, cfg.d_inner).to(x_t.dtype)
    return _mamba2_out(cfg, p, y, z), conv_state, ssm_state
