"""K7: the Mamba1 selective scan (falcon-mamba-7b's recurrence).

Replaces `repro.kernels.ssm_scan.ssm_scan_pallas` (src/repro/kernels/
ssm_scan.py:55). CUDA source: `csrc/ssm_scan.cu`. It computes what
`repro.models.ssm.mamba1_scan_ref` computes, from an optional initial
state `h0` (the Pallas kernel asserts h0 is None; chunked prefill and
prefix hits resume from a carried state), and on request writes the state
after every position into a caller-given (B, S, di, N) float32 buffer --
`mamba1_scan_states`' output, the checkpoints a verify round rolls back
to. One kernel computes the states and the final state, so they are the
same arithmetic.

Bound on the H100: the exponentials (B S di N of them) on the SFU, or the
bytes of x, dt and y in the model dtype plus the fp32 h0, final state and
states, whichever is longer: at a 128-token chunk of falcon-mamba-7b the
SFU (~4 us against ~2 us of bytes), at a verify round's launch (B = 4,
S = 5, states written) the bytes (~4.8 us). Design (`csrc/ssm_scan.cu`):
a thread holds one channel and R of its N states, strided (n = l + L j
for lane l of the channel's L = N / R lanes), so a warp step updates 32 R
states, and walks `group` time steps at once (their exponentials first);
y's sum over n adds the same operands in the same tree as a
one-state-a-thread butterfly (levels N/2 .. L inside the thread, L/2 .. 1
by warp shuffles), so the outputs do not move by one ulp with R or the
group; x and dt tiles are double-buffered by cp.async, B and C staged
permuted in fp32. Issue slots, not the SFU, bound it: ~20 instructions
an update, with ~8 warps an SM at a B = 1 chunk.
There is no chunked parallel scan: it would round the state differently
from the plain decode step and the verify checkpoints. `scan_plan` is
the launch plan.

`ssm_scan` runs the kernel on CUDA tensors and `ssm_scan_plain` on CPU
tensors; `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import PLAIN_DEVICES

from . import _build

launches = 0

THREADS = 128      # threads a block (csrc/ssm_scan.cu: kScanThreads)
TILE = 32          # time steps a staged tile (kScanTile)
R_CHOICES = (2, 4)      # states a thread the kernel is built for (N >= R)
GROUP_CHOICES = (1, 8)  # time steps a thread walks together, built for both
STATES_PER_THREAD = 4   # the R `scan_plan` takes where N allows


class ScanPlan(NamedTuple):
    r: int             # states a thread
    group: int         # time steps walked together
    lanes: int         # threads a channel, N // r
    channels: int      # channels a block, THREADS // lanes
    grid: tuple        # (channel blocks, batch rows)
    tile: int          # time steps a staged tile


def plan_for(r: int, group: int, B: int, S: int, di: int, N: int) -> ScanPlan:
    """The launch of K7 with r states a thread and `group` steps walked
    together: r is 2 or 4 and at most N, or 1 at N = 1; group is 1 or 8; N
    is a power of two <= 32."""
    if not 1 <= N <= 32 or N & (N - 1):
        raise ValueError(f"ssm_scan: state size N={N} must be a power of two <= 32")
    if r not in (1, *R_CHOICES) or r > N or (r == 1) != (N == 1):
        raise ValueError(f"ssm_scan: {r} states a thread at N={N}")
    if group not in GROUP_CHOICES:
        raise ValueError(f"ssm_scan: {group} steps walked together")
    lanes = N // r
    channels = THREADS // lanes
    return ScanPlan(r, group, lanes, channels, (-(-di // channels), B), min(TILE, max(S, 1)))


def scan_plan(B: int, S: int, di: int, N: int) -> ScanPlan:
    """K7's launch for x (B, S, di) and state size N: STATES_PER_THREAD
    states a thread (N where N is smaller); 8 steps walked together when a
    tile is full (S >= TILE: more independent work for the few warps a
    B = 1 chunk has), else 1 (fewer registers, more blocks resident for the
    many short rows of a verify round)."""
    return plan_for(min(STATES_PER_THREAD, N), 8 if S >= TILE else 1, B, S, di, N)


def ssm_scan_plain(x, dt, A, B_mat, C_mat, D, h0=None, states=None):
    """Plain PyTorch version: the JAX recurrence step by step in fp32
    (`mamba1_scan_ref`). x, dt (B, S, di); A (di, N) float32; B_mat, C_mat
    (B, S, N); D (di); h0 (B, di, N) float32 or None (zeros); states an
    optional (B, S, di, N) float32 buffer that receives the state after
    every position. Returns (y (B, S, di) in x's dtype, h (B, di, N)
    float32)."""
    Bsz, S, di = x.shape
    N = A.shape[-1]
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B_mat.float(), C_mat.float()
    if x.device.type == "meta":
        # meta tensors (the dry run) hold no values to recur over: one
        # step's ops stand for the S steps', on the same inputs and with the
        # loop's shapes and dependences, without S rounds of Python calls
        h = torch.exp(dtf[:, 0, :, None] * A) * h + \
            (dtf[:, 0] * xf[:, 0])[..., None] * Bf[:, 0, None, :]
        ys = Cf.sum(-1)[:, :, None] * h.sum(-1)[:, None, :]
        if states is not None:
            states.copy_(h[:, None].expand_as(states))
        return (ys + xf * D.float()).to(x.dtype), h
    ys = torch.empty((Bsz, S, di), dtype=torch.float32, device=x.device)
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * A)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)
        if states is not None:
            states[:, t] = h
    y = ys + xf * D.float()
    return y.to(x.dtype), h


def _check(x, dt, A, B_mat, C_mat, D, h0, states):
    if x.ndim != 3:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, want (B, S, di)")
    Bsz, S, di = x.shape
    if A.ndim != 2 or A.shape[0] != di:
        raise ValueError(f"ssm_scan: A {tuple(A.shape)}, want ({di}, N)")
    N = A.shape[1]
    shapes = {"dt": (dt, (Bsz, S, di)), "B_mat": (B_mat, (Bsz, S, N)),
              "C_mat": (C_mat, (Bsz, S, N)), "D": (D, (di,))}
    if h0 is not None:
        shapes["h0"] = (h0, (Bsz, di, N))
    if states is not None:
        shapes["states"] = (states, (Bsz, S, di, N))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssm_scan: {name} {tuple(t.shape)}, want {want}")
    for name, t in (("A", A), ("h0", h0), ("states", states)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} must be float32, got {t.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssm_scan: x dtype {x.dtype}")
    for name, t in (("dt", dt), ("B_mat", B_mat), ("C_mat", C_mat), ("D", D)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}, x is {x.dtype}")
    return Bsz, S, di, N


def ssm_scan(x, dt, A, B_mat, C_mat, D, h0=None, states=None):
    """Shapes and result as `ssm_scan_plain`; x, dt, B_mat, C_mat and D
    share one dtype (float32 or bfloat16). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. On the card N must be
    a power of two <= 32 and every tensor contiguous."""
    Bsz, S, di, N = _check(x, dt, A, B_mat, C_mat, D, h0, states)
    if x.device.type in PLAIN_DEVICES:
        return ssm_scan_plain(x, dt, A, B_mat, C_mat, D, h0, states)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: device {x.device}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B_mat", B_mat), ("C_mat", C_mat),
                    ("D", D), ("h0", h0), ("states", states)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")
    plan = scan_plan(Bsz, S, di, N)
    y = torch.empty_like(x)
    h = torch.empty((Bsz, di, N), dtype=torch.float32, device=x.device)
    if Bsz == 0:
        return y, h
    _launch(plan, x, dt, A, B_mat, C_mat, D, h0, y, h, states)
    return y, h


def _launch(plan: ScanPlan, x, dt, A, B_mat, C_mat, D, h0, y, h, states) -> None:
    """Run the kernel with `plan` on checked CUDA tensors into y and h (and
    states); `ssm_scan` passes `scan_plan`'s."""
    global launches
    Bsz, S, di = x.shape
    rc = _build.library().repro_ssm_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        None if states is None else states.data_ptr(), Bsz, S, di, A.shape[1], plan.r,
        plan.group, _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
        _build.stream_handle(x.device))
    _build.check(rc, "ssm_scan")
    launches += 1
