"""Optimizers in PyTorch: AdamW, Adafactor, 8-bit Adam (counterpart of
`repro.training.optim`), as plain functions on dicts of tensors.

Each rule works per JAX leaf (`tree.leaves`): the JAX package applies its
math to the stacked layer tensor, and several rules read that tensor as a
whole -- weight decay applies where the stacked leaf has ndim >= 2 (every
stacked norm scale and bias among them), Adafactor factors a stacked (L, d)
norm into vr (L,) and one vc (d,) shared across the layers and takes its
update-clipping RMS over the whole stack, and 8-bit Adam's float32
exemption counts the stacked size. So an update stacks the group, applies
the JAX math to the stacked tensor and writes the slices back into the
parameters, in place. The state is kept in the JAX leaf's shape, keyed by
its `keystr` path: AdamW {"m": {path: t}, "v": {path: t}, "step"},
Adafactor {"f": {path: {"vr", "vc"} or {"v"}}, "step"}, 8-bit Adam {"q":
{path: {"mq", "ms", "vq", "vs"} or {"m", "v"}}, "step"}; "step" a 0-d
int32 tensor. `torch.optim.AdamW` is not used: it orders the arithmetic
otherwise and decays every tensor.

Scalars are float32 tensors formed as the JAX code forms them (lr,
b1 ** step), so the two packages round alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.tree import leaves


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor | adam8bit
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    q_block: int = 128             # adam8bit quantization block


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: OptConfig, step):
    """Linear warmup: lr * min(1, (step + 1) / warmup_steps), float32. The
    updates pass the already-incremented step, as the JAX package does."""
    warm = torch.clamp((step.float() + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over JAX leaves (`jax.tree.leaves` order) of each
    leaf's sum of squares in float32."""
    total = 0
    for _, group, _ in leaves(tree):
        leaf = 0
        for g in group:
            leaf = leaf + torch.sum(torch.square(g.float()))
        total = total + leaf
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    """(the gradients in float32 scaled by min(1, max_norm / max(norm,
    1e-9)), the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(t):
        if isinstance(t, dict):
            return {k: clip(v) for k, v in t.items()}
        if isinstance(t, list):
            return [clip(v) for v in t]
        return t.float() * scale
    return clip(grads), norm


# ------------------------------------------------------------ quant utils --


def _q8(x, block: int):
    """Blockwise int8 quantization along the last axis (the tensor keeps
    its shape): (q int8, scale (..., nb) float32); round half to even."""
    shape = x.shape
    xf = x.reshape(shape[:-1] + (shape[-1] // block, block))
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q.reshape(shape), scale[..., 0].float()


def _dq8(q, scale, block: int):
    shape = q.shape
    qf = q.reshape(shape[:-1] + (-1, block)).float()
    return (qf * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------- leaves --


def _stacked(group, stacked: bool) -> torch.Tensor:
    return torch.stack(group) if stacked else group[0]


def _shape(group, stacked: bool) -> tuple:
    return ((len(group),) if stacked else ()) + tuple(group[0].shape)


def _write(group, stacked: bool, new) -> None:
    """The updated JAX leaf back into the port's parameters, in place."""
    if stacked:
        for i, t in enumerate(group):
            t.copy_(new[i])
    else:
        group[0].copy_(new)


def _update_leaves(params, grads, fn):
    """fn(path, p, g) -> new p on every JAX leaf (p and g stacked), written
    back into `params` in place."""
    for (path, group, stacked), (_, ggroup, _) in zip(leaves(params), leaves(grads)):
        p = _stacked([t.detach() for t in group], stacked)
        new = fn(path, p, _stacked(ggroup, stacked))
        with torch.no_grad():
            _write(group, stacked, new)
    return params


def _step_scalars(cfg: OptConfig, state):
    step = state["step"] + 1
    return step, lr_schedule(cfg, step)


def _zeros(shape, like, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _step0(params) -> torch.Tensor:
    """The state's step counter: a 0-d int32 zero on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0][1][0].device)


# -------------------------------------------------------------- adamw ------


def adamw_init(params):
    m = {path: _zeros(_shape(g, s), g[0]) for path, g, s in leaves(params)}
    v = {path: torch.zeros_like(t) for path, t in m.items()}
    return {"m": m, "v": v, "step": _step0(params)}


def adamw_update(cfg: OptConfig, grads, state, params):
    step, lr = _step_scalars(cfg, state)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(_f32(b1, step.device), step.float())
    c2 = 1 - torch.pow(_f32(b2, step.device), step.float())
    new_m, new_v = {}, {}

    def upd(path, p, g):
        g = g.float()
        m = b1 * state["m"][path] + (1 - b1) * g
        v = b2 * state["v"][path] + (1 - b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_m[path], new_v[path] = m, v
        return (p.float() - lr * delta).to(p.dtype)
    params = _update_leaves(params, grads, upd)
    return params, {"m": new_m, "v": new_v, "step": step}


# ------------------------------------------------------------ adafactor ----


def adafactor_init(params):
    def z(group, stacked):
        shape = _shape(group, stacked)
        if len(shape) >= 2:
            return {"vr": _zeros(shape[:-1], group[0]),
                    "vc": _zeros(shape[:-2] + shape[-1:], group[0])}
        return {"v": _zeros(shape, group[0])}
    return {"f": {path: z(g, s) for path, g, s in leaves(params)}, "step": _step0(params)}


def adafactor_update(cfg: OptConfig, grads, state, params):
    step, lr = _step_scalars(cfg, state)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    new_f = {}

    def upd(path, p, g):
        f = state["f"][path]
        g = g.float()
        g2 = torch.square(g) + 1e-30
        if p.ndim >= 2:
            vr = decay * f["vr"] + (1 - decay) * g2.mean(dim=-1)
            vc = decay * f["vc"] + (1 - decay) * g2.mean(dim=-2)
            denom = torch.sqrt(vr[..., None] * vc[..., None, :] / torch.clamp(
                vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30))
            new_f[path] = {"vr": vr, "vc": vc}
        else:
            v = decay * f["v"] + (1 - decay) * g2
            denom = torch.sqrt(v)
            new_f[path] = {"v": v}
        delta = g / torch.clamp(denom, min=1e-12)
        # relative step-size clipping (Adafactor's update clipping)
        rms = torch.sqrt(torch.mean(torch.square(delta)))
        delta = delta / torch.clamp(rms, min=1.0)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)
    params = _update_leaves(params, grads, upd)
    return params, {"f": new_f, "step": step}


# ------------------------------------------------------------- adam8bit ----


def adam8bit_init(params, q_block=256):
    def z(group, stacked):
        shape = _shape(group, stacked)
        if len(shape) == 0 or shape[-1] % q_block or math.prod(shape) < 4 * q_block:
            # small / ragged tensors keep fp32 moments (negligible memory)
            return {"m": _zeros(shape, group[0]), "v": _zeros(shape, group[0])}
        scales = shape[:-1] + (shape[-1] // q_block,)
        return {"mq": _zeros(shape, group[0], torch.int8), "ms": _zeros(scales, group[0]),
                "vq": _zeros(shape, group[0], torch.int8), "vs": _zeros(scales, group[0])}
    return {"q": {path: z(g, s) for path, g, s in leaves(params)}, "step": _step0(params)}


def adam8bit_update(cfg: OptConfig, grads, state, params):
    step, lr = _step_scalars(cfg, state)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(_f32(b1, step.device), step.float())
    c2 = 1 - torch.pow(_f32(b2, step.device), step.float())
    new_q = {}

    def upd(path, p, g):
        q = state["q"][path]
        g = g.float()
        if "mq" in q:
            m = _dq8(q["mq"], q["ms"], cfg.q_block)
            v = _dq8(q["vq"], q["vs"], cfg.q_block)
        else:
            m, v = q["m"], q["v"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(torch.clamp(v / c2, min=0.0)) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        if "mq" in q:
            mq, ms = _q8(m, cfg.q_block)
            vq, vs = _q8(v, cfg.q_block)
            new_q[path] = {"mq": mq, "ms": ms, "vq": vq, "vs": vs}
        else:
            new_q[path] = {"m": m, "v": v}
        return (p.float() - lr * delta).to(p.dtype)
    params = _update_leaves(params, grads, upd)
    return params, {"q": new_q, "step": step}


# ------------------------------------------------------------- registry ----


def make_optimizer(cfg: OptConfig):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state)); update writes the new values into `params` in place and
    returns them."""
    if cfg.name == "adamw":
        return adamw_init, partial(adamw_update, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, partial(adafactor_update, cfg)
    if cfg.name == "adam8bit":
        return partial(adam8bit_init, q_block=cfg.q_block), partial(adam8bit_update, cfg)
    raise ValueError(cfg.name)
