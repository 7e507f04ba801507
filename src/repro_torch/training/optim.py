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

On a (data, model) mesh (`make_optimizer(cfg, mesh)`, `mesh` a
`distributed.sharding.MeshRank`) each rank updates its shards with the
global arithmetic that GSPMD gives the JAX step. The state is that of the
global parameters cut by `opt_state_specs` (`shard_opt_state`). AdamW is
elementwise. `global_norm` sums each leaf's squares over the axes that
shard it, a leaf replicated over an axis once. Adafactor's row and column
means sum over the sharded dim with an all-reduce, its factored
statistics are whole on every rank (their specs replicate) and its update
RMS sums over the leaf's shards. 8-bit Adam quantises blocks of q_block
along the last dim as the unsharded array does: where a shard's width is
a multiple of q_block its blocks are the global ones, and elsewhere the
rank quantises on the leaf gathered along that dim. These sums run in
another order than one device's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.distributed.sharding import global_shape, shard_opt_state
from repro_torch.launch.mesh import axis_size
from repro_torch.tree import at, leaves, map_leaves


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


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum over JAX leaves (`jax.tree.leaves` order) of each
    leaf's sum of squares in float32. On a mesh (`tree` the rank's shards
    of the parameters' structure) the leaves' sums are grouped by the axes
    that shard them, and each group is summed over those axes: a leaf
    replicated over an axis counts once."""
    total = 0
    if mesh is None:
        for _, group, _ in leaves(tree):
            leaf = 0
            for g in group:
                leaf = leaf + torch.sum(torch.square(g.float()))
            total = total + leaf
        return torch.sqrt(total)
    sums, groups = [], {}
    for (_, group, _), (_, specs, _) in zip(leaves(tree), leaves(mesh.specs)):
        leaf = 0
        for g in group:
            leaf = leaf + torch.sum(torch.square(g.float()))
        axes = tuple(sorted({a for e in specs[0] if e is not None
                             for a in ((e,) if isinstance(e, str) else e)}))
        groups.setdefault(axes, []).append(len(sums))
        sums.append(leaf)
    # one all-reduce per set of axes, then the leaves added in leaf order:
    # one card's order, so a mesh of one rank gives its norm bit for bit
    for axes, idx in groups.items():
        summed = mesh.leaf_sum(torch.stack([sums[i] for i in idx]), axes)
        for j, i in enumerate(idx):
            sums[i] = summed[j]
    for leaf in sums:
        total = total + leaf
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, mesh=None):
    """(the gradients in float32 scaled by min(1, max_norm / max(norm,
    1e-9)), the norm); on a mesh the global norm of the shards."""
    norm = global_norm(grads, mesh)
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


def _spec(mesh, path, ndim) -> tuple:
    """The mesh spec of a JAX leaf (stacked layers' leading None included),
    padded with None to `ndim` entries."""
    sp = mesh.leaf_specs().get(path, ())
    return tuple(sp) + (None,) * (ndim - len(sp))


def _size(mesh, entry) -> int:
    return 1 if entry is None else axis_size(mesh.mesh, entry)


def _adafactor_mesh(cfg, mesh, path, f, p, g, decay):
    """One Adafactor leaf on a mesh: (delta, new state leaf). The row and
    column means sum over their sharded dims and are gathered whole (the
    factored statistics replicate); the update RMS sums over every shard."""
    sp = _spec(mesh, path, p.ndim)
    row_sh, col_sh = mesh.sharding(path, sp[:-1]), mesh.sharding(path, sp[:-2] + sp[-1:])
    g2 = torch.square(g) + 1e-30
    if p.ndim >= 2:
        row = mesh.leaf_sum(g2.sum(dim=-1), sp[-1:]) / (p.shape[-1] * _size(mesh, sp[-1]))
        col = mesh.leaf_sum(g2.sum(dim=-2), sp[-2:-1]) / (p.shape[-2] * _size(mesh, sp[-2]))
        vr = decay * f["vr"] + (1 - decay) * row_sh.whole(row)
        vc = decay * f["vc"] + (1 - decay) * col_sh.whole(col)
        vr_mean = vr.mean(dim=-1, keepdim=True)
        denom = torch.sqrt(row_sh.local(vr)[..., None] * col_sh.local(vc)[..., None, :]
                           / torch.clamp(mesh.sharding(path, sp[:-2] + (None,)).local(
                               vr_mean)[..., None], min=1e-30))
        new = {"vr": vr, "vc": vc}
    else:
        v = decay * f["v"] + (1 - decay) * g2
        denom = torch.sqrt(v)
        new = {"v": v}
    delta = g / torch.clamp(denom, min=1e-12)
    n = math.prod(global_shape(delta.shape, sp, mesh.mesh))
    rms = torch.sqrt(mesh.leaf_sum(torch.sum(torch.square(delta)), sp) / n)
    return delta / torch.clamp(rms, min=1.0), new


def adafactor_update(cfg: OptConfig, grads, state, params, mesh=None):
    step, lr = _step_scalars(cfg, state)
    decay = 1.0 - (step.float() + 1.0) ** -0.8
    new_f = {}

    def upd(path, p, g):
        f = state["f"][path]
        g = g.float()
        if mesh is not None:
            delta, new_f[path] = _adafactor_mesh(cfg, mesh, path, f, p, g, decay)
            if p.ndim >= 2:
                delta = delta + cfg.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)
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


def adam8bit_update(cfg: OptConfig, grads, state, params, mesh=None):
    step, lr = _step_scalars(cfg, state)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(_f32(b1, step.device), step.float())
    c2 = 1 - torch.pow(_f32(b2, step.device), step.float())
    new_q = {}

    def upd(path, p, g):
        q = state["q"][path]
        if mesh is not None and "mq" in q:
            sp = _spec(mesh, path, p.ndim)
            if sp[-1] is not None and p.shape[-1] % cfg.q_block:
                # the shard's blocks are not the global ones: quantise on the
                # leaf gathered along its last dim, and keep the shard
                last = mesh.sharding(path, (None,) * (p.ndim - 1) + sp[-1:])
                q = {k: last.whole(t) if k in ("mq", "vq") else t for k, t in q.items()}
                new = step_leaf(path, q, last.whole(p), last.whole(g))
                new_q[path] = {k: last.local(t) if k in ("mq", "vq") else t
                               for k, t in new_q[path].items()}
                return last.local(new)
        return step_leaf(path, q, p, g)

    def step_leaf(path, q, p, g):
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


def make_optimizer(cfg: OptConfig, mesh=None):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state)); update writes the new values into `params` in place and
    returns them. On a mesh (`mesh`, a `MeshRank`; `params` the rank's
    shards) init makes the state of the global parameters, cut into the
    rank's shards (`shard_opt_state`), and update runs the global
    arithmetic on them (the module docstring)."""
    if cfg.name == "adamw":
        init, update = adamw_init, partial(adamw_update, cfg)
    elif cfg.name == "adafactor":
        init, update = adafactor_init, partial(adafactor_update, cfg, mesh=mesh)
    elif cfg.name == "adam8bit":
        init, update = (partial(adam8bit_init, q_block=cfg.q_block),
                        partial(adam8bit_update, cfg, mesh=mesh))
    else:
        raise ValueError(cfg.name)
    if mesh is None:
        return init, update

    def init_shards(params):
        shapes = map_leaves(lambda keys, index, t: torch.empty(
            global_shape(t.shape, at(mesh.specs, keys, index), mesh.mesh), dtype=t.dtype,
            device="meta"), params)
        dev = leaves(params)[0][1][0].device
        return shard_opt_state(mesh.cfg, init(shapes), mesh.specs, mesh.mesh, device=dev)
    return init_shards, update
