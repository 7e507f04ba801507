"""Sharding rules: FSDP+TP 2D parameter layout, activation/cache specs
(counterpart of `repro.distributed.sharding`).

Policy (DESIGN.md §4), as in the JAX package:
  - every large matrix: "feature" dim over `model` (TP), other big dim over
    `data` (FSDP / ZeRO-3); a layer all-gathers its FSDP shards before it
    runs and all-reduces its TP partials.
  - axes only apply when the dim is divisible by the axis size (GQA kv=8 on
    a 16-way model axis stays replicated; qk-norm scales etc. replicate).
  - batch over (pod, data); KV caches: batch over data, *sequence over
    model* (sequence-sharded decode, `distributed/decode.py`); SSM state:
    d_inner over model; the paged pool: pages replicated, heads over model.
  - optimizer state mirrors its parameter's spec (extra leading quant-block
    dims for adam8bit replicate).

A spec is a plain tuple with the entries of the JAX `PartitionSpec`: per
tensor dim an axis name, a tuple of names, or None. The port keeps each
layer stack as a list of per-layer dicts (`bridge.STACKS`), so a layer
leaf's spec is the JAX spec of the stacked leaf without its leading None;
the optimizer state keys stacked JAX leaves (`training.optim`), so its
specs keep it. `placements` turns a spec into DTensor placements, and
`local_shard` cuts a full tensor into one rank's shard; `shard_params` does
that for a whole parameter tree.

Where GSPMD inserts collectives from these specs, the port writes them
out: `MeshRank` is a rank's view of a (data, model) mesh that the model's
forwards take (`models.model`, `models.layers`), serving's and training's.
Training needs each collective with its adjoint, which GSPMD derives and
the port writes as `torch.autograd.Function`s: the FSDP all-gather over
`data` (backward: a reduce-scatter, sum), the `model` sum of row-parallel
partials (backward: the identity), the entry of a column-parallel region,
whose input is replicated over `model` (`MeshRank.model_in`: forward the
identity, backward an all-reduce over `model`), and a gather over `model`
whose result every rank uses whole, the vocabulary's (backward: the
rank's slice). A collective takes its autograd form only where its input
records a gradient, so serving runs the raw c10d calls as before.
`shard_opt_state` cuts an optimizer state by `opt_state_specs`, and
`Sharding` (`param_shardings`, `opt_state_shardings`) cuts a global
tensor into a rank's shard and gathers it back, for checkpoints. JAX's `shard_map` and
`to_shardings` are JAX idiom (a per-device program and `NamedSharding`
objects) and have no counterpart: in the port every rank already runs its
own program on its own shards.

The spec functions read a mesh only through `launch.mesh.axis_names` and
`axis_size`, so they take a `DeviceMesh` or a stand-in with the JAX
`Mesh`'s `axis_names` and `shape`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import (axes_group, axis_names, axis_rank, axis_size,
                                     batch_axes)
from repro_torch.models.config import ModelConfig
from repro_torch.tree import at as _at
from repro_torch.tree import keystr, leaves, map_leaves, path_keys

from .decode import make_seq_sharded_decode_attn

FSDP = "data"
TP = "model"

# trailing-dim roles per leaf name: 'f' = FSDP(data), 't' = TP(model),
# '.' = replicated. Leading dims (layer stacks etc.) always replicate.
_ROLES = {
    "embed": "tf",
    "lm_head": "ft",
    "dec_pos": "..",
    "wq": "ft.", "wk": "ft.", "wv": "ft.",
    "wo": "t.f",
    "bq": "t.", "bk": "t.", "bv": "t.",
    "q_norm": ".", "k_norm": ".",
    "w": ".", "b": ".",                      # norms
    "w_gate": "ft", "w_up": "ft", "w_in": "ft", "w_down": "tf",
    "router": "f.",
    "wq_mla": "ft.",
    "w_dkv": "f.",
    "w_uk": "ft.", "w_uv": "ft.",
    "kv_norm": ".",
    "in_proj": "ft",                          # mamba1 (aligned halves)
    "in_proj_m2": "f.",                       # mamba2 (mixed boundary)
    "conv_w": ".t", "conv_b": "t",
    "x_proj": "t.", "dt_proj": ".t", "dt_bias": "t",
    "A_log": "t.", "A_log_1d": "t", "D": "t",
    "norm_w": "t",
    "out_proj": "tf",
    "w1": "f.", "w2": "f.",                   # mm projector
    "a_q": "f.", "a_k": "f.", "a_v": "f.", "a_o": "f.",
    "b_q": ".t", "b_k": ".t", "b_v": ".t", "b_o": "..",
}


def _spec_for_leaf(name, shape, mesh, cfg: ModelConfig, overrides=None) -> tuple:
    roles = (overrides or {}).get(name, _ROLES.get(name))
    # disambiguate shared names
    if name == "in_proj" and cfg.mamba_version == 2:
        roles = _ROLES["in_proj_m2"]
    if name == "A_log" and len(shape) >= 1 and cfg.mamba_version == 2:
        roles = "t"                          # (h,): one dim, over model
    if roles is None:
        return ()
    ndim = len(shape)
    roles = roles[-ndim:] if len(roles) > ndim else roles
    lead = ndim - len(roles)
    spec = [None] * lead
    fsz, tsz = axis_size(mesh, FSDP), axis_size(mesh, TP)
    names = axis_names(mesh)
    for dim, role in zip(shape[lead:], roles):
        if role == "f" and FSDP in names and dim % fsz == 0 and dim >= fsz:
            spec.append(FSDP)
        elif role == "t" and TP in names and dim % tsz == 0 and dim >= tsz:
            spec.append(TP)
        else:
            spec.append(None)
    return tuple(spec)


def param_specs(cfg: ModelConfig, params, mesh, overrides=None):
    """Spec tree mirroring a parameter tree (tensors on any device, the
    meta device included: only shapes are read). A layer leaf's spec is the
    JAX spec of its stacked leaf without the leading None.

    `overrides`: {leaf_name: role_string} -- variant sharding layouts (e.g.
    expert parallelism: w_gate -> "tf." shards experts over `model`)."""
    return map_leaves(lambda keys, index, t: _spec_for_leaf(
        keys[-1], tuple(t.shape), mesh, cfg, overrides), params)


def _jax_leaf_specs(pspecs) -> dict:
    """{JAX keystr: spec of the JAX leaf}: a stacked leaf's spec gains the
    leading None of its layer axis (an empty spec stays empty)."""
    return {path: ((None,) + group[0]) if stacked and group[0] else group[0]
            for path, group, stacked in leaves(pspecs)}


def opt_state_specs(cfg: ModelConfig, opt_state, pspecs, mesh):
    """Optimizer-state specs (`training.optim`'s states, keyed by JAX leaf
    paths): mirror the parameter's spec where shapes match (adam m/v);
    8-bit Adam quant blocks shard their block dim as the parameter's last
    dim while it still divides; factored stats and scalars replicate.
    Parent leaves are found by the JAX package's suffix match on paths."""
    pflat = _jax_leaf_specs(pspecs)

    def parent_param_spec(s):
        for pkey, pspec in pflat.items():
            if s.endswith(pkey):
                return pspec
        return None

    def spec_of(keys, t):
        name = keys[-1]
        if name.startswith("["):             # a JAX leaf path: its last key
            name = path_keys(name)[-1]
        if name in ("mq", "vq", "ms", "vs", "m", "v"):
            pspec = parent_param_spec(keystr(keys[:-1]))
            if pspec is not None and len(pspec) == t.ndim:
                if name in ("ms", "vs"):
                    # scales: last axis shrank by q_block; keep axis only if
                    # still divisible
                    last = pspec[-1]
                    msz = axis_size(mesh, last) if last else 1
                    ok = last is not None and t.shape[-1] % msz == 0
                    return pspec[:-1] + (last if ok else None,)
                return pspec
        s = keystr(keys)
        for pkey, pspec in pflat.items():
            if s.endswith(pkey):
                if len(pspec) == t.ndim:
                    return pspec
        return ()

    return map_leaves(lambda keys, index, t: spec_of(keys, t), opt_state)


# ------------------------------------------------------- activations -------


def batch_spec(mesh, batch_size: int) -> tuple:
    """Largest prefix of (pod, data) that divides the batch."""
    axes = []
    n = 1
    for a in batch_axes(mesh):
        sz = axis_size(mesh, a)
        if batch_size % (n * sz) == 0:
            axes.append(a)
            n *= sz
    return tuple(axes) if axes else ()


def _batch_entry(mesh, batch_size: int):
    """The batch dim's spec entry: its axes, one axis as its bare name (as a
    JAX `PartitionSpec` normalizes it), None where the batch replicates."""
    baxes = batch_spec(mesh, batch_size)
    if not baxes:
        return None
    return baxes[0] if len(baxes) == 1 else baxes


def make_constrain(mesh, batch_size: int, *, ep_moe: bool = False):
    """The activation specs that JAX pins through the model forward:
    returns spec(shape, kind) -> the spec of an activation of `shape`, or
    None where JAX leaves it unconstrained. The port's forwards read the
    batch entry of "hidden" to pick a rank's rows (`MeshRank.rows`).

    ep_moe: MoE dispatch/combine buffers (E, C, d) over data, so tokens move
    to the experts' shards."""
    b = _batch_entry(mesh, batch_size)

    def spec(shape, kind):
        ndim = len(shape)
        if kind == "hidden":
            return (b,) + (None,) * (ndim - 1)
        if kind == "logits":
            return (b,) + (None,) * (ndim - 2) + (TP,)
        if kind == "moe_dispatch" and ep_moe:
            e_ax = FSDP if shape[0] % axis_size(mesh, FSDP) == 0 else None
            return (e_ax,) + (None,) * (ndim - 1)
        if kind == "moe_grouped":
            g_ax = FSDP if shape[0] % axis_size(mesh, FSDP) == 0 else None
            return (g_ax,) + (None,) * (ndim - 1)
        return None

    return spec


def input_sharding(mesh, batch_size: int, ndim: int) -> tuple:
    b = _batch_entry(mesh, batch_size)
    return (b,) + (None,) * (ndim - 1)


def cache_specs(cfg: ModelConfig, cache: dict, mesh, batch_size: int) -> dict:
    """Slab decode-cache specs (`model.init_decode_cache`'s dict): batch
    over data, sequence over model (for KV), d_inner over model (for SSM
    state)."""
    b = _batch_entry(mesh, batch_size)
    msz = axis_size(mesh, TP)

    def spec(name, shp):
        if name in ("k", "v"):          # (L, B, S, Hkv, hd)
            s = TP if shp[2] % msz == 0 else None
            return (None, b, s, None, None)
        if name in ("ck", "cv"):        # (L, B, enc_S, Hkv, hd)
            s = TP if shp[3] % msz == 0 else None
            return (None, b, None, s, None)
        if name in ("ckv", "krope"):    # (L, B, S, r)
            s = TP if shp[2] % msz == 0 else None
            return (None, b, s, None)
        if name == "ssm":               # (L, B, di, N) or (L, B, h, p, N)
            if len(shp) == 4:
                s = TP if shp[2] % msz == 0 else None
                return (None, b, s, None)
            s = TP if shp[2] % msz == 0 else None
            return (None, b, s, None, None)
        if name == "conv":              # (L, B, K-1, C)
            s = TP if shp[3] % msz == 0 else None
            return (None, b, None, s)
        return ()

    return {k: spec(k, tuple(a.shape)) for k, a in cache.items()}


def pool_specs(pools: dict, mesh) -> dict:
    """Paged-KV pool specs (DESIGN.md §15): page tables are host-local
    integers, so the page axis (axis 1) always replicates -- a page id must
    dereference the same physical page on every rank. The per-position
    feature axes shard over `model` where divisible: attention heads for
    k/v, the latent/rope rank for MLA's ckv/krope. Shapes are
    (layer_axis, num_pages, page_size, *tail)."""
    msz = axis_size(mesh, TP)
    specs = {}
    for name, a in pools.items():
        tail = a.shape[3:]
        spec = [None, None, None]
        for i, dim in enumerate(tail):
            # shard the first tail dim that divides (heads for k/v, rank
            # for ckv/krope); everything after it replicates
            if i == 0 and dim % msz == 0 and dim >= msz:
                spec.append(TP)
            else:
                spec.append(None)
        specs[name] = tuple(spec)
    return specs


# ------------------------------------------------- placements and shards ---


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """DTensor placements of a spec on `mesh`: per mesh dim Shard(d) where
    the spec puts that axis on tensor dim d, else Replicate()."""
    where = {a: d for d, entry in enumerate(spec) for a in _entry_axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


def shard_range(spec, dim: int, size: int, mesh, coords=None) -> tuple:
    """(start, stop) of this rank's part of tensor dim `dim` of length
    `size` under `spec`: the dim splits over its axes, major to minor as
    listed. `coords` ({axis: coordinate}) defaults to the rank's own."""
    axes = _entry_axes(spec[dim]) if dim < len(spec) else ()
    idx, n = 0, 1
    for a in axes:
        sz = axis_size(mesh, a)
        c = coords[a] if coords is not None else axis_rank(mesh, a)
        idx, n = idx * sz + c, n * sz
    step = size // n
    return idx * step, (idx + 1) * step


def local_shard(t, spec, mesh, coords=None):
    """This rank's shard of the full tensor `t` under `spec`, as its own
    contiguous tensor (the whole tensor, unchanged, where nothing splits)."""
    out = t
    for d in range(len(spec)):
        lo, hi = shard_range(spec, d, t.shape[d], mesh, coords)
        if hi - lo != t.shape[d]:
            out = out.narrow(d, lo, hi - lo)
    return out if out is t else out.contiguous()


class MeshParams(dict):
    """One rank's local shards of a parameter tree (`shard_params`), with the
    spec tree and the mesh they were cut by."""

    def __init__(self, tree: dict, specs: dict, mesh):
        super().__init__(tree)
        self.specs = specs
        self.mesh = mesh


def shard_params(cfg: ModelConfig, params, mesh, device=None) -> MeshParams:
    """Cut a full parameter tree into this rank's shards under
    `param_specs`, on `device` (default: where the tensors are). Shards
    that are already cut are returned as they are."""
    if isinstance(params, MeshParams):
        return params
    specs = param_specs(cfg, params, mesh)
    local = map_leaves(lambda keys, index, t: _sharding(cfg, keys, _at(specs, keys, index), mesh)
                       .local(t).to(device if device is not None else t.device), params)
    return MeshParams(local, specs, mesh)


def shard_opt_state(cfg: ModelConfig, opt_state, pspecs, mesh, device=None):
    """Cut an optimizer state (`training.optim`'s, of the global
    parameters; tensors on any device, the meta device included, which
    gives zeros) into this rank's shards under `opt_state_specs`, on
    `device` (default: where the tensors are). The state of Mamba1's
    in_proj takes the parameter's x | z layout (`_interleaved`)."""
    shard = opt_state_shardings(cfg, opt_state, pspecs, mesh)

    def cut(keys, index, t):
        dev = device if device is not None else t.device
        if t.device.type == "meta":
            return torch.zeros(shard_shape(t.shape, _at(shard, keys, index).spec, mesh),
                               dtype=t.dtype, device=dev)
        return _at(shard, keys, index).local(t).to(dev)
    return map_leaves(cut, opt_state)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's shard of a global tensor of `shape` under
    `spec`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[d] //= axis_size(mesh, a)
    return tuple(out)


def global_shape(shape, spec, mesh) -> tuple:
    """The global shape whose shards under `spec` have `shape`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[d] *= axis_size(mesh, a)
    return tuple(out)


def _interleaved(cfg: ModelConfig, path: str, spec) -> bool:
    """Whether a leaf at `path` (a JAX keystr: a parameter, an optimizer
    state's leaf of one, or a statistic of one) holds Mamba1 in_proj's
    x | z halves on its last dim, over `model` under `spec`. Its shard is
    then not a contiguous slice of the columns, which would give model
    rank r a whole half (or parts of both that are not its channels), but
    rank r's columns of the x half beside the same columns of the z half:
    the conv, the scan and the gate then all run on the rank's d_inner
    channels."""
    return (cfg.mamba_version == 1 and "['mamba']['in_proj']" in path
            and len(spec) >= 1 and spec[-1] == TP)


def _sharding(cfg: ModelConfig, keys, spec, mesh) -> "Sharding":
    """The `Sharding` of the leaf at tree `keys` under `spec`."""
    return Sharding(spec, mesh, _interleaved(cfg, keystr(keys), spec))


class Sharding(NamedTuple):
    """How one leaf of a tree is cut over a mesh, the port's counterpart of
    a JAX `NamedSharding`: `local(t)` is this rank's shard of the global
    tensor t, and `whole(t)` gathers the ranks' shards back into the global
    tensor (a collective: every rank of the mesh calls it). `interleave`:
    the last dim holds Mamba1 in_proj's x | z halves, each cut on its own
    (`_interleaved`)."""
    spec: tuple
    mesh: object
    interleave: bool = False

    def local(self, t):
        if self.interleave:
            x, z = t.chunk(2, dim=-1)
            return torch.cat([local_shard(x, self.spec, self.mesh),
                              local_shard(z, self.spec, self.mesh)], dim=-1)
        return local_shard(t, self.spec, self.mesh)

    def whole(self, t):
        with torch.no_grad():
            for d, entry in enumerate(self.spec):
                for a in reversed(_entry_axes(entry)):
                    t = _gather_dim(t, d, axes_group(self.mesh, a), axis_size(self.mesh, a),
                                    self.interleave and d == t.ndim - 1)
        return t


def _gather_dim(t, dim, group, n, interleave=False):
    """The n ranks' t concatenated along `dim`, in group rank order (raw,
    no gradient); `interleave`: each rank's t is x | z halves, and the
    result is every x, then every z."""
    t = t.contiguous()
    out = t.new_empty((n,) + tuple(t.shape))
    dist.all_gather_into_tensor(out.view((n * t.shape[0],) + tuple(t.shape[1:])), t,
                                group=group)
    if interleave:
        x, z = out.chunk(2, dim=dim + 1)
        return torch.cat([_merge(x, dim), _merge(z, dim)], dim=dim)
    return _merge(out, dim)


def _merge(out, dim):
    """(n, *shape) pieces concatenated along `dim`."""
    shape = list(out.shape[1:])
    shape[dim] *= out.shape[0]
    return out.movedim(0, dim).reshape(shape)


def param_shardings(cfg: ModelConfig, params, mesh):
    """A `Sharding` per leaf of a (global or per-layer) parameter tree
    under `param_specs` (the JAX `param_shardings`)."""
    specs = param_specs(cfg, params, mesh)
    return map_leaves(lambda keys, index, t: _sharding(cfg, keys, _at(specs, keys, index), mesh),
                      params)


def opt_state_shardings(cfg: ModelConfig, opt_state, pspecs, mesh):
    """A `Sharding` per leaf of an optimizer state under
    `opt_state_specs` (`pspecs` the parameters' `param_specs`)."""
    specs = opt_state_specs(cfg, opt_state, pspecs, mesh)
    return map_leaves(lambda keys, index, t: _sharding(cfg, keys, _at(specs, keys, index), mesh),
                      opt_state)


def serving_cache_specs(cfg: ModelConfig, cache: dict, mesh, batch_size: int) -> dict:
    """The specs of a serving engine's per-slot state and slab on a mesh:
    `cache_specs`, with two departures the port makes. The moe family's
    rows replicate over `data` (K6 numbers every row of a call against one
    capacity, so every rank runs every row: `MeshRank.split_rows`),
    and the hybrid family's Mamba2 state keeps its channels whole (Mamba2
    runs whole on every rank). The engine's `pos` replicates."""
    specs = cache_specs(cfg, cache, mesh, batch_size)
    out = {}
    for k, spec in specs.items():
        spec = list(spec)
        if spec and cfg.family == "moe":
            spec[1] = None
        if k in ("conv", "ssm") and cfg.family == "hybrid":
            spec = [e if e != TP else None for e in spec]
        out[k] = tuple(spec)
    return out


def global_nbytes(tree: dict, specs: dict, mesh, seq_len: int | None = None) -> int:
    """The bytes of the global tensors whose shards on this rank are the
    tensors of `tree` under `specs` (a sharded tensor counts whole, as the
    JAX package counts a sharded array). `seq_len` is the global length of
    a trimmed prefix snapshot's sequence-sharded KV (its shards differ in
    length from rank to rank)."""
    total = 0
    for k, t in tree.items():
        if not torch.is_tensor(t):
            continue
        shape = list(t.shape)
        for d, entry in enumerate(specs.get(k, ())):
            if not _entry_axes(entry):
                continue
            if seq_len is not None and d == 2 and k in ("k", "v", "ckv", "krope"):
                shape[d] = seq_len
            else:
                for a in _entry_axes(entry):
                    shape[d] *= axis_size(mesh, a)
        n = 1
        for x in shape:
            n *= x
        total += n * t.element_size()
    return total


# ------------------------------------------- collectives with gradients ----


def _records(*xs) -> bool:
    """Whether a collective's input records a gradient (its autograd form
    runs then, the raw c10d call otherwise)."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _reduce_scatter(g, group, n: int, rank: int):
    """This rank's row of the sum over `group` of g (n, numel): a
    reduce-scatter where the backend has one (NCCL), else an all-reduce
    and the rank's row (gloo)."""
    g = g.contiguous()
    if dist.get_backend(group) == "nccl":
        out = g.new_empty(g.shape[1:])
        dist.reduce_scatter_tensor(out, g, group=group)
        return out
    g = g.clone()
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    return g[rank]


class _Gather(torch.autograd.Function):
    """x (numel,) -> (n, numel), the n ranks' x in group rank order.
    Backward: `sum_grad` -- a reduce-scatter (sum) where every rank used
    its whole copy for its own part of the loss (the FSDP gather over
    `data`), else the rank's slice, where every rank computed the same
    whole gradient (a gather over `model` used whole)."""

    @staticmethod
    def forward(ctx, x, group, n, rank, sum_grad):
        ctx.group, ctx.n, ctx.rank, ctx.sum_grad = group, n, rank, sum_grad
        out = x.new_empty((n, x.numel()))
        dist.all_gather_into_tensor(out.view(-1), x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            gx = _reduce_scatter(g, ctx.group, ctx.n, ctx.rank)
        else:
            gx = g[ctx.rank].contiguous()
        return gx, None, None, None, None


class _Sum(torch.autograd.Function):
    """The sum over `group` of row-parallel partials; backward the
    identity (every rank holds the whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _In(torch.autograd.Function):
    """The entry of a column-parallel region: forward the identity,
    backward the sum over `group` of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


# ------------------------------------------------------------- MeshRank ----


class MeshRank:
    """A rank's view of a (data, model) serving mesh for the port's forwards:
    the collectives that GSPMD inserts from the specs, written out.

    - `gather` all-gathers a parameter subtree's `data`-sharded dims (FSDP:
      a layer gathers its weights before it runs);
    - `model_sum` all-reduces a row-parallel product's partials over
      `model`; `model_cat` concatenates a `model`-sharded last dim;
    - `rows(B)` is this rank's slice of a batch of B rows under
      `make_constrain(mesh, B)`'s "hidden" spec (all rows where the batch
      replicates, as B = 1 prefill does), and `rows_cat` all-gathers a
      batch-sharded result's rows over `data`;
    - `on_model(name, dim)` says whether the leaf `name` has dim `dim` over
      `model`: a top-level leaf by its key ("embed"), a block's leaf by its
      last two keys ("attn/wo", "mlp/w_down", "moe/w_down",
      "shared/w_down", "mamba/x_proj"; every layer of a stack has the same
      spec, and the stacks agree where they share such a path);
    - `gather_whole` all-gathers every sharded dim (a leaf the port keeps
      whole where JAX shards it: the hybrid family's Mamba2 blocks), and
      `model_cat_dim` concatenates a `model`-sharded dim of an activation;
    - the moe family's rows replicate over `data`, which then carries only
      FSDP: every rank runs every row (`split_rows` False);
    - `seq_shards` is (shards, this rank's shard) of the sequence of the
      owner's slab of `slab_len` positions: (n_model, model_rank) where it
      is over `model` (`cache_specs`: the KV's sequence where n_model
      divides it), else (1, 0), as where the owner keeps no slab
      (`slab_len` None: the paged layout, whose MLA page views run the
      slab's functions whole); `seq_split` says which, and `seq_attn` is
      then the sequence-sharded combine on this mesh
      (`make_seq_sharded_decode_attn`), else None.

    Training (`models.model.forward(mesh=)`) adds, each with its gradient:
    `model_in(x)` at the entry of a column-parallel region (forward the
    identity, backward dx all-reduced over `model`), and `region(p,
    prefix)`, which passes a block's parameters replicated over `model`
    through it too (each rank's use of them inside the region is a part
    of the whole); `gather`'s backward is then a reduce-scatter over
    `data`, `model_sum`'s the identity, and a `model` gather's the rank's
    slice. `train_rows(B, G)` picks a training forward's rows and MoE
    groups, `sync_grads` sums the gradients of the leaves replicated over
    `data`, `leaf_sum` sums a per-leaf statistic over the axes that shard
    the leaf, and `sharding(path, spec)` is the `Sharding` by which the
    optimizers cut and gather a leaf's statistics.

    Collectives run whatever the size of their group: a 1x1 mesh runs the
    same code as a 2x2 one."""

    def __init__(self, cfg: ModelConfig, params: MeshParams, slab_len: int | None):
        mesh = params.mesh
        if axis_names(mesh) != (FSDP, TP):
            raise ValueError(f"a serving mesh has axes ('data', 'model'), got "
                             f"{axis_names(mesh)}")
        self.cfg = cfg
        self.mesh = mesh
        self.specs = params.specs
        self._leaf_specs = None
        self.split_rows = cfg.family != "moe"
        self.data = axes_group(mesh, FSDP)
        self.model = axes_group(mesh, TP)
        self.n_data, self.n_model = axis_size(mesh, FSDP), axis_size(mesh, TP)
        self.data_rank, self.model_rank = axis_rank(mesh, FSDP), axis_rank(mesh, TP)
        self.seq_split = slab_len is not None and cfg.family != "ssm" \
            and slab_len % self.n_model == 0
        self.seq_shards = (self.n_model, self.model_rank) if self.seq_split else (1, 0)
        self.seq_attn = make_seq_sharded_decode_attn(mesh) if self.seq_split else None
        # leaf path -> spec: the top-level leaves by key (embed, lm_head,
        # ...), then each stack's first layer by its last two keys
        self._specs = {}
        top = {k: v for k, v in self.specs.items() if not isinstance(v, list)}
        map_leaves(lambda keys, index, s: self._specs.__setitem__("/".join(keys), s), top)
        for stack in ("layers", "dense_layers", "enc_layers", "dec_layers", "shared_blocks",
                      "lora"):
            for block in self.specs.get(stack, [])[:1]:
                map_leaves(lambda keys, index, s:
                           self._specs.__setitem__("/".join(keys[-2:]), s), block)

    # parameters ------------------------------------------------------------

    def on_model(self, name: str, dim: int) -> bool:
        spec = self._specs.get(name, ())
        return dim < len(spec) and TP in _entry_axes(spec[dim])

    def model_local(self, name: str) -> bool:
        """Whether the leaf `name` has any dim over `model`."""
        return any(TP in _entry_axes(e) for e in self._specs.get(name, ()))

    def region(self, p: dict, prefix: str, names=None) -> dict:
        """A block's parameters `p` (leaves "<prefix>/<key>") for use inside
        a column-parallel region: a leaf with no dim over `model` goes
        through `model_in` (its gradient on each rank is that rank's part
        of the whole); the rank's own shards as they are. `names` limits
        it to those keys."""
        def one(k, v):
            if not torch.is_tensor(v) or (names is not None and k not in names):
                return v
            name = f"{prefix}/{k}" if prefix else k
            return v if self.model_local(name) else self.model_in(v)
        return {k: one(k, v) for k, v in p.items()}

    def gather_whole(self, tree, specs):
        """`gather`, then every `model`-sharded dim all-gathered too: the
        whole leaves on every rank."""
        tree = self.gather(tree, specs)

        def whole(keys, index, t):
            spec = _at(specs, keys, index)
            for d, entry in enumerate(spec):
                if TP in _entry_axes(entry):
                    t = self._cat(t, d, self.model, self.n_model, self.model_rank)
            return t
        return map_leaves(whole, tree)

    def _cat(self, t, dim, group, n, rank=0):
        """The n ranks' t concatenated along `dim`, in group rank order: one
        all-gather into an (n, *t.shape) buffer, whose rank axis then moves
        next to `dim` (a copy only where n > 1). With a gradient, its
        backward is this rank's (`rank`) slice: every rank uses the whole
        result."""
        t = t.contiguous()
        if _records(t):
            out = _Gather.apply(t.reshape(-1), group, n, rank, False).view(
                (n,) + tuple(t.shape))
            return _merge(out, dim)
        out = t.new_empty((n,) + tuple(t.shape))
        dist.all_gather_into_tensor(out.view((n * t.shape[0],) + tuple(t.shape[1:])), t,
                                    group=group)
        return _merge(out, dim)

    def gather(self, tree, specs):
        """`tree` (local shards, or one tensor) with its `data`-sharded dims
        all-gathered, in one all-gather a dtype: the leaves' shards are
        packed flat, and each gathered leaf is the ranks' pieces
        concatenated along its `data` dim, contiguous in its own layout (a
        view where n = 1: the same strides as the shard, so the products
        that read it are the single-card path's). `model` dims stay local."""
        if torch.is_tensor(tree):
            return self.gather({"t": tree}, {"t": specs})["t"]
        packs: dict = {}

        def pack(keys, index, t):
            spec = _at(specs, keys, index)
            dims = [d for d, entry in enumerate(spec) if FSDP in _entry_axes(entry)]
            if dims:
                packs.setdefault(t.dtype, []).append(((keys, index), dims[0], t))
        map_leaves(pack, tree)
        full = {}
        n = self.n_data
        for dtype, leaves_ in packs.items():
            flat = torch.cat([t.reshape(-1) for _, _, t in leaves_])
            if _records(flat):
                out = _Gather.apply(flat, self.data, n, self.data_rank, True)
            else:
                out = flat.new_empty((n, flat.numel()))
                dist.all_gather_into_tensor(out.view(-1), flat, group=self.data)
            off = 0
            for at, d, t in leaves_:
                shape = list(t.shape)
                shape[d] *= n
                piece = out[:, off:off + t.numel()].reshape((n,) + tuple(t.shape))
                full[at] = piece.movedim(0, d).reshape(shape)
                off += t.numel()
        return map_leaves(lambda keys, index, t: full.get((keys, index), t), tree)

    # activations -----------------------------------------------------------

    def model_sum(self, x):
        if _records(x):
            return _Sum.apply(x, self.model)
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.model)
        return x

    def model_in(self, x):
        """x at the entry of a column-parallel region: itself, and with a
        gradient, its gradient summed over `model` in the backward pass."""
        return _In.apply(x, self.model) if _records(x) else x

    def model_cat(self, x):
        return self._cat(x, x.ndim - 1, self.model, self.n_model, self.model_rank)

    def model_cat_dim(self, x, dim: int):
        return self._cat(x, dim, self.model, self.n_model, self.model_rank)

    def model_slice(self, x, dim: int):
        """This rank's part of dim `dim` of a whole activation, over `model`."""
        n = x.shape[dim] // self.n_model
        return x.narrow(dim, self.model_rank * n, n)

    def batch_split(self, B: int) -> bool:
        if not self.split_rows:
            return False
        spec = make_constrain(self.mesh, B)((B,), "hidden")
        return spec[0] is not None

    def local_cache(self, cfg: ModelConfig, cache: dict, B: int) -> dict:
        """This rank's shard of a full per-slot state or slab of B rows under
        `serving_cache_specs`, as its own contiguous tensors."""
        specs = serving_cache_specs(cfg, cache, self.mesh, B)
        return {k: local_shard(a, specs[k], self.mesh) for k, a in cache.items()}

    def local_row(self, row: int, B: int):
        """Row `row` of a batch of B rows in this rank's rows, or None where
        another `data` rank holds it."""
        r = self.rows(B)
        return row - r.start if r.start <= row < r.stop else None

    def rows(self, B: int) -> slice:
        if not self.batch_split(B):
            return slice(0, B)
        n = B // self.n_data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def train_rows(self, cfg: ModelConfig, B: int, G, constrain=None):
        """(rows, groups) of a training forward over B rows: this rank's
        rows (`constrain`'s "hidden" spec, default `make_constrain(mesh,
        B)`'s: the batch over `data` where it divides, else every row) and
        the MoE dispatch groups among them, of the call's G (None:
        ungrouped; `models.layers.moe_groups`). The moe family's rows split
        only under grouped dispatch with G a multiple of n_data: each rank
        then holds whole groups, G / n_data of them, numbered as on one
        card (the JAX "moe_grouped" constraint); ungrouped, capacity counts
        every token of the call, so every rank runs every row."""
        split = (constrain or make_constrain(self.mesh, B))((B,), "hidden")[0] is not None
        if cfg.family == "moe" and (G is None or G % self.n_data):
            split = False
        if not split:
            return slice(0, B), G
        n = B // self.n_data
        return slice(self.data_rank * n, (self.data_rank + 1) * n), \
            (None if G is None else G // self.n_data)

    def data_sum(self, x):
        """x summed over `data` (raw, no gradient)."""
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.data)
        return x

    def sync_grads(self, grads):
        """The gradients of the leaves replicated over `data` summed over
        it (each rank's is the gradient of its part of the loss); a
        `data`-sharded leaf's gradient is already summed by the backward of
        its FSDP gather."""
        def one(keys, index, g):
            spec = _at(self.specs, keys, index)
            if any(FSDP in _entry_axes(e) for e in spec):
                return g
            return self.data_sum(g)
        return map_leaves(one, grads)

    def leaf_sum(self, x, spec):
        """x, a statistic of one leaf's shard, summed over the axes of the
        mesh that shard the leaf under `spec` (raw, no gradient)."""
        axes = {a for e in spec for a in _entry_axes(e)}
        for a in (FSDP, TP):
            if a in axes:
                x = x.contiguous().clone()
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self.data if a == FSDP else self.model)
        return x

    def leaf_specs(self) -> dict:
        """{JAX keystr path: spec of the JAX leaf} of the parameters (a
        stacked leaf's spec with its layer axis's leading None)."""
        if self._leaf_specs is None:
            self._leaf_specs = _jax_leaf_specs(self.specs)
        return self._leaf_specs

    def sharding(self, path: str, spec) -> Sharding:
        """The `Sharding` under `spec` of a leaf at JAX path `path` (one of
        the parameters', or a statistic of one), on this rank's mesh."""
        return Sharding(spec, self.mesh, _interleaved(self.cfg, path, spec))

    def rows_cat(self, x, B: int):
        """The batch-sharded rows of x (this rank's `rows(B)`) all-gathered
        into all B rows; x as it is where the batch replicates."""
        if not self.batch_split(B):
            return x
        return self._cat(x, 0, self.data, self.n_data)
