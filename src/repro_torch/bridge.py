"""Carry the JAX package's parameters into the port.

`params_from_numpy` takes the nested dict of numpy arrays that
`jax.tree.map(np.asarray, repro.models.init_params(cfg, key))` gives --
layers stacked on axis 0 -- and returns the port's parameters: the same
names and per-layer shapes, each stack ("layers"; the moe family's
"dense_layers"; the hybrid family's "shared_blocks" and its
per-application "lora" adapters; the encdec family's "enc_layers" and
"dec_layers") as a list of per-entry dicts, tensors in `dtype` (default
cfg.dtype) on `device`, for every family the port serves (dense, vlm with
its "mm_proj", Mamba1, MoE with MLA or standard attention, hybrid, encdec
with "dec_pos", "enc_final_norm" and every LayerNorm's bias). This module imports no JAX; the parity tests call JAX
on one side and this function on the other.

`params_to_numpy` goes the other way, into the JAX layout. The optimizer
state crosses with `opt_state_from_numpy` (the numpy tree of a JAX AdamW,
Adafactor or 8-bit Adam state into the port's, `training.optim`) and
`opt_state_to_numpy`, so both packages can start from, and be compared
at, one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _check_family, torch_dtype
from repro_torch.tree import keystr, leaves, path_keys

STACKS = ("dense_layers", "layers", "shared_blocks", "lora",   # stacked on axis 0
          "enc_layers", "dec_layers")


def _to_torch(tree, dev, dt):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, dt) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))        # a writable copy
    return t.to(device=dev, dtype=dt if t.is_floating_point() else t.dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None, dtype=None) -> dict:
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    out = {k: _to_torch(v, dev, dt) for k, v in tree.items() if k not in STACKS}

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()

    def n_layers(tree):
        return n_layers(next(iter(tree.values()))) if isinstance(tree, dict) else tree.shape[0]

    for key in STACKS:
        if key in tree:
            stacked = _to_torch(tree[key], dev, dt)
            out[key] = [layer(stacked, i) for i in range(n_layers(stacked))]
    return out


def _nest(flat: dict) -> dict:
    """{keystr path: value} -> the nested dict the paths spell."""
    out = {}
    for path, value in flat.items():
        *head, last = path_keys(path)
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def _numpy(t) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def params_to_numpy(params: dict) -> dict:
    """The port's parameters as the JAX package's numpy tree: layer stacks
    stacked on axis 0."""
    return _nest({path: np.stack([_numpy(t) for t in g]) if stacked else _numpy(g[0])
                  for path, g, stacked in leaves(params)})


_STATE_KEYS = {"m", "v", "vr", "vc", "mq", "ms", "vq", "vs"}   # an optimizer leaf's dict


def _state_leaves(tree, prefix=()):
    """(path, leaf) of a JAX optimizer subtree shaped like the parameters:
    a leaf is an array, or the dict of one parameter's state tensors."""
    if isinstance(tree, dict) and not set(tree) <= _STATE_KEYS:
        for k in sorted(tree):
            yield from _state_leaves(tree[k], prefix + (k,))
    else:
        yield keystr(prefix), tree


def opt_state_from_numpy(tree: dict, device=None) -> dict:
    """A JAX optimizer state (`jax.tree.map(np.asarray, state)`: AdamW's
    m/v/step, Adafactor's f/step with vr/vc or v a leaf, 8-bit Adam's
    q/step with mq/ms/vq/vs or m/v a leaf) as the port's: the same keys,
    each parameter-shaped subtree keyed by the JAX leaf's `keystr` path,
    tensors in their own dtype on `device`."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)
    out = {}
    for key, sub in tree.items():
        if key == "step":
            out[key] = tensor(sub)
            continue
        out[key] = {path: {k: tensor(v) for k, v in leaf.items()} if isinstance(leaf, dict)
                    else tensor(leaf) for path, leaf in _state_leaves(sub)}
    return out


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state as the JAX package's numpy tree."""
    out = {}
    for key, sub in state.items():
        if key == "step":
            out[key] = _numpy(sub)
            continue
        out[key] = _nest({path: {k: _numpy(v) for k, v in leaf.items()}
                          if isinstance(leaf, dict) else _numpy(leaf)
                          for path, leaf in sub.items()})
    return out
