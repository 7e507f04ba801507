"""Carry the JAX package's parameters into the port.

`params_from_numpy` takes the nested dict of numpy arrays that
`jax.tree.map(np.asarray, repro.models.init_params(cfg, key))` gives --
layers stacked on axis 0 -- and returns the port's parameters: the same
names and per-layer shapes, each layer stack ("layers", and the moe
family's "dense_layers") as a list of per-layer dicts, tensors in `dtype`
(default cfg.dtype) on `device`, for every family the port serves (dense,
Mamba1, MoE with MLA). This module imports no
JAX; the parity tests call JAX on one side and this function on the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _check_family, torch_dtype

STACKS = ("dense_layers", "layers")      # layer stacks, stacked on axis 0


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
