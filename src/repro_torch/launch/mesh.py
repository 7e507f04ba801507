"""Meshes over `torch.distributed` (counterpart of
`repro.launch.mesh`): functions, never module-level constants, so importing
this module starts no process group.

A port mesh is a `DeviceMesh` with the JAX axis names: (data, model) for a
serving or single-pod mesh, (pod, data, model) for a multi-pod one. Where
JAX runs one process over every device, the port runs one process a rank:
every mesh function needs a default process group that the caller has started
(`torch.distributed.init_process_group`: NCCL for CUDA, gloo for the CPU),
whose world size is the product of the shape.

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model) -- `pod`
carries data parallelism across the slower inter-pod links (one gradient
all-reduce per step, optionally int8-compressed), `model` stays within a
node on NVLink.

The spec functions of `distributed/sharding.py` read a mesh through
`axis_names` and `axis_size`, which take a `DeviceMesh` or any object with
the JAX `Mesh`'s `axis_names` and `shape` (a name -> size mapping).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _build(shape: tuple, axes: tuple, device=None):
    """A DeviceMesh of `shape` named `axes` over the started default
    process group, on CUDA unless `device` asks for the CPU."""
    kind = resolve_device(device).type
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh shape {shape} needs a started default process group of {need} "
            f"ranks: run one process a rank and call torch.distributed."
            f"init_process_group({'nccl' if kind == 'cuda' else 'gloo'!r}, "
            f"init_method=..., world_size={need}, rank=...) in each before "
            f"building the mesh")
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"mesh shape {shape} needs {need} ranks, found a world of {have}; "
            f"launch {need} processes (one a rank, ranks 0..{need - 1}) and "
            f"start the default process group with world_size={need}")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, multi_pod: bool = False,
                   device=None):
    """Small mesh for tests (gloo on the CPU with device="cpu")."""
    if multi_pod:
        return _build((2, n_data, n_model), ("pod", "data", "model"), device)
    return _build((n_data, n_model), ("data", "model"), device)


def parse_mesh_shape(spec) -> tuple:
    """"2x2" / "1,4" / (2, 2) -> (n_data, n_model)."""
    if isinstance(spec, (tuple, list)):
        shape = tuple(int(x) for x in spec)
    else:
        shape = tuple(int(x) for x in str(spec).replace(",", "x").split("x"))
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape must be (n_data, n_model), got {spec!r}")
    return shape


def make_serving_mesh(shape=(1, 2), device=None):
    """Serving mesh with axes (data, model) -- `data` carries slot batch
    parallelism, `model` tensor parallelism. On CUDA unless `device` asks
    for the CPU. Fails with the launch recipe when the world size is not
    the product of the shape (each rank is its own process, so it cannot
    be fixed from here)."""
    return _build(parse_mesh_shape(shape), ("data", "model"), device)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        return 1
    shape = mesh.shape
    return int(shape[names.index(name)] if isinstance(shape, tuple) else shape[name])


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on `name` (0 off the mesh's axes)."""
    if name not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(name))


def axes_group(mesh, axes):
    """The process group over one axis (`mesh.get_group`) or over several
    together, ranked major to minor in the order given. A group over
    several axes is made here, collectively: every rank makes the same
    call, and each call makes new groups."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = axis_names(mesh)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    rows = mesh.mesh.permute(rest + dims).reshape(-1, math.prod(mesh.mesh.shape[d]
                                                               for d in dims))
    mine = None
    for row in rows.tolist():
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


def mesh_device(mesh) -> torch.device:
    """The device a rank of `mesh` computes on: cuda:{rank % device_count}
    on a CUDA mesh, the CPU on a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device(f"cuda:{dist.get_rank() % torch.cuda.device_count()}")
    return torch.device(mesh.device_type)
