"""Abstract parameter, optimizer-state, cache and input specs, on the meta
device (counterpart of `repro.launch.specs`): zero bytes allocated.

Each leaf is an `Abstract`: a meta tensor of the global shape and dtype
and its spec tuple on a mesh (`distributed.sharding`'s `param_specs`,
`opt_state_specs`, `cache_specs`, `batch_spec`; () where the mesh is None
or the leaf replicates) -- the port's form of a JAX `ShapeDtypeStruct`
with its `NamedSharding`. A mesh may be a `DeviceMesh` or a shape-only
stand-in with the JAX `Mesh`'s `axis_names` and `shape`, so that the
production meshes can be described without their ranks. The trees keep
the port's layouts: per-layer lists of parameters (`bridge.STACKS`) and
optimizer states keyed by JAX leaf paths (`training.optim`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models import init_decode_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import VISION_DIM, torch_dtype
from repro_torch.training.optim import OptConfig, make_optimizer
from repro_torch.tree import at, map_leaves


class Abstract(NamedTuple):
    """A meta tensor (`value`) and its spec on a mesh."""
    value: torch.Tensor
    spec: tuple = ()

    @property
    def shape(self) -> tuple:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def sds(shape, dtype, mesh=None, spec=None) -> Abstract:
    return Abstract(torch.empty(shape, dtype=dtype, device="meta"),
                    tuple(spec or ()) if mesh is not None else ())


def _with_specs(tree, specs=None):
    """`tree`'s meta tensors as `Abstract`s with the specs of `specs` (a
    tree of its structure), or () each."""
    return map_leaves(lambda keys, index, t: Abstract(
        t, at(specs, keys, index) if specs is not None else ()), tree)


def values(tree):
    """The meta tensors of a tree of `Abstract`s."""
    return map_leaves(lambda keys, index, a: a.value, tree)


def abstract_params(cfg: ModelConfig, mesh=None, dtype=None, overrides=None):
    dt = dtype or torch_dtype(cfg.dtype)
    params = init_params(cfg, device="meta", dtype=dt)
    if mesh is None:
        return _with_specs(params)
    return _with_specs(params, sh.param_specs(cfg, params, mesh, overrides))


def abstract_opt_state(cfg: ModelConfig, params_abs, opt_cfg: OptConfig, mesh=None):
    params = values(params_abs)
    state = make_optimizer(opt_cfg)[0](params)
    if mesh is None:
        return _with_specs(state)
    pspecs = sh.param_specs(cfg, params, mesh)
    return _with_specs(state, sh.opt_state_specs(cfg, state, pspecs, mesh))


def abstract_cache(cfg: ModelConfig, B: int, max_len: int, mesh=None):
    cache = init_decode_cache(cfg, B, max_len, device="meta")
    if mesh is None:
        return _with_specs(cache)
    return _with_specs(cache, sh.cache_specs(cfg, cache, mesh, B))


def _batch_structs(cfg: ModelConfig, shape: ShapeSpec, mesh, *, train: bool):
    B, S = shape.global_batch, shape.seq_len
    bspec = sh.batch_spec(mesh, B) if mesh else ()
    b = bspec if bspec else None

    def mk(shp, dt, sp):
        return sds(shp, dt, mesh, sp)
    batch = {}
    model_dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        batch["tokens"] = mk((B, S - n_img), torch.int32, (b, None))
        batch["image_embeds"] = mk((B, n_img, VISION_DIM), model_dt, (b, None, None))
    else:
        batch["tokens"] = mk((B, S), torch.int32, (b, None))
    if cfg.family == "encdec":
        batch["frames"] = mk((B, cfg.encoder_seq, cfg.d_model), model_dt, (b, None, None))
    if train:
        batch["labels"] = mk(batch["tokens"].shape, torch.int32, (b, None))
    return batch


def input_specs(arch: str, shape_name: str, mesh=None, *, opt_cfg=None,
                cfg: ModelConfig | None = None, shard_overrides=None,
                decode_layout: str = "default"):
    """`Abstract` stand-ins for one (arch x shape) cell. Returns a dict:
      train  : {params, opt_state, batch, opt_cfg}
      prefill: {params, batch}
      decode : {params, token, cache}
    """
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    B = shape.global_batch
    if shape.kind == "train":
        params = abstract_params(cfg, mesh, dtype=torch.float32, overrides=shard_overrides)
        opt_cfg = opt_cfg or default_opt_cfg(cfg)
        opt = abstract_opt_state(cfg, params, opt_cfg, mesh)
        batch = _batch_structs(cfg, shape, mesh, train=True)
        return {"params": params, "opt_state": opt, "batch": batch, "opt_cfg": opt_cfg}
    params = abstract_params(cfg, mesh, overrides=shard_overrides)
    if shape.kind == "prefill":
        return {"params": params, "batch": _batch_structs(cfg, shape, mesh, train=False)}
    # decode: one new token against a seq_len cache, from a full cache position
    pos = sds((), torch.int32, mesh, ())
    if decode_layout == "ws2d":
        # 2D weight-stationary serving: batch replicated, cache sequence
        # sharded over (data, model) -- weights never move, activations do
        token = sds((B, 1), torch.int32, mesh, ())
        cache = dict(abstract_cache_ws2d(cfg, B, shape.seq_len, mesh))
        cache["pos"] = pos
        return {"params": params, "token": token, "cache": cache}
    bspec = sh.batch_spec(mesh, B) if mesh else ()
    b = bspec if bspec else None
    token = sds((B, 1), torch.int32, mesh, (b, None))
    cache = dict(abstract_cache(cfg, B, shape.seq_len, mesh))
    cache["pos"] = pos
    return {"params": params, "token": token, "cache": cache}


def default_opt_cfg(cfg: ModelConfig) -> OptConfig:
    """Memory-appropriate optimizer per model size (DESIGN.md §4)."""
    n = cfg.param_count()
    if n > 100e9:
        return OptConfig(name="adam8bit")
    if n > 25e9:
        return OptConfig(name="adafactor")
    return OptConfig(name="adamw")


def default_microbatch(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Gradient-accumulation microbatch: keep per-device activation tokens
    bounded (~2k tokens/device/microstep with remat)."""
    if shape.kind != "train":
        return 0
    n_batch_devices = 1
    for a in sh.batch_spec(mesh, shape.global_batch):
        n_batch_devices *= axis_size(mesh, a)
    # microbatch must stay divisible by the batch-sharded device count
    mb = shape.global_batch
    while mb > n_batch_devices and (mb // 2) % n_batch_devices == 0 and \
            (mb // 2) * shape.seq_len // n_batch_devices >= 2048:
        mb //= 2
    return mb if mb < shape.global_batch else 0


def abstract_cache_ws2d(cfg: ModelConfig, B: int, max_len: int, mesh):
    """ws2d decode cache: sequence over (data, model), batch replicated."""
    cache = init_decode_cache(cfg, B, max_len, device="meta")
    names = axis_names(mesh)
    total = 1
    for a in ("data", "model"):
        if a in names:
            total *= axis_size(mesh, a)
    msz = axis_size(mesh, "model")

    def spec(name, shp):
        seq = ("data", "model")
        if name in ("k", "v"):          # (L, B, S, Hkv, hd)
            return (None, None, seq if shp[2] % total == 0 else None, None, None)
        if name in ("ck", "cv"):
            return (None, None, None, None, None)
        if name in ("ckv", "krope"):    # (L, B, S, r)
            return (None, None, seq if shp[2] % total == 0 else None, None)
        if name == "ssm":
            return (None, None, "model" if shp[2] % msz == 0 else None) + \
                (None,) * (len(shp) - 3)
        if name == "conv":
            return (None, None, None, "model" if shp[3] % msz == 0 else None)
        return ()
    return {k: Abstract(t, spec(k, tuple(t.shape))) for k, t in cache.items()}
