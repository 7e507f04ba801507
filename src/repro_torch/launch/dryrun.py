"""Multi-pod dry run of the port (counterpart of `repro.launch.dryrun`).

For every (architecture x input shape) cell, builds the abstract inputs
(`launch.specs.input_specs`, meta tensors: no allocation), runs the
corresponding step (`make_train_step`, `prefill`, `decode_step_slab`) as
rank 0 of the production mesh, and records its memory, flops and
per-rank collective bytes (`launch.comm_analysis`) into an incremental
JSON file.

One process plays rank 0 of `make_production_mesh` -- (data 16, model 16),
or (pod 2, data 16, model 16) -- over torch's `fake` process-group
backend, which accepts every collective and moves nothing, on meta
tensors. The kernel wrappers send meta tensors to their plain versions
(`device.PLAIN_DEVICES`), so this is the one entry point of the port that
does no device work: it allocates nothing on any device and launches no
CUDA kernel. It needs no card. It starts the default process group itself
and refuses to run where one is already started by someone else.

Where JAX lowers one SPMD program for the whole mesh, the port runs one
process a rank, so a record is rank 0's: its local inputs (arguments),
the peak of what the step allocates above them (temp), its flops
(`FlopCounterMode`: matrix products; attention through the kernels' plain
versions, whose products are counted -- JAX's `dense_attn` probe option
has no counterpart, `blockwise_attention` being unported by design) and
the collectives it calls, each call counted (HLO text counts a loop body
once). A multi-pod rank runs its pod's (data, model) mesh on the pod's
part of the batch, with the gradient mean over `pod`
(`distributed.compression.make_pod_grad_sync`) as the train step's
`grad_transform`. The variants: `seq_decode` and `serve_ws_seqdec` pass the
sequence-sharded combine (`make_seq_sharded_decode_attn`) explicitly (the
port's slab decode on a mesh runs it anyway); `serve_ws*` and `ep_*` take
JAX's parameter overrides, which the port's FSDP gathers read as they
stand (the port has no all-to-all dispatch: `ep_moe`'s experts are
gathered over `data`); `ep_grouped` sets the MoE dispatch groups to
n_data (`models.layers.set_moe_groups`); `serve_ws2d*` shard the decode
cache's sequence over (data, model) with the batch replicated
(`abstract_cache_ws2d`), for the families whose cache is a k/v slab alone
(dense, vlm, grok's moe); another cache's cell records the error.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --arch qwen3-32b --shape train_4k
  ... --probe 2  (reduced-depth cost probe)
Results go to build/repro_torch/dryrun_results.json unless --out says
otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, SHAPE_ORDER, ShapeSpec, applicable
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import _ROLES as _BASE_ROLES
from repro_torch.launch import comm_analysis as ca
from repro_torch.launch import flops as F
from repro_torch.launch.mesh import (axis_names, axis_rank, axis_size, make_production_mesh,
                                    make_test_mesh)
from repro_torch.launch.specs import default_microbatch, input_specs, values
from repro_torch.models import decode_step_slab, prefill
from repro_torch.models import layers as mlayers
from repro_torch.models.config import ModelConfig
from repro_torch.tree import map_leaves

RESULTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun_results.json"
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}    # make_production_mesh's
VARIANTS = ["baseline", "seq_decode", "ep_moe", "serve_ws", "serve_ws_seqdec", "serve_ws2d",
            "serve_ws2d_seqdec", "ep_grouped"]


def probe_config(cfg: ModelConfig, n: int) -> ModelConfig:
    """Reduced-depth config for unrolled cost probes (same widths)."""
    if cfg.family == "hybrid":
        return cfg.replace(num_layers=n * cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.replace(num_layers=n, n_encoder_layers=n)
    if cfg.family == "moe" and cfg.first_dense_layers:
        return cfg.replace(num_layers=cfg.first_dense_layers + n)
    return cfg.replace(num_layers=n)


VARIANT_OVERRIDES = {
    # expert parallelism: experts over `data`, ff over `model` — dispatch
    # moves tokens (all-to-all), weights stay put
    "ep_moe": {"w_gate": "f.t", "w_up": "f.t", "w_down": "ft."},
    # grouped-local dispatch: groups = data shards; expert weights replicated
    # over data (ff over model) so per-group expert compute is fully local
    "ep_grouped": {"w_gate": "..t", "w_up": "..t", "w_down": ".t."},
    # weight-stationary serving: drop FSDP (replicate over `data`), keep TP —
    # decode must move activations (tiny), not weights (huge)
    "serve_ws": {n: r.replace("f", ".") for n, r in _BASE_ROLES.items()},
    "serve_ws_seqdec": {n: r.replace("f", ".") for n, r in _BASE_ROLES.items()},
}

_started_world = None      # the world of the fake group this module started


def stop_fake_world() -> None:
    """Destroy the default group where this module started it."""
    global _started_world
    if _started_world is not None and dist.is_initialized():
        dist.destroy_process_group()
    _started_world = None


def start_fake_world(world: int) -> None:
    """Start the default process group as rank 0 of `world` on the `fake`
    backend (or keep the one this module started for the same world).
    Raises where another default group is started: it is not replaced."""
    global _started_world
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if _started_world is None:
            raise RuntimeError(
                "the dry run starts its own default process group on the fake "
                f"backend, and one is already started ({dist.get_backend()!r}, world "
                f"{dist.get_world_size()}); run the dry run in a process of its own")
        if _started_world == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _started_world = world


def production_mesh(mesh_kind: str):
    """`make_production_mesh`'s mesh, or a (pod,) data x model test mesh where
    MESH_SHAPES has been cut (a test's)."""
    *_, n_data, n_model = MESH_SHAPES[mesh_kind]
    multi = mesh_kind == "multi"
    if (n_data, n_model) == (16, 16):
        return make_production_mesh(multi_pod=multi, device="cpu")
    return make_test_mesh(n_data, n_model, multi_pod=multi, device="cpu")


def _materialize(tree, device):
    """The meta tensors of `tree` as zeros on `device` (a real run of the
    same step: the gloo check of the counts); as they are on meta."""
    if torch.device(device).type == "meta":
        return tree
    return map_leaves(lambda keys, index, t: torch.zeros(t.shape, dtype=t.dtype,
                                                         device=device), tree)


def _local_bytes(tree, mesh) -> int:
    """The bytes of the rank's shards of a tree of `Abstract`s."""
    def one(keys, index, a):
        return math.prod(sh.shard_shape(a.shape, a.spec, mesh)) * a.value.element_size()
    total = []
    map_leaves(lambda k, i, a: total.append(one(k, i, a)), tree)
    return sum(total)


def build_step(arch: str, shape_name: str, mesh, *, probe: int = 0,
               variant: str = "baseline", cfg: ModelConfig | None = None,
               shape: ShapeSpec | None = None, device="meta"):
    """(cfg, shape, fn, args, argument_bytes, meta) of one cell on `mesh`
    (a production or test DeviceMesh over a started default group): the
    port's step and its inputs, rank-local, on `device` (meta: shapes
    only). `cfg` and `shape` stand in for the registry's where given."""
    cfg = cfg or get_config(arch)
    if probe:
        cfg = probe_config(cfg, probe)
    shape = shape or SHAPES[shape_name]
    transform = None
    run_shape = shape
    if "pod" in axis_names(mesh):
        # a rank runs its pod's (data, model) mesh on the pod's rows
        n_pod = axis_size(mesh, "pod")
        if shape.global_batch % n_pod == 0:
            run_shape = dataclasses.replace(shape, global_batch=shape.global_batch // n_pod)
        if shape.kind == "train":
            from repro_torch.distributed.compression import make_pod_grad_sync
            transform = make_pod_grad_sync(mesh, compress=False)
        mesh = mesh["data", "model"]
    ws2d = variant.startswith("serve_ws2d")
    specs = input_specs(arch, shape_name, mesh, cfg=cfg, shape=run_shape,
                        shard_overrides=VARIANT_OVERRIDES.get(variant),
                        decode_layout="ws2d" if ws2d else "default")
    B = run_shape.global_batch
    constrain = sh.make_constrain(mesh, B) if not ws2d else None
    if variant == "ep_grouped":
        mlayers.set_moe_groups(axis_size(mesh, "data"))
    params = sh.shard_params(cfg, _materialize(values(specs["params"]), device), mesh,
                             overrides=VARIANT_OVERRIDES.get(variant))
    if shape.kind == "train":
        from repro_torch.training import make_train_step
        opt_cfg = specs["opt_cfg"]
        mb = 0 if probe else default_microbatch(cfg, run_shape, mesh)
        tp = sh.MeshRank(cfg, params, None)
        init, step = make_train_step(cfg, opt_cfg, remat=True, constrain=constrain,
                                     microbatch=mb, grad_transform=transform, mesh=tp)
        opt = init(params)
        batch = _materialize(values(specs["batch"]), device)
        args = (params, opt, batch)
        arg_bytes = _local_bytes(specs["params"], mesh) + \
            _local_bytes(specs["opt_state"], mesh) + _local_bytes(specs["batch"], mesh)
        return cfg, shape, step, args, arg_bytes, {"opt": opt_cfg.name, "microbatch": mb}
    tp = sh.MeshRank(cfg, params, run_shape.seq_len)
    if shape.kind == "prefill":
        batch = _materialize(values(specs["batch"]), device)

        def fn(p, b):
            return prefill(cfg, p, b["tokens"], run_shape.seq_len,
                           image_embeds=b.get("image_embeds"), frames=b.get("frames"),
                           mesh=tp)
        arg_bytes = _local_bytes(specs["params"], mesh) + _local_bytes(specs["batch"], mesh)
        return cfg, shape, fn, (params, batch), arg_bytes, {}
    from repro_torch.distributed.decode import make_seq_sharded_decode_attn
    cache = dict(specs["cache"])
    del cache["pos"]
    attn_impl = None            # None: the slab's own combine on a mesh (`tp.seq_attn`)
    if variant in ("seq_decode", "serve_ws_seqdec"):
        attn_impl = make_seq_sharded_decode_attn(mesh)
    if ws2d:
        if set(cache) != {"k", "v"}:
            raise NotImplementedError(
                f"the ws2d layout shards a k/v slab's sequence over (data, model) with "
                f"every row on every rank; {cfg.name}'s cache holds {sorted(cache)}")
        # every rank runs every row; the sequence over (data, model)
        tp.split_rows = False
        tp.seq_shards = (axis_size(mesh, "data") * axis_size(mesh, "model"),
                         axis_rank(mesh, "data") * axis_size(mesh, "model")
                         + axis_rank(mesh, "model"))
        tp.seq_attn = make_seq_sharded_decode_attn(mesh, axis=("data", "model"),
                                                   batch_axis=None)
        local = {k: sh.local_shard(_materialize(a.value, device), a.spec, mesh)
                 for k, a in cache.items()}
        cache_bytes = _local_bytes(cache, mesh)
    else:
        local = tp.local_cache(cfg, _materialize(values(cache), device), B)
        cspecs = sh.serving_cache_specs(cfg, values(cache), mesh, B)
        cache_bytes = sum(math.prod(sh.shard_shape(tuple(a.shape), cspecs[k], mesh))
                          * a.value.element_size() for k, a in cache.items())
    local["pos"] = torch.full((), run_shape.seq_len - 1, dtype=torch.int32, device=device)
    token = _materialize(values(specs["token"]), device)

    def fn(p, t, c):
        return decode_step_slab(cfg, p, t, c, attn_impl=attn_impl, mesh=tp)
    arg_bytes = _local_bytes(specs["params"], mesh) + cache_bytes + \
        _local_bytes(specs["token"], mesh)
    return cfg, shape, fn, (params, token, local), arg_bytes, {}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, probe: int = 0,
             variant: str = "baseline") -> tuple:
    """(key, record) of one cell, as rank 0 of the production mesh on the
    fake backend (started here: `start_fake_world`)."""
    cfg_full = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg_full, shape_name)
    key = f"{arch}|{shape_name}|{mesh_kind}" + (f"|probe{probe}" if probe else "")
    if variant != "baseline":
        key += f"|{variant}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "probe": probe,
           "variant": variant}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return key, rec
    start_fake_world(math.prod(MESH_SHAPES[mesh_kind]))
    mesh = production_mesh(mesh_kind)
    t0 = time.time()
    try:
        cfg, shape, fn, args, arg_bytes, meta = build_step(arch, shape_name, mesh,
                                                           probe=probe, variant=variant)
        record = ca.record_step(fn, *args, argument_bytes=arg_bytes)
        rec.update({
            "status": "ok",
            "run_s": round(time.time() - t0, 2),
            "rank": dist.get_rank(),
            "n_devices": dist.get_world_size(),
            "memory": ca.memory_analysis_dict(record),
            "cost": ca.cost_analysis_dict(record),
            "collectives": ca.collective_bytes(record),
            "collective_sites": [list(s) for s in ca.collective_bytes_by_site(record, top=5)],
            "attention_flops_from": "the kernels' plain versions",
            **meta,
        })
        if not probe:
            rec["model_flops"] = F.model_flops(cfg, shape)
            rec["attention_flops"] = F.attention_flops(cfg, shape)
            rec["ssm_scan_flops"] = F.ssm_scan_flops(cfg, shape)
            rec["param_count"] = cfg.param_count()
            rec["param_count_active"] = cfg.param_count(active_only=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        mlayers.set_moe_groups(0)
    return key, rec


def load_results(path: Path = RESULTS) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_result(key: str, rec: dict, path: Path = RESULTS):
    res = load_results(path)
    res[key] = rec
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1, default=float))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=SHAPE_ORDER + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probe", type=int, default=0, help="reduced depth cost probe")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--out", default=str(RESULTS), help="the results' JSON file")
    args = ap.parse_args(argv)

    out = Path(args.out)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else SHAPE_ORDER
    existing = load_results(out)
    try:
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|{args.mesh}" + (
                    f"|probe{args.probe}" if args.probe else "")
                if args.variant != "baseline":
                    key += f"|{args.variant}"
                if not args.force and key in existing and \
                        existing[key].get("status") in ("ok", "skipped"):
                    print(f"[skip-cached] {key}")
                    continue
                print(f"[run] {key}", flush=True)
                k, rec = run_cell(arch, shape_name, args.mesh, probe=args.probe,
                                  variant=args.variant)
                save_result(k, rec, out)
                st = rec["status"]
                extra = ""
                if st == "ok":
                    mem = rec["memory"].get("temp_size_in_bytes", 0)
                    extra = (f" run={rec['run_s']}s "
                             f"temp={mem/2**30:.2f}GiB "
                             f"flops={rec['cost'].get('flops', 0):.3e} "
                             f"coll={rec['collectives'].get('_total', 0)/2**20:.1f}MiB")
                elif st == "error":
                    extra = " " + rec["error"][:200]
                print(f"[done] {key}: {st}{extra}", flush=True)
    finally:
        stop_fake_world()


if __name__ == "__main__":
    main()
