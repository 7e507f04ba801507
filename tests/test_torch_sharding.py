"""The port's sharding rules (`repro_torch.distributed.sharding`) and mesh
helpers (`repro_torch.launch.mesh`) against the JAX package's, with no
process group: `param_specs`, `opt_state_specs` (AdamW, Adafactor, 8-bit
Adam), `cache_specs`, `pool_specs`, `batch_spec`, `make_constrain`'s
per-kind specs and `input_sharding` for every registry id, at its SMOKE
config and at its published widths (abstract shapes only: `jax.eval_shape`
on the JAX side, the meta device on the port's), on meshes (1, 2), (2, 2),
(4, 1), (1, 4) and (2, 16, 16) with `pod`. Both sides get one stand-in mesh
with the JAX `Mesh`'s `axis_names`, `shape` and `devices.shape`. A port
layer leaf's spec is the JAX spec of the stacked leaf without its leading
None. Also: the straggler pool through both packages, `parse_mesh_shape`,
and the port's placements and local shards."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.distributed.sharding as jsh  # noqa: E402
import repro.distributed.straggler as jstrag  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_decode_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed import straggler as tstrag  # noqa: E402
from repro_torch.launch.mesh import axis_size, batch_axes, parse_mesh_shape  # noqa: E402
from repro_torch.models.cache_ops import PageAllocator  # noqa: E402
from repro_torch.models.model import init_decode_cache, init_params  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.tree import keystr, leaves, map_leaves  # noqa: E402

MESHES = {"1x2": (("data", "model"), (1, 2)), "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1)), "1x4": (("data", "model"), (1, 4)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
OPTIMIZERS = {"adamw": (joptim.adamw_init, toptim.adamw_init),
              "adafactor": (joptim.adafactor_init, toptim.adafactor_init),
              "adam8bit": (joptim.adam8bit_init, toptim.adam8bit_init)}
POOL_PAGES, PAGE_SIZE, CACHE_LEN = 4, 16, 64


def _mesh(name):
    names, shape = MESHES[name]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           devices=SimpleNamespace(shape=shape))


def _configs(arch, size):
    if size == "smoke":
        return jax_smoke_config(arch), get_smoke_config(arch)
    return jax_get_config(arch), get_config(arch)


def _jax_flat(tree) -> dict:
    return {jtu.keystr(path): tuple(spec) for path, spec in
            jtu.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_flat(tree) -> dict:
    out = {}
    map_leaves(lambda keys, index, spec: out.setdefault(keystr(keys), spec), tree)
    return out


@pytest.fixture(scope="module")
def shapes():
    """{(arch, size): (jax cfg, port cfg, JAX abstract params, port meta
    params)}, made once."""
    out = {}
    for arch in ARCH_IDS:
        for size in ("smoke", "published"):
            jcfg, tcfg = _configs(arch, size)
            jparams = jax.eval_shape(lambda c=jcfg: jax_init_params(c, jax.random.PRNGKey(0)))
            out[arch, size] = (jcfg, tcfg, jparams, init_params(tcfg, device="meta"))
    return out


@pytest.mark.parametrize("size", ["smoke", "published"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_and_opt_state_specs_match_jax(shapes, mesh, size):
    m = _mesh(mesh)
    for arch in ARCH_IDS:
        jcfg, tcfg, jparams, tparams = shapes[arch, size]
        jspecs = jsh.param_specs(jcfg, jparams, m)
        tspecs = tsh.param_specs(tcfg, tparams, m)
        jflat = _jax_flat(jspecs)
        port = leaves(tspecs)
        assert sorted(path for path, _, _ in port) == sorted(jflat), arch
        for path, group, stacked in port:
            want = jflat[path][1:] if stacked and jflat[path] else jflat[path]
            assert all(s == want for s in group), (arch, path, group[0], jflat[path])
        for opt, (jinit, tinit) in OPTIMIZERS.items():
            jstate = jax.eval_shape(jinit, jparams)
            want = _jax_flat(jsh.opt_state_specs(jcfg, jstate, jspecs, m))
            got = _port_flat(tsh.opt_state_specs(tcfg, tinit(tparams), tspecs, m))
            assert got == want, (arch, opt)


@pytest.mark.parametrize("size", ["smoke", "published"])
def test_cache_and_pool_specs_match_jax(shapes, size):
    for mesh in MESHES:
        m = _mesh(mesh)
        for arch in ARCH_IDS:
            jcfg, tcfg, _, _ = shapes[arch, size]
            for B in (8, 3):
                jcache = jax.eval_shape(lambda c=jcfg: jax_init_cache(c, B, CACHE_LEN))
                tcache = init_decode_cache(tcfg, B, CACHE_LEN, device="meta")
                want = _jax_flat(jsh.cache_specs(jcfg, jcache, m, B))
                got = {keystr((k,)): s for k, s in
                       tsh.cache_specs(tcfg, tcache, m, B).items()}
                assert got == want, (arch, mesh, B)
            template = jax.eval_shape(lambda c=jcfg: jax_init_cache(c, 1, PAGE_SIZE))
            jpools = {k: jax.ShapeDtypeStruct((a.shape[0], POOL_PAGES) + a.shape[2:],
                                              a.dtype)
                      for k, a in template.items() if k in ("k", "v", "ckv", "krope")}
            tpools = PageAllocator(tcfg, POOL_PAGES, PAGE_SIZE, device="meta").pools
            assert {k: tuple(a.shape) for k, a in tpools.items()} == \
                {k: a.shape for k, a in jpools.items()}, arch
            want = {k: tuple(s) for k, s in jsh.pool_specs(jpools, m).items()}
            assert tsh.pool_specs(tpools, m) == want, (arch, mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_activation_specs_match_jax(mesh, monkeypatch):
    """batch_spec for every batch size up to 64; make_constrain's spec of
    each activation kind (JAX's constraint captured in place of applied);
    input_sharding."""
    m = _mesh(mesh)
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jsh, "jax", SimpleNamespace(
        lax=SimpleNamespace(with_sharding_constraint=lambda x, s: s)))
    assert batch_axes(m) == tuple(a for a in ("pod", "data") if a in m.axis_names)
    for B in range(1, 65):
        assert tsh.batch_spec(m, B) == jsh.batch_spec(m, B), B
    shapes = [(8, 5, 64), (2, 1, 96), (3, 7), (16, 8, 32), (6, 4, 2, 8), (1, 3, 64)]
    kinds = ("hidden", "logits", "moe_dispatch", "moe_grouped", "other")
    for B in (1, 2, 3, 4, 8, 32, 64):
        for ep_moe in (False, True):
            jc = jsh.make_constrain(m, B, ep_moe=ep_moe)
            tc = tsh.make_constrain(m, B, ep_moe=ep_moe)
            for shape in shapes:
                for kind in kinds:
                    want = jc(np.zeros(shape), kind)
                    want = tuple(want) if isinstance(want, P) else None
                    assert tc(shape, kind) == want, (B, ep_moe, shape, kind)
        for ndim in (1, 2, 3):
            assert tsh.input_sharding(m, B, ndim) == tuple(jsh.input_sharding(m, B, ndim))


def test_placements_and_local_shards():
    """A spec's DTensor placements, and each rank's shard of a full tensor:
    the shards of every coordinate tile the tensor in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh("2x2")
    spec = ("model", None, "data")
    assert tsh.placements(spec, m) == (Shard(2), Shard(0))
    assert tsh.placements((None, ("data", "model")), m) == (Shard(1), Shard(1))
    assert tsh.placements((), m) == (Replicate(), Replicate())
    t = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    rows = []
    for mr in range(2):
        cols = [tsh.local_shard(t, spec, m, coords={"data": dr, "model": mr})
                for dr in range(2)]
        assert all(c.is_contiguous() and c.shape == (2, 3, 4) for c in cols)
        rows.append(torch.cat(cols, dim=2))
    assert torch.equal(torch.cat(rows, dim=0), t)
    both = [tsh.local_shard(t, (None, None, ("data", "model")), m,
                            coords={"data": d, "model": k}) for d in range(2) for k in range(2)]
    assert torch.equal(torch.cat(both, dim=2), t) and both[0].shape == (4, 3, 2)
    assert tsh.local_shard(t, (None, None, None), m, coords={"data": 1, "model": 1}) is t
    assert axis_size(m, "pod") == 1 and axis_size(m, "model") == 2


def test_parse_mesh_shape():
    assert parse_mesh_shape("2x2") == (2, 2)
    assert parse_mesh_shape("1,4") == (1, 4)
    assert parse_mesh_shape((4, 1)) == (4, 1)
    for bad in ("3", "2x2x2", "0x4"):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)


@pytest.mark.parametrize("mod", [jstrag, tstrag], ids=["jax", "torch"])
def test_straggler_reissue_on_slow_worker(mod):
    """One synthetic slow worker: its units blow the p95 deadline, get
    reissued to healthy workers, and every unit still completes exactly once
    with the right value (first completion wins, duplicates suppressed)."""
    slow = lambda wid: 0.4 if wid == 0 else 0.002  # noqa: E731
    results, stats = mod.run_with_stragglers(
        list(range(10)), lambda p: p * p, n_workers=3,
        deadline_factor=2.0, min_deadline_s=0.05, worker_delay=slow)
    assert results == {i: i * i for i in range(10)}
    assert stats.completed == 10
    assert stats.reissued >= 1
    assert stats.completed + stats.duplicates_suppressed >= 10


@pytest.mark.parametrize("mod", [jstrag, tstrag], ids=["jax", "torch"])
def test_straggler_no_reissue_when_healthy(mod):
    results, stats = mod.run_with_stragglers(
        list(range(6)), lambda p: p + 1, n_workers=3,
        deadline_factor=50.0, min_deadline_s=5.0)
    assert results == {i: i + 1 for i in range(6)}
    assert stats.reissued == 0
