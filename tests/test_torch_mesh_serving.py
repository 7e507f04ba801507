"""Mesh serving in the port (`ServingEngine(mesh=)`, `ReplicaGroup(mesh=)`)
on gloo meshes on the CPU, one child process per rank
(`test_torch_distributed.run_ranks`). The JAX package's mesh serving
tests fail on XLA's host-device meshes on the CPU (ROADMAP.md Queue 3),
so the port's mesh engine is held to the port's single-device engine, run
in the parent, and once to the JAX single-device engine.

Weights: SMOKE qwen2.5-3b and llava-next-mistral-7b from the JAX
`init_params(..., PRNGKey(0))` with the byte vocabulary, bridged. The
workload is JAX `tests/test_sharded_serving.py`'s: 4 prompts with a
12-token shared prefix, 2 slots, max_len 64, pages of 8, chunks of 5, 4 new
tokens each. Combos, on 1x2 and 2x2: qwen2.5-3b paged with the prefix
cache and prompt lookup, qwen2.5-3b paged with neither, llava paged with
prompt lookup; on 1x4 (n_kv_heads 2 < 4: the pool keeps every head)
qwen2.5-3b plain; and a `ReplicaGroup` of 2 replicas on 1x2. Every rank's
rows and tokens and the engine's `stats` must be identical to the
single-device engine's. The slab layout, the draft-model drafter and the
moe, ssm, hybrid and encdec families on a mesh: `test_torch_mesh_families`."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data as jax_lm_data  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(4)]
ENGINE_KW = dict(slots=2, max_len=64, kv_layout="paged", prefix_min_len=4, page_size=8,
                 chunk_size=5)
ARCHS = ("qwen2.5-3b", "llava-next-mistral-7b")
COMBOS = {"qwen-pc-pl": ("qwen2.5-3b", True, "prompt_lookup"),
          "qwen-plain": ("qwen2.5-3b", False, "off"),
          "llava-pl": ("llava-next-mistral-7b", False, "prompt_lookup")}
RUNS = [(name, shape) for shape in ("1x2", "2x2") for name in COMBOS] + \
    [("qwen-plain", "1x4")]

CHILD = """
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_data
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.replicas import ReplicaGroup

SHARED = %(shared)r
PROMPTS = %(prompts)r
KW = %(kw)r
COMBOS = %(combos)r

def load(arch):
    flat = np.load(os.path.join(OUT, arch + ".npz"))
    tree = {}
    for key, a in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a
    cfg = get_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
    return cfg, params_from_numpy(cfg, tree, device="cpu")

def reqs():
    return [Request(rid=i, prompt=p, max_new=4, eos_id=-1, shared_len=len(SHARED))
            for i, p in enumerate(PROMPTS)]

weights = {arch: load(arch) for arch in {a for a, _, _ in COMBOS.values()}}
for shape, names in %(runs)r:
    mesh = make_serving_mesh(tuple(int(n) for n in shape.split("x")), device="cpu")
    for name in names:
        arch, pc, spec = COMBOS[name]
        cfg, params = weights[arch]
        eng = ServingEngine(cfg, params, prefix_cache=pc, spec_decode=spec, mesh=mesh, **KW)
        eng.submit_many(reqs())
        done = eng.run()
        emit(**{f"{name}@{shape}": {"rows": {str(i): done[i].out for i in done},
                                    "stats": dict(eng.stats),
                                    "pool_heads": eng.alloc.pools["k"].shape[3]}})
    if %(group)r and shape == "1x2":
        cfg, params = weights["qwen2.5-3b"]
        grp = ReplicaGroup(cfg, params, replicas=2, mesh=mesh, prefix_cache=True,
                           spec_decode="prompt_lookup", **KW)
        grp.submit_many(reqs())
        done = grp.run()
        emit(group={"rows": {str(i): done[i].out for i in done},
                    "replicas": len(grp.engines)})
"""


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX weights, port weights, single-device port results, each mesh
    rank's results), the two child groups run once."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    jax_w, port_w = {}, {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).replace(vocab_size=jax_lm_data.VOCAB)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        np.savez(tmp / f"{arch}.npz", **_flatten(tree))
        cfg = get_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
        jax_w[arch] = (jcfg, jparams)
        port_w[arch] = (cfg, params_from_numpy(cfg, tree, device="cpu"))
    single = {}
    for name, (arch, pc, spec) in COMBOS.items():
        cfg, params = port_w[arch]
        eng = ServingEngine(cfg, params, prefix_cache=pc, spec_decode=spec, device="cpu",
                            **ENGINE_KW)
        eng.submit_many(_reqs(Request))
        done = eng.run()
        single[name] = {"rows": {str(i): done[i].out for i in done},
                        "stats": json.loads(json.dumps(dict(eng.stats)))}
    code = CHILD % {"shared": SHARED, "prompts": PROMPTS, "kw": ENGINE_KW,
                    "combos": COMBOS, "group": True,
                    "runs": [("1x2", list(COMBOS))]}
    two = run_ranks(code, 2, tmp)
    code = CHILD % {"shared": SHARED, "prompts": PROMPTS, "kw": ENGINE_KW,
                    "combos": COMBOS, "group": False,
                    "runs": [("2x2", list(COMBOS)), ("1x4", ["qwen-plain"])]}
    four = run_ranks(code, 4, tmp)
    return jax_w, single, two, four


def _reqs(Req):
    return [Req(rid=i, prompt=p, max_new=4, eos_id=-1, shared_len=len(SHARED))
            for i, p in enumerate(PROMPTS)]


@pytest.mark.parametrize("name,shape", RUNS, ids=[f"{n}@{s}" for n, s in RUNS])
def test_mesh_engine_matches_single_device(served, name, shape):
    _, single, two, four = served
    ranks = two if shape == "1x2" else four
    for r, res in enumerate(ranks):
        got = res[f"{name}@{shape}"]
        assert got["rows"] == single[name]["rows"], (r, got["rows"], single[name]["rows"])
        assert got["stats"] == single[name]["stats"], r
    heads = {res[f"{name}@{shape}"]["pool_heads"] for res in ranks}
    n_model = int(shape.split("x")[1])
    # the pool's heads over `model` where n_kv_heads (2) divides it, else whole
    assert heads == {2 // n_model if 2 % n_model == 0 else 2}


def test_replica_group_on_mesh_matches_single_device(served):
    """Two replicas on one 1x2 mesh, one shared sharded pool and prefix
    cache: rows identical to one single-device engine's."""
    _, single, two, _ = served
    for res in two:
        assert res["group"]["replicas"] == 2
        assert res["group"]["rows"] == single["qwen-pc-pl"]["rows"]


def test_mesh_engine_matches_jax_single_device(served):
    """One combo against the JAX engine: rows identical."""
    jax_w, _, _, four = served
    jcfg, jparams = jax_w["qwen2.5-3b"]
    eng = JaxEngine(jcfg, jparams, prefix_cache=True, spec_decode="prompt_lookup",
                    **ENGINE_KW)
    eng.submit_many(_reqs(JaxRequest))
    want = {str(i): list(r.out) for i, r in eng.run().items()}
    for res in four:
        assert res["qwen-pc-pl@2x2"]["rows"] == want
