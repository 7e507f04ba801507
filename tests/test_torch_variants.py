"""The family variants that the JAX model runs beyond the registry's
configs, on the port against the JAX package (SMOKE sizes):

- dense with MLA: qwen2.5-3b SMOKE with deepseek-v2-lite-16b SMOKE's MLA
  widths. The model functions on the page pool (the JAX engine's gather
  and block scatter on the reference side) and on the slab, the training
  forward with its loss and gradients, one AdamW step, the engine in
  {paged, slab} x {off, prompt lookup + prefix cache} (tokens, `stats`,
  the latent pools), a dense MLA draft model, and the served legal query
  on a few documents (rows, ledger columns, counters);
- vlm with MLA: llava-next-mistral-7b SMOKE with those widths, chunked
  prefill and decode with seeded image embeddings on the pool and on the
  slab, and the engine;
- dense and vlm with `n_experts` > 0: plain dense blocks, no "moe" leaf,
  while `ModelConfig.param_count` counts the experts as JAX's does;
- the ssm family with `mamba_version` 0, which both packages run as
  Mamba1;
- the rows the JAX model fails on (ssm with Mamba2, hybrid with Mamba1 or
  none): JAX raises and the port refuses with `NotImplementedError`;
- dense MLA on a gloo 1x2 and 2x1 mesh (serving, each rank's latent pools;
  one training step), held to the port's single device as
  `tests/test_torch_mesh_families.py` and `tests/test_torch_mesh_training.py`
  hold theirs.
"""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import test_torch_mesh_training as mesh_training  # noqa: E402
import test_torch_moe as moe_tests  # noqa: E402
import test_torch_serving as serving_tests  # noqa: E402
import test_torch_vlm as vlm_tests  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index.embedder import HashedEmbedder as JaxEmbedder  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.training.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.train_step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.distributed.sharding import local_shard, pool_specs  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.models import forward, init_params, param_count  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training import OptConfig, make_loss_fn, make_train_step  # noqa: E402
from repro_torch.tree import flat, like  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

_DEEPSEEK = get_smoke_config("deepseek-v2-lite-16b")
MLA = {k: getattr(_DEEPSEEK, k) for k in ("use_mla", "kv_lora_rank", "qk_nope_dim",
                                          "qk_rope_dim", "v_head_dim")}
EXPERTS = dict(n_experts=4, moe_top_k=2, n_shared_experts=1, expert_d_ff=32)
# name: (arch, fields replaced on its SMOKE config)
VARIANTS = {
    "dense-mla": ("qwen2.5-3b", MLA),
    "vlm-mla": ("llava-next-mistral-7b", MLA),
    "dense-experts": ("qwen2.5-3b", EXPERTS),
    "vlm-experts": ("llava-next-mistral-7b", EXPERTS),
    "ssm-mamba0": ("falcon-mamba-7b", dict(mamba_version=0)),
}
# the rows the JAX model fails on
REFUSED = {
    "ssm-mamba2": ("falcon-mamba-7b", dict(mamba_version=2)),
    "hybrid-mamba0": ("zamba2-2.7b", dict(mamba_version=0)),
    "hybrid-mamba1": ("zamba2-2.7b", dict(mamba_version=1)),
}
ENGINE_VARIANTS = ("dense-mla", "vlm-mla", "dense-experts", "ssm-mamba0")
MODES = {"off": {}, "pl-pc": dict(prefix_cache=True, spec_decode="prompt_lookup", spec_k=4)}
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
BASE = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5)
# the legal corpus's first documents a served query reads, as chip_smoke.py's
# reference modes: the slab's prefix hits decode their suffixes token by token
SERVED_DOCS = {"paged": 5, "slab": 3}
# float32 throughout (tests/test_torch_train_forward.py's tolerances)
LOGIT_TOL = 2e-6
GRAD_TOL = 1e-5


def configs(name, vocab=lm_data.VOCAB):
    arch, fields = {**VARIANTS, **REFUSED}[name]
    jcfg = jax_smoke_config(arch).replace(vocab_size=vocab, **fields)
    tcfg = get_smoke_config(arch).replace(vocab_size=vocab, **fields)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    return jcfg, tcfg


_WEIGHTS = {}


def weights(name):
    """(jcfg, jparams, tcfg, tparams, tree): the JAX init bridged to the
    port, once a variant."""
    if name not in _WEIGHTS:
        jcfg, tcfg = configs(name)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        _WEIGHTS[name] = (jcfg, jparams, tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                          tree)
    return _WEIGHTS[name]


# ----------------------------------------------------------- the table ------


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_where_jax_fails(name):
    """JAX builds one Mamba's parameters and runs the other's forward on
    them; the port refuses the config at every entry point, naming the
    JAX line."""
    jcfg, tcfg = configs(name)
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError):
        jax_forward(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(0)),
                    {"tokens": jnp.asarray(tokens)})
    with pytest.raises(NotImplementedError, match=r"src/repro/models/model\.py"):
        init_params(tcfg, device="meta")
    with pytest.raises(NotImplementedError, match="mamba_version"):
        params_from_numpy(tcfg, {}, device="cpu")
    with pytest.raises(NotImplementedError):
        forward(tcfg, {}, {"tokens": tokens})


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_params_match_jax(name):
    """The bridged tree and the port's own init hold the JAX leaves: MLA's
    latent projections, no router or experts for dense/vlm with
    `n_experts` (the config's `param_count` still counts them, as JAX's),
    Mamba1's blocks for mamba_version 0."""
    jcfg, jparams, tcfg, tparams, tree = weights(name)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(mine)] == \
        [tuple(a.shape) for a in jax.tree.leaves(tparams)]
    assert param_count(tparams) == param_count(mine) == param_count(
        init_params(tcfg, device="meta")) == n
    assert tcfg.param_count() == jcfg.param_count()
    block = tparams["layers"][0]
    if tcfg.use_mla:
        assert set(block["attn"]) == {"wq", "w_dkv", "w_uk", "w_uv", "wo", "kv_norm"}
    if tcfg.n_experts:
        assert "moe" not in block and "mlp" in block
        assert tcfg.param_count() > tcfg.replace(n_experts=0).param_count()   # counted
    if tcfg.family == "ssm":
        assert set(block["mamba"]) == set(tree["layers"]["mamba"])
        assert "x_proj" in block["mamba"]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_and_gradients_match_jax(name):
    """The training forward's logits, the loss and every gradient leaf
    against JAX's `value_and_grad` (constant leaves moved off their
    constants with seeded noise)."""
    jcfg, tcfg = configs(name, vocab=jax_smoke_config(VARIANTS[name][0]).vocab_size)
    rng = np.random.default_rng(1)

    def jitter(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    tree = jax.tree.map(jitter, jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0))))
    batch = _train_batch(jcfg, 2)
    jloss_fn = jax_make_loss_fn(jcfg, remat=False)

    @jax.jit
    def reference(p, b):
        return jax_forward(jcfg, p, b), jax.value_and_grad(jloss_fn, has_aux=True)(p, b)
    (jlogits, _), ((jloss, _), jgrads) = reference(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        logits, _ = forward(tcfg, params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGIT_TOL)
    for t in flat(params):
        t.requires_grad_(True)
    loss, _ = make_loss_fn(tcfg, remat=False)(params, {k: torch.as_tensor(v)
                                                      for k, v in batch.items()})
    grads = like(params, torch.autograd.grad(loss, flat(params)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=LOGIT_TOL)
    mine = jax.tree_util.tree_flatten_with_path(params_to_numpy(
        like(grads, [g.detach() for g in flat(grads)])))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, jax.tree_util.keystr(path)


def _train_batch(cfg, n, seed=0, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (n, cfg.n_image_tokens, 1024)).astype(np.float32)
    return batch


# ------------------------------------------------------ model functions -----


def test_dense_mla_paged_model_functions_match_jax_engine_form():
    """`tests/test_torch_moe.py`'s paged case on dense MLA: chunks, decode
    steps and a verify round with a dead row, every page after each call."""
    moe_tests.test_paged_model_functions_match_jax_engine_form(weights("dense-mla"))


def test_dense_mla_slab_model_functions_match_jax():
    moe_tests.test_slab_model_functions_match_jax(weights("dense-mla"))


def test_vlm_mla_with_images_match_jax():
    """`tests/test_torch_vlm.py`'s model cases on vlm MLA: seeded image
    embeddings on the first chunk on the latent pool, then teacher-forced
    decode; the slab prefill behind the images, then slab decode."""
    models = weights("vlm-mla")[:4]
    vlm_tests.test_prefill_and_decode_logits_teacher_forced(models)
    vlm_tests.test_slab_prefill_with_images_matches_jax(models)


# ---------------------------------------------------------------- engine ----


def _run(Eng, Req, cfg, params, prompts=PROMPTS, dev=None, **kw):
    eng = Eng(cfg, params, **{**BASE, **kw}, **(dev or {}))
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, prompt=p, max_new=6, eos_id=-1, shared_len=len(SHARED)))
    done = eng.run()
    return eng, {i: done[i].out for i in done}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("name", ENGINE_VARIANTS)
def test_engine_matches_jax(name, layout, mode):
    """Three requests sharing a 12-token template: tokens, every `stats`
    counter (kv_bytes_peak, prefix hits, verify rounds) and, on the page
    pool, every page of the latent pools, the sink included."""
    jcfg, jparams, tcfg, tparams, _ = weights(name)
    kw = dict(kv_layout=layout, **MODES[mode])
    je, jo = _run(JaxEngine, JaxRequest, jcfg, jparams, **kw)
    te, to = _run(ServingEngine, Request, tcfg, tparams, dev={"device": "cpu"}, **kw)
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    if mode == "pl-pc":
        assert te.stats["prefix_hits"] == 2 and te.stats["spec_rounds"] > 0
    if te.paged:
        assert te.alloc.pools.keys() == je.alloc.pools.keys()
        if tcfg.use_mla:                 # the block write-back, sink page included
            assert te.alloc.refcount == je.alloc.refcount
            for k in ("ckv", "krope"):
                np.testing.assert_allclose(te.alloc.pools[k].numpy(),
                                           np.asarray(je.alloc.pools[k]),
                                           atol=1e-5, rtol=1e-5, err_msg=k)


def test_dense_mla_draft_model_matches_jax():
    """A dense MLA draft model (JAX allows a dense draft,
    `serving/spec_decode.py:117`): the target as its own draft, on the pool
    with the prefix cache; the drafter's stats too."""
    jcfg, jparams, tcfg, tparams, _ = weights("dense-mla")
    je, jo = _run(JaxEngine, JaxRequest, jcfg, jparams, prefix_cache=True,
                  spec_decode="draft", draft_model=(jcfg, jparams))
    te, to = _run(ServingEngine, Request, tcfg, tparams, dev={"device": "cpu"},
                  prefix_cache=True, spec_decode="draft", draft_model=(tcfg, tparams))
    assert to == jo
    assert dict(te.stats) == dict(je.stats) and te.stats["draft_tokens"] > 0
    assert te.drafter.stats == je.drafter.stats


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["paged", "slab"])
def test_dense_mla_served_query_identical(layout, mode):
    """The served legal query on the first SERVED_DOCS[layout] documents through
    dense MLA: rows, ledger token columns, engine, extractor and scheduler
    counters and every request's tokens identical to the JAX package's."""
    jcfg, jparams, tcfg, tparams, _ = weights("dense-mla")
    kw = dict(slots=4, max_len=1024, kv_layout=layout, **MODES[mode])
    proj = np.asarray(JaxEmbedder()._proj)

    def run_jax():
        corpus = serving_tests._legal(jcorpus, SERVED_DOCS[layout])
        eng = JaxEngine(jcfg, jparams, **kw)
        ex = JaxServed(corpus, eng, max_new=6)
        sess = jcore.Session(JaxRetriever(corpus), ex, batch_size=4)
        return sess.prepare(serving_tests._legal_query(jcore)).submit().result(), eng, ex, sess

    def run_torch():
        corpus = serving_tests._legal(tcorpus, SERVED_DOCS[layout])
        eng = ServingEngine(tcfg, tparams, device="cpu", **kw)
        ex = ServedExtractor(corpus, eng, max_new=6)
        ret = TwoLevelRetriever(corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                                device="cpu")
        sess = tcore.Session(ret, ex, batch_size=4)
        return sess.prepare(serving_tests._legal_query(tcore)).submit().result(), eng, ex, sess
    want, got = run_jax(), run_torch()
    serving_tests._assert_identical(want, got)
    assert dataclasses.asdict(got[2].stats)["requests"] > 0
    if mode == "pl-pc":
        assert got[1].stats["prefix_hits"] > 0


def test_dense_mla_train_step_matches_jax():
    """One AdamW step from the bridged state: loss, gradient norm and every
    parameter after it (`tests/test_torch_training.py`'s rule)."""
    import test_torch_training as training_tests
    jcfg, tcfg = configs("dense-mla")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _train_batch(jcfg, 4)
    kw = dict(lr=1e-3, warmup_steps=2)
    j_init, j_step = jax_make_train_step(jcfg, JaxOptConfig(**kw), remat=False)
    t_init, t_step = make_train_step(tcfg, OptConfig(**kw), remat=False)
    jp = jax.tree.map(jnp.asarray, tree)
    js = j_init(jp)
    tp = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    leaves = flat(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = make_loss_fn(tcfg, remat=False)(tp, {k: torch.as_tensor(v)
                                               for k, v in batch.items()})[0]
    first = params_to_numpy(like(tp, torch.autograd.grad(loss, leaves)))
    tp = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    jp, js, jm = jax.jit(j_step)(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts, tm = t_step(tp, ts, batch)
    for key in ("loss", "grad_norm", "ce"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    agree = jax.tree.map(lambda a: np.ones(a.shape, bool), tree)
    training_tests._check_params(params_to_numpy(tp), jax.tree.map(np.asarray, jp), first, 1,
                                 agree, training_tests.PARAM_TOL)


# ------------------------------------------------------------------ mesh ----

MESH_COMBOS = {"paged": dict(prefix_cache=True, spec_decode="prompt_lookup"),
               "slab": dict(kv_layout="slab", prefix_cache=True, spec_decode="prompt_lookup"),
               "draft": dict(prefix_cache=True, spec_decode="draft")}
MESH_PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(4)]

CHILD = """
sys.path.insert(0, %(tests)r)
from repro_torch.distributed.sharding import MeshRank, make_constrain, shard_params
from repro_torch.launch.mesh import axis_rank, make_serving_mesh, make_test_mesh
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import make_train_step
import test_torch_mesh_training as MT
import test_torch_variants as T

cfg = T.mesh_config()
w = torch.load(os.path.join(OUT, "weights.pt"))
for shape in %(shapes)r:
    dims = tuple(int(n) for n in shape.split("x"))
    mesh = make_serving_mesh(dims, device="cpu")
    coords = {a: axis_rank(mesh, a) for a in ("data", "model")}
    for name, kw in T.MESH_COMBOS.items():
        kw = dict(kw, **T.BASE)
        if kw.get("spec_decode") == "draft":
            kw["draft_model"] = (cfg, w)
        eng = ServingEngine(cfg, w, mesh=mesh, **kw)
        eng.submit_many(T.mesh_requests())
        done = eng.run()
        if eng.paged:
            torch.save({k: p[:, :eng.alloc.num_pages].contiguous()
                        for k, p in eng.alloc.pools.items()},
                       os.path.join(OUT, f"{name}@{shape}-r{RANK}.pt"))
        emit(**{f"{name}@{shape}": {"rows": {str(i): done[i].out for i in done},
                                    "stats": dict(eng.stats), "coords": coords}})
    tmesh = make_test_mesh(*dims, device="cpu")
    ref = torch.load(os.path.join(OUT, "train.ref.pt"))
    params, opt, metrics, grads = T.train_step(ref["init"], tmesh)
    errs = MT.compare_shards(cfg, params, opt, grads, ref, params.mesh)
    emit(**{f"train@{shape}": {"loss": float(metrics["loss"]),
                               "grad_norm": float(metrics["grad_norm"]), **errs}})
"""


def mesh_config():
    return get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB, **MLA)


def mesh_requests():
    return [Request(rid=i, prompt=p, max_new=4, eos_id=-1, shared_len=len(SHARED))
            for i, p in enumerate(MESH_PROMPTS)]


def train_step(params, mesh=None):
    """One AdamW step of dense MLA on `mesh_training`'s batch shape from
    `params` (float32), on one device or over the mesh rank's shards."""
    from repro_torch.distributed.sharding import MeshRank, make_constrain, shard_params
    cfg = mesh_config()
    batch = _train_batch(cfg, mesh_training.B, seed=1)
    tp = constrain = None
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
        tp = MeshRank(cfg, params, None)
        constrain = make_constrain(mesh, mesh_training.B)
    seen = {}

    def capture(grads):
        seen["grads"] = grads
        return grads
    init, step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1), constrain=constrain,
                                 grad_transform=capture, mesh=tp)
    return (*step(params, init(params), batch), seen["grads"])


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """The single-device runs and the two ranks' reports on 1x2 and 2x1."""
    tmp = tmp_path_factory.mktemp("variants_mesh")
    cfg = mesh_config()
    gen = torch.Generator().manual_seed(0)
    w = init_params(cfg, gen, device="cpu")
    for lp in w["layers"]:
        lp["attn"]["kv_norm"].copy_(1 + torch.randn(lp["attn"]["kv_norm"].shape,
                                                    generator=gen) * 0.1)
    torch.save(w, tmp / "weights.pt")
    single = {}
    for name, kw in MESH_COMBOS.items():
        kw = dict(kw, **BASE)
        if kw.get("spec_decode") == "draft":
            kw["draft_model"] = (cfg, w)
        eng = ServingEngine(cfg, w, device="cpu", **kw)
        eng.submit_many(mesh_requests())
        done = eng.run()
        single[name] = {"rows": {str(i): done[i].out for i in done},
                        "stats": json.loads(json.dumps(dict(eng.stats))),
                        "pools": {k: p[:, :eng.alloc.num_pages].contiguous()
                                  for k, p in eng.alloc.pools.items()} if eng.paged else {}}
    init = {k: v.float() if torch.is_tensor(v) else v for k, v in w.items()}
    params, opt, metrics, grads = train_step(mesh_training._clone(init))
    torch.save({"init": init, "params": params, "opt": opt, "grads": grads,
                "loose": mesh_training.loose_entries(grads)}, tmp / "train.ref.pt")
    single["train"] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    tests = str(Path(__file__).resolve().parent)
    ranks = run_ranks(CHILD % {"tests": tests, "shapes": ["1x2", "2x1"]}, 2, tmp)
    return tmp, single, ranks


class _StandIn:
    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
@pytest.mark.parametrize("name", list(MESH_COMBOS))
def test_dense_mla_mesh_serving_matches_single_device(gloo_mesh, name, shape):
    """Every rank's rows and `stats` equal the single-device engine's; on
    the page pool each rank's latent pools are its shard of the single
    device's (`pool_specs`: r over `model`, replicated over `data`, where
    each rank runs its rows and writes every row's blocks)."""
    tmp, single, ranks = gloo_mesh
    want = single[name]
    dims = tuple(int(n) for n in shape.split("x"))
    for r, res in enumerate(ranks):
        got = res[f"{name}@{shape}"]
        assert got["rows"] == want["rows"], r
        assert got["stats"] == want["stats"], r
        if want["pools"]:
            pools = torch.load(tmp / f"{name}@{shape}-r{r}.pt")
            specs = pool_specs(want["pools"], _StandIn(dims))
            for k, full in want["pools"].items():
                shard = local_shard(full, specs[k], _StandIn(dims), got["coords"])
                scale = float(full.abs().max())
                assert float((pools[k] - shard).abs().max()) <= 1e-5 * scale, (r, k)


@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_dense_mla_mesh_train_step_matches_single_device(gloo_mesh, shape):
    """One AdamW step on the mesh: each rank's loss, gradient norm, and
    gradient, parameter and optimizer-state shards against the single
    device's, at `tests/test_torch_mesh_training.py`'s tolerances."""
    _, single, ranks = gloo_mesh
    for r, res in enumerate(ranks):
        got = res[f"train@{shape}"]
        np.testing.assert_allclose(got["loss"], single["train"]["loss"],
                                   rtol=mesh_training.LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], single["train"]["grad_norm"],
                                   rtol=mesh_training.LOSS_RTOL)
        mesh_training._assert_params(got, r)
        assert got["state"] <= mesh_training.STATE_RTOL, (r, got)
