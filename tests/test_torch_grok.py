"""grok-1-314b (MoE with standard GQA attention, 8 experts, top 2, gated
GELU experts) on the port against the JAX package, at SMOKE size with
bridged parameters: the parameter layout and the published count, chunk,
decode and verify logits on the page pool (TOL, float32), and the engine
in both KV layouts with and without prompt lookup and the prefix cache.

MoE capacity is set per call from every token of the call, dead rows and
padded positions included, so what a dead row or a padded candidate reads
changes which assignments a full expert drops. Those rows read the sink
page, so the port's sink must hold what the JAX engine's holds: the
engine tests run 4 slots with staggered requests, so that rows die at
different steps and verify rounds have several rows writing the sink, and
compare the K/V pools, sink page included, with the JAX engine's."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.models import init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import init_params, param_count, prefill, verify_chunk  # noqa: E402
from repro_torch.models import decode_step as torch_decode_step  # noqa: E402
from repro_torch.models.cache_ops import PAGE_SINK  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_model import MAX_LEN, PS, TOL, _pool, _prefill, jax_decode_step  # noqa: E402

ARCH = "grok-1-314b"
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
# six requests on four slots, prompts and generation lengths staggered so
# that rows finish at different steps and later requests reuse their slots
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] + list(range(40, 40 + 3 * i)) for i in range(6)]
MAX_NEW = [4 + 3 * i for i in range(6)]
# pools after a run: the same arithmetic in float32, summed in another order
POOL_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tcfg, tree, device="cpu"), tree)


def test_params_match_jax_layout_and_published_count(weights):
    """The port's init draws the JAX tree's names and shapes (standard
    attention inside each MoE block), the bridge carries every leaf, and
    the published config counts grok-1-314b's 316,489,340,928 parameters
    on the meta device, its first 4 layers 21,290,539,008."""
    jcfg, jparams, tcfg, tparams, tree = weights
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert mine.keys() == tparams.keys() == tree.keys()
    assert "dense_layers" not in mine and len(mine["layers"]) == tcfg.num_layers
    assert sorted(mine["layers"][0]["attn"]) == ["wk", "wo", "wq", "wv"]
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert param_count(tparams) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    full = get_config(ARCH)
    assert param_count(init_params(full, device="meta")) == 316_489_340_928
    assert param_count(init_params(full.replace(num_layers=4), device="meta")) == \
        21_290_539_008


def test_chunk_decode_and_verify_logits_match_reference(weights):
    """Chunked prefill, teacher-forced decode (beside a dead row whose
    table is all sink) and a verify round on the page pool, against the
    JAX model on its dense cache, within TOL."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(1)
    pools, ctx = _pool(tcfg, rng)
    prompt = [int(t) for t in rng.integers(0, 256, size=41)]
    cache, pos, pairs = _prefill(jcfg, jparams, tcfg, tparams, prompt, pools, ctx)
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    for t in [int(x) for x in rng.integers(0, 256, size=6)]:
        jl, cache = jax_decode_step(jcfg, jparams, jnp.asarray([[t]]), cache)
        tl = torch_decode_step(tcfg, tparams, torch.as_tensor([[t]]),
                               torch.as_tensor([pos], dtype=torch.int32), pools,
                               ctx[None], ctx[pos // PS].reshape(1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        pos += 1
    C = 5
    toks = rng.integers(0, 256, size=(1, C))
    cache["pos"] = jnp.asarray([pos], jnp.int32)
    jl, _, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(toks)}, cache)
    cpos = torch.as_tensor(pos + np.arange(C))
    tl = verify_chunk(tcfg, tparams, torch.as_tensor(toks),
                      torch.as_tensor([pos], dtype=torch.int32), pools, ctx[None],
                      ctx[cpos // PS][None], (cpos % PS)[None])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_slab_prefill_matches_reference(weights):
    """A bucketed whole-prompt prefill into a slab cache: logits and every
    layer's K/V within TOL of the JAX `prefill`."""
    jcfg, jparams, tcfg, tparams, _ = weights
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 256, size=27)]
    toks = prompt + [0] * 5
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks])}, MAX_LEN,
                         length=jnp.asarray(len(prompt)))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), MAX_LEN, length=len(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == len(prompt)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=TOL, rtol=TOL)
    assert jax.tree.map(np.shape, dict(init_decode_cache(jcfg, 1, MAX_LEN))) == \
        {k: tuple(v.shape) for k, v in tc.items()}


def _sink_rounds(monkeypatch, slots, C):
    """Wrap the engine's `sink_plan` to count, for each verify round, the
    rows that write a sink block (a dead row, or a candidate past the
    row's pages)."""
    counts = []
    plan = engine_mod.sink_plan

    def counted(table, wpos, wblocks, page_size, scratch):
        table, wpos = np.asarray(table), np.asarray(wpos)
        if wpos.shape == (slots, C):
            view = table.shape[1] * page_size
            counts.append(sum(
                any(table[b, p // page_size] == PAGE_SINK for p in wpos[b] if p < view)
                for b in range(slots)))
        return plan(table, wpos, wblocks, page_size, scratch)
    monkeypatch.setattr(engine_mod, "sink_plan", counted)
    return counts


@pytest.mark.parametrize("layout,mode", [("paged", "off"), ("paged", "spec"),
                                         ("paged", "spec_ps4"), ("slab", "off"),
                                         ("slab", "spec")])
def test_engine_matches_reference(weights, monkeypatch, layout, mode):
    """Six staggered requests on four slots: tokens, every counter, the
    pool's reference counts, the prefix cache's entries and (paged) the K/V
    pools with the sink page equal the JAX engine's. In the verify modes at
    least one round has two or more rows writing the sink."""
    jcfg, jparams, tcfg, tparams, _ = weights
    ps = 4 if mode == "spec_ps4" else 8
    spec = mode != "off"
    kw = dict(slots=4, max_len=64, prefix_min_len=4, page_size=ps, chunk_size=5,
              kv_layout=layout, prefix_cache=spec,
              spec_decode="prompt_lookup" if spec else "off", spec_k=4)
    counts = _sink_rounds(monkeypatch, 4, 5)
    engines = []
    for Eng, Req, cfg, params, dev in ((JaxEngine, JaxRequest, jcfg, jparams, {}),
                                       (ServingEngine, Request, tcfg, tparams,
                                        {"device": "cpu"})):
        eng = Eng(cfg, params, **kw, **dev)
        for i, p in enumerate(PROMPTS):
            eng.submit(Req(rid=i, prompt=p, max_new=MAX_NEW[i], eos_id=-1,
                           shared_len=len(SHARED)))
        eng.run()
        engines.append(eng)
    je, te = engines
    assert {r: q.out for r, q in te.finished.items()} == \
        {r: q.out for r, q in je.finished.items()}
    assert len(te.finished) == len(PROMPTS)
    assert dict(te.stats) == dict(je.stats)
    if spec:
        assert te.stats["prefix_hits"] > 0 and te.stats["spec_rounds"] > 0
        assert te.prefix_cache.stats.snapshot() == je.prefix_cache.stats.snapshot()
    if layout == "paged":
        assert te.alloc.refcount == je.alloc.refcount
        n = je.alloc.num_pages
        for k in ("k", "v"):
            jp = np.asarray(je.alloc.pools[k])
            assert float(np.abs(jp[:, PAGE_SINK]).max()) > 0.1     # the sink was written
            np.testing.assert_allclose(te.alloc.pools[k][:, :n].numpy(), jp,
                                       atol=POOL_TOL, rtol=POOL_TOL, err_msg=k)
        if spec:
            assert max(counts) >= 2, counts
