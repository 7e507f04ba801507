"""The port's serving engine on deepseek-v2-lite-16b (MoE with MLA
attention, SMOKE size, bridged weights) against the JAX engine on the same
requests: the compressed ckv/krope cache on both layouts, the prefix
cache, prompt lookup, a MoE self-draft and the served legal query. Tokens
and every `stats` counter (kv_bytes_peak included) must be identical.

MoE dispatch is capacity-limited per call, so the tokens of one call
interact: pad positions and dead rows take expert slots too. A case with
the capacity factor lowered makes verify rounds drop assignments, and the
port must drop the same ones as the JAX engine."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index.embedder import HashedEmbedder as JaxEmbedder  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.kernels import moe_gating as k6  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import (_assert_identical, _legal,  # noqa: E402
                                _legal_query)

ARCH = "deepseek-v2-lite-16b"
SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
BASE = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams, np.asarray(JaxEmbedder()._proj)


def _run(Eng, Req, cfg, params, prompts, *, max_new=6, shared=len(SHARED), dev=None,
         base=BASE, **kw):
    eng = Eng(cfg, params, **{**base, **kw}, **(dev or {}))
    for i, p in enumerate(prompts):
        new = max_new[i] if isinstance(max_new, list) else max_new
        eng.submit(Req(rid=i, prompt=p, max_new=new, eos_id=-1, shared_len=shared))
    done = eng.run()
    return eng, {i: done[i].out for i in range(len(prompts)) if i in done}


def _pair(weights, prompts=PROMPTS, *, cfgs=None, draft=False, **kw):
    """The same requests through the JAX engine and the port's; asserts
    identical tokens and stats (the drafter's too). `draft` drafts with
    the target's own weights on each side."""
    jcfg, jparams, tcfg, tparams, _ = weights
    if cfgs is not None:
        jcfg, tcfg = cfgs
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jkw.update(spec_decode="draft", draft_model=(jcfg, jparams))
        tkw.update(spec_decode="draft", draft_model=(tcfg, tparams))
    je, jo = _run(JaxEngine, JaxRequest, jcfg, jparams, prompts, **jkw)
    te, to = _run(ServingEngine, Request, tcfg, tparams, prompts, dev={"device": "cpu"},
                  **tkw)
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    if draft:
        assert te.drafter.stats == je.drafter.stats
    if te.paged:
        _assert_same_pools(te, je)
    return je, te, to


def _assert_same_pools(te, je):
    """Every page the runs left behind, the sink page included: dead rows
    and blocks past a row's pages write the sink, and a dead row of a later
    round reads it back, so the port writes it as the JAX engine does."""
    assert te.alloc.refcount == je.alloc.refcount
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(te.alloc.pools[k].numpy(), np.asarray(je.alloc.pools[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def plain(weights):
    """Tokens of the paged engine with speculation and the prefix cache
    off, the output every other mode must give at the shipped capacity."""
    return _pair(weights)[2]


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("pc", [False, True])
def test_layouts_and_prefix_cache_match_reference(weights, plain, layout, pc):
    """The moe case of `tests/test_paged_kv.py`'s layout parity: three
    requests sharing a 12-token template, the compressed cache pooled as
    (L, P, ps, r) and (L, P, ps, rd) pages or held as a slab, the prefix
    entry's pages (paged) or trimmed ckv/krope snapshot (slab) of the same
    byte size as the JAX entry's."""
    je, te, to = _pair(weights, kv_layout=layout, prefix_cache=pc)
    assert to == plain
    cfg = te.cfg
    if layout == "paged":
        assert {k: tuple(v.shape) for k, v in te.alloc.pools.items()} == \
            {k: tuple(v.shape) for k, v in je.alloc.pools.items()} == \
            {"ckv": (cfg.num_layers, te.alloc.num_pages, 8, cfg.kv_lora_rank),
             "krope": (cfg.num_layers, te.alloc.num_pages, 8, cfg.qk_rope_dim)}
        assert te.alloc.page_nbytes == je.alloc.page_nbytes
        assert te.estimate_pages(20, 4) == je.estimate_pages(20, 4) > 0
    if pc:
        assert te.stats["prefix_hits"] == 2 and te.stats["prefix_inserts"] == 1
        assert te.prefix_cache.nbytes == je.prefix_cache.nbytes > 0
    assert k6.launches == 0                 # CPU tensors take the plain version


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("pc", [False, True])
def test_prompt_lookup_matches_reference(weights, plain, layout, pc):
    """Verify rounds of every slot at per-row positions (on the pool: the
    gathered views and the dirtied blocks written back), prompt lookup's
    drafts accepted or rolled back, identical to plain decode, as
    `tests/test_spec_decode.py`'s moe case."""
    _, te, to = _pair(weights, kv_layout=layout, prefix_cache=pc,
                      spec_decode="prompt_lookup", spec_k=4)
    assert to == plain
    assert te.stats["spec_rounds"] == te.stats["decode_steps"] > 0


@pytest.mark.parametrize("pc", [False, True])
def test_moe_self_draft_matches_reference(weights, plain, pc):
    """A MoE draft model (the target's own weights: its slab cache, batched
    slab decode steps and bucketed prefills) proposes; engine and drafter
    counters equal the JAX engine's, tokens equal plain decode."""
    _, te, to = _pair(weights, prefix_cache=pc, spec_k=4, draft=True)
    assert to == plain
    assert te.drafter.stats["draft_model_steps"] > 0
    assert te.stats["accepted_tokens"] == te.stats["draft_tokens"] > 0


def test_low_capacity_drops_match_reference(weights, monkeypatch):
    """Capacity factor 0.1 (8 slots per expert) and spec_k = 8: a verify
    round of four slots routes 36 tokens, two experts each, over 8 experts,
    so assignments are dropped, and which ones depends on every token of
    the round -- padded candidates and the rows of finished requests, which
    read the sink page, included. Requests of different lengths leave dead
    rows behind. Tokens and stats must equal the JAX engine's on both
    layouts, and drops must have happened in verify rounds."""
    jcfg, _, tcfg, _, _ = weights
    cfgs = (jcfg.replace(capacity_factor=0.1), tcfg.replace(capacity_factor=0.1))
    drops = []
    real = tlayers.moe_apply

    def counting(cfg, p, x):
        T, d = x.shape[0] * x.shape[1], x.shape[2]
        _, idx = k6.moe_gating_plain((x.reshape(T, d) @ p["router"]).float(), cfg.moe_top_k)
        flat = idx.reshape(-1).long()
        pos = (torch.nn.functional.one_hot(flat, cfg.n_experts).cumsum(0) - 1) \
            .gather(1, flat[:, None])[:, 0]
        drops.append((x.shape[0], int((pos >= tlayers.moe_capacity(cfg, T)).sum())))
        return real(cfg, p, x)

    monkeypatch.setattr(tlayers, "moe_apply", counting)
    prompts = [SHARED + [10 + i, 20 + i, 30 + i][: 1 + i % 3] for i in range(6)]
    kw = dict(base={**BASE, "slots": 4}, max_new=[3, 9, 5, 12, 4, 7],
              spec_decode="prompt_lookup", spec_k=8, prefix_cache=True)
    for layout in ("paged", "slab"):
        drops.clear()
        _, te, _ = _pair(weights, prompts, cfgs=cfgs, kv_layout=layout, **kw)
        assert te.stats["spec_rounds"] > 0
        if layout == "paged":                          # the sink was written
            assert float(te.alloc.pools["ckv"][:, 0].abs().max()) > 0
        assert sum(n for b, n in drops if b == 4) > 0, drops


@pytest.mark.parametrize("served", [False, True])
def test_served_legal_query_identical(weights, served):
    """The served legal query on deepseek-v2-lite-16b SMOKE, with
    speculation and the prefix cache off, and with the served settings
    (prefix cache, prompt lookup, spec_k=4, chunk_size=128 as the card's
    moe path runs): rows, ledger token columns, engine counters,
    ServedStats, scheduler counters and every request's tokens equal the
    JAX package's."""
    jcfg, jparams, tcfg, tparams, proj = weights
    kw = dict(slots=4, max_len=1024)
    if served:
        kw.update(prefix_cache=True, spec_decode="prompt_lookup", spec_k=4, chunk_size=128)
    jeng = JaxEngine(jcfg, jparams, **kw)
    jex = JaxServed(_legal(jcorpus), jeng, max_new=6)
    jsess = jcore.Session(JaxRetriever(jex.corpus), jex, batch_size=4)
    want = (jsess.prepare(_legal_query(jcore)).submit().result(), jeng, jex, jsess)
    teng = ServingEngine(tcfg, tparams, device="cpu", **kw)
    tex = ServedExtractor(_legal(tcorpus), teng, max_new=6)
    ret = TwoLevelRetriever(tex.corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                            device="cpu")
    tsess = tcore.Session(ret, tex, batch_size=4)
    got = (tsess.prepare(_legal_query(tcore)).submit().result(), teng, tex, tsess)
    _assert_identical(want, got)
    if served:
        assert teng.stats["prefix_hits"] > 0 and teng.stats["spec_rounds"] > 0
    else:
        assert teng.stats["decode_steps"] > 0 and teng.stats["prefill_chunks"] > 0
