"""Draft-model speculative decoding on the port against the JAX package:
the `DraftModelDrafter` (its own slab cache, bucketed prefill, batched
slab decode steps, resync by common prefix) behind the paged engine, on
bridged SMOKE qwen2.5-3b weights. Tokens, every engine counter and the
drafter's counters must equal the JAX engine's, for self-drafting (every
draft accepted) and for a draft perturbed by noise from another seed
(rejections and resyncs), and the served legal query with
spec_decode="draft" must give the same rows, ledger and counters on both
packages."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.spec_decode import DraftModelDrafter as JaxDrafter  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.kernels import decode_attention as k5  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.spec_decode import DraftModelDrafter  # noqa: E402
from test_torch_serving import (_assert_identical, _legal,  # noqa: E402
                                _legal_query, weights)  # noqa: F401

PROMPTS = [[7, 3, 9, 4, 2, 8, 1, 6, 5, 10 + i] for i in range(2)]


@pytest.fixture(scope="module")
def other_draft(weights):
    """A draft model that agrees with the target on some tokens: the
    target's weights plus noise (0.3 of each tensor's spread) drawn from
    another seed. A draft drawn whole from another seed agrees on none."""
    jcfg, jparams, tcfg, _, _ = weights
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * np.asarray(a).std()
        * rng.standard_normal(a.shape).astype(np.float32), jparams)
    return (jax.tree.map(jax.numpy.asarray, tree),
            params_from_numpy(tcfg, tree, device="cpu"))


def _run_pair(weights, prompts, *, draft=None, max_new=8, **kw):
    """The same requests through both engines (paged target, slots=2,
    max_len=64); `draft` is (jax params, port params) of the draft model, or
    None for speculation off. Returns ((jax engine, outs), (port engine,
    outs)) after asserting tokens, engine stats and drafter stats equal."""
    jcfg, jparams, tcfg, tparams, _ = weights
    base = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5)
    out = []
    for i, (Eng, Req, cfg, params, dev) in enumerate(
            ((JaxEngine, JaxRequest, jcfg, jparams, {}),
             (ServingEngine, Request, tcfg, tparams, {"device": "cpu"}))):
        spec = {} if draft is None else dict(spec_decode="draft",
                                             draft_model=(cfg, draft[i]))
        eng = Eng(cfg, params, **base, **spec, **kw, **dev)
        for rid, p in enumerate(prompts):
            eng.submit(Req(rid=rid, prompt=p, max_new=max_new, eos_id=-1))
        done = eng.run()
        out.append((eng, {r: done[r].out for r in range(len(prompts))}))
    (je, jo), (te, to) = out
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    if draft is not None:
        assert te.drafter.stats == je.drafter.stats
    return out


def test_self_draft_matches_reference(weights):
    """Self-drafting (the target is its own draft model, the acceptance
    ceiling; `tests/test_spec_decode.py`): identical to speculation off,
    every draft accepted in float32, fewer target decode steps."""
    _, jparams, _, tparams, _ = weights
    _, (e_off, off) = _run_pair(weights, PROMPTS)
    _, (te, on) = _run_pair(weights, PROMPTS, draft=(jparams, tparams))
    assert on == off
    assert te.stats["accepted_tokens"] == te.stats["draft_tokens"] > 0
    assert te.stats["decode_steps"] < e_off.stats["decode_steps"]
    assert te.drafter.stats["draft_model_steps"] > 0
    assert te.drafter.stats["draft_prefill_tokens"] == sum(map(len, PROMPTS))
    assert k5.dense_launches == 0            # CPU tensors take the plain version


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_perturbed_draft_resyncs(weights, other_draft, prefix_cache):
    """A draft model with perturbed weights: partial acceptance, so rows roll
    back and resync by common prefix every round; output identical to
    speculation off, with and without the target's prefix cache."""
    shared = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
    prompts = [shared + [10 + i, 20 + i] for i in range(3)]
    _, (_, off) = _run_pair(weights, prompts, max_new=10)
    _, (te, on) = _run_pair(weights, prompts, draft=other_draft, max_new=10,
                            prefix_cache=prefix_cache)
    assert on == off
    assert 0 < te.stats["accepted_tokens"] < te.stats["draft_tokens"]


def test_drafter_resync_internals(weights):
    """`tests/test_spec_decode.py`'s drafter test on both packages: after a
    full rejection the fed history shrinks back to the target's kept
    tokens, and the proposals, histories and counters agree."""
    jcfg, jparams, tcfg, tparams, _ = weights
    jd = JaxDrafter(jcfg, jparams, slots=1, max_len=64)
    td = DraftModelDrafter(tcfg, tparams, slots=1, max_len=64, device="cpu")
    reqs = (JaxRequest(rid=0, prompt=[7, 3, 9, 4, 2], max_new=8, eos_id=-1),
            Request(rid=0, prompt=[7, 3, 9, 4, 2], max_new=8, eos_id=-1))
    for d, req in zip((jd, td), reqs):
        d.on_insert(0, req)
        req.out = [11]
    props = [d.draft_round({0: r}, {0: 3})[0] for d, r in zip((jd, td), reqs)]
    assert props[0] == props[1] and len(props[1]) == 3
    assert td._hist[0] == jd._hist[0] == [7, 3, 9, 4, 2, 11] + props[1][:2]
    for d, req in zip((jd, td), reqs):
        req.out = [11, 40]                  # the target rejected everything
        d.draft_round({0: req}, {0: 3})
    assert td._hist[0] == jd._hist[0]
    assert td._hist[0][:7] == [7, 3, 9, 4, 2, 11, 40]
    assert td._pos_h.tolist() == np.asarray(jd.cache["pos"]).tolist()
    assert td.stats == jd.stats
    td.on_free(0)
    assert td._hist[0] == []


def test_draft_validation(weights):
    """The JAX engine's validation: a missing draft model, a vocab
    mismatch and a family other than dense/moe raise ValueError; a MoE
    draft (standard attention, as grok-1-314b) passes it and gets its slab
    cache; on a mesh the drafter runs on the rank's device, so a device
    beside mesh= raises (the drafter on a mesh: test_torch_mesh_families)."""
    _, _, tcfg, tparams, _ = weights
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft",
                      draft_model=(tcfg.replace(vocab_size=tcfg.vocab_size + 1), tparams))
    with pytest.raises(ValueError, match="dense/moe"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft",
                      draft_model=(tcfg.replace(family="ssm"), tparams))
    moe = ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft",
                        draft_model=(tcfg.replace(family="moe", n_experts=4), tparams))
    assert moe.drafter.cfg.family == "moe" and moe.drafter.cache["k"].shape[0] == \
        tcfg.num_layers
    with pytest.raises(ValueError, match="device=None"):
        DraftModelDrafter(tcfg, tparams, slots=1, max_len=64, mesh=object(), device="cpu")


def test_served_legal_query_draft_identical(weights):
    """The served legal query with spec_decode="draft" (self-draft): rows,
    ledger token columns, engine counters, ServedStats, scheduler counters
    and every request's tokens equal the JAX package's, and so do the
    drafter's counters."""
    jcfg, jparams, tcfg, tparams, proj = weights
    kw = dict(slots=4, max_len=1024, spec_decode="draft", spec_k=4)
    jeng = JaxEngine(jcfg, jparams, draft_model=(jcfg, jparams), **kw)
    jex = JaxServed(_legal(jcorpus), jeng, max_new=6)
    jsess = jcore.Session(JaxRetriever(jex.corpus), jex, batch_size=4)
    want = (jsess.prepare(_legal_query(jcore)).submit().result(), jeng, jex, jsess)

    teng = ServingEngine(tcfg, tparams, device="cpu", draft_model=(tcfg, tparams), **kw)
    tex = ServedExtractor(_legal(tcorpus), teng, max_new=6)
    ret = TwoLevelRetriever(tex.corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                            device="cpu")
    tsess = tcore.Session(ret, tex, batch_size=4)
    got = (tsess.prepare(_legal_query(tcore)).submit().result(), teng, tex, tsess)
    _assert_identical(want, got)
    assert teng.drafter.stats == jeng.drafter.stats
    assert teng.stats["spec_rounds"] == teng.stats["decode_steps"] > 0
    assert tex.stats.draft_tokens == teng.stats["draft_tokens"] > 0
