"""The port's serving engine on falcon-mamba-7b (Mamba1, SMOKE size,
bridged weights) against the JAX engine on the same requests: the per-slot
recurrent state through chunked prefill, decode and verify rounds, prefix
entries that carry the exact boundary state, and the rollback of rejected
drafts from per-position checkpoints. Tokens and every `stats` counter
must be identical, across {paged, slab} x {prefix cache off, on}, prompt
lookup, scripted drafts that are rejected in part or whole, a dense draft
model, and the served legal query (rows, ledger, served and scheduler
counters)."""
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
from repro_torch.kernels import ssm_scan as k7  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import (_assert_identical, _legal,  # noqa: E402
                                _legal_query)

ARCH = "falcon-mamba-7b"
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


@pytest.fixture(scope="module")
def dense_draft():
    """A dense draft model (SMOKE qwen2.5-3b) on both sides."""
    jcfg = jax_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return ((jcfg, jparams),
            (tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")))


class Scripted:
    """Test drafter proposing the known greedy continuation with every
    token from position `good` on corrupted: good=0 rejects every draft,
    good=2 accepts two of four and rolls the rest back. The same class
    drives both engines."""

    def __init__(self, truth: dict, good: int, vocab: int):
        self.truth, self.good, self.vocab = truth, good, vocab

    def on_insert(self, slot, req):
        pass

    def on_free(self, slot):
        pass

    def draft_round(self, reqs, k_eff):
        out = {}
        for slot, req in reqs.items():
            d = list(self.truth[req.rid][len(req.out):][: k_eff.get(slot, 0)])
            out[slot] = [t if i < self.good else (t + 1) % self.vocab for i, t in enumerate(d)]
        return out


def _run(Eng, Req, cfg, params, prompts, *, max_new=6, shared=len(SHARED), dev=None, **kw):
    eng = Eng(cfg, params, **{**BASE, **kw}, **(dev or {}))
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, prompt=p, max_new=max_new, eos_id=-1, shared_len=shared))
    done = eng.run()
    return eng, {i: done[i].out for i in range(len(prompts)) if i in done}


def _pair(weights, prompts=PROMPTS, jax_kw=None, port_kw=None, **kw):
    """The same requests through the JAX engine and the port's; asserts
    identical tokens and stats. `jax_kw` / `port_kw` hold options that
    differ in kind between the two (a drafter instance, draft weights)."""
    jcfg, jparams, tcfg, tparams, _ = weights
    je, jo = _run(JaxEngine, JaxRequest, jcfg, jparams, prompts, **kw, **(jax_kw or {}))
    te, to = _run(ServingEngine, Request, tcfg, tparams, prompts, dev={"device": "cpu"},
                  **kw, **(port_kw or {}))
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    _assert_same_state(te, je)
    return je, te, to


def _assert_same_state(te, je):
    """The per-slot recurrent state the runs left behind. With random SMOKE
    weights the skip path D * x dominates each block's output, so a wrong
    state seldom flips a token; comparing the state itself is the bar."""
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(te.cache[k].numpy(), np.asarray(je.cache[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def plain(weights):
    """Tokens of the paged engine with speculation and the prefix cache
    off, the output every other mode must give."""
    return _pair(weights)[2]


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("pc", [False, True])
def test_layouts_and_prefix_cache_match_reference(weights, plain, layout, pc):
    """The ssm case of `tests/test_paged_kv.py`'s layout parity: three
    requests sharing a 12-token template. Paged: no page is allocated and
    the state lives per slot. With the prefix cache on, the entry carries
    the exact state at the boundary, its byte size (the state's) equals
    the JAX entry's, and the hits resume from it."""
    je, te, to = _pair(weights, kv_layout=layout, prefix_cache=pc)
    assert to == plain
    assert te.estimate_pages(20, 4) == je.estimate_pages(20, 4) == 0
    if layout == "paged":
        assert te.alloc.pools == {} and te.alloc.used_pages == 0
    if pc:
        assert te.stats["prefix_hits"] == 2 and te.stats["prefix_inserts"] == 1
        assert te.prefix_cache.nbytes == je.prefix_cache.nbytes > 0
        (tentry,), (jentry,) = te.prefix_cache._entries.values(), je.prefix_cache._entries.values()
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tentry.cache[k].numpy(), np.asarray(jentry.cache[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    assert k7.launches == 0                 # CPU tensors take the plain version


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("pc", [False, True])
def test_prompt_lookup_matches_reference(weights, plain, layout, pc):
    """Verify rounds through K7 with per-position checkpoints, prompt
    lookup's drafts accepted or rolled back, identical to plain decode."""
    _, te, to = _pair(weights, kv_layout=layout, prefix_cache=pc,
                      spec_decode="prompt_lookup", spec_k=4)
    assert to == plain
    assert te.stats["spec_rounds"] == te.stats["decode_steps"] > 0
    assert te._ckpts["ssm"].shape == (2, 2, 5, te.cfg.d_inner, te.cfg.ssm_state)


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("good", [0, 2, 4])
def test_rejected_drafts_roll_back(weights, plain, layout, good):
    """Scripted drafts with every token rejected (each round keeps one
    token: the state is restored from the first checkpoint), two of four
    accepted (restored from the third), or all accepted: the batched
    restore gives exactly the plain-decode state, on both layouts."""
    truth = {i: out for i, out in plain.items()}
    vocab = weights[2].vocab_size
    _, te, to = _pair(weights, kv_layout=layout, spec_k=4,
                      jax_kw={"spec_decode": Scripted(truth, good, vocab)},
                      port_kw={"spec_decode": Scripted(truth, good, vocab)})
    assert to == plain
    st = te.stats
    assert st["draft_tokens"] > 0
    if good == 0:
        assert st["accepted_tokens"] == 0 and st["decode_steps_saved"] == 0
    elif good == 4:
        assert st["accepted_tokens"] == st["draft_tokens"]
    else:
        assert 0 < st["accepted_tokens"] < st["draft_tokens"]


@pytest.mark.parametrize("pc", [False, True])
def test_dense_draft_model_for_ssm_target(weights, plain, dense_draft, pc):
    """A dense draft model (its own slab cache, K5-path decode steps on the
    card) for the Mamba1 target: tokens equal plain decode, and engine and
    drafter counters equal the JAX engine's."""
    (jd, td) = dense_draft
    je, te, to = _pair(weights, prefix_cache=pc, spec_k=4,
                       jax_kw={"spec_decode": "draft", "draft_model": jd},
                       port_kw={"spec_decode": "draft", "draft_model": td})
    assert to == plain
    assert te.drafter.stats == je.drafter.stats
    assert te.drafter.stats["draft_model_steps"] > 0 and te.stats["draft_tokens"] > 0


def test_drain_and_reinsert_match_reference(weights):
    """A slot drained mid-decode and a cancelled request: the requeued
    request prefills into a fresh state that overwrites the slot's, as in
    the JAX engine."""
    jcfg, jparams, tcfg, tparams, _ = weights
    outs = []
    for Eng, Req, cfg, params, dev in ((JaxEngine, JaxRequest, jcfg, jparams, {}),
                                       (ServingEngine, Request, tcfg, tparams,
                                        {"device": "cpu"})):
        eng = Eng(cfg, params, **BASE, **dev)
        for i, p in enumerate(PROMPTS):
            eng.submit(Req(rid=i, prompt=p, max_new=6, eos_id=-1))
        eng.step()
        eng.step()
        eng.drain_slot(next(iter(eng.active)))
        assert eng.cancel(2)
        done = eng.run()
        outs.append((eng, {r: q.out for r, q in done.items()}))
    (je, jo), (te, to) = outs
    assert to == jo and sorted(to) == [0, 1]
    assert dict(te.stats) == dict(je.stats) and te.stats["evictions"] == 1
    _assert_same_state(te, je)


@pytest.mark.parametrize("served", [False, True])
def test_served_legal_query_identical(weights, served):
    """The served legal query on falcon-mamba-7b SMOKE, with speculation
    and the prefix cache off, and with the served settings (prefix cache,
    prompt lookup, spec_k=4, chunk_size=128 as the card's ssm path runs):
    rows, ledger token columns, engine counters, ServedStats, scheduler
    counters and every request's tokens equal the JAX package's."""
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
    _assert_same_state(teng, jeng)
    if served:
        assert teng.stats["prefix_hits"] > 0 and teng.stats["spec_rounds"] > 0
    else:
        assert teng.stats["decode_steps"] > 0 and teng.stats["prefill_chunks"] > 0


def test_unported_families_raise(weights):
    """Mamba2 in the ssm family is not ported (the JAX model fails on it:
    tests/test_torch_variants.py; the hybrid family runs Mamba2): the
    engine refuses it on either layout. The encdec family is served now
    (tests/test_torch_whisper.py)."""
    _, _, tcfg, tparams, _ = weights
    for layout in ("paged", "slab"):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServingEngine(tcfg.replace(mamba_version=2), tparams, device="cpu",
                          kv_layout=layout)
