"""Speculative decoding on the port against the JAX package: the n-gram
drafter, and the paged engine's draft/verify rounds with rollback, on the
same requests through both engines (bridged SMOKE qwen2.5-3b weights).
Tokens, every `stats` counter and the pool's page refcounts must be
identical, in the cases of `tests/test_spec_decode.py`; and the served
legal query with the prefix cache and prompt lookup on must give the same
rows, ledger, counters and tokens on both packages."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

try:                                   # hypothesis is optional in the seed
    from hypothesis import given, settings, strategies as st
except ImportError:                    # image; fall back to fixed examples
    given = settings = st = None

import repro.core as jcore  # noqa: E402
import repro.serving.spec_decode as jspec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving.spec_decode as tspec  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index.retriever import TwoLevelRetriever as JaxRetriever  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.kernels import verify_attention as k4  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from test_torch_serving import (_assert_identical, _legal,  # noqa: E402
                                _legal_query, weights)  # noqa: F401

SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]


class ScriptedDrafter:
    """Test drafter proposing a fixed transform of the known true greedy
    continuation -- exact (full-k acceptance) or off-by-one (zero
    acceptance). The same class drives both engines."""

    def __init__(self, truth: dict, *, corrupt: bool, vocab: int):
        self.truth = truth
        self.corrupt = corrupt
        self.vocab = vocab

    def on_insert(self, slot, req):
        pass

    def on_free(self, slot):
        pass

    def draft_round(self, reqs, k_eff):
        out = {}
        for slot, req in reqs.items():
            d = list(self.truth[req.rid][len(req.out):][: k_eff.get(slot, 0)])
            out[slot] = [(t + 1) % self.vocab for t in d] if self.corrupt else d
        return out


# ------------------------------------------------------------ drafter ------


def test_prompt_lookup_is_a_line_for_line_copy():
    for name in ("prompt_lookup", "PromptLookupDrafter"):
        assert inspect.getsource(getattr(tspec, name)) == \
            inspect.getsource(getattr(jspec, name)), name


def _check_lookup(ctx, k, ngram):
    assert tspec.prompt_lookup(ctx, k, ngram) == jspec.prompt_lookup(ctx, k, ngram)


@pytest.mark.parametrize("seed", range(6))
def test_prompt_lookup_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ctx = [int(t) for t in rng.integers(0, 1 + seed, size=rng.integers(0, 30))]
        _check_lookup(ctx, int(rng.integers(1, 8)), int(rng.integers(1, 5)))
    _check_lookup([1, 2, 3, 9, 9, 1, 2, 3, 4, 5, 6, 7, 1, 2, 3], 4, 3)
    _check_lookup([4, 4, 4], 8, 3)


if st is not None:
    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.integers(0, 5), max_size=40), st.integers(1, 8),
           st.integers(1, 4))
    def test_prompt_lookup_property(ctx, k, ngram):
        _check_lookup(ctx, k, ngram)
else:
    @pytest.mark.parametrize("ctx,k,ngram", [([], 4, 3), ([5, 5], 4, 3),
                                             ([1, 2, 1, 2, 1], 3, 2)])
    def test_prompt_lookup_property(ctx, k, ngram):
        _check_lookup(ctx, k, ngram)


def test_prompt_lookup_drafter_respects_k_eff():
    req = Request(rid=0, prompt=[1, 2, 3, 4, 1, 2, 3], max_new=8, eos_id=-1)
    req.out = [4]
    for drafter in (tspec.PromptLookupDrafter(ngram=3),
                    jspec.PromptLookupDrafter(ngram=3)):
        assert drafter.draft_round({0: req}, {0: 2})[0] == [1, 2]
        assert drafter.draft_round({0: req}, {0: 0})[0] == []


def test_engine_spec_options(weights):
    _, _, tcfg, tparams, _ = weights
    assert ServingEngine(tcfg, tparams, device="cpu", spec_decode=False).spec is False
    assert ServingEngine(tcfg, tparams, device="cpu", spec_decode=None).spec is False
    with pytest.raises(ValueError, match="drafter protocol"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode=object())
    with pytest.raises(ValueError, match="spec_decode must be"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="medusa")
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(tcfg, tparams, device="cpu", spec_decode="draft")


# ------------------------------------------------------ engine parity -----


def _run_pair(weights, prompts, *, max_new=8, shared=0, eos_id=-1,
              max_retries=3, engine_kw=None, **kw):
    """The same requests through the JAX engine and the port's; returns
    ((jax engine, outs), (port engine, outs))."""
    jcfg, jparams, tcfg, tparams, _ = weights
    base = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5)
    base.update(engine_kw or {})
    out = []
    for Eng, Req, cfg, params, dev in ((JaxEngine, JaxRequest, jcfg, jparams, {}),
                                       (ServingEngine, Request, tcfg, tparams,
                                        {"device": "cpu"})):
        eng = Eng(cfg, params, **base, **kw, **dev)
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new=max_new, eos_id=eos_id,
                           shared_len=shared, max_retries=max_retries))
        done = eng.run()
        out.append((eng, {i: done[i].out for i in range(len(prompts)) if i in done}))
    return out


def _assert_same_engines(pair):
    (je, jo), (te, to) = pair
    assert to == jo
    assert dict(te.stats) == dict(je.stats)
    assert te.alloc.refcount == je.alloc.refcount
    assert te.alloc.free_pages == je.alloc.free_pages


def _truth(weights, prompts, **kw):
    (_, jo), (_, to) = _run_pair(weights, prompts, spec_decode="off", **kw)
    assert jo == to
    return jo


PROMPTS2 = [[7, 3, 9, 4, 2, 8, 1, 6, 5, 10 + i] for i in range(2)]


@pytest.mark.parametrize("case", ["zero_acceptance", "full_k_acceptance",
                                  "page_boundary_rollback", "near_max_len"])
def test_spec_engine_matches_reference(weights, case):
    """Zero acceptance (every draft rejected and rolled back), full-k
    acceptance, rejected candidates spanning a page boundary (14-token
    prompt, page size 8: a round writes positions 14..18), and verify
    rounds whose padded tail crosses max_len; each against plain decode and
    the JAX engine."""
    _, _, tcfg, _, _ = weights
    if case == "zero_acceptance":
        prompts, max_new = PROMPTS2, 8
    elif case == "full_k_acceptance":
        prompts, max_new = PROMPTS2, 11
    elif case == "page_boundary_rollback":
        prompts, max_new = [list(range(1, 15))], 8
    else:
        prompts, max_new = [list(range(1, 62))], 8
    truth = _truth(weights, prompts, max_new=max_new)
    if case == "near_max_len":
        spec = "prompt_lookup"
    else:
        spec = ScriptedDrafter(truth, corrupt=case != "full_k_acceptance",
                               vocab=tcfg.vocab_size)
    pair = _run_pair(weights, prompts, max_new=max_new, spec_decode=spec, spec_k=4)
    _assert_same_engines(pair)
    te, to = pair[1]
    assert to == truth
    stats = te.stats
    assert stats["spec_rounds"] == stats["decode_steps"] > 0
    if case == "zero_acceptance":
        assert stats["draft_tokens"] > 0 and stats["accepted_tokens"] == 0
        assert stats["decode_steps_saved"] == 0
        assert stats["spec_rounds"] == max(len(o) for o in truth.values()) - 1
    if case == "full_k_acceptance":
        assert stats["accepted_tokens"] == stats["draft_tokens"] > 0
        assert stats["spec_rounds"] == 2 and stats["decode_steps_saved"] == 16
    assert all(rc == 0 for rc in te.alloc.refcount[1:])
    assert te.alloc.free_pages == te.alloc.num_pages - 1
    assert k4.launches == 0                 # CPU tensors take the plain version


def test_rollback_of_cow_boundary_page_keeps_prefix_entry_intact(weights):
    """Speculative writes and rollback land in the slot's CoW copy of a
    prefix entry's boundary page: the entry's page bytes stay untouched on
    the port, and tokens, counters and refcounts equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams, _ = weights
    shared = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7]       # 10 tokens: tail page busy
    kw = dict(slots=1, max_len=64, prefix_min_len=4, page_size=8, chunk_size=6,
              spec_decode="prompt_lookup", spec_k=4)
    je = JaxEngine(jcfg, jparams, prefix_cache=JaxPrefixCache(max_entries=8), **kw)
    te = ServingEngine(tcfg, tparams, prefix_cache=PrefixCache(max_entries=8),
                       device="cpu", **kw)
    for eng, Req in ((je, JaxRequest), (te, Request)):
        eng.submit(Req(rid=0, prompt=shared + [11, 12], max_new=3, eos_id=-1,
                       shared_len=len(shared)))
        eng.run()
    (entry,) = te.prefix_cache._entries.values()
    assert entry.tail_page is not None
    before = {k: p[:, entry.tail_page].clone() for k, p in te.alloc.pools.items()}
    for eng, Req in ((je, JaxRequest), (te, Request)):
        for rid, tail in ((1, [21, 22]), (2, [31, 32, 33])):
            eng.submit(Req(rid=rid, prompt=shared + tail, max_new=6, eos_id=-1,
                           shared_len=len(shared)))
        eng.run()
    for k, p in te.alloc.pools.items():
        assert torch.equal(p[:, entry.tail_page], before[k]), k
    assert te.stats["prefix_hits"] == 2 and te.stats["cow_copies"] >= 3
    assert {r: q.out for r, q in te.finished.items()} == \
        {r: q.out for r, q in je.finished.items()}
    assert dict(te.stats) == dict(je.stats)
    assert te.alloc.refcount == je.alloc.refcount
    # the entry's bytes equal the JAX pool's copy of the same entry
    (jentry,) = je.prefix_cache._entries.values()
    for k, p in te.alloc.pools.items():
        np.testing.assert_allclose(
            p[:, entry.tail_page].numpy(),
            np.asarray(je.alloc.pools[k][:, jentry.tail_page]), atol=1e-5, rtol=1e-5)


def test_pool_exhaustion_mid_spec_drains_slot(weights):
    """Prompt-only pages at insert, lazy growth in verify rounds: with 3
    usable pages the two slots contend for the third, the starved slot is
    drained back to the queue, and every request still finishes with the
    ample-pool output -- with the JAX engine's evictions and refcounts."""
    prompts = [[7, 3, 9, 4, 2, 8], [1, 6, 5, 11, 4, 9]]
    (_, want), _ = _run_pair(weights, prompts, spec_decode="prompt_lookup")
    pair = _run_pair(weights, prompts, spec_decode="prompt_lookup", spec_k=4,
                     max_retries=50, prefix_cache=False,
                     engine_kw=dict(max_len=32, num_pages=4))
    _assert_same_engines(pair)
    te, to = pair[1]
    assert to == want
    assert te.stats["evictions"] >= 1 and not te.failed
    assert all(rc == 0 for rc in te.alloc.refcount[1:])


def test_eos_inside_accepted_draft_stops_like_plain_decode(weights):
    prompts = [[7, 3, 9, 4, 2, 8, 1, 6, 5, 11]]
    base = _truth(weights, prompts, max_new=10, engine_kw=dict(slots=1))
    eos = base[0][4]                               # 5th generated token
    (_, off), _ = _run_pair(weights, prompts, max_new=10, eos_id=eos,
                            spec_decode="off", engine_kw=dict(slots=1))
    oracle = ScriptedDrafter(base, corrupt=False, vocab=weights[2].vocab_size)
    pair = _run_pair(weights, prompts, max_new=10, eos_id=eos, spec_decode=oracle,
                     spec_k=4, engine_kw=dict(slots=1))
    _assert_same_engines(pair)
    on = pair[1][1]
    assert on == off and on[0][-1] == eos


def test_spec_with_prefix_cache_matches_reference(weights):
    """Prefix hits (splice + CoW, suffix prefilled from mid-page) followed
    by prompt-lookup verify rounds, for three requests sharing a template;
    identical with speculation off and to the JAX engine."""
    prompts = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(3)]
    (_, off), _ = _run_pair(weights, prompts, shared=len(SHARED), spec_decode="off")
    pair = _run_pair(weights, prompts, shared=len(SHARED), prefix_cache=True,
                     spec_decode="prompt_lookup")
    _assert_same_engines(pair)
    te, to = pair[1]
    assert to == off
    assert te.stats["prefix_hits"] == 2 and te.stats["spec_rounds"] > 0


# ------------------------------------------------------- served query -----


def test_served_legal_query_spec_prefix_identical(weights):
    """The served legal query with prefix_cache=True and
    spec_decode="prompt_lookup", spec_k=4: rows, ledger token columns,
    engine counters, ServedStats, scheduler counters and every request's
    tokens equal the JAX package's."""
    jcfg, jparams, tcfg, tparams, proj = weights
    kw = dict(slots=4, max_len=1024, prefix_cache=True,
              spec_decode="prompt_lookup", spec_k=4)
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
    assert teng.stats["prefix_hits"] > 0 and teng.stats["spec_rounds"] > 0
    assert teng.stats["spec_rounds"] == teng.stats["decode_steps"]
    assert tex.stats.draft_tokens == teng.stats["draft_tokens"] > 0
