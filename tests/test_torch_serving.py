"""A served QUEST query end to end on the port against the JAX package:
`Session.prepare(q).submit()` -> sampling -> per-document plans ->
`BatchScheduler` rounds -> `TwoLevelRetriever` -> `ServedExtractor` ->
paged `ServingEngine`, with bridged SMOKE qwen2.5-3b weights and the JAX
embedder's projection. Rows, ledger token columns, engine counters,
`ServedStats`, scheduler counters and every request's generated tokens
must be identical."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

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
from repro.models import init_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.index.retriever import TwoLevelRetriever  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

LEDGER_COLUMNS = ("input_tokens", "output_tokens", "llm_calls", "extractions",
                  "per_phase", "per_attr", "per_attr_calls", "batches",
                  "batched_extractions", "max_batch")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config("qwen2.5-3b").replace(vocab_size=lm_data.VOCAB)
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    proj = np.asarray(JaxEmbedder()._proj)
    return jcfg, jparams, tcfg, tparams, proj


def _legal(mod, n=20):
    """The first n legal cases. The sampling phase takes at least 12
    documents whole, so n = 20 leaves 8 for per-document plans and their
    segment retrieval."""
    full = mod.make_legal_corpus(seed=1)
    return full.subset(sorted(full.docs)[:n])


def _mini_swde(mod, n_per_table=8):
    full = mod.make_swde_corpus()
    uni = [d for d in sorted(full.docs) if "universities" in d][:n_per_table]
    lap = [d for d in sorted(full.docs) if "laptops" in d][:n_per_table]
    return full.subset(uni + lap)


def _legal_query(core):
    return core.Query(tables=["cases"], select=[("cases", "case_number")],
                      where=core.conj(core.Filter("year", ">=", 2015, table="cases"),
                                      core.Filter("charges", ">", 3, table="cases")))


def _swde_query(core):
    return core.Query(tables=["universities"],
                      select=[("universities", "university_name")],
                      where=core.Filter("tuition", "<", 30000, table="universities"))


def _run_jax(weights, corpus, query):
    jcfg, jparams, _, _, _ = weights
    eng = JaxEngine(jcfg, jparams, slots=4, max_len=1024)
    ex = JaxServed(corpus, eng, max_new=6)
    sess = jcore.Session(JaxRetriever(corpus), ex, batch_size=4)
    res = sess.prepare(query).submit().result()
    return res, eng, ex, sess


def _run_torch(weights, corpus, query):
    _, _, tcfg, tparams, proj = weights
    eng = ServingEngine(tcfg, tparams, slots=4, max_len=1024, device="cpu")
    ex = ServedExtractor(corpus, eng, max_new=6)
    ret = TwoLevelRetriever(corpus, embedder=HashedEmbedder(proj=proj, device="cpu"),
                            device="cpu")
    sess = tcore.Session(ret, ex, batch_size=4)
    res = sess.prepare(query).submit().result()
    return res, eng, ex, sess


def _assert_identical(a, b):
    (ra, ea, xa, sa), (rb, eb, xb, sb) = a, b
    assert ra.rows, "the query must return rows"
    assert ra.rows == rb.rows
    for col in LEDGER_COLUMNS:
        assert getattr(ra.ledger, col) == getattr(rb.ledger, col), col
    assert dict(ea.stats) == dict(eb.stats)
    assert dataclasses.asdict(xa.stats) == dataclasses.asdict(xb.stats)
    assert sa.scheduler.stats.snapshot() == sb.scheduler.stats.snapshot()
    assert {r: q.out for r, q in ea.finished.items()} == \
        {r: q.out for r, q in eb.finished.items()}


def test_served_legal_query_identical(weights, monkeypatch):
    """Legal documents hold ~300 segments each, so every per-document
    segment search goes through the port's top-k path (N >= 256)."""
    sizes = []
    real = ops.topk_l2

    def counting(db, q, k, *, device):
        sizes.append(len(db))
        return real(db, q, k, device=device)

    monkeypatch.setattr(ops, "topk_l2", counting)
    got = _run_torch(weights, _legal(tcorpus), _legal_query(tcore))
    want = _run_jax(weights, _legal(jcorpus), _legal_query(jcore))
    _assert_identical(want, got)
    assert sizes and min(sizes) >= 256
    assert got[1].stats["decode_steps"] > 0 and got[1].stats["prefill_chunks"] > 0


def test_served_mini_swde_query_identical(weights):
    got = _run_torch(weights, _mini_swde(tcorpus), _swde_query(tcore))
    want = _run_jax(weights, _mini_swde(jcorpus), _swde_query(jcore))
    _assert_identical(want, got)


def test_unported_options_raise(weights):
    _, _, tcfg, tparams, _ = weights
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        ServingEngine(tcfg, tparams, device="cpu", mesh=object())


def test_engine_lifecycle(weights):
    """cancel / poll / drain_slot / strict run on the port's engine."""
    from repro_torch.serving.engine import Request, RunTruncated
    _, _, tcfg, tparams, _ = weights
    eng = ServingEngine(tcfg, tparams, slots=2, max_len=128, device="cpu")
    reqs = [Request(rid=i, prompt=list(range(10 + i, 60 + i)), max_new=4)
            for i in range(4)]
    eng.submit_many(reqs)
    assert eng.cancel(3) and eng.poll(3).error == "cancelled"
    eng.step()
    slot = next(iter(eng.active))
    eng.drain_slot(slot)
    assert eng.stats["evictions"] == 1
    with pytest.raises(RunTruncated):
        eng.run(max_steps=1)
    done = eng.run()
    assert sorted(done) == [0, 1, 2]
    assert all(len(done[r].out) == 4 for r in done)
    assert eng.alloc.used_pages == 0


def test_page_allocator_matches_reference(weights):
    """All-or-nothing allocation, ref-counting, double-free detection, and
    the byte accounting that enters kv_bytes_peak, against the JAX
    package's allocator on the same config."""
    from repro.models.cache_ops import PageAllocator as JaxAllocator
    from repro_torch.models.cache_ops import (PAGE_SINK, PageAllocator,
                                              PagePoolExhausted, cache_nbytes)
    jcfg, _, tcfg, _, _ = weights
    ja, ta = JaxAllocator(jcfg, 9, 16), PageAllocator(tcfg, 9, 16, device="cpu")
    assert ta.page_nbytes == ja.page_nbytes
    assert {k: tuple(v.shape) for k, v in ta.pools.items()} == \
        {k: tuple(v.shape) for k, v in ja.pools.items()}
    ids = ta.alloc(5)
    assert ids == ja.alloc(5) and PAGE_SINK not in ids
    with pytest.raises(PagePoolExhausted):
        ta.alloc(4)                                   # 3 left: nothing taken
    assert ta.free_pages == 3 and ta.nbytes_in_use == ja.nbytes_in_use
    ta.retain(ids[:2])
    ta.release(ids)
    assert ta.used_pages == 2
    ta.release(ids[:2])
    assert ta.used_pages == 0
    with pytest.raises(RuntimeError, match="double free"):
        ta.release(ids[:1])
    with pytest.raises(RuntimeError, match="retain of free page"):
        ta.retain(ids[:1])
    pos = torch.zeros((4,), dtype=torch.int32)
    assert cache_nbytes({"pos": pos}) == 16           # int32, as in JAX
