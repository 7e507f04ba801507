"""The live corpus (`live/`) on the port against the JAX package: the same
mutation streams through each package's `LiveCorpus`, `LiveRetriever` and
`LiveSession`, the embedders sharing the JAX package's projection. The
incremental indexes (one stream each of `tests/test_live_corpus.py`'s
ExactIndex and IVFIndex streams), the live retriever against its rebuild
across an update, a delete and an ingest, and the served cases on bridged
SMOKE qwen2.5-3b weights: an update between two queries against the
rebuilt oracle, and the doc-first `escalate_batch` whose cached prefix
pages a delete returns to the pool. Ids, rows, ledger columns, live,
invalidation, engine and prefix-cache counters and generated tokens must
be identical; distances within 1e-6."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.live as jlive  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.live as tlive  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.extract.served import ServedExtractor as JaxServed  # noqa: E402
from repro.index import vector_index as jvi  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.extract.served import ServedExtractor  # noqa: E402
from repro_torch.index import vector_index as tvi  # noqa: E402
from repro_torch.index.embedder import HashedEmbedder  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_serving import LEDGER_COLUMNS, weights  # noqa: E402,F401

DIST_TOL = 1e-6


# ---------------------------------------------------- incremental indexes --


def _norm_rows(rng, n, d=16):
    e = rng.normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _index_stream(make, seed, n0, ops):
    """Interleaved add/remove; after every op, what the index answers:
    live ids, tombstones, a top-5 search, a range search and one distance."""
    rng = np.random.default_rng(seed)
    emb = _norm_rows(rng, n0)
    idx = make(emb.copy(), [f"d{i}" for i in range(n0)])
    alive = {f"d{i}" for i in range(n0)}
    next_id, seen = n0, []
    for kind in ops:
        if kind == "add" or len(alive) <= 2:
            nid = f"d{next_id}"
            next_id += 1
            idx.add(_norm_rows(rng, 1), [nid])
            alive.add(nid)
        else:
            victim = sorted(alive)[int(rng.integers(len(alive)))]
            idx.remove([victim])
            alive.discard(victim)
        q = _norm_rows(rng, 1)[0]
        (ids, dists), = idx.search(q, k=min(5, len(alive)))
        r_ids, r_d = idx.range_search(q, 1.0)
        seen.append((sorted(idx.live_ids()), idx.n_tombstones, ids, dists, r_ids, r_d,
                     idx.distance(q, sorted(alive)[0]), dict(idx.maint_stats)))
        if isinstance(idx, tvi.ExactIndex):      # the rows K3 ranks are current
            assert np.array_equal(idx._device_emb().cpu().numpy(), idx.emb)
    return seen


def _same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[1], g[2], g[4], g[7]) == (w[0], w[1], w[2], w[4], w[7])
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=DIST_TOL)
        np.testing.assert_allclose(g[5], w[5], rtol=0, atol=DIST_TOL)
        assert abs(g[6] - w[6]) <= DIST_TOL


STREAM = (0, 12, ["add", "rm", "rm", "add", "rm", "add"])


def test_exact_index_incremental_maintenance():
    _same_answers(_index_stream(lambda e, i: tvi.ExactIndex(e, i, device="cpu"), *STREAM),
                  _index_stream(jvi.ExactIndex, *STREAM))


def test_ivf_index_incremental_maintenance():
    stream = (2, 20, ["add", "add", "rm", "rm", "rm", "rm", "rm", "add"])
    _same_answers(
        _index_stream(lambda e, i: tvi.IVFIndex(e, i, n_lists=4, nprobe=4, seed=0,
                                                device="cpu"), *stream),
        _index_stream(lambda e, i: jvi.IVFIndex(e, i, n_lists=4, nprobe=4, seed=0), *stream))


# --------------------------------------------------- incremental retriever --


def _fresh_subset(mod, full, ids):
    """A subset whose Documents are copies: live mutations land in place."""
    sub = full.subset(ids)
    sub.docs = {d: mod.Document(doc.doc_id, doc.domain, doc.text, dict(doc.truth),
                                dict(doc.spans), doc.tokens, version=doc.version,
                                sha=doc.sha)
                for d, doc in sub.docs.items()}
    return sub


def _retriever(pkg, live, proj):
    if pkg == "jax":
        return jlive.LiveRetriever(live)
    return tlive.LiveRetriever(live, embedder=HashedEmbedder(proj=proj, device="cpu"),
                               device="cpu")


def _retriever_view(live, retr):
    """Doc candidates and per-doc segment hits of the live retriever, each
    equal to its rebuild's, and the live doc index's search."""
    ref = retr.rebuild_reference()
    cands = retr.candidate_docs("players", ["age"])
    assert cands == ref.candidate_docs("players", ["age"])
    segs = {}
    for doc_id in list(live.docs)[:6]:
        segs[doc_id] = retr.segments(doc_id, "age", "players")
        assert segs[doc_id] == ref.segments(doc_id, "age", "players")
    q = retr.embedder.embed_one("player age all stars")
    (ids, dists), = retr.doc_index.search(q, k=5)
    (ref_ids, _), = ref.doc_index.search(q, k=5)
    assert ids == ref_ids
    return cands, segs, ids, dists


def _live_retriever_stream(pkg, proj):
    mod = jcorpus if pkg == "jax" else tcorpus
    live_mod = jlive if pkg == "jax" else tlive
    full = mod.make_wiki_corpus(seed=0)
    players = [d for d in full.docs if full.docs[d].domain == "players"]
    teams = [d for d in full.docs if full.docs[d].domain == "teams"]
    ids = players[:20] + teams[:8]
    live = live_mod.LiveCorpus(_fresh_subset(mod, full, ids))
    retr = _retriever(pkg, live, proj)
    views = [_retriever_view(live, retr)]
    live.update(ids[2], live_mod.render_edit(live, ids[2], "age", 44))
    views.append(_retriever_view(live, retr))
    live.delete(ids[3])
    views.append(_retriever_view(live, retr))
    donor = next(d for d in full.docs if d not in live.docs
                 and full.docs[d].domain == "players")
    live.ingest("players/new1", full.docs[donor].text, "players")
    views.append(_retriever_view(live, retr))
    assert len(retr.doc_index) == len(live.docs)
    if pkg == "torch":
        di = retr.doc_index
        assert np.array_equal(di._device_emb().cpu().numpy(), di.emb)
    emb = retr.embedder
    return views, (emb.reembedded_bytes, emb.reused_bytes, emb.reembedded_texts,
                   emb.reused_texts), dataclasses.asdict(live.stats), \
        live.log.manifest_digest()


def test_live_retriever_matches_rebuild_across_mutations(weights):
    proj = weights[4]
    got = _live_retriever_stream("torch", proj)
    want = _live_retriever_stream("jax", proj)
    assert got[1:] == want[1:]
    for (gc, gs, gi, gd), (wc, ws, wi, wd) in zip(got[0], want[0]):
        assert (gc, gs, gi) == (wc, ws, wi)
        np.testing.assert_allclose(gd, wd, rtol=0, atol=DIST_TOL)


# ------------------------------------------------------------ served path --


def _mini_swde(mod, n=6):
    full = mod.make_swde_corpus()
    return full, [d for d in sorted(full.docs) if "universities" in d][:n]


def _served_stack(weights, pkg, live, *, paged_len=None, **ext_kw):
    """(make engine, engine, extractor) on the live corpus: prefix cache on,
    2 slots, max_len 1024 (or `paged_len` with 16-token pages)."""
    jcfg, jparams, tcfg, tparams, _ = weights
    kw = dict(slots=2, max_len=paged_len or 1024, prefix_cache=True)
    if paged_len:
        kw.update(kv_layout="paged", page_size=16)
    if pkg == "jax":
        def make():
            return JaxEngine(jcfg, jparams, **kw)
        Served = JaxServed
    else:
        def make():
            return ServingEngine(tcfg, tparams, device="cpu", **kw)
        Served = ServedExtractor
    eng = make()
    return make, eng, Served(live, eng, max_new=4, **ext_kw)


def _served_update(weights, pkg):
    mod, core, live_mod = (jcorpus, jcore, jlive) if pkg == "jax" else \
        (tcorpus, tcore, tlive)
    full, ids = _mini_swde(mod)
    live = live_mod.LiveCorpus(_fresh_subset(mod, full, ids))
    retr = _retriever(pkg, live, weights[4])
    make, eng, ext = _served_stack(weights, pkg, live)
    Served = type(ext)
    sess = live_mod.LiveSession(live, retr, ext, batch_size=2)
    assert eng.prefix_cache in sess.cascade.prefix_caches
    q = core.Query(tables=["universities"], select=[("universities", "university_name")],
                   where=core.Filter("tuition", "<", 30000, table="universities"))

    def run_both():
        res = sess.execute(q)
        snap = live.snapshot()
        osess = core.Session(retr.rebuild_reference(snap), Served(snap, make(), max_new=4),
                             batch_size=2)
        rows = sorted(res.rows, key=repr)
        assert rows == sorted(osess.execute(q).rows, key=repr)
        return rows, {c: getattr(res.ledger, c) for c in LEDGER_COLUMNS}

    first = run_both()
    sess.update(ids[0], live_mod.render_edit(live, ids[0], "tuition", 12000))
    second = run_both()
    return first, second, dict(eng.stats), eng.prefix_cache.stats.snapshot(), \
        dataclasses.asdict(sess.cascade.stats), dict(sess.live_stats), \
        dataclasses.asdict(ext.stats), {r: q.out for r, q in eng.finished.items()}


def test_served_interleaved_parity_and_prefix_invalidation(weights):
    assert _served_update(weights, "torch") == _served_update(weights, "jax")


def _delete_releases(weights, pkg):
    mod, live_mod = (jcorpus, jlive) if pkg == "jax" else (tcorpus, tlive)
    full, ids = _mini_swde(mod)
    live = live_mod.LiveCorpus(_fresh_subset(mod, full, ids))
    retr = _retriever(pkg, live, weights[4])
    _, eng, ext = _served_stack(weights, pkg, live, paged_len=512,
                                doc_prefix_escalation=True)
    sess = live_mod.LiveSession(live, retr, ext, batch_size=2)
    free0 = eng.pool_free_pages()
    doc = ids[0]
    text = live.docs[doc].text[:200]
    out = ext.escalate_batch([(doc, "tuition", [text]), (doc, "university_name", [text])])
    pc = eng.prefix_cache
    assert any(doc in e.doc_ids for e in pc._entries.values())
    held = eng.pool_free_pages()
    assert held < free0 and pc.stats.hits >= 1
    sess.delete(doc)
    assert pc.stats.invalidated_entries >= 1
    assert eng.pool_free_pages() == free0
    return out, free0, held, dict(eng.stats), pc.stats.snapshot(), \
        dataclasses.asdict(ext.stats), {r: q.out for r, q in eng.finished.items()}


def test_delete_releases_cached_prefix_pages(weights):
    assert _delete_releases(weights, "torch") == _delete_releases(weights, "jax")
