"""The port's index layer against the JAX package's: the hashed embedder
(given JAX's projection), k-means, `ExactIndex` / `IVFIndex` rankings (the
top-k path for N >= 256 and the numpy path below it), and the two-level
retriever's segments on a legal subset."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro.data.corpus import make_legal_corpus as jax_legal  # noqa: E402
from repro.index import embedder as jemb  # noqa: E402
from repro.index import kmeans as jkm  # noqa: E402
from repro.index import retriever as jret  # noqa: E402
from repro.index import vector_index as jvi  # noqa: E402
from repro_torch.data.corpus import make_legal_corpus  # noqa: E402
from repro_torch.index import embedder as temb  # noqa: E402
from repro_torch.index import kmeans as tkm  # noqa: E402
from repro_torch.index import retriever as tret  # noqa: E402
from repro_torch.index import vector_index as tvi  # noqa: E402


def _assert_same_hits(got, want):
    """Per query: identical ids in identical order, distances allclose."""
    assert len(got) == len(want)
    for (g_ids, g_d), (w_ids, w_d) in zip(got, want):
        assert list(g_ids) == list(w_ids)
        np.testing.assert_allclose(g_d, w_d, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def embedders():
    corpus = make_legal_corpus(seed=1)
    texts = [s for d in sorted(corpus.docs)[:2]
             for s in corpus.docs[d].text.split(". ")]
    j = jemb.HashedEmbedder().fit(texts)
    t = temb.HashedEmbedder(proj=np.asarray(j._proj), device="cpu").fit(texts)
    return j, t, texts


def test_embedder_matches_with_jax_projection(embedders):
    j, t, texts = embedders
    np.testing.assert_array_equal(t._idf, j._idf)
    ej, et = j.embed(texts), t.embed(texts)
    assert et.dtype == np.float32 and et.shape == ej.shape
    np.testing.assert_allclose(et, ej, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(t.embed_one(texts[3]), ej[3], atol=1e-6, rtol=1e-5)


def test_default_projection_is_seeded_and_device_free():
    a, b = temb.default_projection(), temb.default_projection()
    assert torch.equal(a, b) and a.shape == (temb.N_FEATURES, temb.EMBED_DIM)
    assert abs(float(a.std()) * np.sqrt(temb.EMBED_DIM) - 1.0) < 0.01


def test_kmeans_matches(embedders):
    _, _, texts = embedders
    x = jemb.HashedEmbedder().embed(texts)
    for k, seed in ((3, 7), (16, 0)):
        cj, aj = jkm.kmeans(x, k, seed=seed)
        ct, at = tkm.kmeans(x, k, seed=seed, device="cpu")
        np.testing.assert_array_equal(at, aj)
        np.testing.assert_allclose(ct, cj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [300, 120])      # top-k path, numpy path
def test_exact_index_rankings_match(embedders, n):
    _, t, texts = embedders
    emb = t.embed(texts)[:n]
    rng = np.random.default_rng(0)
    qs = emb[rng.integers(0, n, size=6)] + 0.01 * rng.standard_normal((6, emb.shape[1]))
    qs = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)
    ji, ti = jvi.ExactIndex(emb), tvi.ExactIndex(emb, device="cpu")
    dj, ij = ji._ranked(qs)
    dt, it = ti._ranked(qs)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=1e-5)
    taus = [0.9, 1.1, 1.2, 1.3, 1.4, 2.0]
    _assert_same_hits(ti.range_search_many(qs, taus), ji.range_search_many(qs, taus))
    _assert_same_hits(ti.search(qs, 7), ji.search(qs, 7))
    # maintenance: tombstones are filtered and re-ranked identically
    for idx in (ji, ti):
        idx.remove([3, 5, 8])
        idx.add(emb[:2], [n, n + 1])
    _assert_same_hits(ti.range_search_many(qs, taus), ji.range_search_many(qs, taus))


def test_ivf_index_rankings_match(embedders):
    _, t, texts = embedders
    emb = t.embed(texts)
    assert len(emb) >= 256
    ji = jvi.IVFIndex(emb, n_lists=2, nprobe=2)
    ti = tvi.IVFIndex(emb, n_lists=2, nprobe=2, device="cpu")
    assert [list(x) for x in ti.lists] == [list(x) for x in ji.lists]
    qs = emb[[0, 17, 99]]
    for q in qs:
        rj, dj = ji._ranked_rows(q)
        rt, dt = ti._ranked_rows(q)
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_allclose(dt, dj, atol=1e-5)
    _assert_same_hits(ti.search(qs, 5), ji.search(qs, 5))


def test_retriever_segments_match_on_legal_subset():
    """Segmentation, idf fit, the document index and per-document segment
    retrieval (~300 segments per case: the top-k path) on three cases."""
    jc, tc = jax_legal(seed=1), make_legal_corpus(seed=1)
    ids = sorted(jc.docs)[:3]
    jc, tc = jc.subset(ids), tc.subset(ids)
    jr = jret.TwoLevelRetriever(jc)
    tr = tret.TwoLevelRetriever(
        tc, embedder=temb.HashedEmbedder(proj=np.asarray(jemb.HashedEmbedder()._proj),
                                         device="cpu"), device="cpu")
    for d in ids:
        assert [s.text for s in tr.doc_segments[d]] == [s.text for s in jr.doc_segments[d]]
        assert len(tr.seg_index[d]) >= 256
    attrs = sorted(jc.attr_specs["cases"])
    assert tr.candidate_docs("cases", attrs[:2]) == jr.candidate_docs("cases", attrs[:2])
    for d in ids:
        for a in attrs:
            assert tr.segments(d, a, "cases") == jr.segments(d, a, "cases")
            assert tr.score_margin(d, a, "cases") == pytest.approx(
                jr.score_margin(d, a, "cases"), abs=1e-5)
