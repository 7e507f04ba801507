"""Incremental index maintenance over a LiveCorpus (DESIGN.md §17).

`LiveRetriever` is a `TwoLevelRetriever` that subscribes to a LiveCorpus
and absorbs each mutation in place:

  * stability-driven re-segmentation — the mutated document re-segments,
    but embeddings go through a `CachedEmbedder` keyed by content hash, so
    only the sentences/segments whose *text actually changed* hit the
    embedder; everything untouched reuses its cached vector. The
    `reembedded_bytes / edited_bytes` ratio is the subsystem's acceptance
    metric (bench_live_corpus).
  * index maintenance — the doc-level index drops the old summary row and
    adds the new one (tombstones + bounded compaction in ExactIndex,
    per-list re-clustering in IVFIndex — never a global rebuild); the
    per-doc segment index rebuilds for the one mutated document only.
  * idf freeze — the embedder fits once, at construction, over the seed
    corpus sentences, and never refits on mutation. `rebuild_reference()`
    hands out a static `TwoLevelRetriever` over the current snapshot with
    a *clone* of that frozen embedder (`refit_idf=False`), which makes the
    rebuilt-from-scratch index byte-comparable to the live one — the
    parity oracle every live test and benchmark checks against.
"""
from __future__ import annotations

import numpy as np

from repro_torch.index.embedder import HashedEmbedder
from repro_torch.index.retriever import TwoLevelRetriever
from repro_torch.index.segmenter import key_sentences, segment_document
from repro_torch.data.tokens import split_sentences

from .log import sha_text


class CachedEmbedder:
    """Content-hash memo in front of an embedder. `segment_document` embeds
    per-sentence and `_build` embeds per-segment, so after a localized edit
    every unchanged sentence/segment resolves from the memo — the embedder
    only sees the bytes the edit actually touched."""

    def __init__(self, base: HashedEmbedder | None = None):
        self.base = base or HashedEmbedder()
        self._memo: dict = {}          # sha(text) -> vector
        self.reembedded_bytes = 0
        self.reused_bytes = 0
        self.reembedded_texts = 0
        self.reused_texts = 0

    @property
    def dim(self) -> int:
        return self.base.dim

    def reset_counters(self) -> None:
        self.reembedded_bytes = 0
        self.reused_bytes = 0
        self.reembedded_texts = 0
        self.reused_texts = 0

    def fit(self, texts):
        self._memo.clear()             # idf changed: every vector is stale
        self.base.fit(texts)
        return self

    def embed(self, texts) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        keys = [sha_text(t) for t in texts]
        miss = [(i, t) for i, (k, t) in enumerate(zip(keys, texts))
                if k not in self._memo]
        if miss:
            fresh = self.base.embed([t for _i, t in miss])
            for (i, t), v in zip(miss, fresh):
                self._memo[keys[i]] = v
                self.reembedded_bytes += len(t.encode("utf-8"))
                self.reembedded_texts += 1
        hit = len(texts) - len(miss)
        if hit:
            missed = {i for i, _t in miss}
            for i, t in enumerate(texts):
                if i not in missed:
                    self.reused_bytes += len(t.encode("utf-8"))
            self.reused_texts += hit
        return np.stack([self._memo[k] for k in keys])

    def embed_one(self, text: str) -> np.ndarray:
        return self.embed([text])[0]


def clone_embedder(src) -> HashedEmbedder:
    """Fresh HashedEmbedder sharing `src`'s projection and a *copy* of its
    idf — embeds byte-identically to `src` without aliasing mutable
    state (the clone can be refit without touching the original)."""
    base = src.base if isinstance(src, CachedEmbedder) else src
    clone = HashedEmbedder(dim=base.dim, device=base.device)
    clone._proj = base._proj           # never written in place: share
    clone._idf = base._idf.copy()
    return clone


class LiveRetriever(TwoLevelRetriever):
    """TwoLevelRetriever wired to a LiveCorpus. Construction fits the
    embedder once over the seed corpus *sentences* (not post-segmentation
    segments: segmentation itself consumes embeddings, so the fit must
    precede it for re-segmentation under the frozen idf to reproduce the
    seed segmentation of unchanged text), then subscribes `apply` so every
    mutation maintains the indexes incrementally."""

    def __init__(self, live_corpus, embedder: HashedEmbedder | None = None,
                 **kwargs):
        self.live = live_corpus
        cached = CachedEmbedder(embedder or HashedEmbedder(device=kwargs.get("device")))
        sents = [s for doc in live_corpus.docs.values()
                 for s in split_sentences(doc.text)]
        cached.fit(sents)
        kwargs.pop("refit_idf", None)
        super().__init__(live_corpus, cached, refit_idf=False, **kwargs)
        live_corpus.subscribe(self.apply)

    # ------------------------------------------------- incremental apply --

    def apply(self, record, old_doc, new_doc) -> None:
        """Absorb one mutation: delete drops the doc's rows, ingest/update
        re-segment the one document and swap its index rows in place."""
        doc_id = record.doc_id
        if record.op == "delete":
            self.doc_segments.pop(doc_id, None)
            self.seg_index.pop(doc_id, None)
            if doc_id in self._doc_emb:
                self.doc_index.remove([doc_id])
                del self._doc_emb[doc_id]
        else:
            segs = segment_document(doc_id, new_doc.text, self.embedder)
            self.doc_segments[doc_id] = segs
            embs = self.embedder.embed([s.text for s in segs])
            self.seg_index[doc_id] = self._make_index(
                embs, list(range(len(segs))))
            e = self.embedder.embed_one(key_sentences(new_doc.text))
            if doc_id in self._doc_emb:
                self.doc_index.remove([doc_id])
            self.doc_index.add(e[None], [doc_id])
            self._doc_emb[doc_id] = e
        self._version += 1             # segment cache keys include version

    # ------------------------------------------------------ parity oracle --

    def rebuild_reference(self, corpus=None) -> TwoLevelRetriever:
        """Static TwoLevelRetriever rebuilt from scratch over the current
        snapshot (or `corpus`), under a clone of the frozen embedder —
        the byte-parity oracle for the incremental indexes."""
        corpus = corpus if corpus is not None else self.live.snapshot()
        return TwoLevelRetriever(
            corpus, clone_embedder(self.embedder), mode=self.mode,
            evidence_k=self.evidence_k, tau_init=self.tau_init,
            gamma_init=self.gamma_init, rag_k=self.rag_k,
            threshold_slack=self.slack,
            per_evidence_radius=self.per_evidence_radius,
            cluster_radius_floor=self.cluster_radius_floor,
            approx_threshold=self.approx_threshold,
            ivf_n_lists=self.ivf_n_lists, ivf_nprobe=self.ivf_nprobe,
            refit_idf=False, device=self.device)
