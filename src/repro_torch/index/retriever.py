"""Two-level index + evidence-augmented retrieval (paper §4), plus the
ablation/baseline retrieval modes used by the benchmark suite.

Modes:
  quest        two-level index + evidence-augmented segment retrieval
  segment_only no document-level filter (Fig. 8-a ablation)
  no_evidence  query-attr embedding only, no evidence (Fig. 8-b ablation)
  llm_evidence synthetic (template/"LLM"-generated) evidence only (Fig. 8-b)
  rag_topk     classic RAG: top-k segments by query embedding, no doc level
  fulldoc      Lotus-like: the whole document is the "segment"
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.tokens import count_tokens
from repro_torch.device import resolve_device
from .embedder import HashedEmbedder
from .kmeans import kmeans
from .segmenter import Segment, key_sentences, segment_document
from .vector_index import ExactIndex, IVFIndex


def synth_evidence_texts(attr: str, description: str) -> list[str]:
    """LLM-synthesized-evidence stand-in (paper: prompt the LLM for ~20
    representative segments when the sample yields none)."""
    a = attr.replace("_", " ")
    return [
        description,
        f"The {a} is reported as 42.",
        f"Its {a} was 17 according to the records.",
        f"{a.title()}: Example Value.",
        f"With a {a} of 23, it ranks among the highest.",
        f"The {a} of the subject is Example.",
    ]


@dataclass
class _AttrState:
    evidence_texts: list = field(default_factory=list)
    evidence_docs: list = field(default_factory=list)  # provenance, parallel
    evidence_emb: np.ndarray | None = None
    probes: np.ndarray | None = None       # kmeans centers
    probe_radii: np.ndarray | None = None  # per-cluster radii (beyond-paper)
    gamma: float = 0.9


class TwoLevelRetriever:
    def __init__(self, corpus, embedder: HashedEmbedder | None = None, *,
                 mode: str = "quest", evidence_k: int = 3,
                 tau_init: float = 1.7, gamma_init: float = 1.25,
                 rag_k: int = 3, threshold_slack: float = 0.1,
                 per_evidence_radius: bool = True,
                 cluster_radius_floor: float = 1.3,
                 approx_threshold: int = 2048,
                 ivf_n_lists: int = 64, ivf_nprobe: int = 8,
                 refit_idf: bool = True, device=None):
        """device: where the embedder's projection, k-means and the
        indexes' top-k run (None = the CUDA device)."""
        self.corpus = corpus
        self.device = resolve_device(device)
        self.embedder = embedder or HashedEmbedder(device=self.device)
        self.mode = mode
        self.evidence_k = evidence_k
        self.tau_init = tau_init
        self.gamma_init = gamma_init
        self.rag_k = rag_k
        self.slack = threshold_slack
        self.per_evidence_radius = per_evidence_radius and mode == "quest"
        self.cluster_radius_floor = cluster_radius_floor
        # stores at/above this many vectors use the approximate IVF index
        # (exact below it — small corpora keep bit-identical retrieval)
        self.approx_threshold = approx_threshold
        self.ivf_n_lists = ivf_n_lists
        self.ivf_nprobe = ivf_nprobe
        # refit_idf=False builds on the embedder's existing idf — the
        # rebuild-from-scratch parity oracle of a live corpus must share the
        # live retriever's frozen idf (live mutation never refits; DESIGN.md
        # §17), so the rebuilt embeddings stay byte-identical.
        self.refit_idf = refit_idf
        self._version = 0
        self._attr_state: dict = {}         # (table, attr) -> _AttrState
        self._tau: dict = {}                # table -> refined tau
        self._doc_center: dict = {}         # table -> evidence-centered query emb
        self._query_emb_cache: dict = {}
        self._seg_cache: dict = {}          # (doc, attr, version) -> [Segment]
        self._margin_cache: dict = {}       # (doc, attr, table, version) -> margin
        # beyond-paper: re-center the document-level query on the summaries
        # of known-relevant sampled docs (evidence augmentation applied to
        # the doc level, symmetric to the paper's segment-level evidence).
        # Disable for the paper-faithful ablation.
        self.doc_evidence = mode == "quest"
        self._build()

    def fork(self) -> "TwoLevelRetriever":
        """Per-query session: shares the (expensive, query-independent)
        indexes but gets fresh evidence/threshold state — query executions
        must not contaminate each other (paper: evidence is collected per
        query during its sampling phase)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._attr_state = {}
        new._tau = {}
        new._doc_center = {}
        new._seg_cache = {}
        new._margin_cache = {}
        new._version = 0
        return new

    # ------------------------------------------------------------- build --

    def _make_index(self, embs: np.ndarray, ids: list):
        """Exact store below `approx_threshold` vectors, IVF at corpus
        scale — both satisfy the same batched search contract."""
        if len(ids) >= self.approx_threshold:
            return IVFIndex(embs, ids, n_lists=self.ivf_n_lists,
                            nprobe=self.ivf_nprobe, device=self.device)
        return ExactIndex(embs, ids, device=self.device)

    def _build(self):
        self.doc_segments: dict = {}
        self.seg_index: dict = {}
        doc_ids, summaries = [], []
        for doc_id, doc in self.corpus.docs.items():
            segs = segment_document(doc_id, doc.text, self.embedder)
            self.doc_segments[doc_id] = segs
            doc_ids.append(doc_id)
            summaries.append(key_sentences(doc.text))
        # idf over the whole segment collection sharpens domain separation
        if self.refit_idf:
            all_seg_texts = [s.text for segs in self.doc_segments.values() for s in segs]
            self.embedder.fit(all_seg_texts)
        for doc_id in doc_ids:
            segs = self.doc_segments[doc_id]
            embs = self.embedder.embed([s.text for s in segs])
            self.seg_index[doc_id] = self._make_index(embs, list(range(len(segs))))
        self.doc_index = self._make_index(self.embedder.embed(summaries), doc_ids)
        self._doc_emb = {d: self.doc_index.emb[i] for i, d in enumerate(doc_ids)}

    # ------------------------------------------------------------ helpers --

    def _attr_query_emb(self, table: str, attr: str) -> np.ndarray:
        key = (table, attr)
        if key not in self._query_emb_cache:
            desc = self.corpus.attr_description(table, attr)
            self._query_emb_cache[key] = self.embedder.embed_one(f"{attr} {desc}")
        return self._query_emb_cache[key]

    def _state(self, table: str, attr: str) -> _AttrState:
        return self._attr_state.setdefault((table, attr), _AttrState(gamma=self.gamma_init))

    def _query_emb(self, table: str, attrs: list) -> np.ndarray:
        embs = [self._attr_query_emb(table, a) for a in attrs]
        e = np.mean(embs, axis=0)
        return e / max(np.linalg.norm(e), 1e-6)

    # --------------------------------------------------- document level ----

    def candidate_docs(self, table: str, attrs: list) -> list:
        """Distance-ranked candidates. Modes without a document-level filter
        still return a *ranked* list (they own the same embeddings; they just
        never prune), so the engine's rank-stratified sampling is fair."""
        table_docs = set(self.corpus.tables[table])
        if self.mode == "fulldoc":
            return sorted(table_docs)
        qe = self._query_emb(table, attrs)
        if self.mode in ("segment_only", "rag_topk"):
            # rank, no filter: computed exactly over the stored doc
            # embeddings — an approximate doc_index (IVF at scale) must not
            # silently drop the unprobed documents these modes never prune
            docs = sorted(table_docs)
            dist = np.linalg.norm(
                np.stack([self._doc_emb[d] for d in docs]) - qe[None], axis=1)
            return [docs[i] for i in np.argsort(dist, kind="stable")]
        tau = self._tau.get(table, self.tau_init)
        center = self._doc_center.get(table, qe)
        ids, _ = self.doc_index.range_search(center, tau)
        return [d for d in ids if d in table_docs]

    def refine_candidates(self, table: str, attrs: list) -> list:
        return self.candidate_docs(table, attrs)

    # ----------------------------------------------------- evidence --------

    def add_evidence(self, table: str, attr: str, segments: list, doc_id=None):
        """`doc_id` records provenance: under a live corpus, evidence
        collected from a document that later mutates must be dropped
        (`absorb_doc_churn`), and provenance is what identifies it."""
        if self.mode in ("no_evidence", "rag_topk", "fulldoc", "llm_evidence"):
            return
        st = self._state(table, attr)
        st.evidence_texts.extend(segments)
        st.evidence_docs.extend([doc_id] * len(segments))
        self._version += 1

    def reset_table_state(self, table: str) -> None:
        """Drop every piece of per-query-derived state for `table`:
        evidence, probes, refined tau, and the evidence-centered doc query.
        The live cascade calls this when a mutation invalidates the sample
        the state was fitted from (DESIGN.md §17) — the next query re-samples
        and re-fits from scratch, exactly like a fresh session."""
        for key in [k for k in self._attr_state if k[0] == table]:
            del self._attr_state[key]
        self._tau.pop(table, None)
        self._doc_center.pop(table, None)
        self._version += 1

    def absorb_doc_churn(self, doc_id) -> int:
        """Drop evidence that originated in `doc_id` and re-fit the probe
        clusters of every attr that held some — incremental absorption of
        segment churn (the evidence cluster geometry follows the corpus
        without a global rebuild). Returns the number of evidence texts
        dropped."""
        dropped = 0
        for (table, attr), st in list(self._attr_state.items()):
            if doc_id not in st.evidence_docs:
                continue
            keep = [i for i, d in enumerate(st.evidence_docs) if d != doc_id]
            dropped += len(st.evidence_docs) - len(keep)
            st.evidence_texts = [st.evidence_texts[i] for i in keep]
            st.evidence_docs = [st.evidence_docs[i] for i in keep]
            if st.probes is not None:
                # state was finalized: re-fit this attr's probes in place
                self._fit_attr_probes(table, attr)
        if dropped:
            self._version += 1
        return dropped

    def finalize_thresholds(self, table: str, attrs: list, stats):
        """Automatic tau/gamma (paper §4.2 'Setting the Threshold')."""
        self._version += 1
        if self.mode in ("rag_topk", "fulldoc"):
            return
        # tau: from sampled docs that yielded values (D_Q^m, relevant) vs.
        # those that yielded none (D_Q^n, irrelevant) — paper §4.2 rule
        # (max relevant distance + slack), widened to the irrelevant margin
        # when the sample shows a clean gap (sampled max underestimates the
        # population max; the gap midpoint is the safer cut).
        sampled, relevant = set(), set()
        for attr in attrs:
            for doc_id, v in stats.sampled_values.get(attr, {}).items():
                sampled.add(doc_id)
                if v is not None:
                    relevant.add(doc_id)
        irrelevant = sampled - relevant
        if relevant and self.mode != "segment_only":
            qe = self._query_emb(table, attrs)
            if self.doc_evidence:
                c = np.mean([self._doc_emb[d] for d in relevant], axis=0)
                qe = c / max(np.linalg.norm(c), 1e-6)
                self._doc_center[table] = qe
            drel = sorted(float(np.linalg.norm(self._doc_emb[d] - qe)) for d in relevant)
            dmax, dmed = drel[-1], drel[len(drel) // 2]
            # sampled max underestimates the population max: extrapolate by
            # the observed upper spread (clamped), never below paper's +slack
            tau = dmax + min(max(self.slack, 2.0 * (dmax - dmed)), 0.35)
            if irrelevant:
                dmin_irr = min(float(np.linalg.norm(self._doc_emb[d] - qe))
                               for d in irrelevant)
                tau = max(tau, dmin_irr - self.slack)
            self._tau[table] = tau
        # gamma_i per attr + evidence clustering
        for attr in attrs:
            self._fit_attr_probes(table, attr)

    def _fit_attr_probes(self, table: str, attr: str) -> None:
        """(Re-)fit one attr's probe clusters from its current evidence —
        the per-attr tail of `finalize_thresholds`, also invoked standalone
        by `absorb_doc_churn` when live mutations drop evidence texts."""
        st = self._state(table, attr)
        texts = st.evidence_texts
        if self.mode == "llm_evidence" or (self.mode == "quest" and not texts):
            texts = synth_evidence_texts(attr, self.corpus.attr_description(table, attr))
            st.evidence_texts = texts
            st.evidence_docs = [None] * len(texts)
        if self.mode == "no_evidence" or not texts:
            st.probes = self._attr_query_emb(table, attr)[None]
            st.gamma = self.gamma_init
            return
        embs = self.embedder.embed(texts)
        st.evidence_emb = embs
        centers, assign = kmeans(embs, min(self.evidence_k, len(texts)), seed=7,
                                 device=self.device)
        norms = np.maximum(np.linalg.norm(centers, axis=1, keepdims=True), 1e-6)
        st.probes = centers / norms
        # Beyond-paper (DESIGN.md §8): *per-cluster* radii. The paper's
        # global gamma = max pairwise evidence distance explodes when
        # evidence spans several phrasing templates (it then swallows
        # whole documents on long corpora); each k-means cluster is one
        # template, whose members sit tightly around their center.
        if self.per_evidence_radius:
            radii = []
            for j in range(len(centers)):
                members = embs[assign == j]
                if len(members):
                    dj = np.sqrt(np.maximum(
                        ((members - st.probes[j]) ** 2).sum(-1), 0.0)).max()
                else:
                    dj = 0.0
                radii.append(max(dj + self.slack, self.cluster_radius_floor))
            st.probe_radii = np.asarray(radii)
        if len(embs) >= 2:
            d = np.sqrt(np.maximum(
                ((embs[:, None] - embs[None]) ** 2).sum(-1), 0.0))
            # paper rule, floored at gamma_init: a tight sample must not
            # collapse the radius (used when per_evidence_radius=False)
            st.gamma = max(float(d.max()) + self.slack, self.gamma_init)
        else:
            st.gamma = self.gamma_init

    # ------------------------------------------------------ segment level --

    def _probes_for(self, table: str, attr: str):
        """(probes (P, D), radii length-P) for quest-family modes: evidence
        cluster centers + the base query embedding ("evidence zero") — the
        merge-and-dedup of paper §4.2 across all probes."""
        st = self._state(table, attr)
        qe = self._attr_query_emb(table, attr)
        if st.probes is None:
            return qe[None], [self.gamma_init]
        probes = np.concatenate([st.probes, qe[None]], axis=0)
        if self.per_evidence_radius and st.probe_radii is not None:
            radii = list(st.probe_radii) + [self.gamma_init]
        else:
            radii = [st.gamma] * len(probes)
        return probes, radii

    def _segments_for(self, doc_id, attr: str, table: str | None = None) -> list[Segment]:
        doc = self.corpus.docs[doc_id]
        table = table or doc.table   # evidence state belongs to the QUERY table
        segs = self.doc_segments[doc_id]
        if self.mode == "fulldoc":
            return [Segment(doc_id, -1, doc.text, count_tokens(doc.text))]
        idx = self.seg_index[doc_id]
        if self.mode == "rag_topk":
            (ids, _), = idx.search(self._attr_query_emb(table, attr), self.rag_k)
            return [segs[i] for i in sorted(ids)]
        probes, radii = self._probes_for(table, attr)
        hit: set = set()
        for pe, rad in zip(probes, radii):
            ids, _ = idx.range_search(pe, rad)
            hit.update(ids)
        return [segs[i] for i in sorted(hit)]

    def prefetch_segments(self, pairs) -> None:
        """Batched retrieval (DESIGN.md §9): fill the segment cache for many
        (doc_id, attr, table) pairs at once. All probes of all requested
        attributes of one document go through a single vectorized
        distance+rank pass (`range_search_many`) instead of one range search
        per probe — per query the hits are identical to `segments`."""
        todo: dict = {}
        for doc_id, attr, table in pairs:
            key = (doc_id, attr, table, self._version)
            if key not in self._seg_cache and (doc_id, attr, table) not in todo:
                todo[(doc_id, attr, table)] = key
        by_doc: dict = {}
        for (doc_id, attr, table), key in todo.items():
            if self.mode in ("fulldoc", "rag_topk"):
                self._seg_cache[key] = self._segments_for(doc_id, attr, table)
            else:
                by_doc.setdefault(doc_id, []).append((attr, table, key))
        for doc_id, entries in by_doc.items():
            segs = self.doc_segments[doc_id]
            idx = self.seg_index[doc_id]
            owners, probes_all, radii_all = [], [], []
            for j, (attr, table, _key) in enumerate(entries):
                t = table or self.corpus.docs[doc_id].table
                probes, radii = self._probes_for(t, attr)
                owners.extend([j] * len(probes))
                probes_all.append(probes)
                radii_all.extend(radii)
            res = idx.range_search_many(np.concatenate(probes_all, axis=0),
                                        radii_all)
            hits: list[set] = [set() for _ in entries]
            for j, (ids, _d) in zip(owners, res):
                hits[j].update(ids)
            for (attr, table, key), hit in zip(entries, hits):
                self._seg_cache[key] = [segs[i] for i in sorted(hit)]

    def segments(self, doc_id, attr: str, table: str | None = None) -> list[str]:
        key = (doc_id, attr, table, self._version)
        if key not in self._seg_cache:
            self._seg_cache[key] = self._segments_for(doc_id, attr, table)
        return [s.text for s in self._seg_cache[key]]

    def segment_tokens(self, doc_id, attr: str, table: str | None = None) -> int:
        key = (doc_id, attr, table, self._version)
        if key not in self._seg_cache:
            self._seg_cache[key] = self._segments_for(doc_id, attr, table)
        return sum(s.tokens for s in self._seg_cache[key])

    def score_margin(self, doc_id, attr: str,
                     table: str | None = None):
        """Normalized retrieval confidence in [0, 1] for (doc, attr) —
        the difficulty-estimation signal of DESIGN.md §18: how far inside
        the attribute's probe radii the document's best segment sits
        (1 = dead-center on a known phrasing template, 0 = scraping the
        radius or outside every probe). `rag_topk` has no radii, so its
        margin is measured against `gamma_init`; `fulldoc` retrieval has
        no segment ranking at all and returns None (neutral). Cached per
        index version, so live mutations invalidate exactly like the
        segment cache."""
        doc = self.corpus.docs.get(doc_id)
        if doc is None or doc_id not in self.seg_index:
            return None
        table = table or doc.table
        key = (doc_id, attr, table, self._version)
        if key in self._margin_cache:
            return self._margin_cache[key]
        idx = self.seg_index[doc_id]
        margin = None
        if self.mode != "fulldoc" and len(idx):
            if self.mode == "rag_topk":
                probes = self._attr_query_emb(table, attr)[None]
                radii = [self.gamma_init]
            else:
                probes, radii = self._probes_for(table, attr)
            best = None
            for (ids, dists), rad in zip(idx.search(probes, 1), radii):
                if len(ids) and rad > 0:
                    m = (rad - float(dists[0])) / rad
                    best = m if best is None else max(best, m)
            if best is not None:
                margin = min(1.0, max(0.0, best))
        self._margin_cache[key] = margin
        return margin
