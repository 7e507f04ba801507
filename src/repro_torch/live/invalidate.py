"""Exact invalidation cascade (DESIGN.md §17): one corpus mutation fans out
to every caching layer that might hold state derived from the mutated
document, and *only* that state.

Layers touched, in order:

  * session attr-value cache + escalation memo — entries keyed
    `(doc_id, attr)` for the mutated doc drop (`Session.drop_doc_state`);
    every other document's cached values survive (they are byte-identical
    to fresh extraction, so keeping them is row-invisible). Under a
    cascade extractor (DESIGN.md §18) the same call drops the doc's
    memoized difficulty estimates and tier-escalation memo entries —
    stale routing evidence; the doc gets a fresh shot at the small tier.
  * sampling investments — under the default `sample_policy="exact"`,
    *every* table's `TableSample` drops on any mutation (rank-stratified
    sampling depends on the candidate distance ranking, which any
    ingest/update/delete can reshuffle), together with the retriever's
    derived per-table thresholds/evidence (`reset_table_state`) — the next
    query re-samples exactly like a fresh session, which is what makes
    interleaved runs byte-match the rebuilt oracle. `"sampled_only"`
    trades that guarantee for cheapness: only samples that actually
    contain the mutated doc drop, and the retriever merely absorbs the
    doc's evidence churn (`absorb_doc_churn`).
  * served prefix caches — entries whose prompt embeds the mutated
    document's text release (`PrefixCache.invalidate_docs`), returning
    their pages to the engine's PageAllocator; template-only entries are
    untagged and survive.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.executor import TableSample


@dataclass
class CascadeStats:
    mutations: int = 0
    cache_entries_dropped: int = 0
    escalations_dropped: int = 0
    samples_dropped: int = 0
    samples_retained: int = 0
    evidence_dropped: int = 0
    prefix_entries_dropped: int = 0
    # model cascade (DESIGN.md §18): a mutated doc's memoized difficulty
    # scores and tier-escalation memo entries are stale routing evidence
    difficulty_dropped: int = 0
    tier_memo_dropped: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class InvalidationCascade:
    """Subscribes to a LiveCorpus and routes each mutation through the
    session's caching layers. `sample_policy`: "exact" (parity-grade, the
    default) or "sampled_only" (drop only directly-stale samples)."""

    def __init__(self, live_corpus, session, *, sample_policy: str = "exact",
                 prefix_caches=()):
        if sample_policy not in ("exact", "sampled_only"):
            raise ValueError(f"unknown sample_policy {sample_policy!r}")
        self.live = live_corpus
        self.session = session
        self.sample_policy = sample_policy
        self.prefix_caches = list(prefix_caches)
        self.stats = CascadeStats()
        live_corpus.subscribe(self.on_mutation)

    def register_prefix_cache(self, prefix_cache) -> None:
        if prefix_cache is not None and prefix_cache not in self.prefix_caches:
            self.prefix_caches.append(prefix_cache)

    # ------------------------------------------------------------ cascade --

    def _tables_with_state(self) -> set:
        ret = self.session.retriever
        tables = set(self.session._samples)
        tables.update(t for t, _a in getattr(ret, "_attr_state", {}))
        tables.update(getattr(ret, "_tau", {}))
        return tables

    def on_mutation(self, record, old_doc, new_doc) -> None:
        s = self.stats
        s.mutations += 1
        doc_id = record.doc_id
        with self.session.tracer.span("live.invalidate", kind="live",
                                      op=record.op, doc=str(doc_id)):
            self._cascade(doc_id)

    def _cascade(self, doc_id) -> None:
        s = self.stats
        dropped = self.session.drop_doc_state(doc_id)
        s.cache_entries_dropped += dropped["cache_entries"]
        s.escalations_dropped += dropped["escalations"]
        s.difficulty_dropped += dropped.get("difficulty_estimates", 0)
        s.tier_memo_dropped += dropped.get("tier_memo", 0)
        ret = self.session.retriever
        for table in sorted(self._tables_with_state()):
            if self.sample_policy == "exact":
                stale = True
            else:
                sample = self.session._samples.get(table)
                stale = (isinstance(sample, TableSample)
                         and doc_id in sample.sampled)
            if stale:
                if self.session.invalidate_table_sample(table):
                    s.samples_dropped += 1
                if hasattr(ret, "reset_table_state"):
                    ret.reset_table_state(table)
            else:
                s.samples_retained += 1
        if self.sample_policy != "exact" and hasattr(ret, "absorb_doc_churn"):
            s.evidence_dropped += ret.absorb_doc_churn(doc_id)
        for pc in self.prefix_caches:
            s.prefix_entries_dropped += pc.invalidate_docs([doc_id])
