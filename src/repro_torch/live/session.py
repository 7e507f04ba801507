"""LiveSession: corpus mutations interleaved with in-flight queries
(DESIGN.md §17).

Snapshot semantics — a query's rows always reflect exactly one corpus
state, never a torn mix:

  * `ingest/update/delete` on the session queue the mutation; it applies
    immediately when it can, otherwise at the top of the next `_step`.
  * a mutation may not apply while any in-flight query has already
    emitted rows — those queries keep running to completion on the
    pre-mutation snapshot (the mutation defers until they drain).
  * in-flight queries that have *not* emitted rows restart: their
    coroutine is closed, sampling reservations roll back, and a fresh
    `QueryRun` is built with the same seed on the same handle/ledger —
    so they execute entirely on the post-mutation snapshot (restart cost
    is honestly charged to the same query ledger). Restarts happen
    *before* the mutation lands, so teardown never observes a half-
    mutated corpus.
  * the `InvalidationCascade` fires as part of applying the mutation
    (listener order: incremental index first, cascade second), so by the
    time restarted queries resume, every stale cache/sample/prefix entry
    is gone.
"""
from __future__ import annotations

from repro_torch.core.session import Session

from .invalidate import InvalidationCascade


class LiveSession(Session):
    """Session over a LiveCorpus-backed retriever/extractor. Mutations go
    through the session (`session.update(...)` etc.) so they serialize
    correctly against in-flight queries; each returns its MutationRecord,
    or None when deferred behind row-emitting queries (it applies — in
    order — once they drain)."""

    def __init__(self, live_corpus, retriever, extractor, *,
                 sample_policy: str = "exact", **kwargs):
        super().__init__(retriever, extractor, **kwargs)
        self.live = live_corpus
        prefix_caches = []
        engine = getattr(extractor, "engine", None)
        pc = getattr(engine, "prefix_cache", None) if engine is not None else None
        if pc is not None:
            prefix_caches.append(pc)
        self.cascade = InvalidationCascade(live_corpus, self,
                                          sample_policy=sample_policy,
                                          prefix_caches=prefix_caches)
        self._pending_mutations: list = []
        self.live_stats = {"mutations_applied": 0, "mutations_deferred": 0,
                           "query_restarts": 0}

    # ---------------------------------------------------------- mutations --

    def ingest(self, *args, **kwargs):
        return self._enqueue("ingest", args, kwargs)

    def update(self, *args, **kwargs):
        return self._enqueue("update", args, kwargs)

    def delete(self, *args, **kwargs):
        return self._enqueue("delete", args, kwargs)

    def _enqueue(self, op, args, kwargs):
        self._pending_mutations.append((op, args, kwargs))
        recs = self._apply_pending()
        return recs[-1] if recs else None

    def _apply_pending(self):
        """Apply queued mutations if no in-flight query has emitted rows;
        restart the (row-less) in-flight queries first so none observes a
        half-mutated corpus. Returns the applied MutationRecords, or None
        when deferred."""
        if not self._pending_mutations:
            return None
        if any(h._rows for h in self._active):
            self.live_stats["mutations_deferred"] += 1
            self.tracer.instant("live.mutation_deferred", kind="live",
                                pending=len(self._pending_mutations))
            return None
        for h in self._active:
            h.gen.close()
            self._release(h)
            h.acquired.clear()
            h._make_run()
            self.live_stats["query_restarts"] += 1
            self.tracer.instant("live.query_restart", kind="live", qid=h.qid)
        recs = []
        pending, self._pending_mutations = self._pending_mutations, []
        for op, args, kwargs in pending:
            with self.tracer.span("live.mutation", kind="live", op=op):
                recs.append(getattr(self.live, op)(*args, **kwargs))
            self.live_stats["mutations_applied"] += 1
        return recs

    # -------------------------------------------------------------- hooks --

    def _step(self) -> bool:
        self._apply_pending()
        return super()._step()

    def _publish_sample(self, h, sample) -> None:
        # stamp the sampling investment with the corpus version it was
        # taken at: exact invalidation checks staleness by seq, and the
        # bench asserts no row ever came from a stale-stamped sample
        sample.version = self.live.seq
        super()._publish_sample(h, sample)
