"""Cross-document batch scheduler for QUEST extraction (DESIGN.md §9).

QUEST's instance-optimized plans are *per document*: each document decides
lazily, filter by filter, which attribute to extract next. That is exactly
wrong for a continuous-batching LLM substrate, which wants many concurrent
requests. The scheduler reconciles the two: per-document plans run as
resumable coroutines (generators yielding `(doc_id, attr, table)` extraction
needs), and the scheduler accumulates the needs of all in-flight documents,
deduplicates them against the engine cache and within the round, retrieves
their segments in one vectorized pass, and submits them to the extractor as
`extract_batch` rounds — so prefill/decode genuinely interleave across
documents while every document keeps its own lazy short-circuit order.

Because batching happens only *across* documents (never reordering the
filters *within* one), result rows and ledger token totals are identical to
serial execution at every batch size (tests/test_batching.py).

Each round's deduplicated needs are additionally *grouped by shared
prompt prefix* — stable-sorted by (attr, table) before chunking — so
same-attribute extractions land in the same engine round and the serving
engine's prefix KV cache (DESIGN.md §10) prefills the shared template
once per group instead of once per document. Grouping only reorders
independent needs within a round, so result rows and ledger token totals
stay identical.

Under a `core.session.Session` (DESIGN.md §11) a round's needs may come
from several concurrent queries: `resolve_round` accepts the merged,
deduplicated needs of all in-flight queries with an `owners` map routing
each charge to the owning query's child ledger, so cross-query needs
share the same extract_batch rounds and (attr, table) prefix groups while
per-query token accounting stays exact.

Knobs: `batch_size` (max extractions per extract_batch round; 1 = the
serial per-extraction path), `queue_depth` (max in-flight documents),
`round_token_budget` (optional latency budget, DESIGN.md §16: a round is
cut when its cumulative *estimated* tokens — retrieved-segment tokens
plus prompt/answer overhead — would exceed the budget, not only when
`batch_size` items accumulate, bounding how long one extract_batch round
can occupy the engine before other work gets a turn; chunk boundaries
never change values or token columns, so the parity bar is unaffected).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from repro_torch.data.tokens import count_tokens
from repro_torch.obs import MetricsRegistry, StatsDict, as_tracer
from repro_torch.obs.metrics import SCHEDULER_STATS

PROMPT_OVERHEAD = 40      # instruction tokens per extraction call
OUTPUT_TOKENS = 12        # answer tokens per extraction call


class SchedulerStats:
    """Scheduler counters, registry-backed (DESIGN.md §19): same attribute
    surface as the old dataclass (`stats.rounds += 1`, `snapshot()`), but
    each field lives in a `scheduler.*` instrument of a `MetricsRegistry`
    — so the counters ride the schema (touching an undeclared field is a
    hard error) and export through the registry's Prometheus exposition.
    Fields: rounds (extract_batch submissions), submitted (extractions
    sent), dedup_hits, cache_hits, empty_retrievals, max_batch."""

    def __init__(self, registry: MetricsRegistry = None):
        object.__setattr__(self, "_d",
                           StatsDict(registry or MetricsRegistry(),
                                     "scheduler", SCHEDULER_STATS))

    def __getattr__(self, key):
        try:
            return self.__dict__["_d"][key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value) -> None:
        self._d[key] = value

    def snapshot(self) -> dict:
        return self._d.snapshot()


class RunQueue:
    """In-flight document coroutines under queue_depth admission control —
    the drive loop shared by `BatchScheduler.run` (single query) and the
    session multiplexer's run barriers (DESIGN.md §11).

    `collect()` returns one round's needs (one per still-blocked
    coroutine). When an entire admitted wave completes without yielding a
    need — e.g. every value was already in the session cache — the next
    wave is admitted and advanced immediately, so a round never comes back
    empty while work remains (returning empty-handed there would read as a
    stall to the caller)."""

    def __init__(self, coroutines: dict, queue_depth: int):
        self.pending = deque(coroutines.items())
        self.live: list = []
        self.results: dict = {}
        self.queue_depth = max(1, int(queue_depth))

    def collect(self, scheduler: "BatchScheduler") -> list:
        while True:
            while self.pending and len(self.live) < self.queue_depth:
                self.live.append(self.pending.popleft())
            needs, blocked = [], []
            for key, gen in self.live:
                need = scheduler._advance(key, gen, self.results)
                if need is not None:
                    needs.append(need)
                    blocked.append((key, gen))
            self.live = blocked
            if needs or self.done:
                return needs

    @property
    def done(self) -> bool:
        return not self.live and not self.pending


class BatchScheduler:
    """Drives per-document coroutines and batches their extraction needs.

    The coroutine protocol: a generator yields `(doc_id, attr, table)` when
    it needs `cache[(doc_id, attr)]` filled; the scheduler resumes it after
    the batched extraction lands. The generator's return value (via
    StopIteration) is its result.
    """

    def __init__(self, retriever, extractor, ledger, cache: dict, *,
                 batch_size: int = 1, queue_depth: int = 32,
                 round_token_budget: Optional[int] = None,
                 tracer=None, metrics: MetricsRegistry = None):
        self.retriever = retriever
        self.extractor = extractor
        self.ledger = ledger
        self.cache = cache
        self.batch_size = max(1, int(batch_size))
        self.queue_depth = max(1, int(queue_depth))
        self.round_token_budget = round_token_budget
        self.tracer = as_tracer(tracer)
        self.stats = SchedulerStats(metrics)

    # ------------------------------------------------------- coroutines ----

    def run(self, coroutines: dict, *, phase: str = "query") -> dict:
        """Drive {key: generator} to completion; returns {key: result}.

        Up to `queue_depth` coroutines are in flight; each round collects one
        pending extraction per blocked coroutine, resolves the deduplicated
        set in `batch_size` chunks, then resumes everyone.
        """
        queue = RunQueue(coroutines, self.queue_depth)
        while True:
            raw = queue.collect(self)
            if queue.done:
                return queue.results
            needs: dict = {}            # ordered de-dup of this round's keys
            for need in raw:
                if need in needs:
                    self.stats.dedup_hits += 1
                needs[need] = None
            self._resolve(list(needs), phase=phase)

    def _advance(self, key, gen, results):
        """Advance one coroutine until it blocks on an uncached extraction
        (returns the need) or finishes (records its result, returns None)."""
        while True:
            try:
                need = next(gen)
            except StopIteration as stop:
                results[key] = stop.value
                return None
            if (need[0], need[1]) not in self.cache:
                return need
            self.stats.cache_hits += 1

    # ------------------------------------------------------ bulk extract ---

    def extract_many(self, keys, *, phase: str = "query") -> dict:
        """Batch-extract `(doc_id, attr, table)` keys; returns
        {(doc_id, attr): value}. Duplicates and cached keys are charged once
        (or not at all) — the dedup guarantee of DESIGN.md §9."""
        todo, seen = [], set()
        for doc_id, attr, table in keys:
            k = (doc_id, attr)
            if k in seen:
                self.stats.dedup_hits += 1
                continue
            seen.add(k)
            if k in self.cache:
                self.stats.cache_hits += 1
                continue
            todo.append((doc_id, attr, table))
        self._resolve(todo, phase=phase)
        return {(d, a): self.cache.get((d, a)) for d, a, _ in keys}

    def resolve_round(self, needs: list, *, owners: dict = None,
                      phase: str = "query") -> None:
        """Resolve one multiplexed round of already-deduplicated needs —
        possibly spanning several concurrent queries (DESIGN.md §11).
        `owners` maps (doc_id, attr) -> the owning query's child ledger;
        unmapped needs charge the session ledger. Prefix grouping and
        chunking treat the merged round as one stream, so same-attribute
        needs from *different* queries share extract_batch rounds and
        prefix-cache groups."""
        self._resolve(needs, phase=phase, owners=owners)

    def _resolve(self, keys: list, *, phase: str, owners: dict = None) -> None:
        if not keys:
            return
        with self.tracer.span("scheduler.round", kind="scheduler",
                              needs=len(keys), phase=phase):
            keys = self._group_by_prefix(keys)
            for chunk in self._chunks(keys):
                self._extract_chunk(chunk, phase=phase, owners=owners)

    def _chunks(self, keys: list):
        """Cut the grouped round into extract_batch chunks: by count alone
        (legacy), or — with `round_token_budget` — also by cumulative
        estimated tokens, so one chunk never occupies the engine past the
        latency budget. A chunk always takes at least one item (an
        over-budget single extraction must still run)."""
        if self.round_token_budget is None:
            for i in range(0, len(keys), self.batch_size):
                yield keys[i:i + self.batch_size]
            return
        chunk, spent = [], 0
        for key in keys:
            est = self._estimate_tokens(key)
            if chunk and (len(chunk) >= self.batch_size or
                          spent + est > self.round_token_budget):
                yield chunk
                chunk, spent = [], 0
            chunk.append(key)
            spent += est
        if chunk:
            yield chunk

    def _estimate_tokens(self, key) -> int:
        """Pre-retrieval token estimate for one need (segment tokens plus
        the fixed prompt/answer overhead). Retrieval is index work, not LLM
        cost — looking segments up here charges nothing."""
        doc_id, attr, table = key
        segs = self.retriever.segments(doc_id, attr, table)
        return PROMPT_OVERHEAD + OUTPUT_TOKENS + \
            sum(count_tokens(s) for s in segs)

    @staticmethod
    def _group_by_prefix(keys: list) -> list:
        """Stable-group (doc, attr, table) needs by (attr, table): requests
        sharing a prompt prefix become adjacent, so they fall into the same
        extract_batch chunk and the engine's prefix cache hits."""
        order: dict = {}
        for _doc, attr, table in keys:
            order.setdefault((attr, table), len(order))
        return sorted(keys, key=lambda k: order[(k[1], k[2])])

    def _extract_chunk(self, chunk: list, *, phase: str,
                       owners: dict = None) -> None:
        prefetch = getattr(self.retriever, "prefetch_segments", None)
        if prefetch is not None and len(chunk) > 1:
            prefetch(chunk)
        items, slots = [], []
        for doc_id, attr, table in chunk:
            segs = self.retriever.segments(doc_id, attr, table)
            if not segs:
                # no relevant segments -> no LLM call at all (free negative)
                self.cache[(doc_id, attr)] = None
                self.stats.empty_retrievals += 1
                continue
            items.append((doc_id, attr, segs))
            slots.append((doc_id, attr))
        if not items:
            return
        hits0, saved0 = self._prefix_stats()
        spec0 = self._spec_stats()
        casc0 = self._cascade_stats()
        chunk_span = self.tracer.span(
            "scheduler.chunk", kind="scheduler", level=2, items=len(items),
            attrs_grouped=len({(a, t) for _d, a, t in chunk}))
        with chunk_span:
            if owners is not None and getattr(self.extractor,
                                              "accepts_owners", False):
                # opt-in protocol extension: the serving path maps each
                # item's owning child ledger to its tenant for admission
                # control. Gated on the attribute so duck-typed extractors
                # (tests, oracle stubs) keep the positional-only signature.
                out = self.extractor.extract_batch(
                    items, owners=[owners.get(k) for k in slots])
            else:
                out = self.extractor.extract_batch(items)
        hits1, saved1 = self._prefix_stats()
        spec1 = self._spec_stats()
        casc1 = self._cascade_stats()
        self.stats.rounds += 1
        self.stats.submitted += len(items)
        self.stats.max_batch = max(self.stats.max_batch, len(items))
        self.ledger.record_batch(len(items))
        self.ledger.record_prefix(hits1 - hits0, saved1 - saved0)
        self.ledger.record_spec(*(b - a for a, b in zip(spec0, spec1)))
        self.ledger.record_cascade(*(b - a for a, b in zip(casc0, casc1)))
        if owners:
            self.record_owner_batches(owners.get(k) for k in slots)
        for (doc_id, attr), (value, inp_tokens) in zip(slots, out):
            ledger = (owners or {}).get((doc_id, attr)) or self.ledger
            ledger.charge(inp=inp_tokens + PROMPT_OVERHEAD,
                          out=OUTPUT_TOKENS, phase=phase, attr=attr)
            self.cache[(doc_id, attr)] = value

    def record_owner_batches(self, ledgers) -> None:
        """Per-query batch participation for one shared chunk: each child
        ledger appearing in `ledgers` (one entry per chunk item; None or the
        session ledger itself are skipped) records one batch of its own item
        count — the session ledger records the shared round itself."""
        per: dict = {}
        for led in ledgers:
            if led is not None and led is not self.ledger:
                ent = per.setdefault(id(led), [led, 0])
                ent[1] += 1
        for led, n in per.values():
            led.record_batch(n)

    # -------------------------------------------------- sampling phase -----

    def extract_full_docs(self, doc_ids: list, attrs: list) -> dict:
        """Batched sampling-phase extraction (full-document prompts).
        Returns {doc_id: (values, segments_by_attr, input_tokens)} in the
        given order; the served path submits each chunk as one
        continuous-batching round."""
        res = self.extract_full_doc_items([(d, attrs) for d in doc_ids])
        return dict(zip(doc_ids, res))

    def extract_full_doc_items(self, items: list, owners: list = None) -> list:
        """Sampling rounds over `items = [(doc_id, attrs)]`, which may span
        several concurrent queries' sampling phases (DESIGN.md §11) — the
        chunks are shared continuous-batching rounds. `owners` (parallel to
        `items`, entries may be None) carries each item's child ledger for
        per-query batch counters. Returns results parallel to `items`."""
        out: list = []
        for i in range(0, len(items), self.batch_size):
            chunk = items[i:i + self.batch_size]
            hits0, saved0 = self._prefix_stats()
            spec0 = self._spec_stats()
            casc0 = self._cascade_stats()
            samp_span = self.tracer.span("scheduler.sampling_chunk",
                                         kind="scheduler", level=2,
                                         docs=len(chunk))
            with samp_span:
                if owners is not None and getattr(self.extractor,
                                                  "accepts_owners", False):
                    res = self.extractor.extract_full_doc_batch(
                        chunk, owners=owners[i:i + self.batch_size])
                else:
                    res = self.extractor.extract_full_doc_batch(chunk)
            hits1, saved1 = self._prefix_stats()
            spec1 = self._spec_stats()
            casc1 = self._cascade_stats()
            self.ledger.record_batch(len(chunk))
            self.ledger.record_prefix(hits1 - hits0, saved1 - saved0)
            self.ledger.record_spec(*(b - a for a, b in zip(spec0, spec1)))
            self.ledger.record_cascade(*(b - a
                                         for a, b in zip(casc0, casc1)))
            if owners:
                self.record_owner_batches(owners[i:i + self.batch_size])
            out.extend(res)
        return out

    def _prefix_stats(self):
        """(prefix_hits, saved_prefill_tokens) from the extractor, when it
        serves through an engine with the prefix KV cache (0 otherwise)."""
        st = getattr(self.extractor, "stats", None)
        return (getattr(st, "prefix_hits", 0),
                getattr(st, "saved_prefill_tokens", 0))

    def _spec_stats(self):
        """(draft_tokens, accepted_tokens, decode_steps_saved) from the
        extractor, when it serves through an engine with speculative
        decoding on (0 otherwise)."""
        st = getattr(self.extractor, "stats", None)
        return (getattr(st, "draft_tokens", 0),
                getattr(st, "accepted_tokens", 0),
                getattr(st, "decode_steps_saved", 0))

    def _cascade_stats(self):
        """(accepted_small, escalations, target_tokens_saved) from the
        extractor, when it is a model cascade (DESIGN.md §18; 0
        otherwise) — per-round deltas route to `ledger.record_cascade`
        like the prefix/spec counters above."""
        st = getattr(self.extractor, "stats", None)
        return (getattr(st, "accepted_small", 0),
                getattr(st, "escalations", 0),
                getattr(st, "target_tokens_saved", 0))
