"""Session layer: query lifecycle and concurrent multi-query execution
multiplexed over one serving engine (DESIGN.md §11).

A `Session` owns everything whose cost amortizes across queries:

  * the shared attribute-value cache (`(doc_id, attr) -> value`) and the
    escalation memo — a value any query extracted is free for the rest;
  * the per-table sampling investment (`TableSample`): the first query on
    a table pays the ~5% full-document sampling sweep, later queries
    whose attributes are covered reuse the statistics, thresholds, and
    cached sample values and skip their sampling phase entirely;
  * the session-wide `CostLedger`, with one `child()` ledger per query so
    `QueryResult` token columns and wall time are strictly per-query;
  * one `BatchScheduler` over one extractor/serving engine.

Lifecycle: `prepare(query)` validates up front (unknown table / op /
attribute errors surface here, never mid-extraction) and `explain()`s the
logical plan with sample-stat cost/selectivity estimates; `submit()`
starts execution and returns a `QueryHandle`; `QueryHandle.rows()`
streams result rows as documents clear projection, `result()` blocks for
the full `QueryResult`.

Concurrency model: cooperative, no threads. Every submitted query is a
`QueryRun` state machine (executor.py) yielding barrier requests; each
`Session._step()` round collects the pending extraction needs of *all*
in-flight queries, merges and deduplicates them, and resolves them in
shared `BatchScheduler` rounds — so extractions from different queries
batch into the same `extract_batch`/`engine.run()` rounds and group by
(attr, table) for prefix-KV reuse across queries. Any blocking call
(`rows()`, `result()`, `drain()`) advances the whole session, so progress
never depends on which handle the caller happens to be waiting on.

Multi-tenant serving (DESIGN.md §16): `submit(..., tenant=...)` routes
the query's charges through a per-tenant ledger layer (query -> tenant ->
session forwarding), tags its extraction requests so a `ServingFrontend`
can apply per-tenant fair-share admission, and `deadline_s` bounds how
long the query may stay in flight — an expired query is cancelled at the
top of the next `_step` and its `result()` raises `QueryTimeout`.
`Session.cancel(handle)` / `QueryHandle.cancel()` aborts a query early;
both paths release every resource the query held (sampling reservations
roll back exactly as on failure) so concurrent queries never stall on a
dead owner. `QueryHandle.aresult()` / `Session.adrain()` are awaitable
facades over the same cooperative `_step` pump for asyncio callers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional, Union

from repro_torch.obs import MetricsRegistry, as_tracer, build_report, render_report

from .executor import QueryResult, QueryRun, TableSample, table_query_attrs
from .expr import Query, QueryError, iter_filters
from .ledger import CostLedger
from .ordering import plan_expression
from .scheduler import (OUTPUT_TOKENS, PROMPT_OVERHEAD, BatchScheduler,
                        RunQueue)
from .stats import SampleStats, sample_size

__all__ = ["Session", "PreparedQuery", "QueryHandle", "QueryError",
           "QueryCancelled", "QueryTimeout"]


class QueryCancelled(RuntimeError):
    """The query was cancelled before completing; raised by `result()` /
    `rows()` of a handle that `Session.cancel()` was called on."""


class QueryTimeout(QueryCancelled):
    """The query's `deadline_s` elapsed before it completed. A subclass of
    QueryCancelled: timeout is cancellation with a clock as the caller."""


# --------------------------------------------------------------- barriers --

# A query's in-flight document coroutines are a scheduler RunQueue: one
# `collect()` per session step mirrors one `BatchScheduler.run` round
# (including immediate re-admission when a whole wave resolves from
# cache), so several queries' rounds land in the same shared chunks.
_RunBarrier = RunQueue


class _OneShotBarrier:
    """Base for barriers resolved wholesale in a single session round."""

    def __init__(self):
        self.ready = False
        self.value = None


class _ExtractBarrier(_OneShotBarrier):
    def __init__(self, keys: list):            # [(doc_id, attr, table)]
        super().__init__()
        self.keys = list(keys)


class _EscalateBarrier(_OneShotBarrier):
    def __init__(self, keys: list):            # [(doc_id, attr)]
        super().__init__()
        self.keys = list(keys)


class _FullDocsBarrier(_OneShotBarrier):
    def __init__(self, items: list):           # [(doc_id, attrs)]
        super().__init__()
        self.items = list(items)


class _SampleWait:
    """Blocked on another query's in-progress sampling of `table`."""

    def __init__(self, table: str, attrs: frozenset):
        self.table = table
        self.attrs = attrs


class _SampleReservation:
    """Marks a table's sampling as in progress, owned by one handle.
    `prior` keeps the previously-published sample (when re-sampling an
    uncovered table) so it can be widened into the new sweep — and
    restored if the owner fails before publishing."""

    def __init__(self, owner: "QueryHandle", prior: TableSample = None):
        self.owner = owner
        self.prior = prior


class _RoundWork:
    """One session round's merged work, deduplicated across queries by
    (doc_id, attr) — the cache key — so the same value is never extracted
    twice in a round no matter how many queries ask for it."""

    def __init__(self):
        self.order: list = []       # (doc_id, attr, table), arrival order
        self.seen: set = set()      # (doc_id, attr)
        self.owners: dict = {}      # (doc_id, attr) -> owning child ledger
        self.extract: list = []     # (handle, _ExtractBarrier)
        self.escalate: list = []    # (handle, _EscalateBarrier)
        self.full: list = []        # (handle, _FullDocsBarrier)

    def add_needs(self, handle: "QueryHandle", needs: list,
                  scheduler: BatchScheduler) -> None:
        for need in needs:
            k = (need[0], need[1])
            if k in self.seen:
                scheduler.stats.dedup_hits += 1
                continue
            self.seen.add(k)
            self.order.append(need)
            self.owners[k] = handle.ledger

    def add_extract(self, handle: "QueryHandle", barrier: _ExtractBarrier,
                    scheduler: BatchScheduler) -> None:
        self.extract.append((handle, barrier))
        for doc_id, attr, table in barrier.keys:
            k = (doc_id, attr)
            if k in scheduler.cache:
                scheduler.stats.cache_hits += 1
            elif k in self.seen:
                scheduler.stats.dedup_hits += 1
            else:
                self.seen.add(k)
                self.order.append((doc_id, attr, table))
                self.owners[k] = handle.ledger

    @property
    def empty(self) -> bool:
        return not (self.order or self.extract or self.escalate or self.full)


# ---------------------------------------------------------------- handles --


class QueryHandle:
    """One in-flight query. `rows()` streams result rows as documents clear
    projection; `result()` blocks for the full `QueryResult`. Iterating or
    blocking on any handle advances the *whole* session, so concurrent
    handles make progress together and share extraction rounds."""

    def __init__(self, session: "Session", prepared: "PreparedQuery", *,
                 tenant: Optional[str] = None, priority: int = 0,
                 deadline_s: Optional[float] = None):
        self.session = session
        self.query = prepared.query
        self.qid = session._next_qid()
        self.tenant = tenant or ""
        self.priority = priority
        # query ledger hangs off the tenant layer when one is named, so
        # charges forward query -> tenant -> session and the ledger's
        # tenant tag rides to the serving tier via scheduler owners=
        parent = (session._tenant_ledger(tenant) if tenant
                  else session.ledger)
        self.ledger = parent.child()
        self._make_run()
        self.reservations: set = set()      # tables whose sampling we own
        self.acquired: set = set()          # tables we hold/held for execution
        self._rows: list = []
        self._done = False
        self._error: Optional[BaseException] = None
        self._result: Optional[QueryResult] = None
        self._t0 = time.time()
        self.deadline = (self._t0 + deadline_s
                         if deadline_s is not None else None)
        self._span = -1                     # tracer id of the lifecycle span

    def _make_run(self) -> None:
        """(Re-)build the query's execution state machine from current
        session state. Called at submit, and again by `LiveSession` when a
        corpus mutation restarts an in-flight query: the fresh QueryRun
        sees the post-mutation snapshot, same seed (sampling parity with a
        fresh session), charges still on this handle's ledger."""
        session = self.session
        self.run = QueryRun(
            self.query, retriever=session.retriever,
            extractor=session.extractor, cache=session.cache,
            escalated=session._escalated, ledger=self.ledger,
            seed=session.seed, sample_rate=session.sample_rate,
            ordering=session.ordering, join_strategy=session.join_strategy,
            batch_size=session.scheduler.batch_size,
            ctx_hook=session.table_context_hook)
        self.gen = self.run.run_co()
        self.barrier = None
        self.send_value = None

    # -- consumption ------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done

    def cancel(self) -> bool:
        """Abort this query; returns False if it already finished. Its
        `result()`/`rows()` raise `QueryCancelled` from then on."""
        return self.session.cancel(self)

    def rows(self) -> Iterator[dict]:
        """Stream result rows in arrival order, each exactly once per
        iterator. Drives the session until this query finishes."""
        i = 0
        while not self._done or i < len(self._rows):
            if i < len(self._rows):
                yield self._rows[i]
                i += 1
            else:
                self.session._step()
        if self._error is not None:
            raise self._error

    def result(self) -> QueryResult:
        """Block until the query completes; returns the full QueryResult
        (rows identical to what `rows()` streamed)."""
        while not self._done:
            self.session._step()
        if self._error is not None:
            raise self._error
        return self._result

    async def aresult(self) -> QueryResult:
        """Awaitable `result()`: one cooperative session round per event-
        loop turn, yielding control between rounds so other coroutines
        (and other handles' awaiters) interleave. Rows and ledger columns
        are byte-identical to the blocking path — same `_step` pump, the
        event loop just owns the outer loop."""
        import asyncio
        while not self._done:
            self.session._step()
            await asyncio.sleep(0)
        if self._error is not None:
            raise self._error
        return self._result

    def report(self) -> dict:
        """EXPLAIN ANALYZE (DESIGN.md §19): estimated-vs-actual per plan
        stage — selectivity, tokens per invocation, tier split — plus the
        savings columns and (when a tracer is attached) per-kind wall
        attribution. The query must have finished."""
        return build_report(self)

    def report_text(self) -> str:
        return render_report(self.report())

    # -- session-side hooks ----------------------------------------------

    def _emit(self, rows: list) -> None:
        self._rows.extend(rows)

    def _finish(self, meta: dict) -> None:
        self.ledger.wall_time_s += time.time() - self._t0
        self._result = QueryResult(list(self._rows), self.ledger,
                                   dict(self.run._plan_log), meta=dict(meta))
        self._done = True

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self.ledger.wall_time_s += time.time() - self._t0
        self._done = True


@dataclass
class PreparedQuery:
    """A validated query bound to a session: `explain()` before paying for
    anything, `submit()` when ready."""
    session: "Session"
    query: Query

    def explain(self) -> dict:
        """Logical-plan summary with sample-stat cost/selectivity estimates
        per stage (estimates come from the session's sampling investment
        when the table is already sampled, defaults otherwise)."""
        return self.session._explain(self.query)

    def explain_text(self) -> str:
        return render_explain(self.explain())

    def submit(self, *, tenant: Optional[str] = None, priority: int = 0,
               deadline_s: Optional[float] = None) -> QueryHandle:
        return self.session.submit(self, tenant=tenant, priority=priority,
                                   deadline_s=deadline_s)


def render_explain(plan: dict) -> str:
    """Human-readable rendering of `PreparedQuery.explain()`."""
    lines = [f"QUERY  {plan['query']}",
             f"  ordering={plan['ordering']} join_strategy="
             f"{plan['join_strategy']} batch_size={plan['batch_size']}"]
    for t in plan["tables"]:
        s = t["sampling"]
        samp = (f"sampling: reused ({s['n_sampled']} docs already paid)"
                if s.get("reused") else
                f"sampling: will sample ~{s['planned_sample']} docs")
        lines.append(f"  TABLE {t['table']}: {t['candidate_docs']} candidate "
                     f"docs | {samp}")
        for st in t.get("stages", []):
            split = st.get("predicted_tier_split")
            tier = (f", cascade small {split['small']:.0%}" if split else "")
            lines.append(f"    - {st['filter']}  [sel={st['selectivity']}, "
                         f"~{st['mean_cost_tokens']} tok/doc{tier}]")
        if "est_cost_tokens_per_doc" in t:
            lines.append(f"    => est {t['est_cost_tokens_per_doc']} tok/doc x "
                         f"{t['candidate_docs']} docs = "
                         f"~{t['est_total_cost_tokens']} tokens, "
                         f"pass rate {t['est_pass_rate']}")
        if t["select"]:
            lines.append(f"    SELECT {', '.join(t['select'])}")
    for j in plan["joins"]:
        lines.append(f"  JOIN {j}")
    return "\n".join(lines)


# ---------------------------------------------------------------- session --


class Session:
    """See module docstring. `table_context_hook(ctx, query)` is an optional
    wrapper applied to each freshly-built TableContext (benchmarks use it to
    substitute ground-truth statistics)."""

    def __init__(self, retriever, extractor, *, sample_rate: float = 0.05,
                 seed: int = 0, ordering: str = "quest",
                 join_strategy: str = "transform",
                 ledger: Optional[CostLedger] = None,
                 batch_size: int = 1, queue_depth: int = 32,
                 round_token_budget: Optional[int] = None,
                 table_context_hook=None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        self.retriever = retriever
        self.extractor = extractor
        self.sample_rate = sample_rate
        self.seed = seed
        self.ordering = ordering
        self.join_strategy = join_strategy
        self.ledger = ledger if ledger is not None else CostLedger()
        self.table_context_hook = table_context_hook
        self.cache: dict = {}               # (doc_id, attr) -> value
        self._escalated: set = set()        # keys already retried full-doc
        # observability (DESIGN.md §19): tracer defaults to the shared
        # no-op; the registry holds session.* and scheduler.* instruments
        # (share one registry across session/engine/frontend for a single
        # exposition surface — but one registry per engine)
        self.tracer = as_tracer(tracer)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m = {k: self.metrics.counter(f"session.{k}")
                   for k in ("queries", "queries_finished", "queries_failed",
                             "steps")}
        self.scheduler = BatchScheduler(retriever, extractor, self.ledger,
                                        self.cache, batch_size=batch_size,
                                        queue_depth=queue_depth,
                                        round_token_budget=round_token_budget,
                                        tracer=self.tracer,
                                        metrics=self.metrics)
        self._samples: dict = {}    # table -> TableSample | _SampleReservation
        self._active: list = []     # in-flight QueryHandles, submit order
        self._tenant_ledgers: dict = {}     # tenant -> per-tenant CostLedger
        self._qid = 0

    def _next_qid(self) -> int:
        self._qid += 1
        return self._qid

    def _tenant_ledger(self, tenant: str) -> CostLedger:
        """Memoized per-tenant layer between session and query ledgers."""
        led = self._tenant_ledgers.get(tenant)
        if led is None:
            led = self.ledger.child(tenant=tenant)
            self._tenant_ledgers[tenant] = led
        return led

    def tenant_costs(self) -> dict:
        """tenant -> ledger snapshot, for everything charged under it."""
        return {t: led.snapshot()
                for t, led in sorted(self._tenant_ledgers.items())}

    # ------------------------------------------------------------ prepare --

    def prepare(self, query: Query) -> PreparedQuery:
        """Validate up front: structure (tables declared for every SELECT/
        WHERE/join reference — also enforced at Query construction) plus
        corpus-level name resolution. Raises `QueryError`; nothing is
        charged."""
        query.validate()
        corpus = getattr(self.retriever, "corpus", None)
        if corpus is None:
            corpus = getattr(self.extractor, "corpus", None)
        if corpus is not None:
            self._check_names(query, corpus)
        return PreparedQuery(self, query)

    @staticmethod
    def _check_names(query: Query, corpus) -> None:
        for t in query.tables:
            if t not in corpus.tables:
                raise QueryError(
                    f"unknown table {t!r} (corpus tables: "
                    f"{sorted(corpus.tables)})")
        known_any: set = set()
        for t in query.tables:
            known_any |= set(corpus.attr_specs.get(t, {}))
        for t in query.tables:
            known = set(corpus.attr_specs.get(t, {}))
            for a in query.select_attrs(t):
                if a not in known:
                    raise QueryError(
                        f"unknown SELECT attribute {t}.{a} (table has: "
                        f"{sorted(known)})")
        for f in iter_filters(query.where):
            if f.table:
                if f.attr not in corpus.attr_specs.get(f.table, {}):
                    raise QueryError(
                        f"unknown WHERE attribute {f.table}.{f.attr}")
            elif f.attr not in known_any:
                raise QueryError(
                    f"unknown WHERE attribute {f.attr!r} (no queried table "
                    f"defines it)")
        for j in query.joins:
            for t, a in ((j.left_table, j.left_attr),
                         (j.right_table, j.right_attr)):
                if a not in corpus.attr_specs.get(t, {}):
                    raise QueryError(f"unknown join attribute {t}.{a}")

    # ------------------------------------------------------------ explain --

    def _explain(self, query: Query) -> dict:
        out = {"query": str(query), "ordering": self.ordering,
               "join_strategy": self.join_strategy,
               "batch_size": self.scheduler.batch_size,
               "tables": [], "joins": [str(j) for j in query.joins]}
        for t in query.tables:
            attrs = table_query_attrs(query, t)
            sample = self._samples.get(t)
            covered = (isinstance(sample, TableSample)
                       and set(attrs) <= sample.attrs)
            stats = sample.stats if covered else SampleStats(table=t)
            cands = len(self.retriever.candidate_docs(t, attrs))
            entry = {
                "table": t, "attrs": attrs, "candidate_docs": cands,
                "sampling": ({"reused": True, "n_sampled": stats.n_sampled}
                             if covered else
                             {"reused": False, "planned_sample":
                              sample_size(cands, self.sample_rate)}),
                "select": query.select_attrs(t),
            }
            expr = query.where_for(t)
            if expr is not None:
                plan = plan_expression(
                    expr, lambda f: stats.mean_cost(f.attr), stats.selectivity)
                entry["plan"] = plan.describe()
                entry["est_cost_tokens_per_doc"] = round(plan.cost, 2)
                entry["est_total_cost_tokens"] = round(plan.cost * cands)
                entry["est_pass_rate"] = round(plan.prob, 4)
                est = getattr(self.extractor, "difficulty", None)
                entry["stages"] = []
                for f in plan.ordered_filters():
                    stage = {"filter": str(f), "attr": f.attr,
                             "selectivity": round(stats.selectivity(f), 4),
                             "mean_cost_tokens":
                                 round(stats.mean_cost(f.attr), 2)}
                    if est is not None:
                        # predicted cascade tier mix for this stage, from
                        # the sampled docs' difficulty scores (§18); None
                        # until the table's sampling phase has folded
                        stage["predicted_tier_split"] = \
                            est.predicted_split(t, f.attr)
                    entry["stages"].append(stage)
            out["tables"].append(entry)
        return out

    # ------------------------------------------------------------- submit --

    def submit(self, prepared: Union[PreparedQuery, Query], *,
               tenant: Optional[str] = None, priority: int = 0,
               deadline_s: Optional[float] = None) -> QueryHandle:
        """Start executing a prepared query; returns its handle. Execution
        interleaves with every other in-flight handle's from the next
        `_step` on, whoever drives it. `tenant` routes charges through a
        per-tenant ledger and tags the query's serving requests for
        admission control; `deadline_s` cancels the query (with
        `QueryTimeout`) if it is still in flight that many seconds after
        submit."""
        if isinstance(prepared, Query):
            prepared = self.prepare(prepared)
        if prepared.session is not self:
            raise QueryError("prepared query belongs to a different session")
        handle = QueryHandle(self, prepared, tenant=tenant,
                             priority=priority, deadline_s=deadline_s)
        self._active.append(handle)
        self._m["queries"].inc()
        handle._span = self.tracer.begin(
            "session.query", kind="query", qid=handle.qid,
            tenant=handle.tenant, tables=list(handle.query.tables))
        return handle

    def execute(self, query: Union[PreparedQuery, Query]) -> QueryResult:
        """Single-query convenience: prepare + submit + block."""
        return self.submit(query).result()

    def cancel(self, handle: QueryHandle,
               err: Optional[BaseException] = None) -> bool:
        """Abort an in-flight query. Returns False if it already finished
        (a completed result is never retracted). Everything the query
        holds is released — its coroutine is closed, unpublished sampling
        reservations roll back to the prior sample — so queries blocked on
        its sampling re-acquire next round instead of stalling."""
        if handle not in self._active:
            return False
        handle.gen.close()
        self._failed(handle, err or QueryCancelled(
            f"query {handle.qid} cancelled"))
        return True

    def _expire_deadlines(self) -> None:
        now = time.time()
        for h in list(self._active):
            if h.deadline is not None and now >= h.deadline:
                self.cancel(h, QueryTimeout(
                    f"query {h.qid} exceeded deadline of "
                    f"{h.deadline - h._t0:.3f}s"))

    def drain(self) -> None:
        """Drive every in-flight query to completion."""
        while self._active:
            self._step()

    async def adrain(self) -> None:
        """Awaitable `drain()`: one `_step` round per event-loop turn."""
        import asyncio
        while self._active:
            self._step()
            await asyncio.sleep(0)

    # -------------------------------------------------------- multiplexer --

    def _step(self) -> bool:
        """One multiplexed round: pump every in-flight query to its next
        blocking point, merge all pending work, resolve it in shared
        scheduler rounds. Returns False when nothing remains in flight."""
        if not self._active:
            return False
        t0 = time.time()
        self._expire_deadlines()
        if not self._active:
            return False
        self._m["steps"].inc()
        work = _RoundWork()
        progressed = False
        with self.tracer.span("session.step", kind="session",
                              in_flight=len(self._active)):
            for h in list(self._active):
                if h not in self._active:   # cancelled by a hook mid-round
                    continue
                progressed |= self._pump(h, work)
            if not work.empty:
                progressed = True
                self._resolve_work(work)
        self.ledger.wall_time_s += time.time() - t0
        if not progressed and self._active:
            raise RuntimeError(
                "session stalled: in-flight queries cannot make progress")
        return bool(self._active)

    def _pump(self, h: QueryHandle, work: _RoundWork) -> bool:
        """Advance one handle as far as it can go without resolving new
        extractions; contribute its blocked work to the round."""
        progressed = False
        while True:
            b = h.barrier
            if b is None:
                try:
                    op = h.gen.send(h.send_value)
                except StopIteration as stop:
                    self._finish(h, stop.value or {})
                    return True
                except Exception as err:    # noqa: BLE001 — query-scoped
                    self._failed(h, err)
                    return True
                h.send_value = None
                progressed = True
                kind = op[0]
                if self.tracer.enabled(2):
                    self.tracer.instant("query.barrier", kind="query",
                                        level=2, qid=h.qid, barrier=kind)
                if kind == "rows":
                    h._emit(op[1])
                elif kind == "sample_publish":
                    self._publish_sample(h, op[1])
                    self.tracer.instant("query.sample_publish", kind="query",
                                        qid=h.qid, table=op[1].table)
                elif kind == "sample_acquire":
                    got = self._try_acquire(h, op[1], frozenset(op[2]))
                    if got is None:
                        h.barrier = _SampleWait(op[1], frozenset(op[2]))
                        return progressed
                    h.send_value = got
                elif kind == "run":
                    h.barrier = _RunBarrier(op[1], self.scheduler.queue_depth)
                elif kind == "extract":
                    h.barrier = _ExtractBarrier(op[1])
                elif kind == "escalate":
                    h.barrier = _EscalateBarrier(op[1])
                elif kind == "full_docs":
                    h.barrier = _FullDocsBarrier(op[1])
                else:
                    self._failed(h, RuntimeError(f"unknown barrier {kind!r}"))
                    return True
                continue
            if isinstance(b, _SampleWait):
                got = self._try_acquire(h, b.table, b.attrs)
                if got is None:
                    return progressed
                h.barrier, h.send_value = None, got
                progressed = True
                continue
            if isinstance(b, _RunBarrier):
                try:
                    needs = b.collect(self.scheduler)
                except Exception as err:    # noqa: BLE001 — a document
                    # coroutine raised: fail this query only, like the
                    # gen.send path (its uncontributed needs are dropped)
                    self._failed(h, err)
                    return True
                if b.done:
                    h.barrier, h.send_value = None, b.results
                    progressed = True
                    continue
                work.add_needs(h, needs, self.scheduler)
                return progressed
            if b.ready:
                h.barrier, h.send_value = None, b.value
                progressed = True
                continue
            if isinstance(b, _ExtractBarrier):
                work.add_extract(h, b, self.scheduler)
            elif isinstance(b, _EscalateBarrier):
                work.escalate.append((h, b))
            elif isinstance(b, _FullDocsBarrier):
                work.full.append((h, b))
            return progressed

    def _resolve_work(self, work: _RoundWork) -> None:
        # sampling rounds first (a query can only be in one phase at a time,
        # so ordering across barrier kinds never reorders within a query)
        if work.full:
            items, owners, spans = [], [], []
            for h, b in work.full:
                spans.append((b, len(items), len(b.items)))
                items.extend(b.items)
                owners.extend([h.ledger] * len(b.items))
            with self.tracer.span("session.sampling_round", kind="session",
                                  docs=len(items)):
                res = self.scheduler.extract_full_doc_items(items, owners)
            for b, off, n in spans:
                b.value = {d: r for (d, _a), r in
                           zip(b.items, res[off:off + n])}
                b.ready = True
        if work.order:
            self.scheduler.resolve_round(work.order, owners=work.owners)
        for _h, b in work.extract:
            b.value = {(d, a): self.cache.get((d, a)) for d, a, _t in b.keys}
            b.ready = True
        if work.escalate:
            with self.tracer.span("session.escalate_round", kind="session",
                                  queries=len(work.escalate)):
                self._resolve_escalations(work.escalate)

    def _resolve_escalations(self, escalations: list) -> None:
        """Full-document-prompt retries for output-critical attrs
        (DESIGN.md §8.3), batched across queries. The same key requested by
        several queries in one round is retried once (first owner pays,
        everyone receives the value); the session escalation memo is marked
        here, at resolve time, so a query pumped later in the same step
        never mistakes an in-flight retry for an already-settled one."""
        corpus = self.extractor.corpus
        flat = []
        for h, b in escalations:
            for k in b.keys:
                if k in self._escalated:    # settled, or claimed this round
                    continue
                self._escalated.add(k)
                flat.append((k[0], k[1], h))
        bs = self.scheduler.batch_size
        # extractors may expose a dedicated escalation entry point (served:
        # doc-first prompt layout so full-document retries share the doc
        # prefix KV across attrs); default to the plain batch path
        run_batch = getattr(self.extractor, "escalate_batch",
                            self.extractor.extract_batch)
        for i in range(0, len(flat), bs):
            chunk = flat[i:i + bs]
            batch = [(d, a, [corpus.docs[d].text]) for d, a, _h in chunk]
            out = run_batch(batch)
            self.ledger.record_batch(len(batch))
            self.scheduler.record_owner_batches(h.ledger for _d, _a, h in chunk)
            for (d, a, h), (value, inp_tokens) in zip(chunk, out):
                h.ledger.charge(inp=inp_tokens + PROMPT_OVERHEAD,
                                out=OUTPUT_TOKENS, phase="query", attr=a)
                if value is not None:
                    self.cache[(d, a)] = value
        for _h, b in escalations:
            b.value = {k: self.cache.get(k) for k in b.keys}
            b.ready = True

    # --------------------------------------------- live-corpus invalidation --

    def drop_doc_state(self, doc_id) -> dict:
        """Exact per-document invalidation (DESIGN.md §17): remove every
        cached attr value and escalation memo keyed to `doc_id` — plus,
        under a cascade extractor (§18), its memoized difficulty estimates
        and tier-escalation memo entries (post-mutation content deserves a
        fresh routing decision and a fresh shot at the small tier). Called
        by the live cascade when the document mutates — a stale value must
        never satisfy a post-mutation query. Returns drop counts."""
        cache_keys = [k for k in self.cache if k[0] == doc_id]
        for k in cache_keys:
            del self.cache[k]
        esc_keys = [k for k in self._escalated if k[0] == doc_id]
        self._escalated.difference_update(esc_keys)
        est = getattr(self.extractor, "difficulty", None)
        n_difficulty = est.drop_doc(doc_id) if est is not None else 0
        tier_memo = getattr(self.extractor, "tier_memo", None)
        tier_keys = ([k for k in tier_memo if k[0] == doc_id]
                     if tier_memo is not None else [])
        if tier_keys:
            tier_memo.difference_update(tier_keys)
        return {"cache_entries": len(cache_keys),
                "escalations": len(esc_keys),
                "difficulty_estimates": n_difficulty,
                "tier_memo": len(tier_keys)}

    def invalidate_table_sample(self, table: str) -> bool:
        """Drop `table`'s sampling investment: the published sample is
        removed (next query re-samples), and an in-progress reservation
        loses its stale `prior` (the owner's sweep still publishes, built
        from post-mutation extractions). Returns True if anything
        dropped."""
        cur = self._samples.get(table)
        if isinstance(cur, TableSample):
            del self._samples[table]
            return True
        if isinstance(cur, _SampleReservation) and cur.prior is not None:
            cur.prior = None
            return True
        return False

    # ------------------------------------------------- sampling ownership --

    def _try_acquire(self, h: QueryHandle, table: str, attrs: frozenset):
        """Resolve a sample_acquire: reuse a covering published sample,
        wait on another query's in-progress sampling, or reserve the table
        and sample ourselves. An *uncovered* query first waits for every
        in-flight query already executing on the table to finish — its
        re-sampling mutates the shared thresholds/evidence/cache, which
        must never happen under a running query — then re-samples the
        union of its attrs and the prior sample's, so paid coverage only
        ever grows."""
        cur = self._samples.get(table)
        if isinstance(cur, TableSample) and attrs <= cur.attrs:
            h.acquired.add(table)
            return ("reuse", cur)
        if isinstance(cur, _SampleReservation):
            if cur.owner is h:
                return ("own", cur.prior)
            return None
        if isinstance(cur, TableSample):     # published but not covering
            if any(o is not h and table in o.acquired for o in self._active):
                return None                  # wait for the table to go quiet
            self._samples[table] = _SampleReservation(h, prior=cur)
        else:
            self._samples[table] = _SampleReservation(h)
        h.reservations.add(table)
        h.acquired.add(table)
        return ("own", self._samples[table].prior)

    def _publish_sample(self, h: QueryHandle, sample: TableSample) -> None:
        # model cascade (DESIGN.md §18): fold the paid sampling sweep into
        # the difficulty estimator at the moment the sample becomes shared
        # state — the summary rides on the TableSample so explain() and
        # later covered queries see the predicted tier mix without refolding
        est = getattr(self.extractor, "difficulty", None)
        if est is not None:
            sample.difficulty = est.fold_sample(
                sample.table, sample.attrs, sample.stats,
                sampled=sample.sampled)
        self._samples[sample.table] = sample
        h.reservations.discard(sample.table)

    def _release(self, h: QueryHandle) -> None:
        """A finished/failed handle's unpublished reservations are rolled
        back — to the prior published sample when re-sampling, else cleared
        — so waiters re-acquire instead of stalling."""
        for table in list(h.reservations):
            cur = self._samples.get(table)
            if isinstance(cur, _SampleReservation) and cur.owner is h:
                if cur.prior is not None:
                    self._samples[table] = cur.prior
                else:
                    del self._samples[table]
        h.reservations.clear()

    def _finish(self, h: QueryHandle, meta: dict) -> None:
        h._finish(meta)
        self._active.remove(h)
        self._release(h)
        self._m["queries_finished"].inc()
        self.tracer.end(h._span, rows=len(h._rows))

    def _failed(self, h: QueryHandle, err: BaseException) -> None:
        h._fail(err)
        self._active.remove(h)
        self._release(h)
        self._m["queries_failed"].inc()
        self.tracer.end(h._span, error=type(err).__name__)
