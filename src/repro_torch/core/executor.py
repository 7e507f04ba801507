"""QUEST execution: optimize-at-execution-time, per-document plans, run as
session-driven per-query state machines.

Flow per table (paper §2.2):
  1. document-level index -> candidate docs (generous tau);
  2. sampling phase (~5%): full-document LLM extraction of all query attrs,
     collecting selectivities, avg costs, evidence segments; thresholds
     tau/gamma are tightened from the sample (index side);
  3. per-document execution: each document gets its own filter order from
     `plan_expression` using *its* index-retrieved segment token counts
     (lazy extraction + short-circuit);
  4. joins run through the join transformation (§3.2): pick a side by the
     two-term cost model, execute it, convert the join into an IN filter on
     the other side and let the orderer place it; multi-joins are ordered
     adaptively (left-deep, re-planned after every join).

Execution is organized in two coroutine layers (DESIGN.md §9 and §11).
Within a query, each document's plan runs as a resumable coroutine that
*yields* its next (doc, attr) extraction need. Around that, the whole
query is itself a state machine: `QueryRun.run_co()` is a generator that
yields *barrier requests* — sampling acquisition, document-coroutine
rounds, bulk extraction sweeps, escalations, result-row emissions — to
the `core.session.Session` multiplexer, which merges the concurrent
barriers of every in-flight query into shared `BatchScheduler` rounds.
Within a document the lazy short-circuit order is untouched, so result
rows and ledger token totals are identical at every `batch_size` and
under any interleaving of disjoint queries.

`Engine` remains as the single-query shim over `Session` so existing call
sites keep working: `Engine.execute(query)` prepares, submits, and blocks
on one query, while `engine.ledger` / `engine.scheduler` expose the
session-wide accounting exactly as before. Per-query state (`plans_sampled`,
`QueryResult.ledger` wall time and token columns) no longer leaks across
`execute()` calls: each query gets a child ledger and its own plan log.

The engine is LLM-agnostic: `extractor` and `retriever` are duck-typed
(OracleExtractor for controlled experiments, ServedExtractor for the real
JAX serving engine; see repro/extract).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from .expr import (And, Expr, Filter, JoinEdge, Or, Query, expr_attrs,
                   iter_filters)
from .ledger import CostLedger
from .ordering import PlanNode, plan_expression
from .scheduler import OUTPUT_TOKENS, PROMPT_OVERHEAD
from .stats import SampleStats, sample_size


@dataclass
class TableContext:
    name: str
    doc_ids: list
    where: Optional[Expr]
    stats: SampleStats
    extra_filters: list = field(default_factory=list)   # IN filters from joins

    def full_expr(self) -> Optional[Expr]:
        parts = list(self.extra_filters)
        if self.where is not None:
            parts.append(self.where)
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else And(tuple(parts))


@dataclass
class TableSample:
    """One table's paid sampling investment, owned by the session: the
    sample statistics plus the docs whose attr values the sampling phase
    already put in the shared cache. A later query whose attributes are a
    subset of `attrs` reuses this wholesale and skips its sampling phase
    (its `per_phase['sampling']` stays 0)."""
    table: str
    attrs: frozenset
    stats: SampleStats
    sampled: list
    # corpus mutation-log seq at publish time (live corpora only): a sample
    # stamped below the current seq is stale evidence for exact invalidation
    version: int = 0
    # per-attr difficulty summary (DESIGN.md §18), folded at publish time
    # when the session's extractor routes through a DifficultyEstimator:
    # attr -> {presence, mean_cost, n, predicted_small}
    difficulty: dict = field(default_factory=dict)


@dataclass
class QueryResult:
    rows: list
    ledger: CostLedger
    plans_sampled: dict = field(default_factory=dict)  # doc -> plan description
    meta: dict = field(default_factory=dict)


def table_query_attrs(query: Query, table: str) -> list:
    """All attributes a query touches on `table`: WHERE filters, SELECT
    projections, and join keys — the set the sampling phase extracts."""
    return sorted(set(
        [f.attr for f in iter_filters(query.where_for(table))]
        + query.select_attrs(table)
        + [j.left_attr if j.left_table == table else j.right_attr
           for j in query.joins if table in (j.left_table, j.right_table)]))


class QueryRun:
    """Per-query execution state machine (DESIGN.md §11).

    `run_co()` is a generator that yields barrier requests to the session
    multiplexer and receives their results via `send`:

      ("sample_acquire", table, attrs) -> ("own", None) | ("reuse", TableSample)
      ("sample_publish", TableSample)  -> None (immediate)
      ("full_docs", [(doc_id, attrs)]) -> {doc_id: (values, segs, tokens)}
      ("run", {key: doc_coroutine})    -> {key: result}
      ("extract", [(doc, attr, table)])-> {(doc, attr): value}
      ("escalate", [(doc, attr)])      -> {(doc, attr): value}
      ("rows", [row, ...])             -> None (immediate; streamed to handle)

    All mutable state shared across queries (value cache, escalation set,
    retriever thresholds/evidence, sampling investments) lives on the
    session; everything here — rng, plan log, child ledger, table
    contexts — is private to one query, so nothing leaks between
    `execute()` calls.
    """

    def __init__(self, query: Query, *, retriever, extractor, cache: dict,
                 escalated: set, ledger: CostLedger, seed: int = 0,
                 sample_rate: float = 0.05, ordering: str = "quest",
                 join_strategy: str = "transform", batch_size: int = 1,
                 ctx_hook=None):
        self.query = query
        self.retriever = retriever
        self.extractor = extractor
        self._cache = cache
        self._escalated = escalated
        self.ledger = ledger
        self.rng = random.Random(seed)
        self.sample_rate = sample_rate
        self.ordering = ordering
        self.join_strategy = join_strategy
        self.batch_size = max(1, int(batch_size))
        self.ctx_hook = ctx_hook
        self._plan_log: dict = {}
        self.sampling_reused: dict = {}     # table -> bool
        # EXPLAIN ANALYZE actuals (DESIGN.md §19): per-filter short-circuit
        # outcomes, keyed (table, str(filter)) to join with explain() stages
        self.filter_evals: dict = {}        # -> [evaluated, passed]

    # ------------------------------------------------------------ basics --

    def _extract_co(self, doc_id, attr: str, table: str):
        """Coroutine flavour of extraction: yields the (doc, attr, table)
        need when uncached; the scheduler resumes it once the batched
        extraction round has landed in the cache."""
        key = (doc_id, attr)
        if key not in self._cache:
            yield (doc_id, attr, table)
        return self._cache[key]

    def _extract_required_co(self, keys: list):
        """Batch extraction for *output-critical* attributes (join keys and
        SELECT projections): a None from segment-scoped extraction would
        silently drop a result row, so it escalates once to a full-document
        prompt, honestly charged (DESIGN.md §8.3). Filters never escalate —
        their cheap free-negative semantics are the point of the index.

        The escalation memo lives on the *session* and is marked by the
        resolver, so concurrent queries needing the same key in one round
        share a single retry (first owner pays) instead of the laggard
        skipping and dropping its row; a peer's escalated value landing in
        the cache between rounds is picked up by the re-read below."""
        got = yield ("extract", list(keys))
        retry = []
        for doc_id, attr, _table in keys:
            k = (doc_id, attr)
            if got[k] is None:
                if self._cache.get(k) is not None:   # peer escalated it since
                    got[k] = self._cache[k]
                elif k not in self._escalated:
                    retry.append(k)
        if retry:
            esc = yield ("escalate", retry)
            for k in retry:
                if esc.get(k) is not None:
                    got[k] = esc[k]
        return got

    def _filter_cost(self, doc_id, flt: Filter, table: str = None) -> float:
        if (doc_id, flt.attr) in self._cache:
            return 0.0
        t = self.retriever.segment_tokens(doc_id, flt.attr, table or flt.table or None)
        return t + PROMPT_OVERHEAD if t > 0 else 0.0

    # ------------------------------------------------------ sample phase --

    def _prepare_table_co(self, table: str):
        """Sampling phase with session-level reuse: the first query on a
        table pays the ~5% full-document sweep and publishes the resulting
        `TableSample`; later queries whose attrs are covered acquire it and
        skip sampling entirely (their sampling token column stays 0)."""
        query = self.query
        attrs = table_query_attrs(query, table)
        mode, sample = yield ("sample_acquire", table, tuple(attrs))
        if mode == "reuse":
            self.sampling_reused[table] = True
            docs = self.retriever.refine_candidates(table, attrs)
            doc_set = dict.fromkeys(list(docs) + list(sample.sampled))
            ctx = TableContext(table, list(doc_set), query.where_for(table),
                               sample.stats)
            return self._wrap_ctx(ctx)
        self.sampling_reused[table] = False
        # re-sampling an uncovered table widens to the union of our attrs
        # and the prior sample's, so the session's paid coverage only grows
        if sample is not None:
            attrs = sorted(set(attrs) | set(sample.attrs))
        docs = self.retriever.candidate_docs(table, attrs)
        stats = SampleStats(table=table)
        n = sample_size(len(docs), self.sample_rate)
        if n < len(docs):
            # rank-stratified: candidate_docs is distance-ordered, so picking
            # evenly-spaced ranks from the nearer 60% yields in-domain
            # evidence even when the table's domain is a small fraction of
            # the pool, without collapsing the tau estimate to the very
            # nearest docs; the random half keeps selectivity estimates
            # representative of D_Q (DESIGN.md §8).
            pool = list(docs)
            k_head = (n + 1) // 2
            top = pool[: max(k_head, int(0.6 * len(pool)))]
            step = max(1, len(top) // k_head)
            head = top[::step][:k_head]
            rest = [d for d in pool if d not in head]
            sampled = head + self.rng.sample(rest, n - len(head))
        else:
            sampled = list(docs)
        # sampling goes through the same batched path as query execution:
        # full-document prompts of a chunk share one continuous-batching
        # round (merged with any concurrently-sampling query's chunk)
        full = yield ("full_docs", [(d, attrs) for d in sampled])
        for doc_id in sampled:
            vals, segs_by_attr, inp_tokens = full[doc_id]
            self.ledger.charge(inp=inp_tokens + PROMPT_OVERHEAD,
                               out=OUTPUT_TOKENS * len(attrs), phase="sampling")
            for attr in attrs:
                v = vals.get(attr)
                segs = segs_by_attr.get(attr, [])
                stats.record(doc_id, attr, v, inp_tokens // max(len(attrs), 1), segs)
                self._cache[(doc_id, attr)] = v
                if segs:
                    self.retriever.add_evidence(table, attr, segs, doc_id=doc_id)
        stats.n_sampled = len(sampled)
        self.retriever.finalize_thresholds(table, attrs, stats)
        yield ("sample_publish",
               TableSample(table, frozenset(attrs), stats, list(sampled)))
        docs = self.retriever.refine_candidates(table, attrs)
        # keep sampled docs in scope even if threshold refinement dropped them
        doc_set = dict.fromkeys(list(docs) + sampled)
        ctx = TableContext(table, list(doc_set), query.where_for(table), stats)
        return self._wrap_ctx(ctx)

    def _wrap_ctx(self, ctx: TableContext) -> TableContext:
        return ctx if self.ctx_hook is None else self.ctx_hook(ctx, self.query)

    # -------------------------------------------------- filter execution --

    def _plan_for_doc(self, ctx: TableContext, doc_id) -> Optional[PlanNode]:
        expr = ctx.full_expr()
        if expr is None:
            return None
        doc_cost = lambda f: self._filter_cost(doc_id, f, ctx.name)
        sel = ctx.stats.selectivity
        if self.ordering == "quest":
            return plan_expression(expr, doc_cost, sel)
        if self.ordering == "exhaust":
            from .ordering import exhaustive_plan
            return exhaustive_plan(expr, doc_cost, sel)
        if self.ordering == "avg_cost":   # global order: sample-mean costs
            return plan_expression(expr, lambda f: ctx.stats.mean_cost(f.attr), sel)
        from .ordering import plan_fixed_order
        if self.ordering == "selectivity":
            return plan_fixed_order(expr, doc_cost, sel, key_fn=lambda n: n.prob)
        if self.ordering == "random":
            return plan_fixed_order(expr, doc_cost, sel,
                                    key_fn=lambda n: self.rng.random())
        raise ValueError(f"unknown ordering {self.ordering!r}")

    def _eval_plan_co(self, node: PlanNode, ctx: TableContext, doc_id):
        """Lazy plan evaluation as a coroutine: extraction needs are yielded
        (and batched across documents — and queries — by the session); the
        short-circuit order *within* this document is exactly the serial one."""
        if node.kind == "filter":
            v = yield from self._extract_co(doc_id, node.filter.attr, ctx.name)
            ok = node.filter.evaluate(v)
            ev = self.filter_evals.setdefault((ctx.name, str(node.filter)),
                                              [0, 0])
            ev[0] += 1
            ev[1] += 1 if ok else 0
            return ok
        if node.kind == "and":
            for c in node.children:
                ok = yield from self._eval_plan_co(c, ctx, doc_id)
                if not ok:
                    return False
            return True
        for c in node.children:
            ok = yield from self._eval_plan_co(c, ctx, doc_id)
            if ok:
                return True
        return False

    def _doc_filter_co(self, ctx: TableContext, doc_id, overlap: list):
        """One document's resumable step-machine: overlap prefetch, then
        plan (costed on *this* doc's cached/pending state), then lazy eval."""
        for attr in overlap:
            yield from self._extract_co(doc_id, attr, ctx.name)
        plan = self._plan_for_doc(ctx, doc_id)
        if plan is not None and len(self._plan_log) < 64:
            self._plan_log[(ctx.name, doc_id)] = plan.describe()
        if plan is None:
            return True
        return (yield from self._eval_plan_co(plan, ctx, doc_id))

    def _execute_filters_co(self, ctx: TableContext):
        """Returns surviving doc ids (instance-optimized per-doc plans,
        executed as in-flight coroutines under the session's shared rounds)."""
        expr = ctx.full_expr()
        select_attrs = set(self.query.select_attrs(ctx.name))
        # §3.1.3: with a disjunctive root, attrs in both SELECT and WHERE must
        # be extracted regardless — pull them first (cache makes their
        # filters free, so the orderer then front-loads them).
        overlap = []
        if isinstance(expr, Or):
            overlap = [a for a in expr_attrs(expr) if a in select_attrs]
        passed = yield ("run", {d: self._doc_filter_co(ctx, d, overlap)
                                for d in ctx.doc_ids})
        return [d for d in ctx.doc_ids if passed[d]]

    # ----------------------------------------------------- cost models ----

    def _table_first_two_terms(self, ctx: TableContext, join_attr: str) -> float:
        """Eq. 9/10 first two terms: expected filter cost + P(pass) * cost of
        extracting the join attribute, summed over the table's documents."""
        total = 0.0
        for doc_id in ctx.doc_ids:
            plan = self._plan_for_doc(ctx, doc_id)
            c_join = self._filter_cost(doc_id, Filter(join_attr, "=", None), ctx.name)
            if plan is None:
                total += c_join
            else:
                total += plan.cost + plan.prob * c_join
        return total

    def _table_in_augmented_cost(self, ctx: TableContext, join_attr: str,
                                 values: set) -> float:
        """Expected cost of the IN-augmented plan on `ctx` (third term)."""
        in_f = Filter(join_attr, "in", frozenset(values), table=ctx.name)
        sel = ctx.stats.in_filter_selectivity(join_attr, set(values))
        base = ctx.full_expr()
        expr = in_f if base is None else And((in_f, base))
        total = 0.0
        for doc_id in ctx.doc_ids:
            plan = plan_expression(
                expr, lambda f: self._filter_cost(doc_id, f, ctx.name),
                lambda f: sel if f is in_f else ctx.stats.selectivity(f))
            total += plan.cost
        return total

    # ------------------------------------------------------------ joins ---

    def _edge_tables(self, edge: JoinEdge):
        return ((edge.left_table, edge.left_attr), (edge.right_table, edge.right_attr))

    def _execute_edge_co(self, edge: JoinEdge, ctxs: dict, done_tables: dict):
        """Join transformation for one edge. `done_tables`: table ->
        {doc_id: join-ready}, updated in place with survivors."""
        (t1, a1), (t2, a2) = self._edge_tables(edge)
        if t1 in done_tables and t2 in done_tables:
            return
        if t2 in done_tables:       # orient: t1 = side to execute first
            (t1, a1), (t2, a2) = (t2, a2), (t1, a1)
        if t1 not in done_tables:
            # choose direction by the two-term cost model (§3.2.1)
            c12 = self._table_first_two_terms(ctxs[t1], a1)
            c21 = self._table_first_two_terms(ctxs[t2], a2)
            if c21 < c12:
                (t1, a1), (t2, a2) = (t2, a2), (t1, a1)
            survivors = yield from self._execute_filters_co(ctxs[t1])
            done_tables[t1] = survivors
        else:
            survivors = done_tables[t1]
        # extract join attribute on side-1 survivors (one batched sweep)
        got = yield from self._extract_required_co(
            [(d, a1, t1) for d in survivors])
        values = {v for v in got.values() if v is not None}
        # transform join into IN filter on side 2, re-optimize, execute
        in_f = Filter(a2, "in", frozenset(values), table=t2)
        ctxs[t2].extra_filters.append(in_f)
        done_tables[t2] = yield from self._execute_filters_co(ctxs[t2])

    def _choose_first_edge(self, ctxs: dict) -> JoinEdge:
        best, best_cost = None, float("inf")
        for e in self.query.joins:
            (t1, a1), (t2, a2) = self._edge_tables(e)
            c = min(self._table_first_two_terms(ctxs[t1], a1),
                    self._table_first_two_terms(ctxs[t2], a2))
            if c < best_cost:
                best, best_cost = e, c
        return best

    def _choose_next_edge_co(self, ctxs: dict, done: dict, remaining: list):
        """Adaptive ordering (§3.2.2): among edges touching the joined
        prefix, estimate the IN-augmented cost on the new table."""
        best, best_cost = None, float("inf")
        for e in remaining:
            (t1, a1), (t2, a2) = self._edge_tables(e)
            if t1 in done and t2 in done:
                return e          # closing a cycle: free-ish, do it now
            if t1 not in done and t2 not in done:
                continue
            if t2 in done:
                (t1, a1), (t2, a2) = (t2, a2), (t1, a1)
            # survivors' join values may not all be extracted yet
            got = yield from self._extract_required_co(
                [(d, a1, t1) for d in done[t1]])
            values = {v for v in got.values() if v is not None}
            c = self._table_in_augmented_cost(ctxs[t2], a2, values)
            if c < best_cost:
                best, best_cost = e, c
        return best if best is not None else remaining[0]

    def _assemble_rows(self, done_tables: dict) -> list:
        """Materialize joined rows (hash join over extracted join attrs of
        surviving docs — the expensive extraction is already done)."""
        query = self.query
        tables = list(query.tables)
        rows = [{tables[0]: d} for d in done_tables.get(tables[0], [])]
        joined = {tables[0]}
        edges = list(query.joins)
        while edges:
            e = next((e for e in edges if
                      (e.left_table in joined) != (e.right_table in joined)
                      or (e.left_table in joined and e.right_table in joined)), None)
            if e is None:
                break
            edges.remove(e)
            (t1, a1), (t2, a2) = self._edge_tables(e)
            if t1 not in joined:
                (t1, a1), (t2, a2) = (t2, a2), (t1, a1)
            if t2 in joined:      # cycle edge: filter existing rows
                rows = [r for r in rows
                        if self._cache.get((r[t1], a1)) is not None
                        and self._cache.get((r[t1], a1)) == self._cache.get((r[t2], a2))]
                continue
            index = {}
            for d in done_tables.get(t2, []):
                index.setdefault(self._cache.get((d, a2)), []).append(d)
            new_rows = []
            for r in rows:
                v = self._cache.get((r[t1], a1))
                for d in index.get(v, []) if v is not None else []:
                    nr = dict(r)
                    nr[t2] = d
                    new_rows.append(nr)
            rows = new_rows
            joined.add(t2)
        return rows

    # ------------------------------------------------------------- main ---

    def run_co(self):
        """The whole-query state machine. Yields barriers (see class doc),
        emits result rows in streaming chunks as documents clear projection,
        and returns the query's meta dict."""
        query = self.query
        ctxs = {}
        for t in query.tables:
            ctxs[t] = yield from self._prepare_table_co(t)
        done: dict = {}
        if not query.joins:
            t = query.tables[0]
            done[t] = yield from self._execute_filters_co(ctxs[t])
            rows = [{t: d} for d in done[t]]
        elif self.join_strategy == "pushdown":
            # classical Plan (1): push filters into every table, extract the
            # join attributes of all survivors, hash join.
            for t in query.tables:
                done[t] = yield from self._execute_filters_co(ctxs[t])
            yield from self._extract_required_co(
                [(d, a, t) for e in query.joins
                 for t, a in self._edge_tables(e) for d in done.get(t, [])])
            rows = self._assemble_rows(done)
        else:
            remaining = list(query.joins)
            first = self._choose_first_edge(ctxs)
            remaining.remove(first)
            yield from self._execute_edge_co(first, ctxs, done)
            while remaining:
                nxt = yield from self._choose_next_edge_co(ctxs, done, remaining)
                remaining.remove(nxt)
                yield from self._execute_edge_co(nxt, ctxs, done)
            for t in query.tables:      # disconnected tables: plain filters
                if t not in done:
                    done[t] = yield from self._execute_filters_co(ctxs[t])
            rows = self._assemble_rows(done)

        # project SELECT attributes (extracted only for surviving rows), in
        # scheduler-sized chunks so rows *stream* out as their documents
        # clear projection; repeated docs across chunks dedup to one charge
        # through the shared cache, so token totals match the one-sweep path.
        for i in range(0, len(rows), self.batch_size):
            part = rows[i:i + self.batch_size]
            got = yield from self._extract_required_co(
                [(r[t], a, t) for r in part for t, a in query.select])
            out_rows = []
            for r in part:
                rec = {}
                ok = True
                for t, a in query.select:
                    v = got[(r[t], a)]
                    rec[f"{t}.{a}"] = v
                    if v is None:
                        ok = False
                rec["_docs"] = dict(r)
                if ok:
                    out_rows.append(rec)
            if out_rows:
                yield ("rows", out_rows)
        return {"survivors": {k: len(v) for k, v in done.items()},
                "sampling_reused": dict(self.sampling_reused)}


class Engine:
    """Single-query shim over `core.session.Session` (DESIGN.md §11): the
    original blocking entry point. Each `execute()` prepares, submits, and
    drains one query on the engine's session, so sequential queries share
    the session's value cache and sampling investment while their
    `QueryResult`s carry clean per-query ledgers and plan logs."""

    def __init__(self, retriever, extractor, *, sample_rate: float = 0.05,
                 seed: int = 0, ordering: str = "quest",
                 join_strategy: str = "transform",
                 ledger: Optional[CostLedger] = None,
                 batch_size: int = 1, queue_depth: int = 32):
        """ordering: quest | exhaust | avg_cost | selectivity | random
        (paper §5.3 baselines). join_strategy: transform | pushdown
        (paper §5.4: QUEST's join transformation vs. classical Plan (1)).
        batch_size/queue_depth: cross-document batching knobs (DESIGN.md §9);
        batch_size=1 is the serial per-extraction path."""
        from .session import Session
        self.session = Session(retriever, extractor, sample_rate=sample_rate,
                               seed=seed, ordering=ordering,
                               join_strategy=join_strategy, ledger=ledger,
                               batch_size=batch_size, queue_depth=queue_depth,
                               table_context_hook=self._wrap_table_context)

    # session-wide views, kept for existing call sites
    @property
    def retriever(self):
        return self.session.retriever

    @property
    def extractor(self):
        return self.session.extractor

    @property
    def ledger(self) -> CostLedger:
        return self.session.ledger

    @property
    def scheduler(self):
        return self.session.scheduler

    @property
    def _cache(self) -> dict:
        return self.session.cache

    def _wrap_table_context(self, ctx: TableContext, query: Query) -> TableContext:
        """Subclass hook: wrap/replace a freshly-built TableContext (e.g.
        benchmarks substitute ground-truth statistics)."""
        return ctx

    def execute(self, query: Query) -> QueryResult:
        return self.session.execute(query)
