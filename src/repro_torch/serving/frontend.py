"""Admission control and SLO-aware scheduling for the serving tier
(DESIGN.md §16).

The engine's `step()` is a mechanism; *policy* — who gets the next free
slot, what happens when the paged-KV pool is full, when a request has
waited too long — lives here. `ServingFrontend` fronts one `ServingEngine`
or `ReplicaGroup` with:

  admission queue   per-tenant FIFOs under weighted fair queuing (virtual
                    time: a dispatched request advances its tenant's
                    finish tag by cost/weight, cost = prompt + max_new
                    tokens), with strict priority classes on top — the
                    highest-priority backlogged head always dispatches
                    first, ties broken by fair-share vtime. Strict
                    priority can starve lower classes under sustained
                    overload by design; within one class the WFQ bound
                    applies (tests/test_serve_frontend.py pins both).
  backpressure      `PagePoolExhausted` NEVER escapes to callers. The
                    dispatch loop gates on estimated page headroom while
                    the engine is busy (work stays queued — "defer");
                    anything that slips through is absorbed by the
                    engine's `defer_admission` path or caught here and
                    counted. Requests that could *never* run (prompt over
                    max_len, page demand over the whole pool) and, with
                    `max_queue` set, requests past the bound are *shed*:
                    a typed terminal Ticket status, not an exception.
  cancellation      `cancel()` / per-ticket deadlines (deterministic pump
                    ticks or wall seconds) release every held resource —
                    queue entry, slot, paged-KV refs — wherever the
                    request is in its lifecycle (engine.cancel does the
                    engine-side cleanup; the leak regression test holds
                    pool free-count to baseline).
  observability     one `TenantStats` per tenant (serving/costs.py):
                    queue depth, admission/shed/timeout counters, pages
                    held, speculative acceptance, p50/p99 of queue wait
                    and submit→done latency — sampled in pump ticks, so
                    benches gate them deterministically.

One `pump()` is one scheduling round: expire deadlines → dispatch under
the fair-share order and page headroom → one engine step (prefill budget
`max_prefill_chunks` interleaves admission prefill with live decode,
bounding time-to-first-token) → harvest resolved requests. Drive it
synchronously (`pump_until_idle`, deterministic — what the tests and the
load bench do) or from the background pump thread (`start()`/`stop()`,
tickets resolve through `Ticket.wait`).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.models.cache_ops import PagePoolExhausted
from repro_torch.data import lm_data
from repro_torch.obs import MetricsRegistry, StatsDict, as_tracer
from repro_torch.obs.metrics import FRONTEND_STATS

from .costs import TenantStats
from .engine import Request

# ticket lifecycle: QUEUED -> ADMITTED -> one terminal state
QUEUED = "queued"
ADMITTED = "admitted"
DONE = "done"
FAILED = "failed"
SHED = "shed"            # backpressure: typed rejection, never an exception
CANCELLED = "cancelled"
TIMEOUT = "timeout"
TERMINAL = frozenset({DONE, FAILED, SHED, CANCELLED, TIMEOUT})

# typed shed reasons
SHED_QUEUE_FULL = "queue_full"   # admission queue past max_queue
SHED_TOO_LARGE = "too_large"     # could never run on this engine


@dataclass
class Ticket:
    """A request's handle through the admission tier. Terminal status is
    always one of TERMINAL; `req.out` holds the decoded tokens for DONE."""
    req: Request
    tenant: str
    priority: int
    status: str = QUEUED
    shed_reason: Optional[str] = None
    submitted_tick: int = 0
    admitted_tick: Optional[int] = None
    resolved_tick: Optional[int] = None
    deadline_tick: Optional[int] = None     # pump-tick deadline (deterministic)
    deadline_s: Optional[float] = None      # wall-clock deadline
    pages_est: int = 0
    _resolved: threading.Event = field(default_factory=threading.Event,
                                       repr=False)

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def done(self) -> bool:
        return self.status in TERMINAL

    @property
    def out(self) -> list:
        return list(self.req.out)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket resolves (background-pump mode)."""
        return self._resolved.wait(timeout)


class ServingFrontend:
    def __init__(self, engine, *, tenant_weights: Optional[dict] = None,
                 default_weight: float = 1.0,
                 max_queue: Optional[int] = None,
                 max_prefill_chunks: Optional[int] = None,
                 clock: str = "ticks", tracer=None, metrics=None):
        """engine: a ServingEngine or ReplicaGroup (duck-typed on the
        non-blocking step API: step/poll/cancel/free_slots/estimate_pages/
        pool_free_pages). The frontend owns admission — the engine's own
        `queue_depth` bound should be left None.
        tenant_weights: fair-share weight per tenant (missing tenants get
        `default_weight`); a tenant with weight 2 drains twice the token
        cost per unit virtual time of a weight-1 tenant.
        max_queue: total queued-ticket bound; past it submissions shed
        with SHED_QUEUE_FULL (None = queue without bound).
        max_prefill_chunks: per-pump prefill budget handed to
        `engine.step` — bounds how much admission prefill a round may do
        before the decode phase runs (None = drain inserts every round).
        clock: "ticks" samples latencies in pump ticks (deterministic,
        what benches gate); "wall" samples in seconds."""
        self.engine = engine
        self.weights = dict(tenant_weights or {})
        self.default_weight = float(default_weight)
        self.max_queue = max_queue
        self.max_prefill_chunks = max_prefill_chunks
        if clock not in ("ticks", "wall"):
            raise ValueError(f"clock must be 'ticks' or 'wall', got {clock!r}")
        self.clock = clock
        self.tick = 0
        self.tenants: dict = {}          # tenant -> TenantStats
        self._pending: dict = {}         # tenant -> deque[Ticket]
        self._order: list = []           # tenant arrival order (tie-break)
        self._vtime: dict = {}           # tenant -> WFQ finish tag
        self._vnow = 0.0                 # virtual time of the last dispatch
        self._inflight: dict = {}        # rid -> Ticket (admitted, unresolved)
        self._tickets: dict = {}         # rid -> Ticket (all, for poll())
        self._next_rid = 0
        # observability (DESIGN.md §19): frontend counters live in a typed
        # registry behind the legacy dict surface; `metrics_text()` serves
        # the Prometheus exposition. Pass the engine's registry as
        # `metrics` for one combined exposition (names don't collide).
        self.tracer = as_tracer(tracer)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = StatsDict(self.metrics, "frontend", FRONTEND_STATS)
        self._queue_delay = self.metrics.histogram("frontend.queue_delay")
        # max page demand a request may ever pose: the whole pool when empty
        self._pool_total = engine.pool_free_pages()
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- helpers --

    def _engines(self):
        return self.engine.engines if hasattr(self.engine, "engines") \
            else [self.engine]

    def _busy(self) -> bool:
        return any(e.active or e._inserting for e in self._engines())

    def _capacity(self) -> int:
        """Slots the engine could start filling right now (free slots minus
        already-dispatched-but-unadmitted requests)."""
        cap = sum(e.free_slots - len(e.queue) for e in self._engines())
        if hasattr(self.engine, "engines"):
            cap -= len(self.engine.queue)
        return cap

    def _now(self):
        return self.tick if self.clock == "ticks" else time.time()

    def _tenant(self, tenant: str) -> TenantStats:
        if tenant not in self.tenants:
            self.tenants[tenant] = TenantStats(tenant=tenant)
            self._pending[tenant] = deque()
            self._order.append(tenant)
            self._vtime[tenant] = self._vnow
        return self.tenants[tenant]

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._pending.values())

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def has_work(self) -> bool:
        return bool(self.queued or self._inflight)

    # ------------------------------------------------------------ intake --

    def submit(self, prompt=None, *, req: Optional[Request] = None,
               tenant: str = "default", priority: int = 0,
               max_new: int = 16, eos_id: int = lm_data.EOS,
               shared_len: int = 0, deadline_ticks: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Queue one request under `tenant`. Always returns a Ticket: a
        request that cannot be accepted resolves immediately with a typed
        SHED status instead of raising."""
        with self._lock:
            if req is None:
                req = Request(rid=self._next_rid, prompt=list(prompt),
                              max_new=max_new, eos_id=eos_id,
                              shared_len=shared_len)
            self._next_rid = max(self._next_rid, req.rid) + 1
            req.tenant, req.priority = tenant, priority
            t = Ticket(req=req, tenant=tenant, priority=priority,
                       submitted_tick=self.tick)
            if deadline_ticks is not None:
                t.deadline_tick = self.tick + int(deadline_ticks)
            if deadline_s is not None:
                t.deadline_s = time.time() + float(deadline_s)
            self._tickets[req.rid] = t
            ts = self._tenant(tenant)
            ts.note_queued()
            self.stats["submitted"] += 1
            eng0 = self._engines()[0]
            t.pages_est = self.engine.estimate_pages(len(req.prompt),
                                                     req.max_new)
            if eng0._extra + len(req.prompt) > eng0.max_len or \
                    (self._pool_total is not None and
                     t.pages_est > self._pool_total):
                self._resolve(t, SHED, reason=SHED_TOO_LARGE)
                return t
            if self.max_queue is not None and self.queued >= self.max_queue:
                self._resolve(t, SHED, reason=SHED_QUEUE_FULL)
                return t
            # WFQ: a tenant going from idle to backlogged catches its
            # finish tag up to the current virtual time (no credit hoarding)
            if not self._pending[tenant]:
                self._vtime[tenant] = max(self._vtime[tenant], self._vnow)
            self._pending[tenant].append(t)
            self.stats["queue_depth_peak"] = max(
                self.stats["queue_depth_peak"], self.queued)
            return t

    def submit_many(self, prompts=None, *, reqs=None, tenant: str = "default",
                    **kw) -> list:
        """All-or-nothing admission accounting: with `max_queue` set,
        either the whole batch queues or the whole batch sheds with
        SHED_QUEUE_FULL — a batch is never left half-enqueued."""
        with self._lock:
            items = list(reqs) if reqs is not None else list(prompts)
            n = len(items)
            if self.max_queue is not None and self.queued + n > self.max_queue:
                out = []
                for it in items:
                    t = self.submit(
                        **({"req": it} if isinstance(it, Request)
                           else {"prompt": it}), tenant=tenant, **kw)
                    if t.status == QUEUED:      # the bound cut in mid-batch
                        self._unqueue(t)
                        self._resolve(t, SHED, reason=SHED_QUEUE_FULL)
                    elif t.status == SHED and t.shed_reason != SHED_QUEUE_FULL:
                        pass                    # keep the more specific reason
                    else:
                        t.status, t.shed_reason = SHED, SHED_QUEUE_FULL
                        t.resolved_tick = self.tick
                    out.append(t)
                return out
            return [self.submit(
                **({"req": it} if isinstance(it, Request)
                   else {"prompt": it}), tenant=tenant, **kw)
                for it in items]

    # ------------------------------------------------------- lifecycle ----

    def _unqueue(self, t: Ticket) -> bool:
        q = self._pending.get(t.tenant)
        if q is not None and t in q:
            q.remove(t)
            return True
        return False

    def _resolve(self, t: Ticket, status: str, reason: Optional[str] = None):
        was_admitted = t.status == ADMITTED
        t.status, t.shed_reason = status, reason
        t.resolved_tick = self.tick
        ts = self.tenants[t.tenant]
        if not was_admitted:
            ts.queue_depth = max(0, ts.queue_depth - 1)
        else:
            ts.in_flight -= 1
            ts.pool_pages_held -= t.pages_est
            ts.draft_tokens += t.req.draft_tokens
            ts.accepted_tokens += t.req.accepted_tokens
            self._inflight.pop(t.rid, None)
        key = {DONE: "completed", FAILED: "failed", SHED: "shed",
               CANCELLED: "cancelled", TIMEOUT: "timeouts"}[status]
        self.stats[key] += 1
        if status == SHED:
            self.tracer.instant("frontend.shed", kind="frontend",
                                rid=t.rid, tenant=t.tenant, reason=reason)
        setattr(ts, key, getattr(ts, key) + 1)
        if status == DONE:
            ts.latency.add(self._now() - (t.submitted_tick if
                                          self.clock == "ticks"
                                          else t.req.submitted_s))
        t._resolved.set()

    def cancel(self, ticket: Ticket) -> bool:
        """Cancel a ticket anywhere in its lifecycle, releasing held
        resources. False when it already resolved (cancel lost the race)."""
        with self._lock:
            if ticket.done:
                return False
            if ticket.status == QUEUED:
                self._unqueue(ticket)
                self._resolve(ticket, CANCELLED)
                return True
            self.engine.cancel(ticket.rid)
            self._resolve(ticket, CANCELLED)
            return True

    def poll(self, rid: int) -> Optional[Ticket]:
        with self._lock:
            return self._tickets.get(rid)

    def _expire(self):
        now_s = time.time()
        for t in list(self._inflight.values()):
            if (t.deadline_tick is not None and self.tick >= t.deadline_tick) \
                    or (t.deadline_s is not None and now_s >= t.deadline_s):
                self.engine.cancel(t.rid)
                self._resolve(t, TIMEOUT)
        for q in self._pending.values():
            for t in list(q):
                if (t.deadline_tick is not None and
                        self.tick >= t.deadline_tick) or \
                        (t.deadline_s is not None and now_s >= t.deadline_s):
                    q.remove(t)
                    self._resolve(t, TIMEOUT)

    # ------------------------------------------------------- scheduling ---

    def _weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def _peek_next(self) -> Optional[Ticket]:
        """Strict priority first, then min WFQ finish tag, then tenant
        arrival order — deterministic under equal weights/timing."""
        best_key, best = None, None
        for i, tenant in enumerate(self._order):
            q = self._pending[tenant]
            if not q:
                continue
            head = q[0]
            key = (-head.priority, self._vtime[tenant], i)
            if best_key is None or key < best_key:
                best_key, best = key, head
        return best

    def _dispatch_one(self, t: Ticket):
        self._pending[t.tenant].popleft()
        cost = len(t.req.prompt) + t.req.max_new
        self._vnow = self._vtime[t.tenant]
        self._vtime[t.tenant] += cost / self._weight(t.tenant)
        t.status, t.admitted_tick = ADMITTED, self.tick
        t.req.submitted_s = time.time()
        self.engine.queue.append(t.req)   # frontend owns the admission bound
        ts = self.tenants[t.tenant]
        ts.queue_depth -= 1
        ts.admitted += 1
        ts.in_flight += 1
        ts.pool_pages_held += t.pages_est
        wait = self._now() - (t.submitted_tick if self.clock == "ticks"
                              else t.req.submitted_s)
        ts.queue_wait.add(wait)
        self._queue_delay.observe(wait)
        self._inflight[t.rid] = t
        self.stats["admitted"] += 1
        if self.tracer.enabled(2):
            self.tracer.instant("frontend.admit", kind="frontend", level=2,
                                rid=t.rid, tenant=t.tenant, wait=wait)

    # ------------------------------------------------------------- pump ---

    def pump(self) -> bool:
        """One scheduling round; returns whether work remains. Safe to call
        when idle (a no-op round)."""
        with self._lock:
            self.tick += 1
            self.stats["pumps"] += 1
            with self.tracer.span("frontend.pump", kind="frontend", level=2,
                                  tick=self.tick):
                return self._pump_locked()

    def _pump_locked(self) -> bool:
        self._expire()
        cap = self._capacity()
        headroom = self.engine.pool_free_pages()
        busy = self._busy()
        while cap > 0:
            t = self._peek_next()
            if t is None:
                break
            if headroom is not None and busy and t.pages_est > headroom:
                # keep it queued: live work will release pages — this
                # is the "defer" arm of the backpressure state machine
                self.stats["deferred"] += 1
                break
            self._dispatch_one(t)
            cap -= 1
            if headroom is not None:
                headroom -= t.pages_est
                busy = True      # an idle engine is busy once fed
        if self._busy() or any(e.queue for e in self._engines()) or \
                (hasattr(self.engine, "engines") and self.engine.queue):
            try:
                self.engine.step(
                    max_prefill_chunks=self.max_prefill_chunks,
                    defer_admission=True)
            except PagePoolExhausted:
                # the engine requeued the request at its queue head
                # (hardening contract) — absorb, count, retry next pump
                self.stats["pool_exhausted_absorbed"] += 1
        for rid, t in list(self._inflight.items()):
            req = self.engine.poll(rid)
            if req is None:
                continue
            if req.done:
                self._resolve(t, DONE)
            elif req.error == "cancelled":
                self._resolve(t, CANCELLED)
            else:
                self._resolve(t, FAILED)
        return self.has_work()

    def pump_until_idle(self, max_pumps: int = 100_000):
        """Synchronous drain (deterministic; what tests and benches use).
        Raises RuntimeError rather than spinning forever."""
        for _ in range(max_pumps):
            if not self.pump():
                return
        if self.has_work():
            raise RuntimeError(
                f"frontend still has work after {max_pumps} pumps "
                f"({self.queued} queued, {self.in_flight} in flight)")

    def wait_all(self, tickets, max_pumps: int = 100_000) -> list:
        """Pump until every ticket resolves; returns them (thread mode:
        just waits)."""
        if self._thread is not None:
            for t in tickets:
                t.wait()
            return list(tickets)
        for _ in range(max_pumps):
            if all(t.done for t in tickets):
                return list(tickets)
            self.pump()
        raise RuntimeError(f"tickets unresolved after {max_pumps} pumps")

    # ------------------------------------------------------ pump thread ---

    def start(self, interval_s: float = 0.0):
        """Run the pump on a background thread; `submit`/`cancel` stay
        safe from other threads and tickets resolve via `Ticket.wait`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.pump():
                    time.sleep(max(interval_s, 1e-3))   # idle: don't spin
                elif interval_s:
                    time.sleep(interval_s)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-frontend-pump")
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    # ------------------------------------------------------ observability --

    def tenant_snapshot(self) -> dict:
        return {name: ts.snapshot() for name, ts in self.tenants.items()}

    def metrics_text(self) -> str:
        """Prometheus text exposition: the typed registry (frontend counters,
        queue-delay histogram, plus engine/session instruments when a shared
        registry was passed in) followed by per-tenant gauge lines rendered
        from `tenant_snapshot()` with a `tenant` label."""
        lines = [self.metrics.exposition().rstrip("\n")]
        per_tenant = ("queue_depth", "in_flight", "admitted", "completed",
                      "shed", "timeouts", "cancelled", "pool_pages_held")
        lines.append("# TYPE repro_frontend_tenant gauge")
        for tenant in sorted(self.tenants):
            snap = self.tenants[tenant].snapshot()
            for key in per_tenant:
                lines.append(
                    f'repro_frontend_tenant{{tenant="{tenant}",'
                    f'stat="{key}"}} {snap[key]}')
        return "\n".join(lines) + "\n"
