"""Request-lifecycle tracing (DESIGN.md §19).

A `Tracer` records structured spans — name, kind, start/end, parent,
attrs — from every layer of the stack: `Session` query lifecycle,
`BatchScheduler` rounds, `ServingFrontend` admission, `ServingEngine`
phases, cascade tier routing, and live-corpus invalidation. Spans nest by
a plain stack: the whole runtime is a cooperative single-thread pump
(DESIGN.md §11), so "current span" is well-defined without thread locals,
and the resulting tree is well-formed by construction (every parent is an
open enclosing span; siblings cannot overlap).

Two clock modes, injectable at construction:

  * wall  — `time.perf_counter` relative to tracer construction; what you
            profile with (`examples/explain_analyze.py`, Perfetto).
  * ticks — any zero-arg callable; `TickClock()` increments by one per
            read, so the same deterministic run produces byte-identical
            trace JSONL (tests/test_obs.py pins this on both the oracle
            and the served extractor).

Long-lived operations that span many pump rounds (a query's life from
submit to finish, a serving request from admission to completion) do not
fit the stack: they are recorded as *async* spans via `begin()`/`end()`
(Chrome "b"/"e" events, grouped by id), while stack spans export as
complete "X" events. `instant()` marks point events (prefix-cache hits,
shed decisions, mutations).

Levels gate cost: 0 = off, 1 = phases (query/round/run granularity),
2 = full (per prefill chunk, decode step, verify round). `NULL_TRACER`
is the shared no-op every layer defaults to, so tracing-off call sites
pay one predicate per would-be span — the <5% overhead budget
`benchmarks/bench_obs_overhead.py` gates (alongside byte-invariance of
rows and ledger token columns, tracing on vs. off).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

LEVEL_OFF = 0
LEVEL_PHASES = 1
LEVEL_FULL = 2

_LEVEL_NAMES = {"off": LEVEL_OFF, "phases": LEVEL_PHASES, "full": LEVEL_FULL}


def resolve_level(level) -> int:
    """Accept 0/1/2 or "off"/"phases"/"full" (the `obs_level` knob)."""
    if isinstance(level, str):
        try:
            return _LEVEL_NAMES[level]
        except KeyError:
            raise ValueError(
                f"obs_level must be one of {sorted(_LEVEL_NAMES)} or 0-2, "
                f"got {level!r}") from None
    lv = int(level)
    if not LEVEL_OFF <= lv <= LEVEL_FULL:
        raise ValueError(f"obs_level must be 0..2, got {level!r}")
    return lv


class TickClock:
    """Deterministic clock: each read advances one tick. Two identical
    runs read the clock in the same order, so every span gets the same
    timestamps — the byte-stability the trace-determinism tests pin."""

    def __init__(self, start: int = 0):
        self.t = start

    def __call__(self) -> int:
        self.t += 1
        return self.t


@dataclass
class Span:
    sid: int
    parent: Optional[int]
    name: str
    kind: str
    t0: float
    t1: Optional[float] = None       # None while open / for instants of 0 dur
    attrs: dict = field(default_factory=dict)
    phase: str = "X"                 # X complete | i instant | b/e async

    def to_dict(self) -> dict:
        d = {"sid": self.sid, "parent": self.parent, "name": self.name,
             "kind": self.kind, "t0": self.t0, "t1": self.t1,
             "ph": self.phase}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanCtx:
    """Context manager for one stack span; reused objects would race under
    re-entrancy, so each `span()` call makes a fresh one (cheap: two
    attributes)."""
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer._close(self._span)


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_CTX = _NullCtx()


class Tracer:
    """Span recorder with an injectable clock and coarse/fine levels.

    clock: "wall" (perf_counter, relative to construction), "ticks"
    (fresh `TickClock`), or any zero-arg callable returning a number.
    level: 0/1/2 or "off"/"phases"/"full" — spans above the level are
    dropped at the call site (`enabled()` / no-op context)."""

    def __init__(self, *, clock="wall", level=LEVEL_FULL):
        self.level = resolve_level(level)
        if clock == "wall":
            base = time.perf_counter()
            self._clock: Callable[[], float] = \
                lambda: time.perf_counter() - base
            self.clock_kind = "wall"
        elif clock == "ticks":
            self._clock = TickClock()
            self.clock_kind = "ticks"
        elif callable(clock):
            self._clock = clock
            self.clock_kind = "external"
        else:
            raise ValueError(
                f"clock must be 'wall', 'ticks' or a callable, got {clock!r}")
        self.spans: list = []
        self._stack: list = []          # open stack spans (sync nesting)
        self._open_async: dict = {}     # sid -> Span (begin()ed, not end()ed)
        self._next_sid = 0

    # -------------------------------------------------------------- record --

    def enabled(self, level: int = LEVEL_PHASES) -> bool:
        return self.level >= level

    def now(self) -> float:
        return self._clock()

    def _new_span(self, name, kind, phase, attrs) -> Span:
        sid = self._next_sid
        self._next_sid += 1
        parent = self._stack[-1].sid if self._stack else None
        return Span(sid, parent, name, kind, self.now(), None,
                    attrs, phase)

    def span(self, name: str, *, kind: str = "span",
             level: int = LEVEL_PHASES, **attrs):
        """Open a nested stack span; use as a context manager."""
        if self.level < level:
            return _NULL_CTX
        span = self._new_span(name, kind, "X", attrs)
        self._stack.append(span)
        self.spans.append(span)
        return _SpanCtx(self, span)

    def _close(self, span: Span) -> None:
        # pop through anything left open by an exception below this span
        while self._stack and self._stack[-1] is not span:
            leaked = self._stack.pop()
            leaked.t1 = leaked.t0
        if self._stack:
            self._stack.pop()
        span.t1 = self.now()

    def instant(self, name: str, *, kind: str = "event",
                level: int = LEVEL_PHASES, **attrs) -> None:
        """Zero-duration point event attached to the current stack span."""
        if self.level < level:
            return
        span = self._new_span(name, kind, "i", attrs)
        span.t1 = span.t0
        self.spans.append(span)

    def begin(self, name: str, *, kind: str = "async",
              level: int = LEVEL_PHASES, **attrs) -> int:
        """Open a long-lived async span (query lifecycle, serving request)
        that outlives the current stack frame. Returns an id for `end()`;
        -1 when disabled at this level."""
        if self.level < level:
            return -1
        span = self._new_span(name, kind, "b", attrs)
        span.parent = None              # async spans are roots of their track
        self.spans.append(span)
        self._open_async[span.sid] = span
        return span.sid

    def end(self, sid: int, **attrs) -> None:
        span = self._open_async.pop(sid, None)
        if span is None:                # begin() was disabled or double-end
            return
        span.t1 = self.now()
        if attrs:
            span.attrs.update(attrs)

    # -------------------------------------------------------------- export --

    def _finalized(self) -> list:
        """Spans with open ends closed out (export may happen mid-run)."""
        out = []
        for s in self.spans:
            if s.t1 is None:
                s = Span(s.sid, s.parent, s.name, s.kind, s.t0, s.t0,
                         s.attrs, s.phase)
            out.append(s)
        return out

    def to_jsonl(self) -> str:
        """One deterministic JSON object per span, in emit order — the
        byte-stable export the determinism tests compare."""
        lines = [json.dumps(s.to_dict(), sort_keys=True,
                            separators=(",", ":"))
                 for s in self._finalized()]
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_jsonl())

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing).
        Stack spans export as complete "X" events; async spans as "b"/"e"
        pairs grouped by id; instants as "i". Tick clocks scale 1 tick =
        1 us so Perfetto renders a readable timeline."""
        scale = 1e6 if self.clock_kind == "wall" else 1.0
        events = []
        for s in self._finalized():
            base = {"name": s.name, "cat": s.kind, "pid": 1, "tid": 1,
                    "ts": round(s.t0 * scale, 3)}
            if s.attrs:
                base["args"] = s.attrs
            if s.phase == "X":
                events.append({**base, "ph": "X",
                               "dur": round((s.t1 - s.t0) * scale, 3)})
            elif s.phase == "i":
                events.append({**base, "ph": "i", "s": "t"})
            else:                       # async begin/end pair
                ev_id = str(s.sid)
                events.append({**base, "ph": "b", "id": ev_id})
                events.append({"name": s.name, "cat": s.kind, "pid": 1,
                               "tid": 1, "ph": "e", "id": ev_id,
                               "ts": round(s.t1 * scale, 3)})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"clock": self.clock_kind}}

    def write_chrome(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh, sort_keys=True,
                      separators=(",", ":"))

    # ------------------------------------------------------------- queries --

    def by_kind(self) -> dict:
        """{kind: {"spans": n, "wall": summed duration}} — the per-phase
        wall attribution `QueryHandle.report()` folds in."""
        agg: dict = {}
        for s in self._finalized():
            slot = agg.setdefault(s.kind, {"spans": 0, "wall": 0.0})
            slot["spans"] += 1
            slot["wall"] += (s.t1 - s.t0)
        return agg

    def find(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


class NullTracer:
    """Shared no-op tracer: default for every instrumented layer, so the
    tracing-off path is one attribute load + one method call per span
    site (gated <5% by bench_obs_overhead)."""

    level = LEVEL_OFF
    clock_kind = "off"
    spans: list = []

    def enabled(self, level: int = LEVEL_PHASES) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def span(self, name, **kw):
        return _NULL_CTX

    def instant(self, name, **kw) -> None:
        return None

    def begin(self, name, **kw) -> int:
        return -1

    def end(self, sid, **kw) -> None:
        return None

    def by_kind(self) -> dict:
        return {}

    def find(self, name) -> list:
        return []

    def to_jsonl(self) -> str:
        return ""

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"clock": "off"}}


NULL_TRACER = NullTracer()


def as_tracer(tracer) -> "Tracer":
    """Normalize an optional tracer argument: None -> NULL_TRACER."""
    return tracer if tracer is not None else NULL_TRACER
