"""Unified telemetry (DESIGN.md §19): request-lifecycle tracing, a typed
metrics registry, and the EXPLAIN ANALYZE report joiner.

Zero-dependency by design — stdlib only — so it can thread through every
layer (core/, serving/, extract/, live/) without changing what the repo
can run on. The three pieces:

  * `Tracer` (trace.py): structured spans with an injectable clock,
    exported as Chrome trace-event JSON (Perfetto) or deterministic
    JSONL. `NULL_TRACER` is the shared no-op default.
  * `MetricsRegistry` (metrics.py): typed Counter/Gauge/Histogram behind
    a registered-name schema; `StatsDict` re-backs the legacy stats-dict
    surfaces with registry instruments; Prometheus text exposition.
  * `build_report`/`render_report` (report.py): join `explain()`'s
    per-stage estimates with per-attr/per-filter actuals —
    `QueryHandle.report()`.

Wiring: construct one `Tracer` (and optionally one shared
`MetricsRegistry`) and hand it to `Session(tracer=...)`,
`ServingEngine(tracer=...)` and `ServingFrontend(tracer=...)`; see
examples/explain_analyze.py and the README "profiling a query"
quickstart.
"""
from .metrics import (SCHEMA, Counter, Gauge, Histogram, MetricsRegistry,
                      MetricsSchemaError, StatsDict, schema_stem)
from .report import build_report, render_report
from .trace import (LEVEL_FULL, LEVEL_OFF, LEVEL_PHASES, NULL_TRACER,
                    NullTracer, Span, TickClock, Tracer, as_tracer,
                    resolve_level)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "TickClock", "Span",
    "as_tracer", "resolve_level", "LEVEL_OFF", "LEVEL_PHASES", "LEVEL_FULL",
    "MetricsRegistry", "MetricsSchemaError", "Counter", "Gauge", "Histogram",
    "StatsDict", "SCHEMA", "schema_stem",
    "build_report", "render_report",
]
