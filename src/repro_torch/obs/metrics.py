"""Typed metrics registry (DESIGN.md §19).

One `MetricsRegistry` replaces the ad-hoc counter dicts that grew per
subsystem (`engine.stats`, `frontend.stats`, `SchedulerStats`) with typed
instruments — `Counter` (monotone; a decrement is a hard error), `Gauge`
(set/max semantics for peaks), `Histogram` (bucketed latency counts) —
behind a *registered-name schema*: every metric the runtime may report is
declared in `SCHEMA` below, creating an undeclared instrument raises, and
`check_complete()` turns "a counter silently stopped being reported" into
a hard error instead of drift (`benchmarks/compare.py` validates bench
counters against the same schema).

The existing dict/dataclass read surfaces stay intact so no call site or
test changes shape: `StatsDict` is a `MutableMapping` whose values live
in registry instruments (`engine.stats["prefill_tokens"] += n` increments
the `engine.prefill_tokens` Counter; reading the key reads the Counter),
and the scheduler's `SchedulerStats` gets the same treatment via
attribute access. Prometheus-style text exposition (`exposition()`) hangs
off the registry; `ServingFrontend.metrics_text()` serves it.

Metric naming scheme: `<subsystem>.<what>[_<unit>]` — subsystems are
`engine`, `frontend`, `scheduler`, `session`, `ledger`. Exposition
rewrites dots to underscores (Prometheus name charset).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Optional


class MetricsSchemaError(KeyError):
    """An instrument name outside the registered schema, a type clash, or
    a schema name that was never registered (stopped being reported)."""


# --------------------------------------------------------------- schema ----
# name -> (type, help). This is THE list of counters the runtime reports;
# engine/frontend/scheduler stats surfaces are built from it, so adding a
# counter means adding it here first (and removing one here breaks the
# construction of the surface that reported it — loudly).

ENGINE_STATS = {
    "prefill_tokens": ("counter", "prompt tokens prefilled (post prefix-hit)"),
    "decode_steps": ("counter", "batched decode steps executed"),
    "evictions": ("counter", "slot evictions (retry path)"),
    "runs": ("counter", "run() drains"),
    "max_live": ("gauge", "peak concurrently-decoding slots"),
    "decode_slot_steps": ("counter", "per-slot decode work (steps x live)"),
    "prefix_hits": ("counter", "prefix-cache hits on insert"),
    "prefix_saved_tokens": ("counter", "prompt tokens skipped via prefix KV"),
    "prefix_inserts": ("counter", "prefix-cache snapshot inserts"),
    "truncations": ("counter", "run() hit max_steps with work left"),
    "failures": ("counter", "requests failed past the retry cap"),
    "prefill_invocations": ("counter", "prefill kernel dispatches"),
    "prefill_chunks": ("counter", "chunked-prefill chunks processed"),
    "cow_copies": ("counter", "copy-on-write page copies"),
    "kv_bytes_peak": ("gauge", "peak live KV-cache bytes"),
    "prefill_ctx_positions": ("counter", "attention positions prefilled"),
    "spec_rounds": ("counter", "speculative verify rounds"),
    "draft_tokens": ("counter", "draft tokens proposed"),
    "accepted_tokens": ("counter", "draft tokens accepted"),
    "decode_steps_saved": ("counter", "decode steps saved by acceptance"),
    "cancelled": ("counter", "requests cancelled"),
    "admission_deferred": ("counter", "admissions deferred on page pressure"),
}

FRONTEND_STATS = {
    "pumps": ("counter", "scheduling rounds pumped"),
    "submitted": ("counter", "tickets submitted"),
    "admitted": ("counter", "tickets admitted to the engine"),
    "completed": ("counter", "tickets completed"),
    "failed": ("counter", "tickets failed"),
    "shed": ("counter", "tickets shed (too large / queue full)"),
    "cancelled": ("counter", "tickets cancelled"),
    "timeouts": ("counter", "tickets expired in queue"),
    "deferred": ("counter", "dispatches deferred on page pressure"),
    "pool_exhausted_absorbed": ("counter", "PagePoolExhausted absorbed"),
    "queue_depth_peak": ("gauge", "peak frontend queue depth"),
}

SCHEDULER_STATS = {
    "rounds": ("counter", "extract_batch submissions"),
    "submitted": ("counter", "extractions sent to the extractor"),
    "dedup_hits": ("counter", "duplicate (doc, attr) folded into one charge"),
    "cache_hits": ("counter", "needs answered from the session cache"),
    "empty_retrievals": ("counter", "no relevant segments -> free negative"),
    "max_batch": ("gauge", "largest extraction batch"),
}

SESSION_STATS = {
    "queries": ("counter", "queries submitted"),
    "queries_finished": ("counter", "queries finished"),
    "queries_failed": ("counter", "queries failed"),
    "steps": ("counter", "multiplexer pump rounds"),
}

# CostLedger token columns — the parity-critical surface (rows + these
# must stay byte-identical tracing on vs. off). The ledger dataclass
# remains authoritative; the registry mirrors it for exposition and for
# schema validation of bench counter names.
LEDGER_COLUMNS = {
    "input_tokens": ("counter", "prompt tokens charged"),
    "output_tokens": ("counter", "completion tokens charged"),
    "llm_calls": ("counter", "LLM invocations"),
    "extractions": ("counter", "attribute extractions"),
    "batches": ("counter", "batched extraction rounds"),
    "batched_extractions": ("counter", "extractions in batched rounds"),
    "max_batch": ("gauge", "largest batch"),
    "prefix_hits": ("counter", "prefix-cache hits"),
    "saved_prefill_tokens": ("counter", "prefill tokens saved by prefix KV"),
    "draft_tokens": ("counter", "speculative draft tokens"),
    "accepted_tokens": ("counter", "speculative tokens accepted"),
    "decode_steps_saved": ("counter", "decode steps saved by speculation"),
    "cascade_small": ("counter", "extractions served by the small tier"),
    "cascade_escalations": ("counter", "small-tier answers escalated"),
    "target_tokens_saved": ("counter", "target-tier tokens saved by cascade"),
    "wall_time_s": ("gauge", "wall seconds charged"),
}

_EXTRA = {
    "frontend.queue_delay": ("histogram", "ticks from submit to dispatch"),
}


def _prefixed(prefix: str, table: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in table.items()}


SCHEMA: dict = {
    **_prefixed("engine", ENGINE_STATS),
    **_prefixed("frontend", FRONTEND_STATS),
    **_prefixed("scheduler", SCHEDULER_STATS),
    **_prefixed("session", SESSION_STATS),
    **_prefixed("ledger", LEDGER_COLUMNS),
    **_EXTRA,
}

# short (unprefixed) counter names the benches may report under derived
# spellings ("prefill_tokens_on"); compare.py strips variant suffixes and
# checks the stem against this set
SCHEMA_STEMS = frozenset(k.split(".", 1)[1] for k in SCHEMA
                         if "." in k)


def schema_stem(counter_name: str) -> Optional[str]:
    """Map a bench counter spelling to the schema stem it derives from,
    or None if no schema metric matches. Benches suffix variant tags
    (`prefill_tokens_on`, `draft_tokens_dp2`) onto schema stems; strip
    trailing tags until a stem matches."""
    name = counter_name
    while True:
        if name in SCHEMA_STEMS or name in SCHEMA:
            return name
        if "_" not in name:
            return None
        name = name.rsplit("_", 1)[0]


# ---------------------------------------------------------- instruments ----


class Counter:
    """Monotone counter. `set_total` (the dict-compat write path) rejects
    decreases — regressions in reporting fail loudly."""
    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n

    def set_total(self, v) -> None:
        if v < self.value:
            raise MetricsSchemaError(
                f"counter {self.name} would decrease ({self.value} -> {v})")
        self.value = v


class Gauge:
    """Point-in-time value; `set_max` gives peak semantics."""
    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    set_total = set                     # dict-compat write path

    def set_max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: le-bounds plus
    +Inf, running sum and count)."""
    kind = "histogram"
    __slots__ = ("name", "help", "bounds", "bucket_counts", "total", "count")

    DEFAULT_BOUNDS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)

    def __init__(self, name: str, help: str = "", bounds=None):
        self.name = name
        self.help = help
        self.bounds = tuple(bounds) if bounds is not None \
            else self.DEFAULT_BOUNDS
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name} bounds must be sorted")
        self.bucket_counts = [0] * (len(self.bounds) + 1)   # +Inf last
        self.total = 0.0
        self.count = 0

    def observe(self, v) -> None:
        self.bucket_counts[bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    @property
    def value(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "buckets": {str(b): c for b, c in
                            zip(list(self.bounds) + ["+Inf"],
                                self._cumulative())}}

    def _cumulative(self) -> list:
        out, run = [], 0
        for c in self.bucket_counts:
            run += c
            out.append(run)
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ------------------------------------------------------------- registry ----


class MetricsRegistry:
    """Central instrument store with schema enforcement.

    schema: name -> (type, help). Default is the repo-wide `SCHEMA`;
    pass `schema=None` for an open registry (tests, scratch). Creating
    an instrument whose name or type disagrees with the schema raises
    `MetricsSchemaError`; so does re-registering a name as a different
    type."""

    def __init__(self, schema: Optional[dict] = SCHEMA):
        self.schema = schema
        self._instruments: dict = {}

    # ---------------------------------------------------------- creation --

    def _make(self, name: str, typ: str, help: str, **kw):
        existing = self._instruments.get(name)
        if existing is not None:
            if existing.kind != typ:
                raise MetricsSchemaError(
                    f"metric {name} already registered as {existing.kind}, "
                    f"requested {typ}")
            return existing
        if self.schema is not None:
            decl = self.schema.get(name)
            if decl is None:
                raise MetricsSchemaError(
                    f"metric {name!r} is not in the registered schema "
                    f"(declare it in repro.obs.metrics.SCHEMA)")
            if decl[0] != typ:
                raise MetricsSchemaError(
                    f"metric {name} declared as {decl[0]}, requested {typ}")
            help = help or decl[1]
        inst = _TYPES[typ](name, help, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._make(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._make(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  bounds=None) -> Histogram:
        return self._make(name, "histogram", help, bounds=bounds)

    # ------------------------------------------------------------- reads --

    def get(self, name: str):
        try:
            return self._instruments[name]
        except KeyError:
            raise MetricsSchemaError(
                f"metric {name!r} was never registered") from None

    def value(self, name: str):
        return self.get(name).value

    def names(self) -> list:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        return {name: inst.value
                for name, inst in sorted(self._instruments.items())}

    def check_complete(self, prefix: str = "") -> None:
        """Hard-error if any schema metric (under `prefix`) was never
        registered — the "counter stopped being reported" guard."""
        if self.schema is None:
            return
        missing = [n for n in self.schema
                   if n.startswith(prefix) and n not in self._instruments]
        if missing:
            raise MetricsSchemaError(
                f"schema metrics never registered (stopped being "
                f"reported?): {sorted(missing)}")

    # -------------------------------------------------------- exposition --

    def exposition(self) -> str:
        """Prometheus text format. Dots become underscores; histograms
        expand to _bucket/_sum/_count families."""
        lines = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            pname = name.replace(".", "_")
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            lines.append(f"# TYPE {pname} {inst.kind}")
            if inst.kind == "histogram":
                cum = inst._cumulative()
                for b, c in zip(list(inst.bounds) + ["+Inf"], cum):
                    lines.append(f'{pname}_bucket{{le="{b}"}} {c}')
                lines.append(f"{pname}_sum {inst.total}")
                lines.append(f"{pname}_count {inst.count}")
            else:
                lines.append(f"{pname} {inst.value}")
        return "\n".join(lines) + ("\n" if lines else "")


# ----------------------------------------------------- compat surfaces ----


class StatsDict:
    """MutableMapping view whose values live in registry instruments.

    Drop-in for the old plain-dict stats surfaces: `stats[k] += n`
    becomes a Counter increment (Gauge set for peak keys), reads are
    registry reads, and touching a key outside the declared table is a
    `MetricsSchemaError` instead of a silently-born counter."""

    def __init__(self, registry: MetricsRegistry, prefix: str, table: dict):
        self._reg = registry
        self._prefix = prefix
        self._inst = {}
        for key, (typ, help) in table.items():
            name = f"{prefix}.{key}"
            self._inst[key] = (registry.counter(name, help) if
                               typ == "counter" else
                               registry.gauge(name, help))

    def __getitem__(self, key):
        try:
            return self._inst[key].value
        except KeyError:
            raise MetricsSchemaError(
                f"stat {key!r} is not in the {self._prefix} metrics "
                f"schema") from None

    def __setitem__(self, key, value) -> None:
        inst = self._inst.get(key)
        if inst is None:
            raise MetricsSchemaError(
                f"stat {key!r} is not in the {self._prefix} metrics "
                f"schema")
        inst.set_total(value)

    def __contains__(self, key) -> bool:
        return key in self._inst

    def __iter__(self):
        return iter(self._inst)

    def __len__(self) -> int:
        return len(self._inst)

    def keys(self):
        return self._inst.keys()

    def values(self):
        return [i.value for i in self._inst.values()]

    def items(self):
        return [(k, i.value) for k, i in self._inst.items()]

    def get(self, key, default=None):
        inst = self._inst.get(key)
        return inst.value if inst is not None else default

    def snapshot(self) -> dict:
        return {k: i.value for k, i in self._inst.items()}

    def __repr__(self) -> str:
        return f"StatsDict({self.snapshot()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsDict):
            other = other.snapshot()
        return self.snapshot() == other
