"""LLM cost accounting — the paper's primary metric (tokens per document).

Every extraction charges input tokens (prompt overhead + relevant-segment
tokens) and output tokens. The ledger is threaded through extractors so
benchmarks report exactly what Table 3 of the paper reports.

Sessions (DESIGN.md §11) use a two-level ledger: the session-wide parent
plus one `child()` per query. Token charges made against a child forward
to its parent, so the session ledger always equals the sum of its queries
(plus any direct charges), while each `QueryResult` carries only its own
query's columns — per-query accounting never double-counts across
`execute()` calls. Batch/prefix counters and wall time are recorded where
they happen (shared rounds on the parent, per-query participation on the
child) and do not forward.

Multi-tenant sessions (DESIGN.md §16) insert a tenant layer: one
`child(tenant=...)` ledger per tenant, whose own children are the
queries, so charges forward query -> tenant -> session and per-tenant
token columns fall out of the same forwarding that per-query ones do.
The `tenant` tag also rides on serving requests so the frontend can
attribute engine work back to the tenant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class CostLedger:
    input_tokens: int = 0
    output_tokens: int = 0
    llm_calls: int = 0
    extractions: int = 0
    wall_time_s: float = 0.0
    per_phase: dict = field(default_factory=dict)   # phase -> token count
    # per-attribute attribution (DESIGN.md §19): tokens/calls by the attr
    # that was being extracted — the "actual" side EXPLAIN ANALYZE joins
    # against explain()'s per-stage estimates. Batch-invariant like every
    # token column (charges are identical, only their grouping changes).
    per_attr: dict = field(default_factory=dict)        # attr -> tokens
    per_attr_calls: dict = field(default_factory=dict)  # attr -> charges
    # per-batch accounting (DESIGN.md §9): token totals are batch-invariant,
    # so batching shows up here and in wall time, never in the token columns
    batches: int = 0
    batched_extractions: int = 0
    max_batch: int = 0
    # prefix-KV-cache accounting (DESIGN.md §10): like batching, prefix
    # reuse is a *serving* saving — the logical prompt is unchanged, so the
    # token columns stay cache-invariant and the saving is reported apart
    prefix_hits: int = 0
    saved_prefill_tokens: int = 0
    # speculative-decoding accounting (DESIGN.md §14): like batching and
    # prefix reuse, speculation changes how tokens are produced, never which
    # — the token columns stay invariant and the draft/verify economy is
    # reported apart (draft tokens proposed, accepted, decode steps saved)
    draft_tokens: int = 0
    accepted_tokens: int = 0
    decode_steps_saved: int = 0
    # model-cascade accounting (DESIGN.md §18): routing an extraction to
    # the small tier changes which *model* produced the value, never which
    # value — token columns stay cascade-invariant and the per-tier economy
    # is reported apart (small-tier extractions kept, verifier escalations,
    # target-model tokens that never had to be spent)
    cascade_small: int = 0
    cascade_escalations: int = 0
    target_tokens_saved: int = 0
    # parent session ledger (child() creates the link); charges forward up
    parent: Optional["CostLedger"] = None
    # admission-control identity: set on per-tenant ledgers (and inherited
    # by their query children) so serving requests can be attributed
    tenant: str = ""

    def child(self, tenant: Optional[str] = None) -> "CostLedger":
        """Per-query (or per-tenant) child: its token charges also land on
        this ledger. `tenant` tags the child; omitted, the child inherits
        this ledger's tenant, so query ledgers under a tenant ledger carry
        the tenant tag without every caller threading it."""
        return CostLedger(parent=self,
                          tenant=self.tenant if tenant is None else tenant)

    def charge(self, *, inp: int, out: int = 0, calls: int = 1,
               phase: str = "query", attr: Optional[str] = None):
        self.input_tokens += inp
        self.output_tokens += out
        self.llm_calls += calls
        self.extractions += 1
        self.per_phase[phase] = self.per_phase.get(phase, 0) + inp + out
        if attr is not None:
            self.per_attr[attr] = self.per_attr.get(attr, 0) + inp + out
            self.per_attr_calls[attr] = self.per_attr_calls.get(attr, 0) + calls
        if self.parent is not None:
            self.parent.charge(inp=inp, out=out, calls=calls, phase=phase,
                               attr=attr)

    def record_batch(self, n: int):
        self.batches += 1
        self.batched_extractions += n
        self.max_batch = max(self.max_batch, n)

    def record_prefix(self, hits: int, saved_tokens: int):
        self.prefix_hits += hits
        self.saved_prefill_tokens += saved_tokens

    def record_spec(self, drafted: int, accepted: int, steps_saved: int):
        self.draft_tokens += drafted
        self.accepted_tokens += accepted
        self.decode_steps_saved += steps_saved

    def record_cascade(self, small: int, escalations: int, saved_tokens: int):
        self.cascade_small += small
        self.cascade_escalations += escalations
        self.target_tokens_saved += saved_tokens

    @property
    def total_tokens(self) -> int:
        return self.input_tokens + self.output_tokens

    def snapshot(self) -> dict:
        return {
            "input_tokens": self.input_tokens,
            "output_tokens": self.output_tokens,
            "total_tokens": self.total_tokens,
            "llm_calls": self.llm_calls,
            "extractions": self.extractions,
            "per_phase": dict(self.per_phase),
            "per_attr": dict(self.per_attr),
            "per_attr_calls": dict(self.per_attr_calls),
            "batches": self.batches,
            "batched_extractions": self.batched_extractions,
            "max_batch": self.max_batch,
            "prefix_hits": self.prefix_hits,
            "saved_prefill_tokens": self.saved_prefill_tokens,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "decode_steps_saved": self.decode_steps_saved,
            "cascade_small": self.cascade_small,
            "cascade_escalations": self.cascade_escalations,
            "target_tokens_saved": self.target_tokens_saved,
        }

    def merged(self, other: "CostLedger") -> "CostLedger":
        out = CostLedger(self.input_tokens + other.input_tokens,
                         self.output_tokens + other.output_tokens,
                         self.llm_calls + other.llm_calls,
                         self.extractions + other.extractions,
                         self.wall_time_s + other.wall_time_s)
        out.batches = self.batches + other.batches
        out.batched_extractions = self.batched_extractions + other.batched_extractions
        out.max_batch = max(self.max_batch, other.max_batch)
        out.prefix_hits = self.prefix_hits + other.prefix_hits
        out.saved_prefill_tokens = (self.saved_prefill_tokens +
                                    other.saved_prefill_tokens)
        out.draft_tokens = self.draft_tokens + other.draft_tokens
        out.accepted_tokens = self.accepted_tokens + other.accepted_tokens
        out.decode_steps_saved = (self.decode_steps_saved +
                                  other.decode_steps_saved)
        out.cascade_small = self.cascade_small + other.cascade_small
        out.cascade_escalations = (self.cascade_escalations +
                                   other.cascade_escalations)
        out.target_tokens_saved = (self.target_tokens_saved +
                                   other.target_tokens_saved)
        for d in (self.per_phase, other.per_phase):
            for k, v in d.items():
                out.per_phase[k] = out.per_phase.get(k, 0) + v
        for src, dst in ((self.per_attr, out.per_attr),
                         (other.per_attr, out.per_attr),
                         (self.per_attr_calls, out.per_attr_calls),
                         (other.per_attr_calls, out.per_attr_calls)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
        return out
