"""Sampling-phase statistics (paper §2.2 / §4.2).

QUEST samples ~5% of the candidate documents, extracts every query attribute
with the LLM, and derives from that single pass: (a) per-filter selectivities,
(b) average per-attribute extraction costs, (c) evidence segments for
retrieval augmentation, and (d) the automatic thresholds tau / gamma.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

from .expr import Expr, Filter, iter_filters


def _smooth(frac: float, n: int) -> float:
    """Laplace-style smoothing keeps selectivities off the {0,1} walls so
    expected-cost products stay informative with small samples."""
    return (frac * n + 1.0) / (n + 2.0)


@dataclass
class SampleStats:
    """Statistics for one table, estimated on its sampled documents."""
    table: str
    n_sampled: int = 0
    sampled_values: dict = field(default_factory=dict)   # attr -> {doc_id: value}
    avg_cost: dict = field(default_factory=dict)         # attr -> mean tokens/doc
    evidence_segments: dict = field(default_factory=dict)  # attr -> [segment text]

    def record(self, doc_id, attr: str, value, cost_tokens: int,
               segments: Optional[list] = None):
        self.sampled_values.setdefault(attr, {})[doc_id] = value
        prev_n = self.avg_cost.get(attr, (0.0, 0))
        if isinstance(prev_n, tuple):
            tot, n = prev_n
        else:  # pragma: no cover
            tot, n = prev_n, 1
        self.avg_cost[attr] = (tot + cost_tokens, n + 1)
        if segments:
            self.evidence_segments.setdefault(attr, []).extend(segments)

    def mean_cost(self, attr: str, default: float = 500.0) -> float:
        entry = self.avg_cost.get(attr)
        if not entry:
            return default
        tot, n = entry
        return tot / max(n, 1)

    def selectivity(self, flt: Filter) -> float:
        vals = self.sampled_values.get(flt.attr)
        if not vals:
            return 0.5
        n = len(vals)
        sat = sum(1 for v in vals.values() if flt.evaluate(v))
        return _smooth(sat / n, n)

    def values(self, attr: str) -> list:
        return [v for v in self.sampled_values.get(attr, {}).values() if v is not None]

    def in_filter_selectivity(self, attr: str, allowed: set) -> float:
        vals = self.values(attr)
        if not vals:
            return 0.5
        sat = sum(1 for v in vals if v in allowed)
        return _smooth(sat / len(vals), len(vals))


def sample_size(n_docs: int, rate: float = 0.05, minimum: int = 12, maximum: int = 64) -> int:
    """~5% like the paper, floored so evidence/selectivity stay usable on
    small candidate pools (our lexical embedder needs a few exemplars per
    phrasing template; documented calibration, DESIGN.md §8.2)."""
    return max(min(minimum, n_docs), min(maximum, math.ceil(n_docs * rate)))
