"""Per-(doc, attr) extraction difficulty estimation for the model cascade
(DESIGN.md §18).

QUEST's sampling phase and two-level index already compute everything a
routing decision needs, for free:

  * **sampling agreement** — the full-document sweep records, per
    attribute, how often the sampled documents yielded a parseable value
    (`SampleStats.sampled_values`). An attribute that parsed on ~every
    sampled document is *easy*: its phrasing templates are regular enough
    that a small model (or even the retrieved evidence alone) pins the
    value down.
  * **retrieval score margins** — for each (doc, attr) the two-level
    index knows how far the document's best segment sits from the
    attribute's evidence probes relative to their radii
    (`TwoLevelRetriever.score_margin`). A large margin means the segment
    matches a known phrasing template dead-on; a segment scraping the
    radius is ambiguous evidence.
  * **segment cost** — longer retrieved context means more surface for a
    cheap model to get lost in (the same monotonicity the oracle noise
    model encodes).

`DifficultyEstimator` combines the three into a deterministic score in
[0, 1] (0 = trivially easy, 1 = hard), memoized per (doc, attr) so routing
is stable within a session. `CascadeExtractor` routes scores at or below
`threshold` to the small tier; everything else — plus anything the
verifier ever escalated — pays the target model directly.

Live corpora: a mutated document's memoized estimates are stale evidence;
`drop_doc` removes them (wired through `Session.drop_doc_state` /
`live.InvalidationCascade`), and the margin source is version-keyed inside
the retriever, so post-mutation scores are computed fresh.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DifficultyStats:
    scored: int = 0              # fresh (doc, attr) scores computed
    memo_hits: int = 0           # scores answered from the memo
    tables_folded: int = 0       # fold_sample calls (sampling sweeps seen)
    estimates_dropped: int = 0   # memoized scores dropped by live mutations

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class DifficultyEstimator:
    """Deterministic difficulty scores from sampling stats + index margins.

    Knobs: `threshold` (route small at score <= threshold; 0 forces the
    target tier, 1 trusts the small tier with everything the verifier will
    let it keep), `margin_weight` / `agreement_weight` / `cost_weight`
    (component mix, normalized internally), `cost_scale` (segment tokens
    at which the cost component saturates to "hard").
    """

    def __init__(self, retriever=None, *, threshold: float = 0.6,
                 margin_weight: float = 0.45, agreement_weight: float = 0.35,
                 cost_weight: float = 0.2, cost_scale: float = 160.0):
        self.retriever = retriever
        self.threshold = float(threshold)
        total = max(margin_weight + agreement_weight + cost_weight, 1e-9)
        self.margin_weight = margin_weight / total
        self.agreement_weight = agreement_weight / total
        self.cost_weight = cost_weight / total
        self.cost_scale = max(float(cost_scale), 1.0)
        self._attr: dict = {}     # (table, attr) -> sampling-derived summary
        self._scores: dict = {}   # (doc_id, attr) -> memoized score
        self.stats = DifficultyStats()

    # ------------------------------------------------------------ folding --

    def fold_sample(self, table: str, attrs, stats, sampled=()) -> dict:
        """Fold one table's sampling sweep into per-attr difficulty
        aggregates; returns the summary dict that `TableSample.difficulty`
        carries. Pre-scores the sampled documents so `predicted_split` can
        report the expected tier mix before the query phase runs. Folding
        refreshes the attr-level evidence, so memoized per-doc scores of
        the folded attrs are recomputed on next use."""
        folded: dict = {}
        attrs = sorted(attrs)
        stale = [k for k in self._scores if k[1] in set(attrs)]
        for k in stale:
            del self._scores[k]
        for attr in attrs:
            vals = stats.sampled_values.get(attr, {})
            present = sum(1 for v in vals.values() if v is not None)
            info = {
                "presence": present / len(vals) if vals else 0.0,
                "mean_cost": round(stats.mean_cost(attr), 2),
                "n": len(vals),
            }
            self._attr[(table, attr)] = info
            small = sum(1 for d in sampled
                        if self.score(d, attr, table) <= self.threshold)
            info["predicted_small"] = (round(small / len(sampled), 4)
                                       if sampled else None)
            folded[attr] = dict(info)
        self.stats.tables_folded += 1
        return folded

    def predicted_split(self, table: str, attr: str):
        """{"small": f, "target": 1-f} predicted from the sampled docs'
        scores, or None before the table's sampling phase folded."""
        info = self._attr.get((table, attr))
        if not info or info.get("predicted_small") is None:
            return None
        f = info["predicted_small"]
        return {"small": f, "target": round(1.0 - f, 4)}

    # ------------------------------------------------------------ scoring --

    def _margin_term(self, doc_id, attr: str, table: str) -> float:
        if self.retriever is None:
            return 0.5
        margin = self.retriever.score_margin(doc_id, attr, table)
        return 0.5 if margin is None else 1.0 - margin

    def _agreement_term(self, table: str, attr: str) -> float:
        info = self._attr.get((table, attr))
        if not info or not info["n"]:
            return 0.5
        return 1.0 - info["presence"]

    def _cost_term(self, table: str, attr: str, seg_tokens) -> float:
        if seg_tokens is None:
            info = self._attr.get((table, attr))
            if not info:
                return 0.5
            seg_tokens = info["mean_cost"]
        return min(1.0, max(seg_tokens, 0.0) / self.cost_scale)

    def score(self, doc_id, attr: str, table: str = None,
              seg_tokens=None) -> float:
        """Difficulty in [0, 1] for extracting `attr` from `doc_id`,
        memoized per (doc, attr). `seg_tokens` (the retrieved context
        length, when the caller already has it) sharpens the cost
        component; omitted, the sampling-phase mean cost stands in."""
        key = (doc_id, attr)
        if key in self._scores:
            self.stats.memo_hits += 1
            return self._scores[key]
        s = (self.margin_weight * self._margin_term(doc_id, attr, table)
             + self.agreement_weight * self._agreement_term(table, attr)
             + self.cost_weight * self._cost_term(table, attr, seg_tokens))
        s = round(min(1.0, max(0.0, s)), 6)
        self._scores[key] = s
        self.stats.scored += 1
        return s

    def route(self, doc_id, attr: str, table: str = None,
              seg_tokens=None) -> str:
        """"small" or "target" — the routing rule of DESIGN.md §18."""
        return ("small"
                if self.score(doc_id, attr, table, seg_tokens) <= self.threshold
                else "target")

    # ------------------------------------------------------- invalidation --

    def drop_doc(self, doc_id) -> int:
        """Live-corpus invalidation: a mutated document's memoized
        estimates are stale; drop them so post-mutation routing re-scores
        against the post-mutation index. Returns the drop count."""
        stale = [k for k in self._scores if k[0] == doc_id]
        for k in stale:
            del self._scores[k]
        self.stats.estimates_dropped += len(stale)
        return len(stale)

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out["threshold"] = self.threshold
        out["attrs_folded"] = len(self._attr)
        out["memoized"] = len(self._scores)
        return out
