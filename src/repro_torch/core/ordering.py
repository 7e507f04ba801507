"""Filter ordering (paper §3.1, Algorithm 1).

Per document, each filter gets a cost `c` (tokens of the segments the index
retrieved for its attribute *in that document*) and a selectivity `p`
(estimated on the sample). Conjunctions sort by (1-p)/c descending (Lemma 1),
disjunctions by p/c (Eq. 5), and mixed AND/OR trees are handled by the
recursive decomposition of Eq. 6: each node's children are ordered
independently because the weight (selectivity) of a sub-expression is
order-invariant. Overall O(|filters| log |filters|).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List

from .expr import And, Expr, Filter, Or

_EPS = 1e-9


@dataclass
class PlanNode:
    kind: str                       # 'filter' | 'and' | 'or'
    filter: Filter | None = None
    children: List["PlanNode"] = field(default_factory=list)  # ordered!
    cost: float = 0.0               # C*: expected evaluation cost
    prob: float = 1.0               # P(node is True)

    def ordered_filters(self) -> list[Filter]:
        if self.kind == "filter":
            return [self.filter]
        out = []
        for c in self.children:
            out.extend(c.ordered_filters())
        return out

    def describe(self) -> str:
        if self.kind == "filter":
            return str(self.filter)
        sep = " AND " if self.kind == "and" else " OR "
        return "(" + sep.join(c.describe() for c in self.children) + ")"


def _flatten(expr: Expr) -> Expr:
    """Merge nested same-operator nodes (same precedence => one ordering
    scope, as in the paper's expression-tree construction)."""
    if isinstance(expr, Filter):
        return expr
    cls = type(expr)
    kids = []
    for c in expr.children:
        fc = _flatten(c)
        if isinstance(fc, cls):
            kids.extend(fc.children)
        else:
            kids.append(fc)
    return cls(tuple(kids))


def _combine(kind: str, planned: list[PlanNode]) -> PlanNode:
    """Expected cost / selectivity of ordered children (Eq. 2 / Eq. 4)."""
    cost, reach = 0.0, 1.0
    for ch in planned:
        cost += ch.cost * reach
        reach *= ch.prob if kind == "and" else (1.0 - ch.prob)
    prob = reach if kind == "and" else 1.0 - reach
    return PlanNode(kind, children=planned, cost=cost, prob=prob)


def plan_expression(expr: Expr,
                    cost_fn: Callable[[Filter], float],
                    sel_fn: Callable[[Filter], float]) -> PlanNode:
    """Algorithm 1: recursive optimal ordering. Returns the planned tree with
    children sorted into execution order and (cost=C*, prob) at every node."""
    expr = _flatten(expr)
    return _plan(expr, cost_fn, sel_fn)


def _plan(expr: Expr, cost_fn, sel_fn) -> PlanNode:
    if isinstance(expr, Filter):
        return PlanNode("filter", filter=expr,
                        cost=float(cost_fn(expr)), prob=float(sel_fn(expr)))
    kind = "and" if isinstance(expr, And) else "or"
    planned = [_plan(c, cost_fn, sel_fn) for c in expr.children]
    if kind == "and":
        planned.sort(key=lambda n: -((1.0 - n.prob) / max(n.cost, _EPS)))
    else:
        planned.sort(key=lambda n: -(n.prob / max(n.cost, _EPS)))
    return _combine(kind, planned)


# ------------------------------------------------------- baselines ---------


def plan_fixed_order(expr: Expr, cost_fn, sel_fn, key_fn) -> PlanNode:
    """Order children by an arbitrary key (Random / Selectivity / Average-cost
    baselines of paper §5.3). key_fn(node) -> sort key (ascending)."""
    expr = _flatten(expr)

    def rec(e):
        if isinstance(e, Filter):
            return PlanNode("filter", filter=e, cost=float(cost_fn(e)),
                            prob=float(sel_fn(e)))
        kind = "and" if isinstance(e, And) else "or"
        planned = [rec(c) for c in e.children]
        planned.sort(key=key_fn)
        return _combine(kind, planned)

    return rec(expr)


def exhaustive_plan(expr: Expr, cost_fn, sel_fn) -> PlanNode:
    """Brute-force optimum over all orders within the tree structure
    (paper's `Exhaust` baseline; exponential — test/benchmark oracle)."""
    expr = _flatten(expr)

    def rec(e):
        if isinstance(e, Filter):
            return PlanNode("filter", filter=e, cost=float(cost_fn(e)),
                            prob=float(sel_fn(e)))
        kind = "and" if isinstance(e, And) else "or"
        planned = [rec(c) for c in e.children]
        best = None
        for perm in itertools.permutations(planned):
            cand = _combine(kind, list(perm))
            if best is None or cand.cost < best.cost - 1e-12:
                best = cand
        return best

    return rec(expr)
