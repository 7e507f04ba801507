"""Predicate / query AST for QUEST's SPJ queries (paper §2.1).

Filters support equality, open/closed ranges, IN (used by the join
transformation) and substring containment. Expressions are arbitrary
AND/OR trees (paper §3.1.4 expression trees).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Optional, Sequence, Union


class QueryError(ValueError):
    """Malformed query: unknown operator, or a SELECT/WHERE/join reference
    to a table the query does not declare. Raised at construction (and by
    `Session.prepare`, which adds corpus-level checks) — never from deep
    inside plan evaluation mid-extraction."""


VALID_OPS = ("=", "!=", ">", ">=", "<", "<=", "between", "in", "contains")


@dataclass(frozen=True)
class Filter:
    attr: str
    op: str                      # '=' '!=' '>' '>=' '<' '<=' 'between' 'in' 'contains'
    value: Any = None
    value2: Any = None           # upper bound for 'between'
    table: str = ""              # owning table (join queries)

    def __post_init__(self):
        if self.op not in VALID_OPS:
            raise QueryError(
                f"unknown op {self.op!r} for filter on {self.attr!r} "
                f"(valid: {', '.join(VALID_OPS)})")

    def evaluate(self, v) -> bool:
        if v is None:
            return False
        try:
            if self.op == "=":
                return v == self.value
            if self.op == "!=":
                return v != self.value
            if self.op == ">":
                return v > self.value
            if self.op == ">=":
                return v >= self.value
            if self.op == "<":
                return v < self.value
            if self.op == "<=":
                return v <= self.value
            if self.op == "between":
                return self.value <= v <= self.value2
            if self.op == "in":
                return v in self.value
            if self.op == "contains":
                return str(self.value).lower() in str(v).lower()
        except TypeError:
            return False
        raise ValueError(f"unknown op {self.op}")

    @property
    def key(self) -> str:
        return f"{self.table}.{self.attr}" if self.table else self.attr

    def __str__(self):
        if self.op == "between":
            return f"{self.value} <= {self.key} <= {self.value2}"
        if self.op == "in":
            vals = list(self.value)
            shown = vals[:3] + (["..."] if len(vals) > 3 else [])
            return f"{self.key} IN {shown}"
        return f"{self.key} {self.op} {self.value}"


@dataclass(frozen=True)
class And:
    children: tuple
    def __str__(self):
        return "(" + " AND ".join(map(str, self.children)) + ")"


@dataclass(frozen=True)
class Or:
    children: tuple
    def __str__(self):
        return "(" + " OR ".join(map(str, self.children)) + ")"


Expr = Union[Filter, And, Or]


def conj(*children) -> Expr:
    return children[0] if len(children) == 1 else And(tuple(children))


def disj(*children) -> Expr:
    return children[0] if len(children) == 1 else Or(tuple(children))


def iter_filters(expr: Optional[Expr]) -> Iterator[Filter]:
    if expr is None:
        return
    if isinstance(expr, Filter):
        yield expr
    else:
        for c in expr.children:
            yield from iter_filters(c)


def expr_attrs(expr: Optional[Expr]) -> list[str]:
    seen, out = set(), []
    for f in iter_filters(expr):
        if f.attr not in seen:
            seen.add(f.attr)
            out.append(f.attr)
    return out


def filters_for_table(expr: Optional[Expr], table: str) -> Optional[Expr]:
    """Project an expression onto one table (used to split per-table
    conjunctive WHERE clauses of join queries)."""
    if expr is None:
        return None
    if isinstance(expr, Filter):
        return expr if expr.table in ("", table) else None
    kept = [filters_for_table(c, table) for c in expr.children]
    kept = [k for k in kept if k is not None]
    if not kept:
        return None
    if len(kept) == 1:
        return kept[0]
    return And(tuple(kept)) if isinstance(expr, And) else Or(tuple(kept))


def evaluate_expr(expr: Expr, values: dict) -> bool:
    """Eager evaluation given a {attr_key: value} dict (testing oracle)."""
    if isinstance(expr, Filter):
        return expr.evaluate(values.get(expr.key, values.get(expr.attr)))
    if isinstance(expr, And):
        return all(evaluate_expr(c, values) for c in expr.children)
    return any(evaluate_expr(c, values) for c in expr.children)


@dataclass(frozen=True)
class JoinEdge:
    left_table: str
    left_attr: str
    right_table: str
    right_attr: str

    def __str__(self):
        return f"{self.left_table}.{self.left_attr} = {self.right_table}.{self.right_attr}"


@dataclass
class Query:
    """SPJ query. `select`: (table, attr) pairs; `where`: AND/OR tree whose
    leaves carry a `table` tag for multi-table queries; `joins`: equi-join
    edges forming the join graph (paper §2.1)."""
    tables: Sequence[str]
    select: Sequence[tuple]             # [(table, attr)]
    where: Optional[Expr] = None
    joins: Sequence[JoinEdge] = field(default_factory=tuple)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Structural validation: every SELECT / tagged-WHERE / join
        reference must name a table the query declares. Corpus-level checks
        (table exists, attribute known) live in `Session.prepare`."""
        if not self.tables:
            raise QueryError("query declares no tables")
        declared = set(self.tables)
        for t, a in self.select:
            if t not in declared:
                raise QueryError(
                    f"SELECT {t}.{a} references table {t!r} absent from "
                    f"query.tables {sorted(declared)}")
        for f in iter_filters(self.where):
            if f.table and f.table not in declared:
                raise QueryError(
                    f"WHERE filter {f} references table {f.table!r} absent "
                    f"from query.tables {sorted(declared)}")
        for j in self.joins:
            for t in (j.left_table, j.right_table):
                if t not in declared:
                    raise QueryError(
                        f"join {j} references table {t!r} absent from "
                        f"query.tables {sorted(declared)}")

    def select_attrs(self, table: str) -> list[str]:
        return [a for t, a in self.select if t == table]

    def where_for(self, table: str) -> Optional[Expr]:
        return filters_for_table(self.where, table)

    def __str__(self):
        sel = ", ".join(f"{t}.{a}" for t, a in self.select)
        s = f"SELECT {sel} FROM {', '.join(self.tables)}"
        conds = [str(j) for j in self.joins]
        if self.where is not None:
            conds.append(str(self.where))
        if conds:
            s += " WHERE " + " AND ".join(conds)
        return s
