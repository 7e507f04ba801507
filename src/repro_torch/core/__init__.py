from .expr import (And, Filter, JoinEdge, Or, Query, QueryError, conj, disj)
from .difficulty import DifficultyEstimator, DifficultyStats
from .executor import Engine, QueryResult, QueryRun, TableSample
from .ledger import CostLedger
from .ordering import exhaustive_plan, plan_expression, plan_fixed_order
from .scheduler import BatchScheduler, SchedulerStats
from .session import (PreparedQuery, QueryCancelled, QueryHandle,
                      QueryTimeout, Session, render_explain)
from .stats import SampleStats

__all__ = ["Filter", "And", "Or", "Query", "JoinEdge", "QueryError",
           "conj", "disj",
           "Engine", "QueryResult", "QueryRun", "TableSample",
           "Session", "PreparedQuery", "QueryHandle", "render_explain",
           "QueryCancelled", "QueryTimeout",
           "CostLedger", "SampleStats",
           "DifficultyEstimator", "DifficultyStats",
           "BatchScheduler", "SchedulerStats",
           "plan_expression", "plan_fixed_order", "exhaustive_plan"]
