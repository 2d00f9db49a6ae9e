"""pyspark.sql.functions-style surface of the slice.

Counterpart of spark_rapids_tpu/api/functions.py: col, lit, sum, avg
(mean), count, min, max, and the window functions row_number, rank,
dense_rank, lead, lag, ntile, percent_rank and cume_dist.
"""

from __future__ import annotations

from ..expr import aggregates as agg
from ..expr import window as win
from .column import Column, _expr, col, lit  # noqa: F401  (re-export)


def sum(c) -> Column:  # noqa: A001
    return Column(agg.AggregateExpression(agg.Sum(_expr(c))))


def count(c="*") -> Column:
    child = None if (isinstance(c, str) and c == "*") else _expr(c)
    return Column(agg.AggregateExpression(agg.Count(child)))


def avg(c) -> Column:
    return Column(agg.AggregateExpression(agg.Average(_expr(c))))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(agg.AggregateExpression(agg.Min(_expr(c))))


def max(c) -> Column:  # noqa: A001
    return Column(agg.AggregateExpression(agg.Max(_expr(c))))


# -- window ------------------------------------------------------------------

def row_number() -> Column:
    return Column(win.RowNumber())


def rank() -> Column:
    return Column(win.Rank())


def dense_rank() -> Column:
    return Column(win.DenseRank())


def lead(c, offset: int = 1) -> Column:
    return Column(win.Lead(_expr(c), offset))


def lag(c, offset: int = 1) -> Column:
    return Column(win.Lag(_expr(c), offset))


def ntile(n: int) -> Column:
    return Column(win.NTile(n))


def percent_rank() -> Column:
    return Column(win.PercentRank())


def cume_dist() -> Column:
    return Column(win.CumeDist())
