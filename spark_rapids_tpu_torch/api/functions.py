"""pyspark.sql.functions-style surface of the slice.

Counterpart of spark_rapids_tpu/api/functions.py: col, lit, sum, avg
(mean) and count.
"""

from __future__ import annotations

from ..expr import aggregates as agg
from .column import Column, _expr, col, lit  # noqa: F401  (re-export)


def sum(c) -> Column:  # noqa: A001
    return Column(agg.AggregateExpression(agg.Sum(_expr(c))))


def count(c="*") -> Column:
    child = None if (isinstance(c, str) and c == "*") else _expr(c)
    return Column(agg.AggregateExpression(agg.Count(child)))


def avg(c) -> Column:
    return Column(agg.AggregateExpression(agg.Average(_expr(c))))


mean = avg
