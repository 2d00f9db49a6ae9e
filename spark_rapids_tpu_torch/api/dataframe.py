"""DataFrame and GroupedData of the slice.

Counterpart of spark_rapids_tpu/api/dataframe.py: filter / where,
group_by / groupBy, agg, join, collect and explain.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from ..exec.join import JOIN_TYPES
from ..expr.aggregates import AggregateExpression
from ..expr.core import Alias, AttributeReference, Expression, Literal
from ..plan import logical as L
from .column import Column


def _to_expr(c) -> Expression:
    if isinstance(c, Column):
        return c.expr
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return AttributeReference(c)
    return Literal(c)


class DataFrame:
    def __init__(self, lp: L.LogicalPlan, session):
        self._lp = lp
        self.session = session

    def filter(self, condition) -> "DataFrame":
        return DataFrame(L.Filter(_to_expr(condition), self._lp),
                         self.session)

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData([_to_expr(c) for c in cols], self)

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return self.group_by().agg(*aggs)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join with ``other``: ``on`` is a column name or a list of names
        (USING: one key column in the output) or a condition; ``how`` one
        of inner, left, right, full, left_semi, left_anti, cross, or a
        Spark alias of one."""
        how = {"leftsemi": "left_semi", "semi": "left_semi",
               "leftanti": "left_anti", "anti": "left_anti",
               "outer": "full", "fullouter": "full",
               "leftouter": "left", "rightouter": "right"}.get(
                   how.lower().replace("_", ""), how.lower())
        if how not in JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}; expected one of "
                             f"{', '.join(JOIN_TYPES)} or a Spark alias")
        cond = None
        using = None
        if on is not None:
            if isinstance(on, str):
                using = [on]
            elif isinstance(on, (list, tuple)) and on and \
                    isinstance(on[0], str):
                using = list(on)
            else:
                cond = _to_expr(on)
        return DataFrame(L.Join(self._lp, other._lp, how, cond, using),
                         self.session)

    def collect(self) -> pa.Table:
        return self.session.execute(self._lp)

    def explain(self) -> str:
        s = self.session.explain(self._lp)
        print(s)
        return s


class GroupedData:
    def __init__(self, grouping: List[Expression], df: DataFrame):
        self.grouping = grouping
        self.df = df

    def agg(self, *aggs) -> DataFrame:
        out = []
        for a in aggs:
            e = a.expr if isinstance(a, Column) else a
            name = a._alias if isinstance(a, Column) else None
            if isinstance(e, Alias) and isinstance(e.child,
                                                   AggregateExpression):
                name, e = e.name, e.child
            if not isinstance(e, AggregateExpression):
                raise TypeError(f"not an aggregate: {e}")
            out.append(AggregateExpression(e.func, name or e.name))
        return DataFrame(L.Aggregate(self.grouping, out, self.df._lp),
                         self.df.session)
