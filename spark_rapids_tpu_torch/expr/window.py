"""Window expressions.

Counterpart of spark_rapids_tpu/expr/window.py.  A WindowExpression pairs
a window function (ranking, lead/lag, or an aggregate) with a WindowSpec
(partition keys, ordering, frame).  exec/window.py evaluates them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .. import types as t
from .aggregates import AggregateFunction
from .core import Expression

UNBOUNDED_PRECEDING = -(2**31)
UNBOUNDED_FOLLOWING = 2**31
CURRENT_ROW = 0


class WindowSpec:
    def __init__(self, partition_by: List[Expression] = None,
                 order_by: List[Tuple[Expression, bool, bool]] = None,
                 frame: Optional[Tuple[str, int, int]] = None):
        self.partition_by = partition_by or []
        # order_by: [(expr, ascending, nulls_first)]
        self.order_by = order_by or []
        # frame: (kind, start, end), kind 'rows' or 'range'
        self.frame = frame

    def effective_frame(self, is_ranking: bool) -> Tuple[str, int, int]:
        if self.frame is not None:
            return self.frame
        if self.order_by and not is_ranking:
            # Spark's default with ORDER BY: range unbounded preceding ..
            # current row, so peers (rows tied on the order keys) share
            # one value
            return ("range", UNBOUNDED_PRECEDING, CURRENT_ROW)
        return ("rows", UNBOUNDED_PRECEDING, UNBOUNDED_FOLLOWING)


class Window:
    """pyspark-style builder: Window.partition_by(...).order_by(...)."""

    unboundedPreceding = UNBOUNDED_PRECEDING
    unboundedFollowing = UNBOUNDED_FOLLOWING
    currentRow = CURRENT_ROW

    @staticmethod
    def partition_by(*cols) -> "WindowBuilder":
        return WindowBuilder().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> "WindowBuilder":
        return WindowBuilder().order_by(*cols)

    orderBy = order_by


class WindowBuilder:
    def __init__(self):
        self.spec = WindowSpec()

    def partition_by(self, *cols):
        from ..api.dataframe import _to_expr
        self.spec.partition_by = [_to_expr(c) for c in cols]
        return self

    partitionBy = partition_by

    def order_by(self, *cols):
        from ..api.column import Column
        from ..api.dataframe import _to_expr
        orders = []
        for c in cols:
            if isinstance(c, Column) and c._sort_order is not None:
                orders.append((c.expr, *c._sort_order))
            else:
                orders.append((_to_expr(c), True, True))
        self.spec.order_by = orders
        return self

    orderBy = order_by

    def rows_between(self, start: int, end: int):
        self.spec.frame = ("rows", start, end)
        return self

    rowsBetween = rows_between

    def range_between(self, start: int, end: int):
        self.spec.frame = ("range", start, end)
        return self

    rangeBetween = range_between


class WindowFunction(Expression):
    is_ranking = False


class RowNumber(WindowFunction):
    is_ranking = True

    def data_type(self):
        return t.INT

    @property
    def nullable(self):
        return False


class Rank(RowNumber):
    pass


class DenseRank(RowNumber):
    pass


class Lead(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.children = (child,)
        self.offset = offset
        self.default = default

    def data_type(self):
        return self.children[0].data_type()


class Lag(Lead):
    pass


class PercentRank(RowNumber):
    """(rank - 1) / (partition rows - 1); 0.0 for a one-row partition."""

    def data_type(self):
        return t.DOUBLE


class CumeDist(RowNumber):
    """Rows with an order key <= the current row's / partition rows."""

    def data_type(self):
        return t.DOUBLE


class NTile(WindowFunction):
    is_ranking = True

    def __init__(self, n: int):
        self.children = ()
        self.n = n

    def data_type(self):
        return t.INT


class WindowExpression(Expression):
    def __init__(self, func, spec: WindowSpec, name: str = None):
        self.children = (func,)
        self.func = func
        self.spec = spec
        self.name = name or f"{type(func).__name__.lower()}_w"

    def with_children(self, children):
        # func mirrors children[0], as in AggregateExpression
        c = super().with_children(children)
        c.func = c.children[0]
        return c

    def data_type(self):
        return self.func.data_type()

    def resolved_type(self, names, dtypes):
        from .aggregates import AggregateExpression, bind_aggregate
        from .core import bind_expression
        f = self.func
        if isinstance(f, AggregateFunction):
            ae = bind_aggregate(AggregateExpression(f), names, dtypes)
            return ae.func.data_type()
        if isinstance(f, (Lead, Lag)):
            return bind_expression(f.children[0], names, dtypes).data_type()
        return f.data_type()

    def sql(self):
        return self.name
