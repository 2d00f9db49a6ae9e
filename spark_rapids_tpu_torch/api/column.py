"""Column wrapper over the expression IR (mirrors pyspark.sql.Column).

Counterpart of spark_rapids_tpu/api/column.py, narrowed to comparisons,
boolean logic, aliases, sort orders and ``over`` (a window).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..expr import predicates as pred
from ..expr.core import Alias, AttributeReference, Expression, Literal


def _expr(v) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


class Column:
    def __init__(self, expr: Expression, alias: Optional[str] = None,
                 sort_order: Optional[Tuple[bool, bool]] = None):
        self.expr = expr
        self._alias = alias
        # (ascending, nulls_first) when the column names a sort order
        self._sort_order = sort_order

    def __eq__(self, o):  # type: ignore[override]
        return Column(pred.EqualTo(self.expr, _expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Column(pred.Not(pred.EqualTo(self.expr, _expr(o))))

    def __lt__(self, o):
        return Column(pred.LessThan(self.expr, _expr(o)))

    def __le__(self, o):
        return Column(pred.LessThanOrEqual(self.expr, _expr(o)))

    def __gt__(self, o):
        return Column(pred.GreaterThan(self.expr, _expr(o)))

    def __ge__(self, o):
        return Column(pred.GreaterThanOrEqual(self.expr, _expr(o)))

    def __and__(self, o):
        return Column(pred.And(self.expr, _expr(o)))

    def __or__(self, o):
        return Column(pred.Or(self.expr, _expr(o)))

    def __invert__(self):
        return Column(pred.Not(self.expr))

    __hash__ = None  # type: ignore[assignment]

    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name), alias=name)

    def asc(self):
        return Column(self.expr, self._alias, sort_order=(True, True))

    def desc(self):
        return Column(self.expr, self._alias, sort_order=(False, False))

    def asc_nulls_last(self):
        return Column(self.expr, self._alias, sort_order=(True, False))

    def desc_nulls_first(self):
        return Column(self.expr, self._alias, sort_order=(False, True))

    def over(self, window) -> "Column":
        """This function over a window: ``window`` is a WindowBuilder
        (``Window.partition_by(...).order_by(...)``) or a WindowSpec."""
        from ..expr.aggregates import AggregateExpression
        from ..expr.window import WindowBuilder, WindowExpression
        spec = window.spec if isinstance(window, WindowBuilder) else window
        e = self.expr
        if isinstance(e, Alias):
            name = e.name
            e = e.child
        else:
            name = self._alias
        if isinstance(e, AggregateExpression):
            e = e.func
        return Column(WindowExpression(e, spec, name))

    def __repr__(self):
        return f"Column<{self.expr.sql()}>"


def col(name: str) -> Column:
    return Column(AttributeReference(name))


def lit(v) -> Column:
    return Column(Literal(v))
