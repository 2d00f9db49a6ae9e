"""Column wrapper over the expression IR (mirrors pyspark.sql.Column).

Counterpart of spark_rapids_tpu/api/column.py over the port's flat types:
arithmetic (``+ - * / %`` with their reflected forms, unary ``-``),
comparisons, boolean logic, ``is_null``, ``is_not_null``, ``isin``,
``eq_null_safe``, ``cast``, aliases, sort orders, ``over`` (a
window), and ``getField``, ``getItem`` and ``[]`` (a struct field or an
array element).  The string methods wait for Queue 1 item 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import types as t
from ..expr import arithmetic as ar
from ..expr import predicates as pred
from ..expr.cast import Cast
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

    # arithmetic
    def __add__(self, o):
        return Column(ar.Add(self.expr, _expr(o)))

    def __radd__(self, o):
        return Column(ar.Add(_expr(o), self.expr))

    def __sub__(self, o):
        return Column(ar.Subtract(self.expr, _expr(o)))

    def __rsub__(self, o):
        return Column(ar.Subtract(_expr(o), self.expr))

    def __mul__(self, o):
        return Column(ar.Multiply(self.expr, _expr(o)))

    def __rmul__(self, o):
        return Column(ar.Multiply(_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(ar.Divide(self.expr, _expr(o)))

    def __rtruediv__(self, o):
        return Column(ar.Divide(_expr(o), self.expr))

    def __mod__(self, o):
        return Column(ar.Remainder(self.expr, _expr(o)))

    def __neg__(self):
        return Column(ar.UnaryMinus(self.expr))

    # comparisons
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

    # null / membership
    def is_null(self):
        return Column(pred.IsNull(self.expr))

    isNull = is_null

    def is_not_null(self):
        return Column(pred.IsNotNull(self.expr))

    isNotNull = is_not_null

    def isin(self, *vals):
        if len(vals) == 1 and isinstance(vals[0], (list, tuple)):
            vals = tuple(vals[0])
        return Column(pred.In(self.expr, [Literal(v) for v in vals]))

    def eq_null_safe(self, o):
        return Column(pred.EqualNullSafe(self.expr, _expr(o)))

    eqNullSafe = eq_null_safe

    def cast(self, to):
        """A cast to a DataType, a type name ("int", "decimal(12,2)", ...)
        or a pyarrow type."""
        if isinstance(to, str):
            to = parse_type(to)
        elif not isinstance(to, t.DataType):
            from ..columnar.interop import from_arrow_type
            to = from_arrow_type(to)
        return Column(Cast(self.expr, to))

    def substr(self, start, length):
        from ..expr.strings import Substring
        return Column(Substring(self.expr, Literal(start), Literal(length)))

    def contains(self, s):
        from ..expr.strings import Contains
        return Column(Contains(self.expr, _expr(s)))

    def startswith(self, s):
        from ..expr.strings import StartsWith
        return Column(StartsWith(self.expr, _expr(s)))

    def endswith(self, s):
        from ..expr.strings import EndsWith
        return Column(EndsWith(self.expr, _expr(s)))

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

    # complex types (expr/complextype.py)
    def getItem(self, key) -> "Column":
        """``c[name]`` a struct field, ``c[i]`` an array element (0-based;
        null out of range)."""
        from ..expr.complextype import GetArrayItem, GetStructField
        if isinstance(key, str):
            return Column(GetStructField(self.expr, key))
        return Column(GetArrayItem(self.expr, _expr(key)))

    def getField(self, name: str) -> "Column":
        from ..expr.complextype import GetStructField
        return Column(GetStructField(self.expr, name))

    def __getitem__(self, key) -> "Column":
        return self.getItem(key)

    def __iter__(self):
        raise TypeError("Column is not iterable")

    def __repr__(self):
        return f"Column<{self.expr.sql()}>"


def parse_type(s: str) -> t.DataType:
    """The type a name stands for, in the reference's spellings
    (``decimal(p,s)`` included; ``types.from_name``)."""
    return t.from_name(s)


def col(name: str) -> Column:
    return Column(AttributeReference(name))


def lit(v) -> Column:
    return Column(Literal(v))
