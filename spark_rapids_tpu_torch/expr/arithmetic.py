"""Numeric type promotion and the numeric Cast.

Counterpart of the parts of spark_rapids_tpu/expr/arithmetic.py
(``promote``, ``cast_data``) and spark_rapids_tpu/expr/cast.py
(``Cast``) that the slice uses: comparisons promote their operands, and
Sum / Average wrap their input in a Cast to the buffer type.  Arithmetic
operators themselves are not ported yet.
"""

from __future__ import annotations

import torch

from .. import types as t
from .core import (EvalContext, Expression, ScalarValue, data_of, evaluator,
                   make_column, validity_of)

_INT_ORDER = (t.IntegerType, t.LongType)
_INT_RANGE = {t.INT: (-(2**31), 2**31 - 1), t.LONG: (-(2**63), 2**63 - 1)}


def promote(a: t.DataType, b: t.DataType) -> t.DataType:
    if a == b or b == t.NULL:
        return a
    if a == t.NULL:
        return b
    if a == t.DOUBLE or b == t.DOUBLE:
        if a == t.BOOLEAN or b == t.BOOLEAN:
            raise TypeError(f"cannot promote {a} and {b}")
        return t.DOUBLE
    if t.is_integral(a) and t.is_integral(b):
        ia = _INT_ORDER.index(type(a))
        ib = _INT_ORDER.index(type(b))
        return a if ia >= ib else b
    raise TypeError(f"cannot promote {a} and {b}")


def cast_data(data, src: t.DataType, dst: t.DataType):
    """Plain numeric representation change of a tensor or a Python
    scalar (no bounds checks)."""
    if src == dst:
        return data
    if isinstance(data, torch.Tensor):
        return data.to(dst.torch_dtype)
    if dst == t.DOUBLE:
        return float(data)
    if dst == t.BOOLEAN:
        return bool(data)
    return int(data)


class Cast(Expression):
    def __init__(self, child: Expression, to: t.DataType):
        self.children = (child,)
        self.to = to

    @property
    def child(self):
        return self.children[0]

    def data_type(self):
        return self.to

    def sql(self):
        return f"CAST({self.child.sql()} AS {self.to.name})"


@evaluator(Cast)
def _eval_cast(e: Cast, ctx: EvalContext):
    src, dst = e.child.data_type(), e.to
    v = e.child.eval(ctx)
    if src == dst:
        return v
    if isinstance(v, ScalarValue):
        v = make_column(ctx, src, data_of(v), validity_of(v))
    d = v.col.data
    val = v.col.validity
    if dst == t.BOOLEAN:
        return make_column(ctx, dst, d != 0, val)
    if src == t.DOUBLE and t.is_integral(dst):
        # Spark's non-ANSI cast: NaN -> 0, out of range -> clamped
        lo, hi = _INT_RANGE[dst]
        clipped = torch.clamp(torch.where(torch.isnan(d),
                                          torch.zeros_like(d), d),
                              float(lo), float(hi))
        return make_column(ctx, dst, clipped.to(dst.torch_dtype), val)
    # int <-> int wraps like Java; int / bool -> double is exact or rounds
    return make_column(ctx, dst, d.to(dst.torch_dtype), val)

