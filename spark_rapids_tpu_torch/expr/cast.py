"""Cast among the port's flat types.

Counterpart of spark_rapids_tpu/expr/cast.py (``Cast``,
``cast_supported_on_tpu``, ``_eval_cast``, ``_int_to_int``) narrowed to
BOOLEAN, INT, LONG, DOUBLE and the NULL type.  Semantics (Spark's
non-ANSI cast):
  * double -> INT / LONG saturates as Java's ``d.toInt`` / ``d.toLong``:
    NaN -> 0, at or above 2^31 / 2^63 -> the type's maximum, below
    -2^31 / -2^63 -> its minimum, in range truncated toward zero.  The
    reference clamps to ``float(2**63 - 1)``, which is 2^63, and then
    converts, which gives INT64_MIN for 1e19 on the CPU; the port
    saturates before it converts (ROADMAP.md Queue 3);
  * integral -> narrower integral wraps bits (Java's ``l.toInt``);
  * numeric -> BOOLEAN is ``x != 0`` (NaN is true);
  * a NULL source gives an all-null column.
Casts to and from strings, dates, timestamps and decimals wait for those
types (Queue 1 item 3).
"""

from __future__ import annotations

import torch

from .. import types as t
from .core import (EvalContext, Expression, ScalarValue, all_null_column,
                   data_of, evaluator, make_column, validity_of)

_INT_LIMITS = {t.INT: (-(2**31), 2**31 - 1), t.LONG: (-(2**63), 2**63 - 1)}
_FLAT = (t.BooleanType, t.IntegerType, t.LongType, t.DoubleType)


def cast_supported_on_gpu(src: t.DataType, dst: t.DataType) -> bool:
    """Whether a cast runs on the GPU: every pair of the flat types, and
    any cast of a NULL."""
    return src == dst or isinstance(src, t.NullType) or (
        isinstance(src, _FLAT) and isinstance(dst, _FLAT))


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


def double_to_integral(d: torch.Tensor, dst: t.DataType) -> torch.Tensor:
    """Java's saturating double -> int / long conversion."""
    lo, hi = _INT_LIMITS[dst]
    too_high = d >= float(hi + 1)           # 2^31 or 2^63, exact doubles
    too_low = d < float(lo)
    zero = torch.isnan(d) | too_high | too_low
    out = torch.where(zero, torch.zeros_like(d), d).to(dst.torch_dtype)
    out = torch.where(too_high, torch.full_like(out, hi), out)
    return torch.where(too_low, torch.full_like(out, lo), out)


@evaluator(Cast)
def _eval_cast(e: Cast, ctx: EvalContext):
    src, dst = e.child.data_type(), e.to
    v = e.child.eval(ctx)
    if src == dst:
        return v
    if isinstance(src, t.NullType):
        return all_null_column(ctx, dst)
    if not cast_supported_on_gpu(src, dst):
        raise NotImplementedError(
            f"cast from {src.name} to {dst.name} is not ported yet (casts "
            f"of dates, timestamps and decimals come with those types, "
            f"Queue 1 item 3; casts to and from string with the string "
            f"functions, Queue 1 item 4)")
    if isinstance(v, ScalarValue):
        v = make_column(ctx, src, data_of(v), validity_of(v))
    d, val = v.col.data, v.col.validity
    if dst == t.BOOLEAN:
        return make_column(ctx, dst, d != 0, val)
    if src == t.DOUBLE and t.is_integral(dst):
        return make_column(ctx, dst, double_to_integral(d, dst), val)
    # int <-> int wraps like Java; int / bool -> double is exact or rounds
    return make_column(ctx, dst, d.to(dst.torch_dtype), val)
