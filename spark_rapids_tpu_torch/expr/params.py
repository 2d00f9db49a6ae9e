"""ParamLiteral: a literal hoisted into a parameter slot.

Counterpart of spark_rapids_tpu/expr/params.py's ``ParamLiteral``.  The
reference hoists literals out of its traced programs so that queries
differing only in their constants share one compiled program; the port
runs eagerly and has no compiled programs to share, so it does not
hoist, and a ParamLiteral that a plan carries evaluates as its value.
"""

from __future__ import annotations

from .. import types as t
from .core import EvalContext, Expression, ScalarValue, evaluator


class ParamLiteral(Expression):
    """A literal in parameter slot ``slot``; ``value`` as a Literal
    stores it (``core.literal_storage``)."""

    def __init__(self, slot: int, dtype: t.DataType, value):
        self.slot = slot
        self.dtype = dtype
        self.value = value

    def data_type(self):
        return self.dtype

    def sql(self):
        return f"$param{self.slot}"


@evaluator(ParamLiteral)
def _eval_param_literal(e: ParamLiteral, ctx: EvalContext):
    return ScalarValue(e.value, e.dtype)
