"""Conditional expressions: Coalesce.

Counterpart of spark_rapids_tpu/expr/conditional.py, narrowed to
Coalesce over the port's numeric and boolean types (the key column of a
full join with USING).  If, CaseWhen, NullIf and the string branches are
not ported yet.
"""

from __future__ import annotations

import torch

from .arithmetic import cast_data, promote
from .core import (EvalContext, Expression, ScalarValue, data_of, evaluator,
                   make_column, validity_of)


class Coalesce(Expression):
    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self):
        out = self.children[0].data_type()
        for c in self.children[1:]:
            out = promote(out, c.data_type())
        return out


@evaluator(Coalesce)
def _eval_coalesce(e: Coalesce, ctx: EvalContext):
    """Per row, the first child that is not null (null if none is)."""
    out = e.data_type()
    data = torch.zeros(ctx.capacity, dtype=out.torch_dtype,
                       device=ctx.device)
    validity = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    for c in e.children:
        v = c.eval(ctx)
        if isinstance(v, ScalarValue):
            v = make_column(ctx, c.data_type(), data_of(v), validity_of(v))
        take = ~validity & v.col.validity
        data = torch.where(take, cast_data(v.col.data, c.data_type(), out),
                           data)
        validity = validity | v.col.validity
    return make_column(ctx, out, data, validity)
