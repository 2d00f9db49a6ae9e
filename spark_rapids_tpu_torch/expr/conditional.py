"""Conditional expressions: If, CaseWhen, Coalesce, NullIf, Nvl.

Counterpart of spark_rapids_tpu/expr/conditional.py over the port's flat
types: every branch evaluates eagerly and the result blends them with
``torch.where``.  The branch type is the promotion of the branches that
are not NULL (``_common_type``); a NULL branch or a literal branch is
broadcast to a column.  A null predicate takes the false branch.  A
STRING result gathers each row's chosen branch out of the branches'
columns laid end to end (``_string_branches``, K16), on either engine.
"""

from __future__ import annotations

import torch

from .. import types as t
from ..columnar.device import DEFAULT_CHAR_BUCKETS, DeviceColumn, bucket_for
from ..ops.carry import mask_validity
from ..ops.gather import gather_column
from ..ops.strings import concat_char_buffers
from .arithmetic import cast_data, promote
from .core import (ColumnValue, EvalContext, Expression, Literal, data_of,
                   evaluator, make_column, validity_of)
from .predicates import EqualTo, _bool_parts


def _string_column(ctx: EvalContext, e: Expression) -> DeviceColumn:
    """``e``'s value as a STRING column (a literal or NULL broadcast)."""
    v = e.eval(ctx)
    if isinstance(v, ColumnValue):
        return v.col
    return make_column(ctx, t.STRING, v.value,
                       None if v.value is not None else False).col


def _string_branches(ctx: EvalContext, exprs, fires):
    """The string value of the first firing branch of each row, else the
    last expression's (``fires`` has one flag lane per expression but
    the last): the branches' columns laid end to end, then one gather of
    row ``branch * cap + row``."""
    cap = ctx.capacity
    cols = [_string_column(ctx, x) for x in exprs]
    choice = torch.full((cap,), len(cols) - 1, dtype=torch.int64,
                        device=ctx.device)
    for i in reversed(range(len(fires))):
        choice = torch.where(fires[i], torch.full_like(choice, i), choice)
    rows = torch.arange(cap, dtype=torch.int64, device=ctx.device)
    validity = torch.stack([c.validity for c in cols])[choice, rows]
    nbytes = torch.stack([c.offsets[cap] for c in cols]).tolist()
    offs, chars = concat_char_buffers(
        [c.offsets for c in cols], [c.data for c in cols],
        [cap] * len(cols), nbytes, cap * len(cols),
        bucket_for(max(sum(nbytes), 1), DEFAULT_CHAR_BUCKETS))
    whole = DeviceColumn(t.STRING, chars,
                         torch.cat([c.validity for c in cols]), offs)
    return ColumnValue(gather_column(whole, choice * cap + rows, validity))


def _common_type(exprs) -> t.DataType:
    out = None
    for e in exprs:
        dt = e.data_type()
        if dt == t.NULL:
            continue
        out = dt if out is None else promote(out, dt)
    return out if out is not None else t.NULL


def _value_parts(ctx: EvalContext, e: Expression, out: t.DataType):
    """(data[cap], validity[cap]) of ``e`` cast to ``out``."""
    v = e.eval(ctx)
    d = data_of(v)
    if e.data_type() == t.NULL:
        d = 0
    d = cast_data(d, e.data_type(), out)
    if not isinstance(d, torch.Tensor):
        d = torch.full((ctx.capacity,), d, dtype=out.torch_dtype,
                       device=ctx.device)
    val = validity_of(v)
    if val is None:
        val = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    elif val is False:
        val = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    return d, val


class If(Expression):
    def __init__(self, pred, if_true, if_false):
        self.children = (pred, if_true, if_false)

    def data_type(self):
        return _common_type(self.children[1:])

    def sql(self):
        p, a, b = self.children
        return f"if({p.sql()}, {a.sql()}, {b.sql()})"


@evaluator(If)
def _eval_if(e: If, ctx: EvalContext):
    out = e.data_type()
    pd, pv = _bool_parts(ctx, e.children[0].eval(ctx))
    cond = pd & pv
    if out == t.STRING:
        return _string_branches(ctx, e.children[1:], [cond])
    ad, av = _value_parts(ctx, e.children[1], out)
    bd, bv = _value_parts(ctx, e.children[2], out)
    return make_column(ctx, out, torch.where(cond, ad, bd),
                       torch.where(cond, av, bv))


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... ELSE d END; children are
    [c1, v1, c2, v2, ..., else] (else is NULL when not given)."""

    def __init__(self, branches, else_value=None):
        kids = []
        for c, v in branches:
            kids += [c, v]
        kids.append(else_value if else_value is not None
                    else Literal(None, t.NULL))
        self.children = tuple(kids)
        self.n_branches = len(branches)

    def branches(self):
        return [(self.children[2 * i], self.children[2 * i + 1])
                for i in range(self.n_branches)]

    def else_value(self):
        return self.children[-1]

    def data_type(self):
        return _common_type([v for _, v in self.branches()]
                            + [self.else_value()])


@evaluator(CaseWhen)
def _eval_case(e: CaseWhen, ctx: EvalContext):
    out = e.data_type()
    taken = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    fires = []
    for c, _ in e.branches():
        pd, pv = _bool_parts(ctx, c.eval(ctx))
        fire = pd & pv & ~taken
        fires.append(fire)
        taken = taken | fire
    if out == t.STRING:
        return _string_branches(
            ctx, [v for _, v in e.branches()] + [e.else_value()], fires)
    data, validity = _value_parts(ctx, e.else_value(), out)
    for fire, (_, v) in zip(fires, e.branches()):
        vd, vv = _value_parts(ctx, v, out)
        data = torch.where(fire, vd, data)
        validity = torch.where(fire, vv, validity)
    return make_column(ctx, out, data, validity)


class Coalesce(Expression):
    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self):
        return _common_type(self.children)


@evaluator(Coalesce)
def _eval_coalesce(e: Coalesce, ctx: EvalContext):
    """Per row, the first child that is not null (null if none is)."""
    out = e.data_type()
    if out == t.STRING:
        cols = [_string_column(ctx, c) for c in e.children]
        return _string_branches(ctx, e.children,
                                [c.validity for c in cols[:-1]])
    data = torch.zeros(ctx.capacity, dtype=out.torch_dtype,
                       device=ctx.device)
    validity = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    for c in e.children:
        vd, vv = _value_parts(ctx, c, out)
        data = torch.where(~validity & vv, vd, data)
        validity = validity | vv
    return make_column(ctx, out, data, validity)


class NullIf(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self):
        return self.children[0].data_type()


@evaluator(NullIf)
def _eval_nullif(e: NullIf, ctx: EvalContext):
    """null where left = right, else left."""
    pd, pv = _bool_parts(ctx, EqualTo(*e.children).eval(ctx))
    if e.data_type() == t.STRING:
        return ColumnValue(mask_validity(_string_column(ctx, e.children[0]),
                                         ~(pd & pv)))
    d, val = _value_parts(ctx, e.children[0], e.data_type())
    return make_column(ctx, e.data_type(), d, val & ~(pd & pv))


class Nvl(Coalesce):
    def __init__(self, left, right):
        super().__init__(left, right)


evaluator(Nvl)(_eval_coalesce)
