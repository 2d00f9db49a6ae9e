"""The small leaves of the expression registry: NaNvl, InSet,
AtLeastNNonNulls, the optimizer's markers KnownNotNull and
KnownFloatingPointNormalized, UnscaledValue, PreciseTimestampConversion,
InputFileBlockStart and InputFileBlockLength.

Counterpart of spark_rapids_tpu/expr/misc_tail.py (its decimal markers
PromotePrecision, MakeDecimal and CheckOverflow are in
expr/arithmetic.py).  Each is one or two torch ops, or none.
"""

from __future__ import annotations

import os

import torch

from .. import types as t
from .core import (EvalContext, Expression, Literal, column_of, evaluator,
                   make_column)


class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def data_type(self):
        # nanvl(float, float) is a float; anything else widens to double
        if all(c.data_type() == t.FLOAT for c in self.children):
            return t.FLOAT
        return t.DOUBLE

    def sql(self):
        return f"nanvl({self.children[0].sql()}, {self.children[1].sql()})"


@evaluator(NaNvl)
def _eval_nanvl(e: NaNvl, ctx: EvalContext):
    a, b = (column_of(ctx, c) for c in e.children)
    out = e.data_type()
    use_b = torch.isnan(a.data)
    return make_column(ctx, out,
                       torch.where(use_b, b.data.to(out.torch_dtype),
                                   a.data.to(out.torch_dtype)),
                       torch.where(use_b, b.validity, a.validity))


class InSet(Expression):
    """IN over a set of literal values: the optimizer's form of In for a
    long list."""

    def __init__(self, child: Expression, values):
        self.children = (child,)
        self.values = tuple(values)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"{self.children[0].sql()} IN ({len(self.values)} values)"


@evaluator(InSet)
def _eval_inset(e: InSet, ctx: EvalContext):
    from .predicates import In
    dt = e.children[0].data_type()
    return In(e.children[0], [Literal(v, dt) for v in e.values]).eval(ctx)


class AtLeastNNonNulls(Expression):
    """True where at least n children are neither null nor NaN (df.dropna's
    predicate); never null."""

    def __init__(self, n: int, children):
        self.n = int(n)
        self.children = tuple(children)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        cs = ", ".join(c.sql() for c in self.children)
        return f"atleastnnonnulls({self.n}, {cs})"


@evaluator(AtLeastNNonNulls)
def _eval_at_least_n(e: AtLeastNNonNulls, ctx: EvalContext):
    count = torch.zeros(ctx.capacity, dtype=torch.int32, device=ctx.device)
    for ch in e.children:
        c = column_of(ctx, ch)
        ok = c.validity
        if ch.data_type() in (t.DOUBLE, t.FLOAT):
            ok = ok & ~torch.isnan(c.data)
        count += ok.to(torch.int32)
    return make_column(ctx, t.BOOLEAN, count >= e.n, None)


class _PassThrough(Expression):
    """A marker of the optimizer: its child's value, unchanged."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()

    def sql(self):
        return self.children[0].sql()


class KnownNotNull(_PassThrough):
    pass


class KnownFloatingPointNormalized(_PassThrough):
    """The marker above NormalizeNaNAndZero."""


@evaluator(KnownNotNull)
@evaluator(KnownFloatingPointNormalized)
def _eval_passthrough(e: _PassThrough, ctx: EvalContext):
    return e.children[0].eval(ctx)


class UnscaledValue(Expression):
    """A DECIMAL64's unscaled value as a LONG: its lane, relabelled."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return t.LONG

    def sql(self):
        return f"unscaledvalue({self.children[0].sql()})"


class PreciseTimestampConversion(Expression):
    """The exact TIMESTAMP <-> LONG conversion of Spark's time-window
    rewrite: the microseconds lane, relabelled."""

    def __init__(self, child: Expression, from_type, to_type):
        self.children = (child,)
        self._from = from_type
        self._to = to_type

    def data_type(self):
        return self._to

    def sql(self):
        return f"precisetimestampconversion({self.children[0].sql()})"


@evaluator(UnscaledValue)
@evaluator(PreciseTimestampConversion)
def _eval_relabel(e: Expression, ctx: EvalContext):
    c = column_of(ctx, e.children[0])
    return make_column(ctx, e.data_type(), c.data.to(torch.int64),
                       c.validity)


class InputFileBlockStart(Expression):
    """The byte offset of the current input block: 0, since the port's
    readers read whole files; -1 where there is no input file."""

    children = ()

    def data_type(self):
        return t.LONG

    def sql(self):
        return "input_file_block_start()"


class InputFileBlockLength(Expression):
    """The length of the current input block: the whole file's size; -1
    where there is no input file."""

    children = ()

    def data_type(self):
        return t.LONG

    def sql(self):
        return "input_file_block_length()"


@evaluator(InputFileBlockStart)
@evaluator(InputFileBlockLength)
def _eval_file_block(e: Expression, ctx: EvalContext):
    from ..io.scan import current_input_file
    path = current_input_file()
    if not path:
        val = -1
    elif isinstance(e, InputFileBlockStart):
        val = 0
    else:
        try:
            val = os.path.getsize(path)
        except OSError:
            val = -1
    return make_column(ctx, t.LONG, val, None)
