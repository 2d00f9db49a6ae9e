"""Bitwise expressions: BitwiseAnd, BitwiseOr, BitwiseXor, BitwiseNot,
ShiftLeft, ShiftRight and ShiftRightUnsigned.

Counterpart of spark_rapids_tpu/expr/bitwise.py, with its result types:
a binary op takes the wider operand's type, a shift INT unless its value
is a LONG.  Shift distances are masked by the width minus one, as Java
does.  ``>>`` of a signed torch integer is arithmetic; the unsigned
shift is logical: a LONG is shifted and masked to its 64 - s low bits
(torch has no uint64 ``>>``), an INT is shifted in int64 from its low 32
bits and wrapped back.
"""

from __future__ import annotations

import torch

from .. import types as t
from .arithmetic import operands, wrap_int
from .core import (EvalContext, Expression, data_of, evaluator,
                   make_column, validity_of)

_WIDTH = {t.BYTE: 1, t.SHORT: 2, t.INT: 4, t.LONG: 8}


def _width(dt: t.DataType) -> int:
    return _WIDTH.get(dt, 8)


class _BitwiseBinary(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def data_type(self):
        lt = self.children[0].data_type()
        rt = self.children[1].data_type()
        return lt if _width(lt) >= _width(rt) else rt

    def sql(self):
        return (f"({self.children[0].sql()} {self.symbol} "
                f"{self.children[1].sql()})")


class BitwiseAnd(_BitwiseBinary):
    symbol = "&"


class BitwiseOr(_BitwiseBinary):
    symbol = "|"


class BitwiseXor(_BitwiseBinary):
    symbol = "^"


_BINARY = {BitwiseAnd: lambda a, b: a & b, BitwiseOr: lambda a, b: a | b,
           BitwiseXor: lambda a, b: a ^ b}


@evaluator(BitwiseAnd)
@evaluator(BitwiseOr)
@evaluator(BitwiseXor)
def _eval_bitwise(e: _BitwiseBinary, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.children[0], e.children[1], out)
    return make_column(ctx, out, _BINARY[type(e)](ld, rd), v)


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()


@evaluator(BitwiseNot)
def _eval_bnot(e: BitwiseNot, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    return make_column(ctx, e.data_type(), ~data_of(v), validity_of(v))


class _Shift(Expression):
    """value SHIFT distance; the distance is masked by the width - 1."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def data_type(self):
        return t.LONG if self.children[0].data_type() == t.LONG else t.INT


class ShiftLeft(_Shift):
    pass


class ShiftRight(_Shift):
    pass


class ShiftRightUnsigned(_Shift):
    pass


def _logical_shr(x: torch.Tensor, s, bits: int) -> torch.Tensor:
    """x >> s with zeros shifted in, for 0 <= s < bits: an INT from its
    low 32 bits in int64, a LONG shifted and masked to its 64 - s low
    bits (``~(-1 << (63 - s) << 1)`` for a column of distances: no shift
    past 63)."""
    if bits == 32:
        return (x.to(torch.int64) & 0xFFFFFFFF) >> s
    if isinstance(s, torch.Tensor):
        return (x >> s) & ~(torch.full_like(s, -1) << (63 - s) << 1)
    return (x >> s) & wrap_int((1 << (64 - s)) - 1, t.LONG)


@evaluator(ShiftLeft)
@evaluator(ShiftRight)
@evaluator(ShiftRightUnsigned)
def _eval_shift(e: _Shift, ctx: EvalContext):
    out = e.data_type()
    bits = 64 if out == t.LONG else 32
    x, s, v = operands(ctx, e.children[0], e.children[1], out)
    if not isinstance(x, torch.Tensor):
        x = torch.full((ctx.capacity,), x, dtype=out.torch_dtype,
                       device=ctx.device)
    s = s & (bits - 1)
    if isinstance(e, ShiftLeft):
        r = x << s
    elif isinstance(e, ShiftRight):
        r = x >> s
    else:
        r = _logical_shr(x, s, bits)
    return make_column(ctx, out, r, v)
