"""Spark's hash(): Murmur3_x86_32 with seed 42, for hash partitioning;
and monotonically_increasing_id().

Counterpart of the flat-type branches of spark_rapids_tpu/expr/hashfns.py
(hash_int32, hash_int64, hash_column, Murmur3Hash), bit for bit with the
reference's numpy branch and so with Spark: ints and booleans hash as one
4-byte block, longs as their low then high word, doubles as the bits of
the value with -0.0 read as 0.0; a null leaves the running seed as it
was.  torch has no uint32 arithmetic, so every 32-bit word is carried in
an int64 lane in [0, 2^32) (the port's rule for unsigned words), and
products are formed from 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

from typing import List

import torch

from .. import types as t
from .core import (ColumnValue, EvalContext, Expression, evaluator,
                   make_column)

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
SEED = 42


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def hash_int32(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 of one 4-byte block per row (Spark hashInt).  ``values``
    holds 32-bit ints in any integer dtype; ``seed`` and the result are
    uint32 words in int64."""
    k1 = _mix_k1(values.to(torch.int64) & M32)
    return _fmix(_mix_h1(seed, k1), 4)


def hash_int64(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hashLong: the low word, then the high word."""
    v = values.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(v & M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & M32))
    return _fmix(h1, 8)


def hash_column(col, seed: torch.Tensor) -> torch.Tensor:
    """Spark-compatible hash of one flat column, folded into the per-row
    seeds; null rows keep their seed."""
    dtype = col.dtype
    if dtype == t.LONG:
        h = hash_int64(col.data, seed)
    elif dtype == t.DOUBLE:
        d = col.data
        d = torch.where(d == 0.0, torch.zeros_like(d), d)   # -0.0 -> 0.0
        h = hash_int64(d.view(torch.int64), seed)
    else:                       # INT, BOOLEAN and the all-null NULL lane
        h = hash_int32(col.data, seed)
    return torch.where(col.validity, h, seed)


class Murmur3Hash(Expression):
    """hash(children...): an INT, never null."""

    def __init__(self, children: List[Expression], seed: int = SEED):
        self.children = tuple(children)
        self.seed = seed

    def data_type(self):
        return t.INT


@evaluator(Murmur3Hash)
def _eval_murmur3(e: Murmur3Hash, ctx: EvalContext):
    h = torch.full((ctx.capacity,), e.seed & M32, dtype=torch.int64,
                   device=ctx.device)
    for c in e.children:
        v = c.eval(ctx)
        if not isinstance(v, ColumnValue):
            v = make_column(ctx, c.data_type(),
                            v.value if v.value is not None else 0,
                            None if v.value is not None else False)
        h = hash_column(v.col, h)
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return make_column(ctx, t.INT, signed.to(torch.int32), None)


class MonotonicallyIncreasingID(Expression):
    """(partition id << 33) + row position within the partition, never
    null (ref GpuMonotonicallyIncreasingID.scala).  The base comes from
    the projection's running row offset (``EvalContext.row_base``)."""

    children = ()

    def data_type(self):
        return t.LONG

    def sql(self):
        return "monotonically_increasing_id()"


@evaluator(MonotonicallyIncreasingID)
def _eval_monotonic_id(e: MonotonicallyIncreasingID, ctx: EvalContext):
    pos = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device)
    return make_column(ctx, t.LONG, pos + ctx.row_base,
                       pos < ctx.batch.num_rows)
