"""SQL types of the port's slice: BOOLEAN, INT, LONG, DOUBLE and STRING,
plus the NULL type of an untyped null literal.

Counterpart of spark_rapids_tpu/types.py, narrowed to the types the
port carries, with the TypeSig algebra the plan rewrite checks operator
and expression types against (``GpuTypeSigs``, the reference's
``TpuTypeSigs``).  Null semantics follow Spark: each column has a bool
validity lane, and the data under a null is canonical zero.  A STRING
column is a span column: ``offsets`` (int32[capacity + 1]) over a uint8
``data`` lane of UTF-8 bytes (columnar/device.py), and a null string is
empty.
"""

from __future__ import annotations

import enum
from typing import List

import torch


class DataType:
    """Base class for SQL data types."""

    name: str = "data"
    torch_dtype: torch.dtype

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return self.name


class BooleanType(DataType):
    name = "boolean"
    torch_dtype = torch.bool


class IntegerType(DataType):
    name = "int"
    torch_dtype = torch.int32


class LongType(DataType):
    name = "bigint"
    torch_dtype = torch.int64


class DoubleType(DataType):
    name = "double"
    torch_dtype = torch.float64


class StringType(DataType):
    """UTF-8 text: ``torch_dtype`` is the dtype of its chars lane."""
    name = "string"
    torch_dtype = torch.uint8


class NullType(DataType):
    """The type of ``lit(None)``: every row null (data lane int8 zeros)."""
    name = "null"
    torch_dtype = torch.int8


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()
STRING = StringType()
NULL = NullType()

BY_NAME = {dt.name: dt for dt in (BOOLEAN, INT, LONG, DOUBLE, STRING)}


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, (IntegerType, LongType))


def from_name(name: str) -> DataType:
    """The type named as in the reference's ``DataType.name``."""
    try:
        return BY_NAME[name]
    except KeyError:
        raise NotImplementedError(
            f"SQL type {name!r} is not ported yet (the port carries "
            f"{sorted(BY_NAME)})") from None


# ---------------------------------------------------------------------------
# TypeEnum + TypeSig algebra (the reference's types.py:340-562)
# ---------------------------------------------------------------------------

class TypeEnum(enum.Flag):
    NONE = 0
    BOOLEAN = enum.auto()
    INT = enum.auto()
    LONG = enum.auto()
    DOUBLE = enum.auto()
    STRING = enum.auto()
    NULL = enum.auto()


_TYPE_BIT = {BooleanType: TypeEnum.BOOLEAN.value,
             IntegerType: TypeEnum.INT.value, LongType: TypeEnum.LONG.value,
             DoubleType: TypeEnum.DOUBLE.value,
             StringType: TypeEnum.STRING.value, NullType: TypeEnum.NULL.value}


class TypeSig:
    """A set of types an op supports.  Immutable; combine with ``+``.  The
    port carries no nested type, so ``nested()`` keeps the top-level set
    (the reference's nested-child capability has nothing to check
    here)."""

    __slots__ = ("initial", "_bits")

    def __init__(self, initial: TypeEnum = TypeEnum.NONE):
        self.initial = initial
        self._bits = initial.value      # tagging checks this plain int

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.initial | other.initial)

    def nested(self, sub: Optional["TypeSig"] = None) -> "TypeSig":
        return self

    def is_supported(self, dt: DataType) -> bool:
        return bool(_TYPE_BIT.get(type(dt), 0) & self._bits)

    def reasons_not_supported(self, dt: DataType) -> List[str]:
        """Human-readable reasons why ``dt`` is not supported (empty ==
        ok), in the reference's words."""
        if self.is_supported(dt):
            return []
        return [f"{dt.name} is not supported"]


class GpuTypeSigs:
    """Standard signatures (the reference's TpuTypeSigs), over what the
    port carries."""
    BOOLEAN = TypeSig(TypeEnum.BOOLEAN)
    INT = TypeSig(TypeEnum.INT)
    LONG = TypeSig(TypeEnum.LONG)
    DOUBLE = TypeSig(TypeEnum.DOUBLE)
    STRING = TypeSig(TypeEnum.STRING)
    NULL = TypeSig(TypeEnum.NULL)

    integral = INT + LONG
    numeric = integral + DOUBLE
    numeric64 = numeric
    comparable = numeric + BOOLEAN + STRING + NULL
    common_scalar = comparable
    all_types = common_scalar


T = GpuTypeSigs
