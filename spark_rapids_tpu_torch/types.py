"""SQL types the port carries: BOOLEAN, BYTE (tinyint), SHORT (smallint),
INT, LONG (bigint), FLOAT, DOUBLE, DATE, TIMESTAMP, DECIMAL(p, s) and
STRING, plus the NULL type of an untyped null literal.

Counterpart of spark_rapids_tpu/types.py, narrowed to the flat types and
STRING, with the TypeSig algebra the plan rewrite checks operator and
expression types against (``GpuTypeSigs``, the reference's
``TpuTypeSigs``).  Null semantics follow Spark: each column has a bool
validity lane, and the data under a null is canonical zero.  Physical
lanes: BYTE int8, SHORT int16, FLOAT float32, DATE int32 days since the
epoch, TIMESTAMP int64 microseconds since the epoch (UTC); a DECIMAL of
at most 18 digits (DECIMAL_64) is its unscaled int64, a wider one
(DECIMAL_128) the unscaled value's low 64 bits in ``data`` (int64 bits of
the unsigned word) and its high 64 bits, signed, in ``data_hi``.  A
STRING column is a span column: ``offsets`` (int32[capacity + 1]) over a
uint8 ``data`` lane of UTF-8 bytes (columnar/device.py), and a null
string is empty.  BINARY, arrays, maps and structs wait for ROADMAP
Queue 1 item 3's last part.
"""

from __future__ import annotations

import enum
import re
from typing import List, Optional

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


class ByteType(DataType):
    name = "tinyint"
    torch_dtype = torch.int8


class ShortType(DataType):
    name = "smallint"
    torch_dtype = torch.int16


class IntegerType(DataType):
    name = "int"
    torch_dtype = torch.int32


class LongType(DataType):
    name = "bigint"
    torch_dtype = torch.int64


class FloatType(DataType):
    name = "float"
    torch_dtype = torch.float32


class DoubleType(DataType):
    name = "double"
    torch_dtype = torch.float64


class DateType(DataType):
    """Days since 1970-01-01 (proleptic Gregorian), int32."""
    name = "date"
    torch_dtype = torch.int32


class TimestampType(DataType):
    """Microseconds since 1970-01-01 00:00:00 UTC, int64."""
    name = "timestamp"
    torch_dtype = torch.int64


MAX_DECIMAL64_PRECISION = 18
MAX_DECIMAL128_PRECISION = 38


class DecimalType(DataType):
    """Fixed point: an unscaled integer times 10^-scale.  At most 18
    digits it is one int64 lane (``is64``); up to 38 the int64 low word
    in ``data`` and the signed high word in ``data_hi``."""
    torch_dtype = torch.int64

    def __init__(self, precision: int = 10, scale: int = 0):
        if precision < 1 or precision > MAX_DECIMAL128_PRECISION:
            raise ValueError(f"decimal precision {precision} out of range")
        if scale > precision:
            raise ValueError(f"decimal scale {scale} > precision "
                             f"{precision}")
        self.precision = precision
        self.scale = scale
        self.name = f"decimal({precision},{scale})"

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))

    @property
    def is64(self) -> bool:
        return self.precision <= MAX_DECIMAL64_PRECISION


class StringType(DataType):
    """UTF-8 text: ``torch_dtype`` is the dtype of its chars lane."""
    name = "string"
    torch_dtype = torch.uint8


class NullType(DataType):
    """The type of ``lit(None)``: every row null (data lane int8 zeros)."""
    name = "null"
    torch_dtype = torch.int8


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()
NULL = NullType()

BY_NAME = {dt.name: dt for dt in (BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
                                  DOUBLE, DATE, TIMESTAMP, STRING, NULL)}
# pyspark's short names for the same types
_ALIASES = {"byte": BYTE, "short": SHORT, "integer": INT, "long": LONG,
            "bool": BOOLEAN}
_DECIMAL_NAME = re.compile(r"^decimal\(\s*(\d+)\s*,\s*(\d+)\s*\)$")
_INTEGRAL = (ByteType, ShortType, IntegerType, LongType)


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, _INTEGRAL)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def is_fractional(dt: DataType) -> bool:
    """FLOAT, DOUBLE or DECIMAL (the reference's FractionalType)."""
    return is_floating(dt) or isinstance(dt, DecimalType)


def is_numeric(dt: DataType) -> bool:
    return is_integral(dt) or is_floating(dt) or isinstance(dt, DecimalType)


def is_dec128(dt: DataType) -> bool:
    """A decimal wider than 18 digits: two lanes, ``data`` and
    ``data_hi``."""
    return isinstance(dt, DecimalType) and not dt.is64


def from_name(name: str) -> DataType:
    """The type named as in the reference's ``DataType.name`` (or
    pyspark's short name), ``decimal(p,s)`` included."""
    key = name.strip().lower()
    dt = BY_NAME.get(key) or _ALIASES.get(key)
    if dt is not None:
        return dt
    if key == "decimal":
        return DecimalType(10, 0)
    m = _DECIMAL_NAME.match(key)
    if m:
        return DecimalType(int(m.group(1)), int(m.group(2)))
    raise NotImplementedError(
        f"SQL type {name!r} is not ported yet (the port carries "
        f"{sorted(BY_NAME)} and decimal(p,s); binary, arrays, maps and "
        f"structs wait for ROADMAP Queue 1 item 3)")


# ---------------------------------------------------------------------------
# TypeEnum + TypeSig algebra (the reference's types.py:340-562)
# ---------------------------------------------------------------------------

class TypeEnum(enum.Flag):
    NONE = 0
    BOOLEAN = enum.auto()
    BYTE = enum.auto()
    SHORT = enum.auto()
    INT = enum.auto()
    LONG = enum.auto()
    FLOAT = enum.auto()
    DOUBLE = enum.auto()
    DATE = enum.auto()
    TIMESTAMP = enum.auto()
    STRING = enum.auto()
    DECIMAL_64 = enum.auto()
    DECIMAL_128 = enum.auto()
    NULL = enum.auto()


_TYPE_BIT = {BooleanType: TypeEnum.BOOLEAN.value,
             ByteType: TypeEnum.BYTE.value, ShortType: TypeEnum.SHORT.value,
             IntegerType: TypeEnum.INT.value, LongType: TypeEnum.LONG.value,
             FloatType: TypeEnum.FLOAT.value,
             DoubleType: TypeEnum.DOUBLE.value,
             DateType: TypeEnum.DATE.value,
             TimestampType: TypeEnum.TIMESTAMP.value,
             StringType: TypeEnum.STRING.value, NullType: TypeEnum.NULL.value}
_DEC_BITS = TypeEnum.DECIMAL_64.value | TypeEnum.DECIMAL_128.value


def _type_bit(dt: DataType) -> int:
    if isinstance(dt, DecimalType):
        return (TypeEnum.DECIMAL_64 if dt.is64
                else TypeEnum.DECIMAL_128).value
    return _TYPE_BIT.get(type(dt), 0)


class TypeSig:
    """A set of types an op supports, and the most decimal digits it
    takes (``max_decimal_precision``, 18 unless the set holds
    DECIMAL_128).  Immutable; combine with ``+``.  The port carries no
    nested type, so ``nested()`` keeps the top-level set (the
    reference's nested-child capability has nothing to check here)."""

    __slots__ = ("initial", "_bits", "max_decimal_precision")

    def __init__(self, initial: TypeEnum = TypeEnum.NONE,
                 max_decimal_precision: int = MAX_DECIMAL64_PRECISION):
        self.initial = initial
        self._bits = initial.value      # tagging checks this plain int
        self.max_decimal_precision = max_decimal_precision

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.initial | other.initial,
                       max(self.max_decimal_precision,
                           other.max_decimal_precision))

    def nested(self, sub: Optional["TypeSig"] = None) -> "TypeSig":
        return self

    def is_supported(self, dt: DataType) -> bool:
        bit = _type_bit(dt)
        if not bit & self._bits:
            return False
        if bit & _DEC_BITS:
            return dt.precision <= self.max_decimal_precision
        return True

    def reasons_not_supported(self, dt: DataType) -> List[str]:
        """Human-readable reasons why ``dt`` is not supported (empty ==
        ok), in the reference's words."""
        if self.is_supported(dt):
            return []
        if _type_bit(dt) & self._bits and isinstance(dt, DecimalType):
            return [f"{dt.name} precision exceeds max supported "
                    f"({self.max_decimal_precision})"]
        return [f"{dt.name} is not supported"]


class GpuTypeSigs:
    """Standard signatures (the reference's TpuTypeSigs), over what the
    port carries.  Expression kernels compute decimals in one int64
    lane, so general expressions take DECIMAL_64 (``numeric64``); the
    aggregation buffers and the operators that only move or compare
    rows take DECIMAL_128 too."""
    none = TypeSig()
    BOOLEAN = TypeSig(TypeEnum.BOOLEAN)
    BYTE = TypeSig(TypeEnum.BYTE)
    SHORT = TypeSig(TypeEnum.SHORT)
    INT = TypeSig(TypeEnum.INT)
    LONG = TypeSig(TypeEnum.LONG)
    FLOAT = TypeSig(TypeEnum.FLOAT)
    DOUBLE = TypeSig(TypeEnum.DOUBLE)
    DATE = TypeSig(TypeEnum.DATE)
    TIMESTAMP = TypeSig(TypeEnum.TIMESTAMP)
    STRING = TypeSig(TypeEnum.STRING)
    NULL = TypeSig(TypeEnum.NULL)
    DECIMAL_64 = TypeSig(TypeEnum.DECIMAL_64)
    DECIMAL_128 = TypeSig(TypeEnum.DECIMAL_64 | TypeEnum.DECIMAL_128,
                          max_decimal_precision=MAX_DECIMAL128_PRECISION)

    integral = BYTE + SHORT + INT + LONG
    gpu_numeric = integral + FLOAT + DOUBLE + DECIMAL_128
    numeric = gpu_numeric
    numeric64 = integral + FLOAT + DOUBLE + DECIMAL_64
    comparable = numeric + BOOLEAN + DATE + TIMESTAMP + STRING + NULL
    common_scalar = comparable
    orderable = common_scalar
    all_types = common_scalar


T = GpuTypeSigs
