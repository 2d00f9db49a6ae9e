"""SQL types the port carries: BOOLEAN, BYTE (tinyint), SHORT (smallint),
INT, LONG (bigint), FLOAT, DOUBLE, DATE, TIMESTAMP, DECIMAL(p, s),
STRING, BINARY, ARRAY, MAP and STRUCT, plus the NULL type of an untyped
null literal.

Counterpart of spark_rapids_tpu/types.py (all but CALENDAR), with the
TypeSig algebra the plan rewrite checks operator and expression types
against (``GpuTypeSigs``, the reference's ``TpuTypeSigs``), nested-child
checks included.  Null semantics follow Spark: each column has a bool
validity lane, and the data under a null is canonical zero.  Physical
lanes: BYTE int8, SHORT int16, FLOAT float32, DATE int32 days since the
epoch, TIMESTAMP int64 microseconds since the epoch (UTC); a DECIMAL of
at most 18 digits (DECIMAL_64) is its unscaled int64, a wider one
(DECIMAL_128) the unscaled value's low 64 bits in ``data`` (int64 bits of
the unsigned word) and its high 64 bits, signed, in ``data_hi``.  A
STRING or BINARY column is a span column: ``offsets`` (int32[capacity +
1]) over a uint8 ``data`` lane of bytes (columnar/device.py), and a null
is empty.  An ARRAY is ``offsets`` over one child column, a MAP the
same over a key child and a value child, and a STRUCT one child a field,
aligned with its rows; a null array or map spans no child rows.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

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


class BinaryType(DataType):
    """Bytes: a span column like STRING; ``torch_dtype`` is its bytes
    lane's."""
    name = "binary"
    torch_dtype = torch.uint8


class NullType(DataType):
    """The type of ``lit(None)``: every row null (data lane int8 zeros)."""
    name = "null"
    torch_dtype = torch.int8


class ArrayType(DataType):
    """Offsets over one child column of ``element_type``."""

    def __init__(self, element_type: DataType, contains_null: bool = True):
        self.element_type = element_type
        self.contains_null = contains_null
        self.name = f"array<{element_type.name}>"

    def __eq__(self, other):
        return (isinstance(other, ArrayType)
                and other.element_type == self.element_type)

    def __hash__(self):
        return hash(("array", self.element_type))


@dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


class StructType(DataType):
    """One child column a field, aligned with the struct's rows."""

    def __init__(self, fields: Iterable[StructField]):
        self.fields: Tuple[StructField, ...] = tuple(fields)
        self.name = "struct<" + ",".join(
            f"{f.name}:{f.data_type.name}" for f in self.fields) + ">"

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash(("struct", self.fields))

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]


class MapType(DataType):
    """Offsets over a key child and a value child (the reference's
    ARRAY<STRUCT<key, value>> without the struct)."""

    def __init__(self, key_type: DataType, value_type: DataType,
                 value_contains_null: bool = True):
        self.key_type = key_type
        self.value_type = value_type
        self.value_contains_null = value_contains_null
        self.name = f"map<{key_type.name},{value_type.name}>"

    def __eq__(self, other):
        return (isinstance(other, MapType) and other.key_type == self.key_type
                and other.value_type == self.value_type)

    def __hash__(self):
        return hash(("map", self.key_type, self.value_type))


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
BINARY = BinaryType()
NULL = NullType()

BY_NAME = {dt.name: dt for dt in (BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
                                  DOUBLE, DATE, TIMESTAMP, STRING, BINARY,
                                  NULL)}
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


def is_span(dt: DataType) -> bool:
    """STRING or BINARY: offsets over a bytes lane."""
    return isinstance(dt, (StringType, BinaryType))


def is_nested(dt: DataType) -> bool:
    return isinstance(dt, (ArrayType, MapType, StructType))


def is_varlen(dt: DataType) -> bool:
    """STRING, BINARY, ARRAY or MAP: a column of offsets over its bytes
    or its children, whose rows vary in length."""
    return is_span(dt) or isinstance(dt, (ArrayType, MapType))


def child_types(dt: DataType) -> List[DataType]:
    """The types of a column's children in the device layout: an
    ARRAY's [element], a MAP's [key, value], a STRUCT's fields; none for
    a flat, STRING or BINARY column."""
    if isinstance(dt, ArrayType):
        return [dt.element_type]
    if isinstance(dt, MapType):
        return [dt.key_type, dt.value_type]
    if isinstance(dt, StructType):
        return [f.data_type for f in dt.fields]
    return []


def _split_top(body: str) -> List[str]:
    """``body`` cut at the commas outside any <> or ()."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    return [p.strip() for p in parts]


def from_name(name: str) -> DataType:
    """The type named as in the reference's ``DataType.name`` (or
    pyspark's short name): ``decimal(p,s)``, ``array<t>``,
    ``map<k,v>`` and ``struct<a:t,...>`` included."""
    key = name.strip().lower()
    dt = BY_NAME.get(key) or _ALIASES.get(key)
    if dt is not None:
        return dt
    if key == "decimal":
        return DecimalType(10, 0)
    m = _DECIMAL_NAME.match(key)
    if m:
        return DecimalType(int(m.group(1)), int(m.group(2)))
    raw = name.strip()
    head, _, rest = raw.partition("<")
    if rest.endswith(">"):
        inner = _split_top(rest[:-1])
        head = head.strip().lower()
        if head == "array" and len(inner) == 1:
            return ArrayType(from_name(inner[0]))
        if head == "map" and len(inner) == 2:
            return MapType(from_name(inner[0]), from_name(inner[1]))
        if head == "struct":
            fields = []
            for f in inner:
                fname, sep, ftype = f.partition(":")
                if not sep:
                    break
                fields.append(StructField(fname.strip(), from_name(ftype)))
            else:
                return StructType(fields)
    raise ValueError(f"cannot parse type {name!r}")


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
    BINARY = enum.auto()
    CALENDAR = enum.auto()
    ARRAY = enum.auto()
    MAP = enum.auto()
    STRUCT = enum.auto()
    UDT = enum.auto()


_TYPE_BIT = {BooleanType: TypeEnum.BOOLEAN.value,
             ByteType: TypeEnum.BYTE.value, ShortType: TypeEnum.SHORT.value,
             IntegerType: TypeEnum.INT.value, LongType: TypeEnum.LONG.value,
             FloatType: TypeEnum.FLOAT.value,
             DoubleType: TypeEnum.DOUBLE.value,
             DateType: TypeEnum.DATE.value,
             TimestampType: TypeEnum.TIMESTAMP.value,
             StringType: TypeEnum.STRING.value, NullType: TypeEnum.NULL.value,
             BinaryType: TypeEnum.BINARY.value,
             ArrayType: TypeEnum.ARRAY.value, MapType: TypeEnum.MAP.value,
             StructType: TypeEnum.STRUCT.value}
_DEC_BITS = TypeEnum.DECIMAL_64.value | TypeEnum.DECIMAL_128.value


def _type_bit(dt: DataType) -> int:
    if isinstance(dt, DecimalType):
        return (TypeEnum.DECIMAL_64 if dt.is64
                else TypeEnum.DECIMAL_128).value
    return _TYPE_BIT.get(type(dt), TypeEnum.UDT.value)


class TypeSig:
    """A set of types an op supports, the types their nested children may
    take (``nested``), and the most decimal digits it takes
    (``max_decimal_precision``, 18 unless the set holds DECIMAL_128).
    Immutable; combine with ``+``.  The reference's checks and reasons
    (its types.py TypeSig)."""

    __slots__ = ("initial", "nested_sig", "_bits", "_nested_bits",
                 "max_decimal_precision")

    def __init__(self, initial: TypeEnum = TypeEnum.NONE,
                 nested_sig: TypeEnum = TypeEnum.NONE,
                 max_decimal_precision: int = MAX_DECIMAL64_PRECISION):
        self.initial = initial
        self.nested_sig = nested_sig
        self._bits = initial.value      # tagging checks these plain ints
        self._nested_bits = nested_sig.value
        self.max_decimal_precision = max_decimal_precision

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.initial | other.initial,
                       self.nested_sig | other.nested_sig,
                       max(self.max_decimal_precision,
                           other.max_decimal_precision))

    def nested(self, sub: Optional["TypeSig"] = None) -> "TypeSig":
        """Allow nested children of ``sub``'s types (default: the top
        level's)."""
        sub_enum = sub.initial if sub is not None else self.initial
        return TypeSig(self.initial, self.nested_sig | sub_enum,
                       self.max_decimal_precision)

    def _supported(self, dt: DataType, allowed: int) -> bool:
        bit = _type_bit(dt)
        if not bit & allowed:
            return False
        if bit & _DEC_BITS:
            return dt.precision <= self.max_decimal_precision
        child = self._nested_bits
        if isinstance(dt, ArrayType):
            return self._supported(dt.element_type, child)
        if isinstance(dt, MapType):
            return (self._supported(dt.key_type, child)
                    and self._supported(dt.value_type, child))
        if isinstance(dt, StructType):
            return all(self._supported(f.data_type, child)
                       for f in dt.fields)
        return True

    def is_supported(self, dt: DataType) -> bool:
        return self._supported(dt, self._bits)

    def reasons_not_supported(self, dt: DataType) -> List[str]:
        """Human-readable reasons why ``dt`` is not supported (empty ==
        ok), in the reference's words."""
        if self.is_supported(dt):
            return []
        if not _type_bit(dt) & self._bits:
            return [f"{dt.name} is not supported"]
        if isinstance(dt, DecimalType):
            return [f"{dt.name} precision exceeds max supported "
                    f"({self.max_decimal_precision})"]
        child = TypeSig(self.nested_sig, self.nested_sig,
                        self.max_decimal_precision)
        if isinstance(dt, ArrayType):
            return [f"array child: {r}"
                    for r in child.reasons_not_supported(dt.element_type)]
        if isinstance(dt, MapType):
            return ([f"map key: {r}"
                     for r in child.reasons_not_supported(dt.key_type)] +
                    [f"map value: {r}"
                     for r in child.reasons_not_supported(dt.value_type)])
        if isinstance(dt, StructType):
            return [f"struct field {f.name}: {r}" for f in dt.fields
                    for r in child.reasons_not_supported(f.data_type)]
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
    BINARY = TypeSig(TypeEnum.BINARY)
    ARRAY = TypeSig(TypeEnum.ARRAY)
    MAP = TypeSig(TypeEnum.MAP)
    STRUCT = TypeSig(TypeEnum.STRUCT)
    DECIMAL_64 = TypeSig(TypeEnum.DECIMAL_64)
    DECIMAL_128 = TypeSig(TypeEnum.DECIMAL_64 | TypeEnum.DECIMAL_128,
                          max_decimal_precision=MAX_DECIMAL128_PRECISION)
    CALENDAR = TypeSig(TypeEnum.CALENDAR)

    integral = BYTE + SHORT + INT + LONG
    gpu_numeric = integral + FLOAT + DOUBLE + DECIMAL_128
    numeric = gpu_numeric
    numeric64 = integral + FLOAT + DOUBLE + DECIMAL_64
    comparable = numeric + BOOLEAN + DATE + TIMESTAMP + STRING + NULL
    common_scalar = comparable
    orderable = common_scalar
    all_types = common_scalar + BINARY + CALENDAR + ARRAY + MAP + STRUCT


T = GpuTypeSigs
