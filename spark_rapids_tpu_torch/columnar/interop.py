"""SQL type <-> pyarrow type, for the port's types.

Counterpart of spark_rapids_tpu/columnar/interop.py.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from .. import types as t

# a STRING column comes back as large_string, as the reference's
# column_to_arrow gives it; a TIMESTAMP as microseconds in UTC
_TO_ARROW = {t.BOOLEAN: pa.bool_(), t.BYTE: pa.int8(), t.SHORT: pa.int16(),
             t.INT: pa.int32(), t.LONG: pa.int64(), t.FLOAT: pa.float32(),
             t.DOUBLE: pa.float64(), t.DATE: pa.date32(),
             t.TIMESTAMP: pa.timestamp("us", tz="UTC"),
             t.STRING: pa.large_string(), t.NULL: pa.null()}


def to_arrow_type(dt: t.DataType) -> pa.DataType:
    if isinstance(dt, t.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    return _TO_ARROW[dt]


def from_arrow_type(at: pa.DataType) -> t.DataType:
    """The reference's mapping: unsigned integers widen to the next
    signed type, every timestamp unit is a TIMESTAMP (converted to
    microseconds on upload)."""
    if pa.types.is_boolean(at):
        return t.BOOLEAN
    if pa.types.is_int8(at):
        return t.BYTE
    if pa.types.is_int16(at) or pa.types.is_uint8(at):
        return t.SHORT
    if pa.types.is_int32(at) or pa.types.is_uint16(at):
        return t.INT
    if pa.types.is_int64(at) or pa.types.is_uint32(at) or \
            pa.types.is_uint64(at):
        return t.LONG
    if pa.types.is_float32(at):
        return t.FLOAT
    if pa.types.is_float64(at):
        return t.DOUBLE
    if pa.types.is_date32(at):
        return t.DATE
    if pa.types.is_timestamp(at):
        return t.TIMESTAMP
    if pa.types.is_decimal128(at):
        return t.DecimalType(at.precision, at.scale)
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return t.STRING
    if pa.types.is_null(at):
        return t.NULL
    raise NotImplementedError(
        f"arrow type {at} is not ported yet (the port carries the flat "
        f"types, decimal128 and string columns; binary, lists, maps and "
        f"structs wait for ROADMAP Queue 1 item 3)")


def to_arrow_schema(names: List[str], dtypes: List[t.DataType]) -> pa.Schema:
    return pa.schema([pa.field(n, to_arrow_type(d))
                      for n, d in zip(names, dtypes)])
