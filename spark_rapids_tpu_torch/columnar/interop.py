"""SQL type <-> pyarrow type, for the port's types.

Counterpart of spark_rapids_tpu/columnar/interop.py: a BINARY column
comes back as large_binary, an ARRAY as large_list, a MAP as map_ and a
STRUCT as struct, as the reference's give them.
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
             t.STRING: pa.large_string(), t.BINARY: pa.large_binary(),
             t.NULL: pa.null()}


def to_arrow_type(dt: t.DataType) -> pa.DataType:
    if isinstance(dt, t.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, t.ArrayType):
        return pa.large_list(to_arrow_type(dt.element_type))
    if isinstance(dt, t.StructType):
        return pa.struct([pa.field(f.name, to_arrow_type(f.data_type),
                                   nullable=f.nullable) for f in dt.fields])
    if isinstance(dt, t.MapType):
        return pa.map_(to_arrow_type(dt.key_type),
                       to_arrow_type(dt.value_type))
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
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return t.BINARY
    if pa.types.is_null(at):
        return t.NULL
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return t.ArrayType(from_arrow_type(at.value_type))
    if pa.types.is_struct(at):
        return t.StructType([t.StructField(f.name, from_arrow_type(f.type),
                                           f.nullable) for f in at])
    if pa.types.is_map(at):
        return t.MapType(from_arrow_type(at.key_type),
                         from_arrow_type(at.item_type))
    raise NotImplementedError(
        f"arrow type {at} has no SQL type in the port (the reference "
        f"maps it to none either)")


def to_arrow_schema(names: List[str], dtypes: List[t.DataType]) -> pa.Schema:
    return pa.schema([pa.field(n, to_arrow_type(d))
                      for n, d in zip(names, dtypes)])
