"""SQL type <-> pyarrow type, for the port's types.

Counterpart of spark_rapids_tpu/columnar/interop.py.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa

from .. import types as t

# a STRING column comes back as large_string, as the reference's
# column_to_arrow gives it
_TO_ARROW = {t.BOOLEAN: pa.bool_(), t.INT: pa.int32(), t.LONG: pa.int64(),
             t.DOUBLE: pa.float64(), t.STRING: pa.large_string(),
             t.NULL: pa.null()}


def to_arrow_type(dt: t.DataType) -> pa.DataType:
    return _TO_ARROW[dt]


def from_arrow_type(at: pa.DataType) -> t.DataType:
    if pa.types.is_boolean(at):
        return t.BOOLEAN
    if pa.types.is_int32(at):
        return t.INT
    if pa.types.is_int64(at):
        return t.LONG
    if pa.types.is_float64(at):
        return t.DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return t.STRING
    if pa.types.is_null(at):
        return t.NULL
    raise NotImplementedError(
        f"arrow type {at} is not ported yet (the port carries bool, "
        f"int32, int64, float64 and string columns)")


def to_arrow_schema(names: List[str], dtypes: List[t.DataType]) -> pa.Schema:
    return pa.schema([pa.field(n, to_arrow_type(d))
                      for n, d in zip(names, dtypes)])
