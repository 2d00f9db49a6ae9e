"""SQL types of the port's slice: BOOLEAN, INT, LONG and DOUBLE.

Counterpart of spark_rapids_tpu/types.py, narrowed to the types the
scan -> filter -> aggregate path carries.  Null semantics follow Spark:
each column has a bool validity lane, and the data under a null is
canonical zero.
"""

from __future__ import annotations

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


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()

BY_NAME = {dt.name: dt for dt in (BOOLEAN, INT, LONG, DOUBLE)}


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
