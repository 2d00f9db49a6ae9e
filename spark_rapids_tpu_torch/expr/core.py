"""Expression IR core.

Counterpart of spark_rapids_tpu/expr/core.py.  Expressions evaluate
eagerly over an ``EvalContext`` holding a DeviceBatch; a column result
is a ``ColumnValue`` over torch tensors on the batch's device, a
literal a ``ScalarValue``.  Null semantics follow Spark: each op
combines its children's validity, and the data under a null is zero.
The reference's literal parameterisation (expr/params.py) exists to
share compiled programs; the port does not hoist literals, and its
ParamLiteral evaluates as its value.
"""

from __future__ import annotations

import datetime
import decimal
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Type)

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn, null_column


class ColumnValue:
    __slots__ = ("col",)

    def __init__(self, col: DeviceColumn):
        self.col = col

    @property
    def dtype(self) -> t.DataType:
        return self.col.dtype


class ScalarValue:
    __slots__ = ("value", "dtype")

    def __init__(self, value: Any, dtype: t.DataType):
        self.value = value
        self.dtype = dtype


class EvalContext:
    """The batch an expression tree evaluates over.  ``row_base`` is
    (partition id << 33) + the partition's running row offset at this
    batch, the positional seed of monotonically_increasing_id (the
    reference's partition-packed layout, GpuMonotonicallyIncreasingID)."""

    __slots__ = ("batch", "capacity", "device", "row_base")

    def __init__(self, batch: DeviceBatch, row_base: int = 0):
        self.batch = batch
        self.capacity = batch.capacity
        self.device = batch.device
        self.row_base = row_base


class Expression:
    children: Tuple["Expression", ...] = ()

    def data_type(self) -> t.DataType:
        raise NotImplementedError(type(self).__name__)

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        import copy
        c = copy.copy(self)
        c.children = tuple(children)
        return c

    def transform_up(self, fn: Callable[["Expression"], "Expression"]
                     ) -> "Expression":
        new = [c.transform_up(fn) for c in self.children]
        node = self if all(a is b for a, b in zip(new, self.children)) \
            else self.with_children(new)
        return fn(node)

    def collect(self, pred: Callable[["Expression"], bool]
                ) -> List["Expression"]:
        """Every node of the tree, this one first, for which ``pred``
        holds."""
        out = [self] if pred(self) else []
        for c in self.children:
            out += c.collect(pred)
        return out

    def sql(self) -> str:
        args = ", ".join(c.sql() for c in self.children)
        return f"{type(self).__name__.lower()}({args})"

    def __repr__(self):
        return self.sql()

    def eval(self, ctx: EvalContext):
        fn = _EVALUATORS.get(type(self))
        if fn is None:
            raise NotImplementedError(
                f"expression {type(self).__name__} is not ported yet")
        return fn(self, ctx)


_EVALUATORS: Dict[Type[Expression], Callable] = {}


def evaluator(cls: Type[Expression]):
    def deco(fn):
        _EVALUATORS[cls] = fn
        return fn
    return deco


_EPOCH_DAY = datetime.date(1970, 1, 1)
_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def infer_literal_type(value: Any) -> t.DataType:
    if value is None:
        return t.NULL
    if isinstance(value, bool):
        return t.BOOLEAN
    if isinstance(value, int):
        return t.INT if -(2**31) <= value < 2**31 else t.LONG
    if isinstance(value, float):
        return t.DOUBLE
    if isinstance(value, (str, bytes)):
        return t.STRING
    if isinstance(value, decimal.Decimal):
        # the reference's rule: scale from the exponent, precision from
        # the digits
        _, digits, exp = value.as_tuple()
        scale = max(-exp, 0)
        return t.DecimalType(max(len(digits), scale), scale)
    if isinstance(value, datetime.datetime):
        return t.TIMESTAMP
    if isinstance(value, datetime.date):
        return t.DATE
    raise NotImplementedError(
        f"literal {value!r} of type {type(value).__name__} is not ported yet")


def literal_storage(value: Any, dtype: t.DataType) -> Any:
    """A literal's value as its column stores it: a DATE as days since
    the epoch, a TIMESTAMP as microseconds since the epoch in UTC (a
    naive datetime read as UTC), a DECIMAL as its unscaled Python int, a
    string as its UTF-8."""
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=datetime.timezone.utc)
        d = value - _EPOCH
        return (d.days * 86400 + d.seconds) * 1_000_000 + d.microseconds
    if isinstance(value, datetime.date):
        return (value - _EPOCH_DAY).days
    if isinstance(value, decimal.Decimal) and \
            isinstance(dtype, t.DecimalType):
        return int(value.scaleb(dtype.scale))
    return value


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[t.DataType] = None):
        if hasattr(value, "item"):              # numpy scalar
            value = value.item()
        self.dtype = dtype if dtype is not None else infer_literal_type(value)
        self.value = literal_storage(value, self.dtype)

    def data_type(self):
        return self.dtype

    def sql(self):
        if self.value is None:
            return "NULL"
        if self.dtype == t.STRING:
            return repr(self.value.decode("utf-8", "replace"))
        return str(self.value)


@evaluator(Literal)
def _eval_literal(e: Literal, ctx: EvalContext):
    return ScalarValue(e.value, e.dtype)


class AttributeReference(Expression):
    """Unresolved column reference by name."""

    def __init__(self, name: str, dtype: Optional[t.DataType] = None):
        self.name = name
        self.dtype = dtype

    def data_type(self):
        if self.dtype is None:
            raise ValueError(f"unresolved attribute {self.name}")
        return self.dtype

    def sql(self):
        return self.name


class BoundReference(Expression):
    """Column reference bound to an input ordinal."""

    def __init__(self, ordinal: int, dtype: t.DataType, name: str = ""):
        self.ordinal = ordinal
        self.dtype = dtype
        self.name = name or f"input[{ordinal}]"

    def data_type(self):
        return self.dtype

    def sql(self):
        return self.name


@evaluator(BoundReference)
def _eval_bound(e: BoundReference, ctx: EvalContext):
    return ColumnValue(ctx.batch.columns[e.ordinal])


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self):
        return self.children[0]

    def data_type(self):
        return self.child.data_type()

    def sql(self):
        return f"{self.child.sql()} AS {self.name}"


@evaluator(Alias)
def _eval_alias(e: Alias, ctx: EvalContext):
    return e.child.eval(ctx)


def output_name(e: Expression) -> str:
    if isinstance(e, (Alias, AttributeReference, BoundReference)):
        return e.name
    return e.sql()


def bind_expression(expr: Expression, names: Sequence[str],
                    dtypes: Sequence[t.DataType]) -> Expression:
    """Replace AttributeReference by BoundReference against a schema."""
    index = {n: i for i, n in enumerate(names)}

    def fn(e: Expression) -> Expression:
        if isinstance(e, AttributeReference):
            if e.name not in index:
                raise ValueError(f"column {e.name!r} not in {list(names)}")
            i = index[e.name]
            return BoundReference(i, dtypes[i], e.name)
        return e
    return expr.transform_up(fn)


# ---------------------------------------------------------------------------
# evaluation helpers
# ---------------------------------------------------------------------------

def data_of(v):
    """A value's data: a tensor for a column, a Python scalar (zero for a
    null) for a literal."""
    if isinstance(v, ColumnValue):
        return v.col.data
    if v.value is None:
        return False if v.dtype == t.BOOLEAN else 0
    return v.value


def validity_of(v):
    """A bool tensor, None for all-valid, or False for an all-null
    literal."""
    if isinstance(v, ColumnValue):
        return v.col.validity
    return None if v.value is not None else False


def and_validity(ctx: EvalContext, *vals):
    out = None
    for v in vals:
        if v is None:
            continue
        if v is False:
            return torch.zeros(ctx.capacity, dtype=torch.bool,
                               device=ctx.device)
        out = v if out is None else (out & v)
    return out


def decimal_pair(col: DeviceColumn):
    """A decimal column's unscaled values as an int128 (lo, hi) pair
    (``ops/int128.py``); a DECIMAL64 lane is sign-extended."""
    data = col.data.to(torch.int64)
    return data, (data >> 63) if col.data_hi is None else col.data_hi


def make_decimal_column(ctx: EvalContext, dtype: t.DecimalType, pair,
                        validity) -> ColumnValue:
    """A DECIMAL column from an int128 (lo, hi) pair of tensors or a
    Python int (broadcast): one lane at most 18 digits (the low word),
    else both.  The words under a null are zero."""
    if not isinstance(pair, tuple):
        from ..ops import int128 as i128
        pair = i128.full(int(pair or 0), torch.empty(ctx.capacity,
                                                dtype=torch.int64,
                                                device=ctx.device))
    if dtype.is64:
        return make_column(ctx, dtype, pair[0], validity)
    col = make_column(ctx, t.LONG, pair[0], validity).col
    hi = torch.where(col.validity, pair[1], torch.zeros_like(pair[1]))
    return ColumnValue(DeviceColumn(dtype, col.data, col.validity, None, hi))


def make_column(ctx: EvalContext, dtype: t.DataType, data,
                validity) -> ColumnValue:
    """A column of ``dtype`` from a tensor or a Python scalar (broadcast);
    ``validity`` is a bool tensor, None (all valid) or False (all null).
    The data under a null is set to zero.  A DECIMAL128 column from one
    int64 lane takes its sign as the high word, as the reference's
    ``make_column`` does."""
    dev = ctx.device
    if validity is None:
        validity = torch.ones(ctx.capacity, dtype=torch.bool, device=dev)
    elif validity is False:
        validity = torch.zeros(ctx.capacity, dtype=torch.bool, device=dev)
    if t.is_dec128(dtype):
        if isinstance(data, torch.Tensor):
            data = data.to(torch.int64)
            data = (data, data >> 63)
        return make_decimal_column(ctx, dtype, data, validity)
    if dtype == t.STRING:
        return ColumnValue(string_literal_column(ctx, data or b"", validity))
    if isinstance(data, torch.Tensor) and data.dim() == 1:
        data = data.to(dtype.torch_dtype)
    else:
        data = torch.full((ctx.capacity,), data, dtype=dtype.torch_dtype,
                          device=dev)
    data = torch.where(validity, data, torch.zeros_like(data))
    return ColumnValue(DeviceColumn(dtype, data, validity))


def string_literal_column(ctx: EvalContext, value: bytes,
                          validity: torch.Tensor) -> DeviceColumn:
    """A STRING column holding ``value`` where ``validity`` is set and the
    empty string elsewhere: a one-row column gathered to every row
    (K16)."""
    from ..ops.gather import gather_column
    one = DeviceColumn(
        t.STRING, torch.tensor(list(value) or [0], dtype=torch.uint8,
                               device=ctx.device),
        torch.ones(1, dtype=torch.bool, device=ctx.device),
        torch.tensor([0, len(value)], dtype=torch.int32, device=ctx.device))
    return gather_column(one, torch.zeros(ctx.capacity, dtype=torch.int32,
                                          device=ctx.device), validity)


def column_of(ctx: EvalContext, e: Expression) -> DeviceColumn:
    """An expression's value as a column (a literal broadcast)."""
    v = e.eval(ctx)
    if isinstance(v, ScalarValue):
        v = make_column(ctx, e.data_type(), data_of(v), validity_of(v))
    return v.col


def all_null_column(ctx: EvalContext, dtype: t.DataType) -> ColumnValue:
    """A column of ``dtype`` that is null in every row."""
    return ColumnValue(null_column(dtype, ctx.capacity, ctx.device))
