"""Complex-type create and extract expressions.

Counterpart of spark_rapids_tpu/expr/complextype.py: GetStructField
(``c.getField(name)``, ``c[name]``), GetArrayItem (``c[i]``, 0-based),
ElementAt (``element_at(c, i)``, 1-based, negative from the end),
CreateArray (``array(...)``) and CreateNamedStruct (``struct(...)``).
An index out of range gives null, as in the reference (Spark without
ANSI mode).  The extracts gather the selected child rows through
``ops/gather.py:gather_columns`` (K8 for flat children, K16 for string
and binary ones, K18 below them); a field of a null struct row is null,
its data zero (``mask_validity``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import types as t
from ..columnar.device import DeviceColumn, bucket_for
from .core import (ColumnValue, EvalContext, Expression, column_of,
                   evaluator)


class GetStructField(Expression):
    def __init__(self, child: Expression, name: str,
                 ordinal: Optional[int] = None):
        self.children = (child,)
        self.name = name
        self.ordinal = ordinal

    def _resolve(self):
        st = self.children[0].data_type()
        if not isinstance(st, t.StructType):
            raise TypeError(
                f"field access `.{self.name}` requires a struct column, "
                f"got {st.name} (map key lookup is not supported)")
        if self.ordinal is not None:
            return self.ordinal, st.fields[self.ordinal].data_type
        for i, f in enumerate(st.fields):
            if f.name == self.name:
                return i, f.data_type
        raise KeyError(f"no field {self.name!r} in {st.name}")

    def data_type(self):
        return self._resolve()[1]

    def sql(self):
        return f"{self.children[0].sql()}.{self.name}"


@evaluator(GetStructField)
def _eval_get_struct_field(e: GetStructField, ctx: EvalContext):
    from ..ops.carry import mask_validity
    parent = column_of(ctx, e.children[0])
    i, _ = e._resolve()
    # struct-level nulls mask the extracted child
    return ColumnValue(mask_validity(parent.children[i], parent.validity))


class GetArrayItem(Expression):
    """arr[index], 0-based; null when out of range (non-ANSI)."""

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    def data_type(self):
        at = self.children[0].data_type()
        if not isinstance(at, t.ArrayType):
            raise TypeError(f"[index] requires an array column, got "
                            f"{at.name}")
        return at.element_type

    def sql(self):
        return f"{self.children[0].sql()}[{self.children[1].sql()}]"


class ElementAt(Expression):
    """element_at(arr, i): 1-based, negative counts from the end."""

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    def data_type(self):
        at = self.children[0].data_type()
        if not isinstance(at, t.ArrayType):
            raise TypeError(f"element_at requires an array column, got "
                            f"{at.name}")
        return at.element_type

    def sql(self):
        return (f"element_at({self.children[0].sql()}, "
                f"{self.children[1].sql()})")


def _gather_element(arr: DeviceColumn, pos: torch.Tensor,
                    in_range: torch.Tensor) -> ColumnValue:
    """Each row's element ``pos`` (an absolute child row), null where not
    ``in_range`` or the array is null."""
    from ..ops.gather import gather_column
    child = arr.children[0]
    idx = pos.clamp(0, child.capacity - 1).to(torch.int32)
    return ColumnValue(gather_column(child, idx, in_range & arr.validity))


def _array_and_index(e, ctx):
    arr = column_of(ctx, e.children[0])
    ic = column_of(ctx, e.children[1])
    i = ic.data.to(torch.int64)
    starts = arr.offsets[:-1].to(torch.int64)
    lens = arr.offsets[1:].to(torch.int64) - starts
    return arr, i, starts, lens, ic.validity


@evaluator(GetArrayItem)
def _eval_get_array_item(e: GetArrayItem, ctx: EvalContext):
    arr, i, starts, lens, ivalid = _array_and_index(e, ctx)
    in_range = (i >= 0) & (i < lens) & ivalid
    return _gather_element(arr, starts + i, in_range)


@evaluator(ElementAt)
def _eval_element_at(e: ElementAt, ctx: EvalContext):
    arr, i, starts, lens, ivalid = _array_and_index(e, ctx)
    pos = torch.where(i > 0, starts + i - 1, starts + lens + i)
    in_range = (((i > 0) & (i <= lens)) | ((i < 0) & (-i <= lens))) & ivalid
    return _gather_element(arr, pos, in_range)


class CreateArray(Expression):
    def __init__(self, children: List[Expression]):
        self.children = tuple(children)

    def data_type(self):
        et = self.children[0].data_type() if self.children else t.NULL
        return t.ArrayType(et)

    def sql(self):
        return f"array({', '.join(c.sql() for c in self.children)})"


@evaluator(CreateArray)
def _eval_create_array(e: CreateArray, ctx: EvalContext):
    """Row r's element j is child row r * n + j of n columns.  A flat
    element type interleaves the lanes; a string or nested one (kept on
    the CPU engine by the rule) stacks the columns and gathers child row
    r * n + j from row j * rows + r of the stack.  Padding rows are null
    and span nothing."""
    n = len(e.children)
    cap, rows, dev = ctx.capacity, ctx.batch.num_rows, ctx.device
    et = e.data_type().element_type
    m = rows * n
    child_cap = bucket_for(max(m, 1))
    live = torch.arange(cap, device=dev) < rows
    offsets = (torch.arange(cap + 1, device=dev).clamp(max=rows) * n
               ).to(torch.int32)
    slot = torch.arange(child_cap, device=dev)
    in_range = slot < m
    if n == 0:
        child = DeviceColumn(t.NULL, torch.zeros(child_cap, dtype=torch.int8,
                                                 device=dev),
                             torch.zeros(child_cap, dtype=torch.bool,
                                         device=dev))
    else:
        cols = [column_of(ctx, c) for c in e.children]
        if all(c.is_flat for c in cols):
            def lane(xs):
                out = torch.zeros(child_cap, dtype=xs[0].dtype, device=dev)
                inter = torch.stack([x[:rows] for x in xs], 1).reshape(-1)
                out[:m] = inter
                return out
            valid = lane([c.validity for c in cols]) & in_range
            data = torch.where(valid, lane([c.data for c in cols]),
                               torch.zeros((), dtype=cols[0].data.dtype,
                                           device=dev))
            hi = None if cols[0].data_hi is None else torch.where(
                valid, lane([c.data_hi for c in cols]),
                torch.zeros((), dtype=torch.int64, device=dev))
            child = DeviceColumn(et, data, valid, None, hi)
        else:
            from ..exec.concat import concat_batches
            from ..columnar.device import DeviceBatch
            from ..ops.gather import gather_column
            stack = concat_batches(
                [DeviceBatch([c], rows, ["e"]) for c in cols], ["e"], [et])
            src = (slot % n) * rows + torch.div(slot, n,
                                                rounding_mode="floor")
            child = gather_column(stack.columns[0],
                                  src.clamp(max=max(m - 1, 0)).to(
                                      torch.int32), in_range)
    return ColumnValue(DeviceColumn(e.data_type(), None, live, offsets, None,
                                    [child]))


class CreateNamedStruct(Expression):
    def __init__(self, names: List[str], values: List[Expression]):
        self.names = list(names)
        self.children = tuple(values)

    def data_type(self):
        return t.StructType([t.StructField(n, c.data_type())
                             for n, c in zip(self.names, self.children)])

    def sql(self):
        inner = ", ".join(f"{n}, {c.sql()}"
                          for n, c in zip(self.names, self.children))
        return f"named_struct({inner})"


@evaluator(CreateNamedStruct)
def _eval_create_named_struct(e: CreateNamedStruct, ctx: EvalContext):
    live = torch.arange(ctx.capacity, device=ctx.device) < \
        ctx.batch.num_rows
    return ColumnValue(DeviceColumn(
        e.data_type(), None, live, None, None,
        [column_of(ctx, c) for c in e.children]))
