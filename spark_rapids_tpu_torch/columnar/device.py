"""Device-resident columnar data over torch tensors.

Counterpart of spark_rapids_tpu/columnar/device.py.  A column is a
``data`` tensor and a bool ``validity`` tensor, both padded to a
capacity bucket; the batch's row count is a host int.  Rows at index
>= num_rows are padding and are always invalid, and the data under a
null is zero.  A STRING column is the reference's span layout:
``offsets`` int32[capacity + 1], rebased to 0 and repeating the last
offset past the live rows, over ``data``, the UTF-8 bytes, uint8
zero-padded to a ``DEFAULT_CHAR_BUCKETS`` bucket; a null string is
empty; a BINARY column is the same layout over its bytes.  A DECIMAL
wider than 18 digits has a second lane, ``data_hi``: ``data`` holds the
unscaled value's low 64 bits (int64 bits of the unsigned word) and
``data_hi`` its signed high 64 bits; every helper that copies a
column's rows carries both.

Nested columns follow the reference's layout and have no ``data``.  An
ARRAY keeps int32 ``offsets[capacity + 1]``, rebased to 0 and padded
with the last offset, over one child column at its own capacity bucket
(``DEFAULT_ROW_BUCKETS`` of the child total); a MAP the same over a key
child and a value child; a null array or map spans no child rows.  A
STRUCT keeps one child a field at the struct's own capacity, aligned
with its rows: the children are read as Arrow holds them, so a child
may hold a value under a null struct row, and every download masks it
with the struct's validity (the reference's ``arr.field(i)`` upload).
A column is flat when it has neither offsets nor children
(``DeviceColumn.is_flat``); only flat columns are row lanes.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from .. import types as t
from .interop import from_arrow_type, to_arrow_type

DEFAULT_ROW_BUCKETS = (1024, 8192, 65536, 262144, 1048576, 4194304)
DEFAULT_CHAR_BUCKETS = (16384, 131072, 1048576, 8388608, 67108864, 268435456)
_INT32_MAX = 2**31 - 1


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_ROW_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the largest, round up to a power of two."""
    n = max(int(n), 1)
    for b in buckets:
        if n <= b:
            return b
    return 1 << math.ceil(math.log2(n))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spark_rapids_tpu_torch: device 'cuda' was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class DeviceColumn:
    """One column: ``data`` and bool ``validity``, both [capacity]; for a
    span column (STRING, BINARY) ``offsets`` int32[capacity + 1] over the
    bytes in ``data``, else None; for a DECIMAL of more than 18 digits
    ``data_hi``, the high words (int64[capacity]), else None.  An ARRAY
    or MAP has ``offsets`` over its ``children`` and no ``data``; a
    STRUCT has row-aligned ``children`` and no ``data``."""

    __slots__ = ("dtype", "data", "validity", "offsets", "data_hi",
                 "children")

    def __init__(self, dtype: t.DataType, data: Optional[torch.Tensor],
                 validity: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None,
                 data_hi: Optional[torch.Tensor] = None,
                 children: Sequence["DeviceColumn"] = ()):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.data_hi = data_hi
        self.children = tuple(children)

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        if self.data is not None:
            return int(self.data.shape[0])
        return int(self.validity.shape[0])

    @property
    def is_flat(self) -> bool:
        """A row lane column: neither offsets nor children."""
        return self.offsets is None and not self.children

    def __repr__(self):
        return f"DeviceColumn({self.dtype.name}, cap={self.capacity})"


def flat_lanes(cols: Sequence[DeviceColumn]):
    """The row lanes of flat columns, column by column: data, validity,
    then data_hi where there is one (``columns_from_lanes`` undoes it).
    A span or nested column has no row lanes: its rows move by a gather
    (``ops/gather.py:gather_columns``), so it raises here."""
    lanes = []
    for c in cols:
        if not c.is_flat:
            raise TypeError(f"flat_lanes: a {c.dtype.name} column moves "
                            f"through gather_columns, not as row lanes")
        lanes += [c.data, c.validity] + ([] if c.data_hi is None
                                         else [c.data_hi])
    return lanes


def null_column(dtype: t.DataType, cap: int,
                device: torch.device) -> DeviceColumn:
    """A column of ``dtype`` that is null in every one of its ``cap``
    rows: zero data, empty spans (an ARRAY's or MAP's children one null
    row each), a STRUCT's children null too."""
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    if isinstance(dtype, t.StructType):
        return DeviceColumn(dtype, None, valid, None, None,
                            [null_column(f.data_type, cap, device)
                             for f in dtype.fields])
    if isinstance(dtype, (t.ArrayType, t.MapType)):
        return DeviceColumn(dtype, None, valid, torch.zeros(
            cap + 1, dtype=torch.int32, device=device), None,
            [null_column(k, 1, device) for k in t.child_types(dtype)])
    if t.is_span(dtype):
        return DeviceColumn(dtype, torch.zeros(
            DEFAULT_CHAR_BUCKETS[0], dtype=torch.uint8, device=device),
            valid, torch.zeros(cap + 1, dtype=torch.int32, device=device))
    zeros = torch.zeros(cap, dtype=dtype.torch_dtype, device=device)
    return DeviceColumn(dtype, zeros, valid, None,
                        torch.zeros_like(zeros) if t.is_dec128(dtype)
                        else None)


def column_bytes(col: DeviceColumn) -> int:
    """The device bytes of a column's tensors, children included."""
    return sum(x.nbytes for x in (col.data, col.validity, col.offsets,
                                  col.data_hi) if x is not None) + \
        sum(column_bytes(c) for c in col.children)


def columns_from_lanes(cols: Sequence[DeviceColumn], lanes):
    """Columns of ``cols``' types over moved lanes laid out as
    ``flat_lanes`` lays them."""
    it = iter(lanes)
    out = []
    for c in cols:
        data, valid = next(it), next(it)
        out.append(DeviceColumn(c.dtype, data, valid, None,
                                None if c.data_hi is None else next(it)))
    return out


def unpack_bits(bitmap: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n] from a bitmap of 8 rows a byte, least significant bit
    first (Arrow's validity bitmap order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmap.device)
    bits = (bitmap.unsqueeze(1) >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """An Arrow validity bitmap (uint8, least significant bit first) of a
    bool[n] on the CPU."""
    return torch.from_numpy(np.packbits(x.numpy(), bitorder="little"))


class HostColumn(DeviceColumn):
    """A column fetched to the host by columnar/fetch.py: ``data`` holds
    the live rows on the CPU and ``bitmap`` their validity as an Arrow
    bitmap (uint8, least significant bit first), or None when every row
    is valid.  ``validity`` unpacks the bitmap on first read, so a
    collect hands the bitmap to Arrow as it came from the card.  A
    STRING or BINARY column's ``offsets`` are int32[rows + 1], as on the
    device, so an operator of the CPU engine gathers it as it gathers a
    device column, and ``data`` its ``offsets[rows]`` bytes; an ARRAY's
    or MAP's ``offsets`` are int32[rows + 1] over ``children`` of
    ``offsets[rows]``
    rows; a STRUCT's ``children`` have ``rows`` rows and ``data`` is
    None, so ``rows`` is given."""

    __slots__ = ("bitmap", "_validity", "_rows")

    def __init__(self, dtype: t.DataType, data: Optional[torch.Tensor],
                 bitmap: Optional[torch.Tensor],
                 offsets: Optional[torch.Tensor] = None,
                 data_hi: Optional[torch.Tensor] = None,
                 children: Sequence[DeviceColumn] = (),
                 rows: Optional[int] = None):
        self.dtype = dtype
        self.data = data
        self.offsets = offsets
        self.data_hi = data_hi
        self.children = tuple(children)
        self.bitmap = bitmap
        self._validity = None
        self._rows = rows

    @property
    def capacity(self) -> int:
        if self._rows is not None:
            return self._rows
        return DeviceColumn.capacity.fget(self)

    @property
    def validity(self) -> torch.Tensor:
        if self._validity is None:
            n = self.capacity
            self._validity = (torch.ones(n, dtype=torch.bool)
                              if self.bitmap is None
                              else unpack_bits(self.bitmap, n))
        return self._validity


class DeviceBatch:
    """Columns of one capacity plus the live row count."""

    __slots__ = ("columns", "num_rows", "names")

    def __init__(self, columns: Sequence[DeviceColumn], num_rows: int,
                 names: Optional[Sequence[str]] = None):
        self.columns = tuple(columns)
        self.num_rows = int(num_rows)
        self.names = tuple(names) if names is not None else tuple(
            f"c{i}" for i in range(len(self.columns)))

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.columns[0].validity.device

    def __repr__(self):
        return (f"DeviceBatch(cap={self.capacity}, rows={self.num_rows}, "
                f"cols={[c.dtype.name for c in self.columns]})")


def _padded(values: np.ndarray, cap: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    out = torch.zeros(cap, dtype=dtype, device=device)
    n = values.shape[0]
    if n:
        with warnings.catch_warnings():
            # Arrow's buffers are read-only; the tensor is only read here
            warnings.filterwarnings("ignore", message=".*not writable.*")
            src = torch.from_numpy(np.ascontiguousarray(values))
        out[:n].copy_(src)
    return out


def string_buffers(arr: pa.Array):
    """(offsets int32[n + 1] rebased to 0, chars uint8[offsets[n]]) of an
    Arrow string, large_string, binary or large_binary array, as numpy
    views where Arrow's buffers allow: a sliced array is rebased, and a
    null becomes empty (the reference's span branch)."""
    n = len(arr)
    wide = pa.types.is_large_string(arr.type) or \
        pa.types.is_large_binary(arr.type)
    empty = b"" if pa.types.is_binary(arr.type) or \
        pa.types.is_large_binary(arr.type) else ""

    def offsets_of(a):
        return np.frombuffer(a.buffers()[1],
                             dtype=np.int64 if wide else np.int32,
                             count=n + 1 + a.offset)[a.offset:]
    offs = offsets_of(arr)
    if arr.null_count and np.diff(offs)[
            ~np.asarray(arr.is_valid())].any():
        arr = arr.fill_null(empty)          # a null with bytes: drop them
        offs = offsets_of(arr)
    bufs = arr.buffers()
    base = int(offs[0])
    nbytes = int(offs[-1]) - base
    if nbytes > _INT32_MAX:
        raise ValueError(f"a string column of {nbytes} bytes exceeds the "
                         f"2^31-1 bytes of int32 offsets; split the batch")
    if base or wide:
        offs = (offs - base).astype(np.int32)
    chars = np.zeros(0, dtype=np.uint8) if bufs[2] is None else \
        np.frombuffer(bufs[2], dtype=np.uint8, count=base + nbytes)[base:]
    return offs, chars


def string_to_device(offs: np.ndarray, chars: np.ndarray, validity,
                     cap: int, device: torch.device,
                     dtype: t.DataType = t.STRING) -> DeviceColumn:
    """A STRING (or BINARY) column from rebased numpy offsets
    (int32[n + 1]) and bytes: offsets padded to cap + 1 by the last
    offset and bytes zero-padded to their bucket, both lanes in one
    host-to-device copy."""
    n = offs.shape[0] - 1
    nbytes = int(offs[-1])
    char_cap = bucket_for(max(nbytes, 1), DEFAULT_CHAR_BUCKETS)
    head = 4 * (cap + 1)
    host = np.empty(head + nbytes, dtype=np.uint8)
    o = host[:head].view(np.int32)
    o[:n + 1] = offs
    o[n + 1:] = nbytes
    host[head:] = chars
    buf = torch.empty(head + char_cap, dtype=torch.uint8, device=device)
    buf[:head + nbytes].copy_(torch.from_numpy(host))
    buf[head + nbytes:].zero_()
    return DeviceColumn(dtype, buf[head:], validity,
                        buf[:head].view(torch.int32))


def decimal_words(arr: pa.Array):
    """(lo, hi) int64 numpy views of a decimal128 array's 16-byte values,
    read straight from its buffer (the reference's ``_decimal_unscaled``);
    the words under a null are whatever the buffer holds."""
    raw = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                        count=2 * (len(arr) + arr.offset))
    raw = raw.reshape(-1, 2)[arr.offset:arr.offset + len(arr)]
    return raw[:, 0], raw[:, 1]


def _flat_numpy(arr: pa.Array, dtype: t.DataType) -> np.ndarray:
    """A flat column's values as the lane's numpy dtype (nulls already
    filled): a DATE as int32 days, a TIMESTAMP as int64 microseconds in
    UTC (pyarrow's safe cast from another unit, as the reference's
    upload casts it), an unsigned integer widened."""
    if dtype == t.DATE:
        return np.asarray(arr.cast(pa.int32()))
    if dtype == t.TIMESTAMP:
        return np.asarray(arr.cast(pa.timestamp("us", tz="UTC"))
                          .cast(pa.int64()))
    data = arr.to_numpy(zero_copy_only=False)
    want = torch.empty(0, dtype=dtype.torch_dtype).numpy().dtype
    return data if data.dtype == want else data.astype(want)


def list_parts(arr: pa.Array):
    """(offsets int32[n + 1] rebased to 0, child arrays of offsets[n]
    rows) of an Arrow list, large_list or map array: the values (a map's
    keys and items) of the slice.  Entries that a null row still spans
    are dropped, so a null row spans none (the reference's map repair,
    and its ``fill_null([])`` of a list)."""
    n = len(arr)
    offs = np.asarray(arr.offsets).astype(np.int64)
    kids = [arr.keys, arr.items] if pa.types.is_map(arr.type) \
        else [arr.values]
    base = int(offs[0]) if n else 0
    spans = np.diff(offs) if n else np.zeros(0, np.int64)
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
        spans0 = np.where(valid, spans, 0)
        if not np.array_equal(spans0, spans):
            keep = np.flatnonzero(np.repeat(valid, spans)) + base
            kids = [k.take(pa.array(keep)) for k in kids]
            spans, base = spans0, 0
    total = int(spans.sum())
    if total > _INT32_MAX:
        raise ValueError(f"a nested column of {total} child rows exceeds "
                         f"the 2^31-1 rows of int32 offsets; split the "
                         f"batch")
    out = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(spans, out=out[1:])
    return out, [k.slice(base, total) for k in kids]


def _validity_lane(arr: pa.Array, cap: int,
                   device: torch.device) -> torch.Tensor:
    if arr.null_count:
        return _padded(np.asarray(arr.is_valid()), cap, torch.bool, device)
    # no nulls: build the validity on the device, not over the bus
    return torch.arange(cap, device=device) < len(arr)


def column_to_device(arr, dtype: t.DataType, cap: int,
                     device: torch.device) -> DeviceColumn:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    if isinstance(dtype, (t.ArrayType, t.MapType)):
        offs, kids = list_parts(arr)
        child_cap = bucket_for(max(int(offs[-1]), 1))
        children = [column_to_device(k, kt, child_cap, device)
                    for k, kt in zip(kids, t.child_types(dtype))]
        full = np.full(cap + 1, offs[-1], dtype=np.int32)
        full[:n + 1] = offs
        return DeviceColumn(dtype, None, _validity_lane(arr, cap, device),
                            torch.from_numpy(full).to(device), None,
                            children)
    if isinstance(dtype, t.StructType):
        return DeviceColumn(dtype, None, _validity_lane(arr, cap, device),
                            None, None,
                            [column_to_device(arr.field(i), f.data_type,
                                              cap, device)
                             for i, f in enumerate(dtype.fields)])
    if isinstance(dtype, t.DecimalType):
        validity = _padded(np.asarray(arr.is_valid()), cap, torch.bool,
                           device) if arr.null_count else \
            torch.arange(cap, device=device) < n
        lo, hi = decimal_words(arr)
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
            lo, hi = np.where(valid, lo, 0), np.where(valid, hi, 0)
        return DeviceColumn(
            dtype, _padded(lo, cap, torch.int64, device), validity, None,
            None if dtype.is64 else _padded(hi, cap, torch.int64, device))
    if t.is_span(dtype):
        return string_to_device(*string_buffers(arr),
                                _validity_lane(arr, cap, device), cap,
                                device, dtype)
    if dtype == t.NULL:
        return DeviceColumn(dtype, torch.zeros(cap, dtype=torch.int8,
                                               device=device),
                            torch.zeros(cap, dtype=torch.bool, device=device))
    if arr.null_count:
        validity = _padded(np.asarray(arr.is_valid()), cap, torch.bool,
                           device)
        arr = arr.fill_null(False if dtype == t.BOOLEAN else 0)
    else:
        # no nulls: build the validity on the device, not over the bus
        validity = torch.arange(cap, device=device) < n
    data = _flat_numpy(arr, dtype)
    return DeviceColumn(dtype, _padded(data, cap, dtype.torch_dtype, device),
                        validity)


def batch_to_device(rb: pa.RecordBatch, device=None,
                    capacity: Optional[int] = None) -> DeviceBatch:
    """Upload an Arrow RecordBatch, padding to a capacity bucket."""
    dev = resolve_device(device)
    n = rb.num_rows
    cap = capacity if capacity is not None else bucket_for(n)
    cols = [column_to_device(rb.column(i), from_arrow_type(f.type), cap, dev)
            for i, f in enumerate(rb.schema)]
    return DeviceBatch(cols, n, rb.schema.names)


def batch_from_numpy_lanes(lanes: Sequence[np.ndarray],
                           validity: Sequence[np.ndarray], num_rows: int,
                           names: Sequence[str], type_names: Sequence[str],
                           device=None) -> DeviceBatch:
    """Build a batch from the numpy arrays of another engine's batch,
    padding rows included: ``lanes[i]`` and ``validity[i]`` are column
    i's data and validity over the whole capacity, ``type_names[i]`` its
    SQL type name (``bigint``, ``int``, ``double``, ``boolean``)."""
    dev = resolve_device(device)
    cols = []
    for data, valid, tn in zip(lanes, validity, type_names):
        dtype = t.from_name(tn)
        if t.is_span(dtype) or t.is_nested(dtype) or t.is_dec128(dtype):
            raise NotImplementedError(
                "batch_from_numpy_lanes takes one flat lane a column; a "
                "string, binary or nested column or a decimal of more "
                "than 18 digits goes through batch_to_device")
        cols.append(DeviceColumn(
            dtype,
            torch.from_numpy(np.array(data)).to(dtype.torch_dtype).to(dev),
            torch.from_numpy(np.array(valid, dtype=np.bool_)).to(dev)))
    return DeviceBatch(cols, num_rows, names)


def move_column(c: DeviceColumn, device: torch.device,
                keep: Optional[int] = None) -> DeviceColumn:
    """The column on ``device``; with ``keep`` only its first ``keep``
    rows (and the bytes or child rows they span, at least one)."""
    valid = c.validity[:keep].to(device)
    if c.offsets is None:
        return DeviceColumn(
            c.dtype, None if c.data is None else c.data[:keep].to(device),
            valid, None,
            None if c.data_hi is None else c.data_hi[:keep].to(device),
            [move_column(k, device, keep) for k in c.children])
    offs = c.offsets if keep is None else c.offsets[:keep + 1]
    inner = None if keep is None else max(int(offs[-1]), 1)
    return DeviceColumn(
        c.dtype, None if c.data is None else c.data[:inner].to(device),
        valid, offs.to(device), None,
        [move_column(k, device, inner) for k in c.children])


def move_batch(batch: DeviceBatch, device: torch.device,
               live_only: bool = False) -> DeviceBatch:
    """The batch with every lane on ``device``; with ``live_only`` only
    the live rows (at least one row) cross, so the copy holds no
    padding beyond that."""
    keep = max(batch.num_rows, 1) if live_only else None
    return DeviceBatch([move_column(c, device, keep) for c in batch.columns],
                       batch.num_rows, batch.names)


def string_to_arrow(offsets: torch.Tensor, chars: torch.Tensor,
                    bitmap, n: int,
                    arrow_type: pa.DataType = pa.large_string()) -> pa.Array:
    """A large_string (or large_binary) array of n rows from a column's
    offsets (rows [0, n]), its chars and an Arrow validity bitmap (or
    None), with no per-row Python."""
    offs = offsets[:n + 1].cpu().to(torch.int64)
    nbytes = int(offs[-1]) if n else 0
    data = chars[:nbytes].cpu().contiguous()
    bitmap = None if bitmap is None else pa.py_buffer(bitmap.numpy())
    return pa.Array.from_buffers(arrow_type, n, [
        bitmap, pa.py_buffer(offs.numpy()), pa.py_buffer(data.numpy())])


def decimal_buffer(lo: torch.Tensor, hi: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """The 16-byte little-endian values of Arrow's decimal128 from the
    low words and the high words (None: the low word's sign), as a CPU
    int64[n, 2] tensor."""
    lo = lo.cpu()
    out = torch.empty(lo.shape[0], 2, dtype=torch.int64)
    out[:, 0] = lo
    out[:, 1] = (lo >> 63) if hi is None else hi.cpu()
    return out


def _bitmap_of(col: DeviceColumn, n: int):
    """An Arrow validity buffer of the column's first n rows, or None
    when every row is valid."""
    if isinstance(col, HostColumn):
        bitmap = col.bitmap
    else:
        valid = col.validity[:n].cpu()
        bitmap = None if bool(valid.all()) else _pack_bits(valid)
    return None if bitmap is None else pa.py_buffer(bitmap.numpy())


def _nested_to_arrow(col: DeviceColumn, n: int) -> pa.Array:
    """An ARRAY, MAP or STRUCT column's first n rows as Arrow, built from
    its buffers (offsets, the validity bitmap, the children), with no
    per-row Python.  A STRUCT's bitmap masks children that hold a value
    under a null row."""
    at = to_arrow_type(col.dtype)
    bitmap = _bitmap_of(col, n)
    if isinstance(col.dtype, t.StructType):
        kids = [column_to_arrow(k, n) for k in col.children]
        return pa.Array.from_buffers(at, n, [bitmap], children=kids)
    offs = col.offsets[:n + 1].cpu().to(torch.int64)
    inner = int(offs[-1]) if n else 0
    kids = [column_to_arrow(k, inner) for k in col.children]
    if isinstance(col.dtype, t.MapType):
        entries = pa.StructArray.from_arrays(
            kids, fields=[at.key_field, at.item_field])
        return pa.Array.from_buffers(at, n, [
            bitmap, pa.py_buffer(offs.to(torch.int32).numpy())],
            children=[entries])
    return pa.Array.from_buffers(at, n, [bitmap, pa.py_buffer(offs.numpy())],
                                 children=kids)


def column_to_arrow(col: DeviceColumn, n: int) -> pa.Array:
    if col.dtype == t.NULL:
        return pa.nulls(n)
    if t.is_nested(col.dtype):
        return _nested_to_arrow(col, n)
    if col.offsets is not None:
        if isinstance(col, HostColumn):
            bitmap = col.bitmap
        else:
            valid = col.validity[:n].cpu()
            bitmap = None if bool(valid.all()) else _pack_bits(valid)
        return string_to_arrow(col.offsets, col.data, bitmap, n,
                               to_arrow_type(col.dtype))
    if isinstance(col.dtype, t.DecimalType):
        # both words into Arrow's 16-byte values, no per-row Python
        words = decimal_buffer(col.data[:n], None if col.data_hi is None
                               else col.data_hi[:n])
        return pa.Array.from_buffers(to_arrow_type(col.dtype), n, [
            _bitmap_of(col, n), pa.py_buffer(words.numpy())])
    if col.dtype != t.BOOLEAN:
        # the lane as Arrow's buffer: without a copy for a fetched lane
        data = col.data[:n].cpu().contiguous()
        if not isinstance(col, HostColumn) and col.data.device.type == "cpu":
            data = data.clone()             # the batch's lane stays its own
        return pa.Array.from_buffers(to_arrow_type(col.dtype), n, [
            _bitmap_of(col, n), pa.py_buffer(data.numpy())])
    data = col.data[:n].cpu().numpy()
    valid = col.validity[:n].cpu().numpy()
    mask = None if valid.all() else ~valid
    return pa.array(data, type=to_arrow_type(col.dtype), mask=mask)


def batch_to_arrow(batch: DeviceBatch) -> pa.RecordBatch:
    n = batch.num_rows
    return pa.RecordBatch.from_arrays(
        [column_to_arrow(c, n) for c in batch.columns],
        names=list(batch.names))
