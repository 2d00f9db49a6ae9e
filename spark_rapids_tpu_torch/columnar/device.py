"""Device-resident columnar data over torch tensors.

Counterpart of spark_rapids_tpu/columnar/device.py.  A column is a
``data`` tensor and a bool ``validity`` tensor, both padded to a
capacity bucket; the batch's row count is a host int.  Rows at index
>= num_rows are padding and are always invalid, and the data under a
null is zero.  A STRING column is the reference's span layout:
``offsets`` int32[capacity + 1], rebased to 0 and repeating the last
offset past the live rows, over ``data``, the UTF-8 bytes, uint8
zero-padded to a ``DEFAULT_CHAR_BUCKETS`` bucket; a null string is
empty.  A DECIMAL wider than 18 digits has a second lane, ``data_hi``:
``data`` holds the unscaled value's low 64 bits (int64 bits of the
unsigned word) and ``data_hi`` its signed high 64 bits; every helper
that copies a column's rows carries both.
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
    span column (STRING) ``offsets`` int32[capacity + 1] over the chars
    in ``data``, else None; for a DECIMAL of more than 18 digits
    ``data_hi``, the high words (int64[capacity]), else None."""

    __slots__ = ("dtype", "data", "validity", "offsets", "data_hi")

    def __init__(self, dtype: t.DataType, data: torch.Tensor,
                 validity: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None,
                 data_hi: Optional[torch.Tensor] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.data_hi = data_hi

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    def __repr__(self):
        return f"DeviceColumn({self.dtype.name}, cap={self.capacity})"


def flat_lanes(cols: Sequence[DeviceColumn]):
    """The row lanes of flat columns, column by column: data, validity,
    then data_hi where there is one (``columns_from_lanes`` undoes it)."""
    lanes = []
    for c in cols:
        lanes += [c.data, c.validity] + ([] if c.data_hi is None
                                         else [c.data_hi])
    return lanes


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
    STRING column's ``offsets`` are int64[rows + 1] and ``data`` its
    ``offsets[rows]`` bytes."""

    __slots__ = ("bitmap", "_validity")

    def __init__(self, dtype: t.DataType, data: torch.Tensor,
                 bitmap: Optional[torch.Tensor],
                 offsets: Optional[torch.Tensor] = None,
                 data_hi: Optional[torch.Tensor] = None):
        self.dtype = dtype
        self.data = data
        self.offsets = offsets
        self.data_hi = data_hi
        self.bitmap = bitmap
        self._validity = None

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
        return self.columns[0].data.device

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
    Arrow string or large_string array, as numpy views where Arrow's
    buffers allow: a sliced array is rebased, and a null becomes empty
    (the reference's span branch)."""
    n = len(arr)
    wide = pa.types.is_large_string(arr.type)

    def offsets_of(a):
        return np.frombuffer(a.buffers()[1],
                             dtype=np.int64 if wide else np.int32,
                             count=n + 1 + a.offset)[a.offset:]
    offs = offsets_of(arr)
    if arr.null_count and np.diff(offs)[
            ~np.asarray(arr.is_valid())].any():
        arr = arr.fill_null("")             # a null with bytes: drop them
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
                     cap: int, device: torch.device) -> DeviceColumn:
    """A STRING column from rebased numpy offsets (int32[n + 1]) and chars:
    offsets padded to cap + 1 by the last offset and chars zero-padded to
    their bucket, both lanes in one host-to-device copy."""
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
    return DeviceColumn(t.STRING, buf[head:], validity,
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


def column_to_device(arr, dtype: t.DataType, cap: int,
                     device: torch.device) -> DeviceColumn:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
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
    if dtype == t.STRING:
        validity = _padded(np.asarray(arr.is_valid()), cap, torch.bool,
                           device) if arr.null_count else \
            torch.arange(cap, device=device) < n
        return string_to_device(*string_buffers(arr), validity, cap, device)
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
        if dtype == t.STRING or t.is_dec128(dtype):
            raise NotImplementedError(
                "batch_from_numpy_lanes takes one flat lane a column; a "
                "string or a decimal of more than 18 digits goes through "
                "batch_to_device")
        cols.append(DeviceColumn(
            dtype,
            torch.from_numpy(np.array(data)).to(dtype.torch_dtype).to(dev),
            torch.from_numpy(np.array(valid, dtype=np.bool_)).to(dev)))
    return DeviceBatch(cols, num_rows, names)


def move_batch(batch: DeviceBatch, device: torch.device,
               live_only: bool = False) -> DeviceBatch:
    """The batch with every lane on ``device``; with ``live_only`` only
    the live rows (at least one row) cross, so the copy holds no
    padding beyond that."""
    keep = max(batch.num_rows, 1) if live_only else None
    cols = []
    for c in batch.columns:
        if c.offsets is None:
            cols.append(DeviceColumn(
                c.dtype, c.data[:keep].to(device),
                c.validity[:keep].to(device), None,
                None if c.data_hi is None else c.data_hi[:keep].to(device)))
            continue
        offs = c.offsets if keep is None else c.offsets[:keep + 1]
        nbytes = None if keep is None else max(int(offs[-1]), 1)
        cols.append(DeviceColumn(c.dtype, c.data[:nbytes].to(device),
                                 c.validity[:keep].to(device),
                                 offs.to(device)))
    return DeviceBatch(cols, batch.num_rows, batch.names)


def string_to_arrow(offsets: torch.Tensor, chars: torch.Tensor,
                    bitmap, n: int) -> pa.Array:
    """A large_string array of n rows from a column's offsets (rows
    [0, n]), its chars and an Arrow validity bitmap (or None), with no
    per-row Python."""
    offs = offsets[:n + 1].cpu().to(torch.int64)
    nbytes = int(offs[-1]) if n else 0
    data = chars[:nbytes].cpu().contiguous()
    bitmap = None if bitmap is None else pa.py_buffer(bitmap.numpy())
    return pa.Array.from_buffers(pa.large_string(), n, [
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


def column_to_arrow(col: DeviceColumn, n: int) -> pa.Array:
    if col.dtype == t.NULL:
        return pa.nulls(n)
    if col.offsets is not None:
        if isinstance(col, HostColumn):
            bitmap = col.bitmap
        else:
            valid = col.validity[:n].cpu()
            bitmap = None if bool(valid.all()) else _pack_bits(valid)
        return string_to_arrow(col.offsets, col.data, bitmap, n)
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
