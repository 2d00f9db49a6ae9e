"""Device-resident columnar data over torch tensors.

Counterpart of spark_rapids_tpu/columnar/device.py.  A column is a
``data`` tensor and a bool ``validity`` tensor, both padded to a
capacity bucket; the batch's row count is a host int.  Rows at index
>= num_rows are padding and are always invalid, and the data under a
null is zero.
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
    """One column: ``data`` and bool ``validity``, both [capacity]."""

    __slots__ = ("dtype", "data", "validity")

    def __init__(self, dtype: t.DataType, data: torch.Tensor,
                 validity: torch.Tensor):
        self.dtype = dtype
        self.data = data
        self.validity = validity

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def __repr__(self):
        return f"DeviceColumn({self.dtype.name}, cap={self.capacity})"


def unpack_bits(bitmap: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n] from a bitmap of 8 rows a byte, least significant bit
    first (Arrow's validity bitmap order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmap.device)
    bits = (bitmap.unsqueeze(1) >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


class HostColumn(DeviceColumn):
    """A column fetched to the host by columnar/fetch.py: ``data`` holds
    the live rows on the CPU and ``bitmap`` their validity as an Arrow
    bitmap (uint8, least significant bit first), or None when every row
    is valid.  ``validity`` unpacks the bitmap on first read, so a
    collect hands the bitmap to Arrow as it came from the card."""

    __slots__ = ("bitmap", "_validity")

    def __init__(self, dtype: t.DataType, data: torch.Tensor,
                 bitmap: Optional[torch.Tensor]):
        self.dtype = dtype
        self.data = data
        self.bitmap = bitmap
        self._validity = None

    @property
    def validity(self) -> torch.Tensor:
        if self._validity is None:
            n = int(self.data.shape[0])
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


def column_to_device(arr, dtype: t.DataType, cap: int,
                     device: torch.device) -> DeviceColumn:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
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
    data = arr.to_numpy(zero_copy_only=False)
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
    cols = [DeviceColumn(c.dtype, c.data[:keep].to(device),
                         c.validity[:keep].to(device))
            for c in batch.columns]
    return DeviceBatch(cols, batch.num_rows, batch.names)


def column_to_arrow(col: DeviceColumn, n: int) -> pa.Array:
    if col.dtype == t.NULL:
        return pa.nulls(n)
    if isinstance(col, HostColumn) and col.dtype != t.BOOLEAN and \
            col.data.shape[0] == n:
        # the fetched lanes as Arrow's buffers, without a copy
        bitmap = None if col.bitmap is None else pa.py_buffer(
            col.bitmap.numpy())
        return pa.Array.from_buffers(to_arrow_type(col.dtype), n, [
            bitmap, pa.py_buffer(col.data.numpy())])
    data = col.data[:n].cpu().numpy()
    valid = col.validity[:n].cpu().numpy()
    mask = None if valid.all() else ~valid
    return pa.array(data, type=to_arrow_type(col.dtype), mask=mask)


def batch_to_arrow(batch: DeviceBatch) -> pa.RecordBatch:
    n = batch.num_rows
    return pa.RecordBatch.from_arrays(
        [column_to_arrow(c, n) for c in batch.columns],
        names=list(batch.names))
