"""Row gather over flat device columns.

Counterpart of spark_rapids_tpu/ops/gather.py for flat columns: row i
of the output is row ``indices[i]`` of the input, and null where
``valid[i]`` is False.  ``gather_rows`` moves row lanes through a sort's
order with kernel K8 (``csrc/gather_rows.cu``), and ``scatter_rows``,
its dual, moves them back to input order with kernel K13
(``csrc/scatter_rows.cu``).  Each wrapper takes its plain version for
CPU tensors only, launches its kernel for CUDA tensors or raises, and
counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import kernels
from ..columnar.device import DeviceBatch, DeviceColumn

_MAX_LANES = 16          # lanes a launch (kMaxLanes in csrc)


def gather_rows_plain(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Plain version of K8: one ``index_select`` per lane."""
    idx = order.to(torch.int64)
    return [x.index_select(0, idx) for x in lanes]


def gather_rows(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """``out[l][i] = lanes[l][order[i]]`` (K8): ``order`` is int32[n], as
    K2 returns it; each lane is 1-D with 1, 4 or 8-byte elements."""
    if order.dtype != torch.int32 or order.dim() != 1:
        raise TypeError(f"gather_rows: order must be int32[n], got "
                        f"{order.dtype}{tuple(order.shape)}")
    if order.device.type == "cpu":
        return gather_rows_plain(order, lanes)
    kernels.require_cuda("gather_rows", order, *lanes)
    for x in lanes:
        if x.dim() != 1 or x.element_size() not in (1, 4, 8):
            raise TypeError(f"gather_rows: lane {x.dtype}{tuple(x.shape)} "
                            f"is not 1-D with 1, 4 or 8-byte elements")
    n = int(order.shape[0])
    outs = [torch.empty(n, dtype=x.dtype, device=x.device) for x in lanes]
    if n == 0 or not lanes:
        return outs
    lib = kernels.library("gather_rows")
    for s in range(0, len(lanes), _MAX_LANES):
        chunk, out_chunk = lanes[s:s + _MAX_LANES], outs[s:s + _MAX_LANES]
        kernels.check(lib, lib.srt_gather_rows(
            order.data_ptr(), n, len(chunk), kernels.pointers(chunk),
            kernels.pointers(out_chunk),
            kernels.ints(x.element_size() for x in chunk),
            kernels.stream(order)), "gather_rows")
        gather_rows.launches += 1
    return outs


gather_rows.launches = 0


def _check_lanes(what: str, order: torch.Tensor,
                 lanes: Sequence[torch.Tensor]) -> None:
    if order.dtype != torch.int32 or order.dim() != 1:
        raise TypeError(f"{what}: order must be int32[n], got "
                        f"{order.dtype}{tuple(order.shape)}")
    n = order.shape[0]
    for x in lanes:
        if x.shape != (n,) or x.element_size() not in (1, 4, 8):
            raise TypeError(f"{what}: lane {x.dtype}{tuple(x.shape)} is not "
                            f"[{n}] with 1, 4 or 8-byte elements")


def scatter_rows_plain(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """Plain version of K13: one indexed assignment per lane."""
    idx = order.to(torch.int64)
    outs = []
    for x in lanes:
        out = torch.empty_like(x)
        out[idx] = x
        outs.append(out)
    return outs


def scatter_rows(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """``out[l][order[i]] = lanes[l][i]`` (K13), the inverse of
    ``gather_rows``: rows sorted by K2's ``order`` go back to input order.
    ``order`` is a permutation, int32[n]; each lane is [n] with 1, 4 or
    8-byte elements."""
    _check_lanes("scatter_rows", order, lanes)
    if order.device.type == "cpu":
        return scatter_rows_plain(order, lanes)
    kernels.require_cuda("scatter_rows", order, *lanes)
    n = int(order.shape[0])
    outs = [torch.empty_like(x) for x in lanes]
    if n == 0 or not lanes:
        return outs
    lib = kernels.library("scatter_rows")
    for s in range(0, len(lanes), _MAX_LANES):
        chunk, out_chunk = lanes[s:s + _MAX_LANES], outs[s:s + _MAX_LANES]
        kernels.check(lib, lib.srt_scatter_rows(
            order.data_ptr(), n, len(chunk), kernels.pointers(chunk),
            kernels.pointers(out_chunk),
            kernels.ints(x.element_size() for x in chunk),
            kernels.stream(order)), "scatter_rows")
        scatter_rows.launches += 1
    return outs


scatter_rows.launches = 0


def gather_column(col: DeviceColumn, indices: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    idx = indices.to(torch.int64)
    data = col.data[idx]
    validity = col.validity[idx]
    if valid is not None:
        validity = validity & valid
        data = torch.where(validity, data, torch.zeros_like(data))
    return DeviceColumn(col.dtype, data, validity)


def gather_batch(batch: DeviceBatch, indices: torch.Tensor,
                 valid: Optional[torch.Tensor], num_rows: int) -> DeviceBatch:
    return DeviceBatch([gather_column(c, indices, valid)
                        for c in batch.columns], num_rows, batch.names)
