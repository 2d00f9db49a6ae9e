"""Grouped aggregate: sort by key words, then one fold per group; and the
host engine's aggregate.

Counterpart of spark_rapids_tpu/exec/aggregate.py (TpuHashAggregateExec
and its _group_reduce, CpuHashAggregateExec).  Per batch: evaluate the grouping keys and the
update inputs, build order-preserving int64 key words, sort the live
rows stably by them (kernel K2), and reduce each group (kernel K3: sums,
counts, min and max),
which reads the lanes through K2's order: no lane is gathered into key
order first.  Across batches: concatenate the partial buffers, order
them by key and buffer words (the canonical keyed merge), and reduce
again through that order with the merge ops.  COMPLETE and FINAL modes
then evaluate the result expressions over the buffers.
CpuHashAggregateExec is the complete-mode aggregate the plan rewrite
starts from and keeps on the CPU where tagging says so: pyarrow's
group_by over the host-evaluated keys and inputs.
"""

from __future__ import annotations

import functools
import itertools
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import kernels
from .. import types as t
from ..analysis.determinism import ORDER_DEPENDENT, ORDER_STABLE, Determinism
from ..columnar.device import (DeviceBatch, DeviceColumn, batch_to_device,
                               bucket_for, column_to_arrow)
from ..columnar.interop import to_arrow_schema, to_arrow_type
from ..expr.aggregates import (COMPLETE, PARTIAL, AggregateExpression,
                               Average, Count, Max, Min, Sum, bind_aggregate)
from ..expr.core import (ColumnValue, EvalContext, Expression, ScalarValue,
                         bind_expression, make_column, output_name)
from ..ops import segmented as seg
from ..ops.carry import sort_order
from ..ops.gather import gather_columns
from .base import CPU, Exec, ExecContext
from .concat import concat_batches

_KIND_COUNT, _KIND_SUM_INT, _KIND_SUM_FLOAT = 0, 1, 2
# min / max of an int64 lane, then of a float64 lane
_KIND_EXTREME = {("min", False): 3, ("max", False): 4, ("min", True): 5,
                 ("max", True): 6}


# ---------------------------------------------------------------------------
# K3: grouped reduce over rows read in key order
# ---------------------------------------------------------------------------

def _op_names(values, ops) -> List[str]:
    """Each op's name: ``count`` for a None value, else ``ops[k]`` (sum,
    min or max; every value sums when ``ops`` is None)."""
    if ops is None:
        ops = ["sum"] * len(values)
    if len(ops) != len(values):
        raise ValueError("segment_reduce_sorted: one op per value lane")
    names = []
    for v, op in zip(values, ops):
        if v is None:
            names.append("count")
        elif op in ("sum", "min", "max"):
            names.append(op)
        else:
            raise ValueError(f"segment_reduce_sorted: op {op!r}")
    return names


def segment_reduce_sorted_plain(words: Sequence[torch.Tensor],
                                live: Optional[torch.Tensor],
                                values: Sequence[Optional[torch.Tensor]],
                                contribs: Sequence[torch.Tensor],
                                global_agg: bool,
                                order: Optional[torch.Tensor] = None,
                                ops: Optional[Sequence[str]] = None):
    """Plain version of K3: the lanes put in key order by index_select,
    then boundaries, segment ids, index_add_ and, for min and max,
    ``ops/segmented.py:segment_reduce``.  See ``segment_reduce_sorted``
    for the arguments and the result."""
    names = _op_names(values, ops)
    if order is not None:
        idx = order.to(torch.int64)
        words = [w.index_select(0, idx) for w in words]
        live = None if live is None else live.index_select(0, idx)
        values = [None if v is None else v.index_select(0, idx)
                  for v in values]
        contribs = [c.index_select(0, idx) for c in contribs]
    lanes = _lanes(words, live, values, contribs)
    n, dev = int(lanes[0].shape[0]), lanes[0].device
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    if global_agg:
        groups = 1
        ids = torch.zeros(n, dtype=torch.int64, device=dev)
        first_row = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        new_group = seg.segment_boundaries(words, live)
        first_row = torch.nonzero(new_group).flatten().to(torch.int32)
        groups = int(first_row.shape[0])
        ids = seg.segment_ids(new_group).to(torch.int64)
    grouped = ids >= 0            # rows before the first start: no group
    sums, counts = [], []
    for v, c, op in zip(values, contribs, names):
        if op in ("min", "max"):
            out, cnt = seg.segment_reduce(op, v, ids, groups, c & grouped)
            sums.append(out)
            counts.append(cnt)
            continue
        c = c & grouped
        idx = ids[c]

        def per_group(x, dtype):
            return torch.zeros(groups, dtype=dtype, device=dev).index_add_(
                0, idx, x.to(dtype))

        cnt = per_group(torch.ones_like(idx), torch.int64)
        counts.append(cnt)
        if v is None:
            sums.append(None)
            continue
        x = v[c]
        if v.dtype != torch.float64:
            sums.append(per_group(x, torch.int64))
            continue
        finite = torch.isfinite(x)
        s = per_group(torch.where(finite, x, torch.zeros_like(x)),
                      torch.float64)
        n_nan = per_group(torch.isnan(x), torch.int64)
        n_pi = per_group(x == float("inf"), torch.int64)
        n_ni = per_group(x == float("-inf"), torch.int64)
        s = torch.where((n_nan > 0) | ((n_pi > 0) & (n_ni > 0)),
                        torch.full_like(s, float("nan")), s)
        s = torch.where((n_pi > 0) & (n_ni == 0) & (n_nan == 0),
                        torch.full_like(s, float("inf")), s)
        s = torch.where((n_ni > 0) & (n_pi == 0) & (n_nan == 0),
                        torch.full_like(s, float("-inf")), s)
        sums.append(torch.where(cnt > 0, s, torch.zeros_like(s)))
    if order is not None and n > 0:
        first_row = order.index_select(0, first_row.to(torch.int64))
    return first_row, sums, counts, groups


def _lanes(words, live, values, contribs) -> List[torch.Tensor]:
    lanes = [x for x in (*words, live, *values, *contribs) if x is not None]
    if not lanes:
        raise ValueError("segment_reduce_sorted needs a key word, the live "
                         "flags or an op")
    return lanes


_K3_OPS_PER_SET = 16           # kOpsPerLaunch in csrc/segment_reduce.cu
_K3_RECORD_SIZES = (16, 32, 64, 128)
_K3_STAGE_BYTES = 65536        # a record tile: 256 threads x K rows x R
_K3_DIRECT_ROWS = 8            # rows a thread on the direct path
_K3_THREADS = 256
_K3_ACC_BYTES = 32             # one per-tile partial
_K3_SECTOR = 32                # what a read through the order moves
_K3_RECORD_KEYS = 7            # more varying words are read through the order
# An order of at most this many increasing runs of input rows (K2's
# stable order over at most this many groups) keeps the direct path:
# its reads then stream, and the records would add the pack and lose
# (chip_smoke.py's q1x row times both paths).
_K3_FEW_RUNS = 64
# K3 keeps the direct path while its distinct inputs are at most this
# many bytes: their reads through the order then mostly hit the 50 MB L2
# cache.  chip_smoke.py's _k3_sweep times both paths on either side.
_K3_DIRECT_BYTES = 96 << 20


class K3Set(NamedTuple):
    """One launch set of K3: its ops (indices into the call's ops), its
    distinct value lanes and contributor masks (each named by the first
    op that reads it), each op's lane (-1 for a count) and mask index
    (also its bit in a record's mask word), and on the record path the
    record's bytes and the byte offsets of the lanes, of the varying key
    words (first set only) and of the mask word."""
    ops: List[int]
    lanes: List[int]
    masks: List[int]
    op_lane: List[int]
    op_mask: List[int]
    record_bytes: int
    lane_offsets: List[int]
    key_offsets: List[int]
    mask_offset: int


class K3Plan(NamedTuple):
    """How K3 folds a call: on the record path (``packed``) or the direct
    one, with K rows a thread, in these sets; the device-memory bytes each
    path moves (a read through the order counted as the 32-byte sector
    it pulls) and the scratch bytes of the chosen one."""
    packed: bool
    rows_per_thread: int
    sets: List[K3Set]
    direct_bytes: int
    packed_bytes: int
    scratch_bytes: int


def _k3_set(ops, values, masks, nkeys, packed) -> Optional[K3Set]:
    """The set of ``ops``; None on the record path when its record would
    exceed 128 bytes.  A record holds the distinct value lanes (8 bytes
    each), then the ``nkeys`` key words it carries (8 each), then the
    mask word."""
    lane_keys, lanes, mask_keys, mks, op_lane, op_mask = [], [], [], [], [], []
    for k in ops:
        if values[k] is None:
            op_lane.append(-1)
        else:
            if values[k] not in lane_keys:
                lane_keys.append(values[k])
                lanes.append(k)
            op_lane.append(lane_keys.index(values[k]))
        if masks[k] not in mask_keys:
            mask_keys.append(masks[k])
            mks.append(k)
        op_mask.append(mask_keys.index(masks[k]))
    if not packed:
        return K3Set(list(ops), lanes, mks, op_lane, op_mask, 0, [], [], 0)
    need = 8 * (len(lanes) + nkeys) + 4
    size = next((r for r in _K3_RECORD_SIZES if r >= need), 0)
    if not size:
        return None
    return K3Set(list(ops), lanes, mks, op_lane, op_mask, size,
                 [8 * i for i in range(len(lanes))],
                 [8 * (len(lanes) + i) for i in range(nkeys)],
                 8 * (len(lanes) + nkeys))


def _k3_sets(values, masks, nkeys, packed) -> List[K3Set]:
    """The ops in order, cut into sets of at most 16; on the record path
    also where the next op's lane would not fit the set's record.  The
    first set's record carries the varying key words where there are at
    most ``_K3_RECORD_KEYS`` (else the fold reads them through the
    order), so one lane always fits."""
    sets, cur = [], []
    rec_keys = nkeys if packed and nkeys <= _K3_RECORD_KEYS else 0
    for k in range(len(values)):
        keys = 0 if sets else rec_keys
        if cur and (len(cur) == _K3_OPS_PER_SET or _k3_set(
                cur + [k], values, masks, keys, packed) is None):
            sets.append(_k3_set(cur, values, masks, keys, packed))
            cur = []
        cur.append(k)
    return sets + [_k3_set(cur, values, masks, 0 if sets else rec_keys,
                           packed)]


def _k3_bytes(n, sets, nkeys, live, ordered) -> int:
    """Device-memory bytes of K3's sets over n rows (the varying pass,
    the same on both paths, left out).  Record path: the pack reads the
    inputs and writes the records, the fold reads the order and one
    record a row, and the key words no record carries one sector a row
    each.  Direct path: the order and one sector a row for each input,
    or the inputs alone for rows already in key order."""
    total = 0
    for i, s in enumerate(sets):
        keys, lv = (nkeys, int(live)) if i == 0 else (0, 0)
        inputs = 8 * (len(s.lanes) + keys) + len(s.masks) + lv
        if s.record_bytes:
            far = keys - len(s.key_offsets)
            total += n * (inputs - 8 * far + s.record_bytes + 4
                          + max(s.record_bytes, _K3_SECTOR)
                          + _K3_SECTOR * far)
        elif ordered:
            total += n * (4 + _K3_SECTOR * (len(s.lanes) + len(s.masks)
                                            + keys + lv))
        else:
            total += n * inputs
    return total


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def k3_scratch_bytes(n: int, rows_per_thread: int, ops_per_set: int,
                     record_max: int) -> int:
    """K3's scratch (``layout`` in ``csrc/segment_reduce.cu``, which
    refuses less): the look-back state, the start bits, the tiles' start
    counts and slots, the head and tail partials of the widest set, and
    the records, each region rounded up to 16 bytes."""
    tiles = -(-n // (_K3_THREADS * rows_per_thread))
    ops = max(ops_per_set, 1)
    return sum(_up16(b) for b in (
        (1 + tiles) * 8, tiles * _K3_THREADS * 2, tiles * 4, tiles * 4,
        tiles * ops * _K3_ACC_BYTES, tiles * ops * _K3_ACC_BYTES,
        n * record_max))


def k3_may_pack(n: int, values: Sequence, masks: Sequence,
                ordered: bool) -> bool:
    """Whether K3's record path can pay before the key words are known:
    the rows come through an order, some op reads a value lane, and the
    distinct inputs outgrow ``_K3_DIRECT_BYTES``."""
    lanes = {v for v in values if v is not None}
    return (ordered and bool(lanes)
            and n * (8 * len(lanes) + len(set(masks))) > _K3_DIRECT_BYTES)


def k3_plan(n: int, values: Sequence, masks: Sequence, nkeys: int,
            ordered: bool, live: bool = False,
            packed: Optional[bool] = None,
            runs: Optional[int] = None) -> K3Plan:
    """See ``_k3_plan``: the inputs reduced to which op first reads each,
    so that calls of one shape share a plan."""
    def first(keys):
        seen = {}
        return tuple(-1 if x is None else seen.setdefault(x, k)
                     for k, x in enumerate(keys))
    return _k3_plan(n, first(values), first(masks), nkeys, ordered, live,
                    packed, runs is not None and runs <= _K3_FEW_RUNS)


@functools.lru_cache(maxsize=256)
def _k3_plan(n: int, values: Tuple[int, ...], masks: Tuple[int, ...],
             nkeys: int, ordered: bool, live: bool,
             packed: Optional[bool], few_runs: bool) -> K3Plan:
    """K3's plan for n rows and one op per entry of ``values`` (each op's
    value lane by its storage, any hashable, or None for a count) and
    ``masks`` (its contributor mask's storage), ``nkeys`` key words that
    vary, rows read through an order (``ordered``) of at most
    ``_K3_FEW_RUNS`` increasing runs (``few_runs``) and live flags
    (``live``).  The record path where ``k3_may_pack`` holds, the order
    has more runs, and it moves fewer bytes than the direct path;
    ``packed`` forces a path.  A record tile is 64 KB: K = 65,536 / (256
    R) rows a thread for the widest record R of the call; the direct
    path takes 8."""
    values = [None if v < 0 else v for v in values]
    direct = _k3_sets(values, masks, nkeys, False)
    recs = _k3_sets(values, masks, nkeys, True)
    direct_bytes = _k3_bytes(n, direct, nkeys, live, ordered)
    packed_bytes = _k3_bytes(n, recs, nkeys, live, ordered)
    if packed is None:
        use = (k3_may_pack(n, values, masks, ordered) and not few_runs
               and packed_bytes < direct_bytes)
    else:
        use = packed
    sets = recs if use else direct
    rmax = max(s.record_bytes for s in sets)
    rows = (min(_K3_STAGE_BYTES // (_K3_THREADS * rmax), 16) if use
            else _K3_DIRECT_ROWS)
    return K3Plan(use, rows, sets, direct_bytes, packed_bytes,
                  k3_scratch_bytes(n, rows, max(len(s.ops) for s in sets),
                                   rmax))


def _storage(x: torch.Tensor):
    """An input's identity for K3: ops over the same storage and type
    read it once."""
    return (x.data_ptr(), x.dtype)


def segment_reduce_sorted(words: Sequence[torch.Tensor],
                          live: Optional[torch.Tensor],
                          values: Sequence[Optional[torch.Tensor]],
                          contribs: Sequence[torch.Tensor],
                          global_agg: bool,
                          order: Optional[torch.Tensor] = None,
                          ops: Optional[Sequence[str]] = None,
                          packed: Optional[bool] = None):
    """Reduce rows per group, reading them in key order (K3).

    Every lane is in input order; ``order`` (int32, K2's permutation)
    puts them in key order -- sorted row i is input row ``order[i]`` --
    or is None when they already are.  A group starts at a live row
    (``live`` None: every row) that is the first sorted row or differs
    from the previous one in a key word; rows before the first start
    belong to no group; with ``global_agg`` all rows form one group.  Per
    op k, ``contribs[k]`` marks the rows that contribute and
    ``values[k]`` is the int64 or float64 lane to reduce (None for a
    count) by ``ops[k]``: ``sum`` (every op when ``ops`` is None),
    ``min`` or ``max``.  Returns (first_row int32[G], sums, counts
    int64[G], G), groups in key order, ``first_row[g]`` the input row of
    group g's first sorted row: int64 sums wrap mod 2^64; float64 sums
    add the finite values and are NaN if any NaN or both infinities
    contribute, else +-inf if one does; a min or max is the value, bit
    for bit, of the group's earliest sorted row whose ordered word
    (``ops/segmented.py:ordered_word``) is the extreme; a result with no
    contributor is 0.  ``packed`` forces K3's path (default:
    ``k3_plan``); the plain version runs for CPU tensors whatever it
    says."""
    names = _op_names(values, ops)
    lanes = _lanes(words, live, values, contribs)
    if order is not None:
        lanes.append(order)
    if lanes[0].device.type == "cpu":
        return segment_reduce_sorted_plain(words, live, values, contribs,
                                           global_agg, order, ops)
    kernels.require_cuda("segment_reduce_sorted", *lanes)
    n = int(lanes[0].shape[0])
    if any(c.dtype != torch.bool or c.shape != (n,)
           for c in [*contribs, *([] if live is None else [live])]):
        raise TypeError("segment_reduce_sorted: live and contributor masks "
                        f"must be bool[{n}]")
    if any(w.dtype != torch.int64 or w.shape != (n,) for w in words):
        raise TypeError(f"segment_reduce_sorted: key words must be int64[{n}]")
    present = [v for v in values if v is not None]
    if any(v.dtype not in (torch.int64, torch.float64) or v.shape != (n,)
           for v in present):
        raise TypeError("segment_reduce_sorted: values must be int64 or "
                        f"float64[{n}]")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (n,)):
        raise TypeError(f"segment_reduce_sorted: order must be int32[{n}]")
    dev = lanes[0].device
    st = kernels.stream(lanes[0])
    m = max(n, 1)
    lib = kernels.library("segment_reduce")
    kinds = [_KIND_COUNT if op == "count" else
             _KIND_EXTREME[op, v.dtype == torch.float64]
             if op in ("min", "max") else
             _KIND_SUM_FLOAT if v.dtype == torch.float64 else _KIND_SUM_INT
             for v, op in zip(values, names)]
    value_keys = [None if v is None else _storage(v) for v in values]
    mask_keys = [_storage(c) for c in contribs]
    word_ptrs = kernels.device_int64s([w.data_ptr() for w in words], dev)
    # the varying key words, then the order's descents (up to 64)
    varying = torch.empty(len(words) + 1, dtype=torch.int32, device=dev)
    if not global_agg:
        kernels.check(lib, lib.srt_segment_reduce_varying(
            word_ptrs.data_ptr(), len(words),
            None if order is None else order.data_ptr(), n,
            varying.data_ptr(), st), "segment_reduce_sorted")
    sums = [None if v is None else torch.empty(m, dtype=v.dtype, device=dev)
            for v in values]
    counts = [torch.empty(m, dtype=torch.int64, device=dev) for _ in values]
    first_row = torch.empty(m, dtype=torch.int32, device=dev)
    groups = torch.empty(1, dtype=torch.int32, device=dev)
    keys = []       # the varying words, which a record may carry
    runs = None     # the order's increasing runs, where few
    look = packed if packed is not None else k3_may_pack(
        n, value_keys, mask_keys, order is not None)
    if look and not global_agg and n:
        flags = varying.tolist()
        keys = [w for w, f in zip(words, flags) if f]
        if order is not None:
            runs = flags[-1] + 1
    plan = k3_plan(n, value_keys, mask_keys, len(keys), order is not None,
                   live is not None, packed, runs)
    scratch = torch.empty(max(plan.scratch_bytes // 8, 2),
                          dtype=torch.int64, device=dev)
    ops_per_set = max(len(s.ops) for s in plan.sets)
    record_max = max(s.record_bytes for s in plan.sets)
    for i, s in enumerate(plan.sets):
        rec_keys = keys if i == 0 and s.key_offsets else []
        kernels.check(lib, lib.srt_segment_reduce_set(
            word_ptrs.data_ptr(), len(words), varying.data_ptr(),
            len(rec_keys), kernels.pointers(rec_keys),
            kernels.ints(s.key_offsets),
            None if live is None else live.data_ptr(),
            None if order is None else order.data_ptr(), n,
            int(global_agg), int(i == 0), len(s.ops),
            kernels.ints(kinds[k] for k in s.ops), kernels.ints(s.op_lane),
            kernels.ints(s.op_mask),
            kernels.pointers([sums[k] for k in s.ops]),
            kernels.pointers([counts[k] for k in s.ops]),
            len(s.lanes), kernels.pointers([values[k] for k in s.lanes]),
            kernels.ints(s.lane_offsets), len(s.masks),
            kernels.pointers([contribs[k] for k in s.masks]),
            s.mask_offset, s.record_bytes, plan.rows_per_thread,
            ops_per_set, record_max, first_row.data_ptr(),
            groups.data_ptr(), scratch.data_ptr(), plan.scratch_bytes, st),
            "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    segment_reduce_sorted.last_plan = plan
    g = int(groups.item())
    return (first_row[:g], [None if s is None else s[:g] for s in sums],
            [c[:g] for c in counts], g)


segment_reduce_sorted.launches = 0
segment_reduce_sorted.last_plan = None     # the plan of the last launch


# ---------------------------------------------------------------------------
# the grouped reduce around K2 and K3
# ---------------------------------------------------------------------------

def _prefix(col: DeviceColumn, n: int) -> DeviceColumn:
    if col.offsets is not None:
        return DeviceColumn(col.dtype, col.data, col.validity[:n],
                            col.offsets[:n + 1])
    return DeviceColumn(col.dtype, col.data[:n], col.validity[:n])


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def _padded_column(col: DeviceColumn, cap: int) -> DeviceColumn:
    """A column of G rows padded to ``cap`` rows; a string's offsets
    repeat its last offset."""
    if col.offsets is None:
        return DeviceColumn(col.dtype, _padded(col.data, cap),
                            _padded(col.validity, cap))
    g = col.offsets.shape[0] - 1
    offs = torch.empty(cap + 1, dtype=col.offsets.dtype,
                       device=col.offsets.device)
    offs[:g + 1] = col.offsets
    offs[g + 1:] = col.offsets[g]
    return DeviceColumn(col.dtype, col.data, _padded(col.validity, cap),
                        offs)


def _ordered_pick(words: List[torch.Tensor], col: DeviceColumn, op: str,
                  global_agg: bool, order: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """The reference's ordered reduce for a string min or max
    (``exec/aggregate.py`` _group_reduce): the rows sorted by (key words,
    not contributing, value words, descending for max) through K2, and
    each group's first row in that order is its extreme; K3 reads the
    first rows.  With ``order`` (the canonical merge order) the second
    sort breaks its ties in that order.  Returns int32[G], the input row
    of each group's pick."""
    vwords = seg.sort_key_words(col, ascending=op == "min")[1:]
    words2 = list(words) + [(~col.validity).to(torch.int64)] + vwords
    if order is None:
        order2 = sort_order(words2)
    else:
        idx = order.to(torch.int64)
        order2 = order.index_select(0, sort_order(
            [w.index_select(0, idx) for w in words2]).to(torch.int64))
    first_row, _, _, _ = segment_reduce_sorted(
        words, None, [None], [col.validity], global_agg, order2)
    return first_row


def _extreme_lane(col: DeviceColumn) -> torch.Tensor:
    """A min/max input as K3 reads it: float64 as it is, any other flat
    type widened to int64."""
    if col.data.dtype == torch.float64:
        return col.data
    return col.data.to(torch.int64)


def k3_ops(vals: List[DeviceColumn], ops: List[str]):
    """K3's value lanes, contributor masks and op names for ``vals``
    reduced by ``ops`` (sum, countvalid, min, max), and for each op the
    index of the K3 op whose result it takes.  A count of a lane's valid
    rows is also the contributor count of an earlier op over the same
    validity lane (avg's sum and count), so K3 folds that lane once."""
    k3_vals, k3_contribs, k3_names, take, by_lane = [], [], [], [], {}
    for v, op in zip(vals, ops):
        lane = v.validity.data_ptr()
        if op == "countvalid" and lane in by_lane:
            take.append(by_lane[lane])
            continue
        by_lane.setdefault(lane, len(k3_vals))
        take.append(len(k3_vals))
        if op == "countvalid" or v.offsets is not None:
            # a string min or max: K3 counts its contributors, and the
            # value comes from the ordered pick (_ordered_pick)
            k3_vals.append(None)
            k3_names.append("sum")
            k3_contribs.append(v.validity)
            continue
        elif op == "sum":
            k3_vals.append(v.data)
        else:
            k3_vals.append(_extreme_lane(v))
        k3_names.append("sum" if op == "countvalid" else op)
        k3_contribs.append(v.validity)
    return k3_vals, k3_contribs, k3_names, take


def _group_reduce(key_cols: List[DeviceColumn],
                  value_cols: List[DeviceColumn], ops: List[str],
                  num_rows: int, global_agg: bool,
                  order: Optional[torch.Tensor] = None
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn], int]:
    """Group the first ``num_rows`` rows by ``key_cols`` and reduce each
    value column with its op (``sum``, ``countvalid``, ``min`` or
    ``max``; a min or max keeps the column's type).  ``order``, when
    given, is a permutation that already sorts the rows by key; else the
    rows are sorted here (K2).  Returns (key columns, value columns, group
    count); the outputs hold one row per group, padded to a capacity
    bucket.

    The reference sorts every row with a leading live word so padding
    sorts last, and carries every lane through the sort; live rows are
    always a prefix here, so only the prefix is sorted, which gives the
    same order, and K3 reads the lanes through the order."""
    for op in ops:
        if op not in ("sum", "countvalid", "min", "max"):
            raise NotImplementedError(
                f"aggregate op {op!r} is not ported (the grouped first and "
                f"last wait for P8)")
    n = num_rows
    keys = [_prefix(c, n) for c in key_cols]
    vals = [_prefix(c, n) for c in value_cols]
    words = [w for kc in keys for w in seg.key_words_for_column(kc)]
    if order is None and words:
        order = sort_order(words)
    k3_vals, k3_contribs, k3_names, take = k3_ops(vals, ops)
    first_row, sums, counts, groups = segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order, k3_names)
    cap = bucket_for(groups)
    # each group's key is read at its first row, in input order
    out_keys = [_padded_column(g, cap)
                for g in gather_columns(keys, first_row)]
    out_vals = []
    for vc, op, i in zip(vals, ops, take):
        s, cnt = sums[i], counts[i]
        if vc.offsets is not None and op in ("min", "max"):
            pick = _ordered_pick(words, vc, op, global_agg, order)
            out_vals.append(_padded_column(
                gather_columns([vc], pick, cnt > 0)[0], cap))
        elif op == "countvalid":
            out_vals.append(DeviceColumn(
                t.LONG, _padded(cnt, cap),
                _padded(torch.ones_like(cnt, dtype=torch.bool), cap)))
        elif op in ("min", "max"):
            out_vals.append(DeviceColumn(
                vc.dtype, _padded(s.to(vc.dtype.torch_dtype), cap),
                _padded(cnt > 0, cap)))
        else:
            out_vals.append(DeviceColumn(vc.dtype, _padded(s, cap),
                                         _padded(cnt > 0, cap)))
    return out_keys, out_vals, groups


class GpuHashAggregateExec(Exec):
    """Grouped aggregate in PARTIAL, FINAL or COMPLETE mode."""

    # Canonical keyed merge: partial buffers are ordered by key and buffer
    # value words before the merge folds them, so float sums do not depend
    # on batch arrival order (``determinism()``).
    stable_merge: bool = True

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[AggregateExpression], mode: str,
                 child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        cn, ct = child.output_names, child.output_types
        if mode in (PARTIAL, COMPLETE):
            self.aggregates = [bind_aggregate(a, cn, ct) for a in aggregates]
        else:
            self.aggregates = list(aggregates)   # FINAL: pre-bound
        self.mode = mode
        self._group_names = [output_name(g) for g in self.grouping]
        if mode in (PARTIAL, COMPLETE):
            self._bound_grouping = [bind_expression(g, cn, ct)
                                    for g in self.grouping]
            self._update_inputs, self._update_ops = [], []
            for ae in self.aggregates:
                for expr, op in ae.func.update():
                    self._update_inputs.append(bind_expression(expr, cn, ct))
                    self._update_ops.append(op)
        self._buffer_names, self._buffer_types, self._merge_ops = [], [], []
        for i, ae in enumerate(self.aggregates):
            for j, bt in enumerate(ae.func.buffer_types()):
                self._buffer_names.append(f"buf{i}_{j}")
                self._buffer_types.append(bt)
            self._merge_ops += ae.func.merge_ops()

    def _key_types(self) -> List[t.DataType]:
        if self.mode in (PARTIAL, COMPLETE):
            return [g.data_type() for g in self._bound_grouping]
        return self.children[0].output_types[:len(self.grouping)]

    @property
    def output_names(self):
        if self.mode == PARTIAL:
            return self._group_names + self._buffer_names
        return self._group_names + [ae.name for ae in self.aggregates]

    @property
    def output_types(self):
        if self.mode == PARTIAL:
            return self._key_types() + self._buffer_types
        return self._key_types() + [ae.data_type() for ae in self.aggregates]

    def determinism(self):
        scoped = self.mode == PARTIAL   # partial buffers regroup with the
        #                                 input split
        if any(bt == t.DOUBLE for bt in self._buffer_types) and \
                not self.stable_merge:
            return Determinism(
                ORDER_DEPENDENT, "float partial buffers fold in batch "
                "arrival order (stable_merge off): a different arrival "
                "order changes the sums", partition_scoped=scoped,
                canonicalizable=True)
        return Determinism(
            ORDER_STABLE, "group emission order follows arrival; the "
            "canonical keyed merge makes buffer folds "
            "content-determined", partition_scoped=scoped)

    def describe(self):
        return (f"GpuHashAggregate(mode={self.mode}, keys="
                f"[{', '.join(self._group_names)}], fns="
                f"[{', '.join(a.name for a in self.aggregates)}])")

    # --- per-batch programs -------------------------------------------------
    def _update_columns(self, batch: DeviceBatch):
        """(grouping key columns, update input columns) of a batch."""
        ctx = EvalContext(batch)
        key_cols = [g.eval(ctx).col for g in self._bound_grouping]
        val_cols = []
        for b in self._update_inputs:
            v = b.eval(ctx)
            if not isinstance(v, ColumnValue):
                v = make_column(ctx, b.data_type(), v.value,
                                None if v.value is not None else False)
            val_cols.append(v.col)
        return key_cols, val_cols

    def _update_batch(self, batch: DeviceBatch) -> DeviceBatch:
        key_cols, val_cols = self._update_columns(batch)
        ok, ov, n = _group_reduce(key_cols, val_cols, self._update_ops,
                                  batch.num_rows, not self.grouping)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _merge_batch(self, batch: DeviceBatch) -> DeviceBatch:
        k = len(self.grouping)
        order = self._canonical_order(batch) if self.stable_merge else None
        ok, ov, n = _group_reduce(list(batch.columns[:k]),
                                  list(batch.columns[k:]), self._merge_ops,
                                  batch.num_rows, not self.grouping, order)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _canonical_order(self, batch: DeviceBatch) -> torch.Tensor:
        """The live rows' order by key and buffer value words, so the fold
        order within a group is a function of content (stable_merge).  The
        key words lead, so the order also sorts the rows by key, as the
        stable key sort of rows put in this order would."""
        n = batch.num_rows
        words = [w for c in batch.columns
                 for w in seg.key_words_for_column(_prefix(c, n))]
        return seg.lexsort(words)

    def _evaluate_batch(self, batch: DeviceBatch) -> DeviceBatch:
        k = len(self.grouping)
        ctx = EvalContext(batch)
        out_cols = list(batch.columns[:k])
        pos = k
        for ae in self.aggregates:
            nb = len(ae.func.buffer_types())
            bufs = [ColumnValue(batch.columns[pos + j]) for j in range(nb)]
            out_cols.append(ae.func.evaluate(ctx, bufs).col)
            pos += nb
        return DeviceBatch(out_cols, batch.num_rows, self.output_names)

    # --- execution ----------------------------------------------------------
    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        it = iter(self.child_batches(0, pid, ctx))
        first = next(it, None)
        second = next(it, None) if first is not None else None
        if first is not None and second is None and \
                self.mode in (PARTIAL, COMPLETE):
            # one input batch leaves unique keys: the merge would be a no-op
            out = self._update_batch(first)
            yield self._evaluate_batch(out) if self.mode == COMPLETE else out
            return
        partials = []
        for b in itertools.chain([x for x in (first, second)
                                  if x is not None], it):
            partials.append(self._update_batch(b)
                            if self.mode in (PARTIAL, COMPLETE) else b)
        if not partials:
            if self.grouping:
                return
            # a global aggregate over no input still yields one row
            child = self.children[0]
            empty = to_arrow_schema(child.output_names, child.output_types)
            rb = pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in empty], schema=empty)
            partials = [self._update_batch(
                batch_to_device(rb, self.device(ctx)))]
        names = self._group_names + self._buffer_names
        types = self._key_types() + self._buffer_types
        merged_in = partials[0] if len(partials) == 1 else \
            concat_batches(partials, names, types)
        out = self._merge_batch(merged_in)
        yield out if self.mode == PARTIAL else self._evaluate_batch(out)



# ---------------------------------------------------------------------------
# the host engine's aggregate: pyarrow group_by
# ---------------------------------------------------------------------------

_PA_AGG = {Sum: "sum", Count: "count", Average: "mean", Min: "min",
           Max: "max"}
_PA_SCALAR = {"sum": pc.sum, "count": pc.count, "mean": pc.mean,
              "min": pc.min, "max": pc.max}


class CpuHashAggregateExec(Exec):
    """Complete-mode aggregate on pyarrow (the 'Spark CPU' role): the
    grouping keys and aggregate inputs are evaluated on CPU tensors, then
    pyarrow groups them.  Groups come out in arrival order."""

    placement = CPU

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[AggregateExpression], child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        cn, ct = child.output_names, child.output_types
        self.aggregates = [bind_aggregate(a, cn, ct) for a in aggregates]
        self._bound_grouping = [bind_expression(g, cn, ct) for g in grouping]
        self._group_names = [output_name(g) for g in grouping]

    @property
    def output_names(self):
        return self._group_names + [a.name for a in self.aggregates]

    @property
    def output_types(self):
        return [g.data_type() for g in self._bound_grouping] + \
            [a.data_type() for a in self.aggregates]

    def describe(self):
        return (f"CpuHashAggregate(keys=[{', '.join(self._group_names)}], "
                f"fns=[{', '.join(a.name for a in self.aggregates)}])")

    def determinism(self):
        floaty = any(bt == t.DOUBLE for ae in self.aggregates
                     for bt in ae.func.buffer_types())
        if floaty:
            return Determinism(
                ORDER_DEPENDENT, "pyarrow group_by folds the table in "
                "batch-arrival row order (no canonical merge on the "
                "host fallback)")
        return Determinism(
            ORDER_STABLE, "integer/decimal folds are exact; group "
            "emission order follows arrival")

    def _input_table(self, b: DeviceBatch) -> pa.Table:
        """The batch's grouping keys and aggregate inputs as Arrow
        columns ``<key name>`` and ``__in<i>``."""
        ec = EvalContext(b)
        n = b.num_rows
        cols = {}
        for g, nm in zip(self._bound_grouping, self._group_names):
            cols[nm] = column_to_arrow(g.eval(ec).col, n)
        for i, ae in enumerate(self.aggregates):
            fn = ae.func
            if fn.children:
                v = fn.child.eval(ec)
                if isinstance(v, ScalarValue):
                    v = make_column(ec, fn.child.data_type(),
                                    v.value if v.value is not None else 0,
                                    None if v.value is not None else False)
                cols[f"__in{i}"] = column_to_arrow(v.col, n)
            else:
                cols[f"__in{i}"] = pa.array([1] * n, type=pa.int64())
        return pa.table(cols)

    def _empty_input(self) -> pa.Table:
        names = self._group_names + [f"__in{i}" for i in
                                     range(len(self.aggregates))]
        dtypes = [g.data_type() for g in self._bound_grouping] + \
            [a.func.child.data_type() if a.func.children else t.INT
             for a in self.aggregates]
        return pa.table({nm: pa.array([], to_arrow_type(dt))
                         for nm, dt in zip(names, dtypes)})

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        tables = [self._input_table(b)
                  for b in self.child_batches(0, pid, ctx)]
        if not tables:
            if self.grouping:
                return
            tables = [self._empty_input()]
        table = pa.concat_tables(tables)
        for ae in self.aggregates:
            if type(ae.func) not in _PA_AGG:
                raise NotImplementedError(
                    f"aggregate {type(ae.func).__name__} is not ported (the "
                    f"grouped first and last wait for P8)")
        aggs = [(f"__in{i}", _PA_AGG[type(ae.func)], None)
                for i, ae in enumerate(self.aggregates)]
        if self.grouping:
            res = pa.TableGroupBy(table, self._group_names,
                                  use_threads=False).aggregate(aggs)
        elif table.num_rows == 0:
            # Spark: a global aggregate over empty input yields one row
            cols = {}
            for cname, kind, _ in aggs:
                scalar = _PA_SCALAR[kind](table.column(cname))
                cols[f"{cname}_{kind}"] = pa.array([scalar.as_py()],
                                                   type=scalar.type)
            res = pa.table(cols)
        else:
            res = pa.TableGroupBy(
                table.append_column("__g", pa.array([1] * table.num_rows)),
                ["__g"], use_threads=False).aggregate(aggs)
            res = res.drop_columns(["__g"])
        out_cols = [res.column(nm) for nm in self._group_names]
        for (cname, kind, _), ae in zip(aggs, self.aggregates):
            out_cols.append(res.column(f"{cname}_{kind}").cast(
                to_arrow_type(ae.data_type())))
        out = pa.table(dict(zip(self.output_names, out_cols)))
        for rb in out.combine_chunks().to_batches():
            yield batch_to_device(rb, self.device(ctx))
