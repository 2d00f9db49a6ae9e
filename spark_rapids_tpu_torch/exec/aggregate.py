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

import array
import collections
import decimal
import functools
import itertools
import math
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
                               ApproximatePercentile, Average, CollectList,
                               CollectSet, Count, First, Last, Max, Min,
                               PivotFirst, StddevPop, StddevSamp, Sum,
                               VariancePop, VarianceSamp, bind_aggregate)
from ..expr.cast import Cast
from ..expr.core import (ColumnValue, EvalContext, Expression, ScalarValue,
                         bind_expression, make_column, output_name)
from ..ops import segmented as seg
from ..ops.carry import compact_lanes, sort_order, sort_order_and_varying
from ..ops.gather import gather_columns
from .base import CPU, MERGES, Exec, ExecContext
from .concat import concat_batches

_KIND_COUNT, _KIND_SUM_INT, _KIND_SUM_FLOAT = 0, 1, 2
# min / max of an int64 lane, then of a float64 lane
_KIND_EXTREME = {("min", False): 3, ("max", False): 4, ("min", True): 5,
                 ("max", True): 6}
# over a (lo, hi) pair of lanes: a DECIMAL of more than 18 digits
_KIND_128 = {"sum": 7, "min": 8, "max": 9}
# the sorted position of a group's first or last contributing row
_KIND_POS = {"first": 10, "last": 11}


class _Sign:
    """``values_hi[k] = SIGN``: op k is a 128-bit sum of the int64 lane
    ``values[k]`` read as its own sign-extended pair (a DECIMAL64 input
    summed into its DECIMAL128 buffer): K3 takes each high word from the
    low word's sign, so no pair is built and no lane of signs is read."""

    def __repr__(self):
        return "SIGN"


SIGN = _Sign()


# ---------------------------------------------------------------------------
# K3: grouped reduce over rows read in key order
# ---------------------------------------------------------------------------

def _op_names(values, ops, contribs) -> List[str]:
    """Each op's name: ``first`` or ``last`` (a positional op, which reads
    no value), ``count`` for another op with a None value, else
    ``ops[k]`` (sum, min or max; every value sums when ``ops`` is
    None).  A None contributor mask (every row) is a count's, a first's
    or a last's alone."""
    if ops is None:
        ops = ["sum"] * len(values)
    if len(ops) != len(values):
        raise ValueError("segment_reduce_sorted: one op per value lane")
    if len(contribs) != len(values):
        raise ValueError("segment_reduce_sorted: one contributor mask per "
                         "value lane")
    names = []
    for v, op in zip(values, ops):
        if op in _KIND_POS:
            if v is not None:
                raise ValueError(f"segment_reduce_sorted: {op} reads no "
                                 f"value lane")
            names.append(op)
        elif v is None:
            names.append("count")
        elif op in ("sum", "min", "max"):
            names.append(op)
        else:
            raise ValueError(f"segment_reduce_sorted: op {op!r}")
    if any(c is None and name not in ("count", "first", "last")
           for c, name in zip(contribs, names)):
        raise ValueError("segment_reduce_sorted: only a count, first or "
                         "last takes every row (a None contributor mask)")
    return names


def segment_reduce_sorted_plain(words: Sequence[torch.Tensor],
                                live: Optional[torch.Tensor],
                                values: Sequence[Optional[torch.Tensor]],
                                contribs: Sequence[torch.Tensor],
                                global_agg: bool,
                                order: Optional[torch.Tensor] = None,
                                ops: Optional[Sequence[str]] = None,
                                values_hi: Optional[Sequence] = None,
                                varying: Optional[Sequence[bool]] = None):
    """Plain version of K3: the lanes put in key order by index_select,
    then boundaries, segment ids, index_add_ and, for min and max,
    ``ops/segmented.py:segment_reduce``; over a (lo, hi) pair
    ``segment_sum128`` and ``segment_extreme128``; for first and last
    ``segment_pick``.  See
    ``segment_reduce_sorted`` for the arguments and the result
    (``varying`` is a hint the plain version does not need)."""
    names = _op_names(values, ops, contribs)
    his = list(values_hi) if values_hi is not None else [None] * len(values)
    his = [v >> 63 if h is SIGN else h for v, h in zip(values, his)]
    if order is not None:
        idx = order.to(torch.int64)
        words = [w.index_select(0, idx) for w in words]
        live = None if live is None else live.index_select(0, idx)
        values = [None if v is None else v.index_select(0, idx)
                  for v in values]
        his = [None if h is None else h.index_select(0, idx) for h in his]
        contribs = [None if c is None else c.index_select(0, idx)
                    for c in contribs]
    lanes = _lanes(words, live, values, contribs)
    n, dev = int(lanes[0].shape[0]), lanes[0].device
    every = torch.ones(n, dtype=torch.bool, device=dev)
    contribs = [every if c is None else c for c in contribs]
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
    for v, h, c, op in zip(values, his, contribs, names):
        if h is not None:
            fn = (seg.segment_sum128 if op == "sum" else
                  functools.partial(seg.segment_extreme128, op))
            lo, hi, cnt = fn(v, h, ids, groups, c & grouped)
            sums.append((lo, hi))
            counts.append(cnt)
            continue
        if op in ("min", "max"):
            out, cnt = seg.segment_reduce(op, v, ids, groups, c & grouped)
            sums.append(out)
            counts.append(cnt)
            continue
        if op in _KIND_POS:
            pos, cnt = seg.segment_pick(op, ids, groups, c & grouped)
            sums.append(_input_rows(pos, cnt, order))
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


def _input_rows(pos: torch.Tensor, cnt: torch.Tensor,
                order: Optional[torch.Tensor]) -> torch.Tensor:
    """A positional op's result: the input row (int32) of each group's
    picked sorted position, 0 where no row contributed."""
    pos = pos.to(torch.int64)
    rows = pos if order is None else order.index_select(0, pos).to(
        torch.int64)
    return torch.where(cnt > 0, rows, torch.zeros_like(rows)).to(torch.int32)


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
_K3_FIX_TILES = 64             # kFixTiles: the fixup's tiles a block
_K3_RECORD_KEYS = 7            # more varying words are read through the order
# An order of at most this many increasing runs of input rows (K2's
# stable order over at most this many groups) keeps the direct path:
# its reads then stream, and the records would add the pack and lose
# (chip_smoke.py's q1x row times both paths).
# Over such an order the direct path takes the run path: its pieces,
# partials and fixup grow with runs x tiles, yet it beats tiles of
# sorted rows through 64 runs (k3_ab.py times both over 6-64 runs).
_K3_FEW_RUNS = 64
# K3 keeps the direct path while its distinct inputs are at most this
# many bytes: their reads through the order then mostly hit the 50 MB L2
# cache.  chip_smoke.py's _k3_sweep times both paths on either side.
_K3_DIRECT_BYTES = 96 << 20
# A call of contributor masks and no value lane (first, last and counts)
# keeps the direct path while its masks are at most this many bytes: a
# byte of each mask a row read through the order then hits the L2 cache,
# which also holds the key word's sectors; past it, records (the key word
# and a word of mask bits) read one sector a row (k3_ab.py's random phase
# times both paths on either side).
_K3_MASKS_CACHED = 32 << 20


class K3Set(NamedTuple):
    """One launch set of K3: its ops (indices into the call's ops), its
    distinct value lanes and contributor masks (a lane named by its
    index into the call's values then values_hi, a mask by the first op
    that reads it), each op's lane (-1 for a count), high lane (a
    128-bit op's, -2 for the signs of its low lane, else -1) and mask
    index (also its bit in a record's
    mask word; -1 for a count, first or last over every row, which K3
    derives from the group's bounds), and on the record path the
    record's bytes and the byte offsets of the lanes, of the varying key
    words (first set only) and of the mask word."""
    ops: List[int]
    lanes: List[int]
    masks: List[int]
    op_lane: List[int]
    op_lane_hi: List[int]
    op_mask: List[int]
    record_bytes: int
    lane_offsets: List[int]
    key_offsets: List[int]
    mask_offset: int


class K3Plan(NamedTuple):
    """How K3 folds a call: on the record path (``packed``) or the direct
    one, with K rows a thread, in these sets; the device-memory bytes each
    path moves (a read through the order counted as the 32-byte sector
    it pulls, the run path's reads once) and the scratch bytes of the
    chosen one; ``run_path``: the direct path folds tiles of input rows
    split by the order's few runs (``csrc/segment_reduce.cu``, "The run
    path"); ``bounds``: some op counts or picks over every row, from the
    groups' bounds."""
    packed: bool
    rows_per_thread: int
    sets: List[K3Set]
    direct_bytes: int
    packed_bytes: int
    scratch_bytes: int
    run_path: bool = False
    bounds: bool = False


def _k3_set(ops, values, masks, nkeys, packed, his) -> Optional[K3Set]:
    """The set of ``ops``; None on the record path when its record would
    exceed 128 bytes.  ``values[k]`` and ``his[k]`` name op k's lane and
    high lane (None: none; SIGN: its lane's signs, no lane) by their
    index into the call's values then values_hi, and ``masks[k]`` its
    mask (None: every row, no mask).  A record holds the distinct lanes
    (8 bytes each), then the ``nkeys`` key words it carries (8 each),
    then the mask word."""
    lanes, mask_keys, mks, op_lane, op_hi, op_mask = [], [], [], [], [], []

    def lane(x):
        if x is None:
            return -1
        if x not in lanes:
            lanes.append(x)
        return lanes.index(x)
    for k in ops:
        op_lane.append(lane(values[k]))
        op_hi.append(-2 if his[k] is SIGN else lane(his[k]))
        if masks[k] is None:
            op_mask.append(-1)
            continue
        if masks[k] not in mask_keys:
            mask_keys.append(masks[k])
            mks.append(k)
        op_mask.append(mask_keys.index(masks[k]))
    if not packed:
        return K3Set(list(ops), lanes, mks, op_lane, op_hi, op_mask, 0, [],
                     [], 0)
    need = 8 * (len(lanes) + nkeys) + 4
    size = next((r for r in _K3_RECORD_SIZES if r >= need), 0)
    if not size:
        return None
    return K3Set(list(ops), lanes, mks, op_lane, op_hi, op_mask, size,
                 [8 * i for i in range(len(lanes))],
                 [8 * (len(lanes) + i) for i in range(nkeys)],
                 8 * (len(lanes) + nkeys))


def _k3_sets(values, masks, nkeys, packed, his) -> List[K3Set]:
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
                cur + [k], values, masks, keys, packed, his) is None):
            sets.append(_k3_set(cur, values, masks, keys, packed, his))
            cur = []
        cur.append(k)
    return sets + [_k3_set(cur, values, masks, 0 if sets else rec_keys,
                           packed, his)]


def _k3_bytes(n, sets, nkeys, live, ordered, run_path=False) -> int:
    """Device-memory bytes of K3's sets over n rows (the varying pass,
    the same on both paths, left out; an op over every row reads
    nothing).  Record path: the pack reads the inputs and writes the
    records, the fold reads the order and one record a row, and the key
    words no record carries one sector a row each.  Direct path: the
    order and one sector a row for each input, or the inputs alone for
    rows already in key order; the run path: each input once and the
    order once a set, and once more for the starts."""
    total = 4 * n if run_path and ordered else 0
    for i, s in enumerate(sets):
        keys, lv = (nkeys, int(live)) if i == 0 else (0, 0)
        inputs = 8 * (len(s.lanes) + keys) + len(s.masks) + lv
        if s.record_bytes:
            far = keys - len(s.key_offsets)
            total += n * (inputs - 8 * far + s.record_bytes + 4
                          + max(s.record_bytes, _K3_SECTOR)
                          + _K3_SECTOR * far)
        elif ordered and not run_path:
            total += n * (4 + _K3_SECTOR * (len(s.lanes) + len(s.masks)
                                            + keys + lv))
        elif ordered:
            total += n * (4 + inputs)
        else:
            total += n * inputs
    return total


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def k3_scratch_bytes(n: int, rows_per_thread: int, ops_per_set: int,
                     record_max: int, runs: int = 0,
                     bounds: bool = False) -> int:
    """K3's scratch (``layout`` in ``csrc/segment_reduce.cu``, which
    refuses less): the look-back state, the start bits, the tiles' start
    counts and slots, the head and tail partials of the widest set, the
    records, on the run path (``runs`` > 0) the pieces' sorted rows, the
    fixup's block heads (a head a set's op for each 64 tiles), the
    counts, slots, partials and block heads on the run path being the
    pieces' (runs x tiles), and with ``bounds`` (an op derived from the
    groups' bounds) the groups' first sorted positions; each region
    rounded up to 16 bytes."""
    tiles = -(-n // (_K3_THREADS * rows_per_thread))
    parts = runs * tiles if runs else tiles
    ops = max(ops_per_set, 1)
    return sum(_up16(b) for b in (
        (1 + tiles) * 8, tiles * _K3_THREADS * 2, parts * 4, parts * 4,
        parts * ops * _K3_ACC_BYTES, parts * ops * _K3_ACC_BYTES,
        n * record_max, runs * (tiles + 1) * 4,
        -(-parts // _K3_FIX_TILES) * ops * _K3_ACC_BYTES,
        n * 4 if bounds else 0))


def k3_may_pack(n: int, values: Sequence, masks: Sequence,
                ordered: bool, his: Sequence = ()) -> bool:
    """Whether K3's record path can pay before the key words are known:
    the rows come through an order, and the distinct inputs (``his``:
    the 128-bit ops' high lanes; a mask of every row is none) outgrow
    ``_K3_DIRECT_BYTES``, or, with no value lane, the masks outgrow
    ``_K3_MASKS_CACHED``."""
    lanes = {v for v in [*values, *his] if v is not None and v is not SIGN}
    mks = {m for m in masks if m is not None}
    if not lanes:
        return ordered and n * len(mks) > _K3_MASKS_CACHED
    return ordered and n * (8 * len(lanes) + len(mks)) > _K3_DIRECT_BYTES


K3_PATHS = (None, "record", "direct", "run")


def k3_plan(n: int, values: Sequence, masks: Sequence, nkeys: int,
            ordered: bool, live: bool = False,
            path: Optional[str] = None,
            runs: Optional[int] = None,
            his: Optional[Sequence] = None) -> K3Plan:
    """See ``_k3_plan``: the inputs reduced to where each is first read
    (each op's lane, then each op's high lane, ``his``: a 128-bit op's,
    SIGN for the signs of its own lane, else None; each op's mask, None
    for every row), so that calls of one shape share a plan.  ``path``
    forces K3's path (one of ``K3_PATHS``; None plans it): ``record``,
    ``direct`` (tiles of sorted rows) or ``run`` (the direct path over an
    order of few runs takes the run path, whatever the inputs' size)."""
    if path not in K3_PATHS:
        raise ValueError(f"K3's path is one of {K3_PATHS}, not {path!r}")
    his = [None] * len(values) if his is None else list(his)

    def first(keys):
        seen = {}
        return tuple(-1 if x is None else -2 if x is SIGN else
                     seen.setdefault(x, k) for k, x in enumerate(keys))
    lanes = first(list(values) + his)
    few = runs if runs is not None and runs <= _K3_FEW_RUNS else 0
    packed = None if path is None else path == "record"
    return _k3_plan(n, lanes[:len(values)], first(masks), nkeys, ordered,
                    live, packed, few, lanes[len(values):], path != "direct")


@functools.lru_cache(maxsize=256)
def _k3_plan(n: int, values: Tuple[int, ...], masks: Tuple[int, ...],
             nkeys: int, ordered: bool, live: bool,
             packed: Optional[bool], few_runs: int,
             his: Tuple[int, ...] = (), run_path: bool = True) -> K3Plan:
    """K3's plan for n rows and one op per entry of ``values`` (each op's
    value lane by its storage, any hashable, or None for a count) and
    ``masks`` (its contributor mask's storage; -1: every row),
    ``nkeys`` key words that vary, rows read through an order
    (``ordered``) of ``few_runs`` increasing runs (0: more than
    ``_K3_FEW_RUNS``, or not counted) and live flags (``live``).  The
    record path where ``k3_may_pack`` holds, the order has more runs, and
    it moves fewer bytes than the direct path; ``packed`` forces a path.
    A record tile is 64 KB: K = 65,536 / (256 R) rows a thread for the
    widest record R of the call; the direct path takes 8, and over an
    order of few runs takes the run path (unless ``run_path`` is False)."""
    values = [None if v < 0 else v for v in values]
    masks = [None if m < 0 else m for m in masks]
    his = [None if v == -1 else SIGN if v == -2 else v
           for v in his] or [None] * len(values)
    direct = _k3_sets(values, masks, nkeys, False, his)
    recs = _k3_sets(values, masks, nkeys, True, his)
    runs = few_runs if run_path and ordered else 0
    direct_bytes = _k3_bytes(n, direct, nkeys, live, ordered, runs > 0)
    packed_bytes = _k3_bytes(n, recs, nkeys, live, ordered)
    if packed is None:
        use = (k3_may_pack(n, values, masks, ordered, his) and not few_runs
               and packed_bytes < direct_bytes)
    else:
        use = packed
    sets = recs if use else direct
    rmax = max(x.record_bytes for x in sets)
    rows = (min(_K3_STAGE_BYTES // (_K3_THREADS * rmax), 16) if use
            else _K3_DIRECT_ROWS)
    runs = 0 if use else runs
    bounds = None in masks
    return K3Plan(use, rows, sets, direct_bytes, packed_bytes,
                  k3_scratch_bytes(n, rows, max(len(x.ops) for x in sets),
                                   rmax, runs, bounds), runs > 0, bounds)


def _storage(x: torch.Tensor):
    """An input's identity for K3: ops over the same storage and type
    read it once (empty lanes, which may share a null pointer, are told
    apart by the tensor)."""
    return (x.data_ptr(), x.dtype) if x.numel() else ("empty", id(x))


def segment_reduce_sorted(words: Sequence[torch.Tensor],
                          live: Optional[torch.Tensor],
                          values: Sequence[Optional[torch.Tensor]],
                          contribs: Sequence[Optional[torch.Tensor]],
                          global_agg: bool,
                          order: Optional[torch.Tensor] = None,
                          ops: Optional[Sequence[str]] = None,
                          path: Optional[str] = None,
                          values_hi: Optional[Sequence] = None,
                          varying: Optional[Sequence[bool]] = None):
    """Reduce rows per group, reading them in key order (K3).

    Every lane is in input order; ``order`` (int32, K2's permutation)
    puts them in key order -- sorted row i is input row ``order[i]`` --
    or is None when they already are.  A group starts at a live row
    (``live`` None: every row) that is the first sorted row or differs
    from the previous one in a key word; rows before the first start
    belong to no group; with ``global_agg`` all rows form one group.  Per
    op k, ``contribs[k]`` marks the rows that contribute (None: every
    row, for a count, first or last alone: K3 then reads no mask and
    takes the result from the group's bounds) and ``values[k]`` is the
    int64 or float64 lane to reduce (None for a count) by ``ops[k]``:
    ``sum`` (every op when ``ops`` is None), ``min`` or ``max``; or
    ``first`` or ``last`` with a None value: the group's least or
    greatest sorted position whose contributor flag is set (K3's
    positional kinds), returned as its input row (int32).  Returns
    (first_row int32[G], sums, counts int64[G], G), groups in key order,
    ``first_row[g]`` the input row of group g's first sorted row: int64
    sums wrap mod 2^64; float64 sums add the finite values and are NaN if
    any NaN or both infinities contribute, else +-inf if one does; a min
    or max is the value, bit for bit, of the group's earliest sorted row
    whose ordered word (``ops/segmented.py:ordered_word``) is the
    extreme; a result with no contributor is 0.  ``values_hi[k]``, where
    given, makes op k a 128-bit one over the pair (``values[k]`` the low
    words, int64 bits of the unsigned word, ``values_hi[k]`` the signed
    high words: a DECIMAL of more than 18 digits): its sum is exact
    modulo 2^128, its min or max ordered by (high signed, low unsigned),
    and its result the pair (low words, high words).  ``values_hi[k] =
    SIGN`` makes a sum a 128-bit one over ``values[k]`` sign-extended (a
    DECIMAL64 input summed into a DECIMAL128 buffer) without a lane of
    signs.  ``path`` forces K3's path (``k3_plan``; None plans it, and
    reads the order's runs only where the inputs outgrow the L2 cache).
    ``varying``, where known (K2's histogram, ``sort_order_and_varying``),
    says which key words hold more than one value; K3 then reads the
    words only where it needs the order's descents.  The plain version
    runs for CPU tensors whatever they say."""
    names = _op_names(values, ops, contribs)
    varying_words = varying
    his = [None] * len(values) if values_hi is None else list(values_hi)
    if len(his) != len(values) or any(
            h is not None and (values[k] is None or names[k] == "count"
                               or (h is SIGN and names[k] != "sum"))
            for k, h in enumerate(his)):
        raise ValueError("segment_reduce_sorted: a high lane needs its "
                         "op's low lane (and SIGN a sum)")
    lanes = _lanes(words, live, values, contribs)
    lanes += [h for h in his if h is not None and h is not SIGN]
    if order is not None:
        lanes.append(order)
    if lanes[0].device.type == "cpu":
        return segment_reduce_sorted_plain(words, live, values, contribs,
                                           global_agg, order, ops, his)
    kernels.require_cuda("segment_reduce_sorted", *lanes)
    n = int(lanes[0].shape[0])
    for c in (*contribs, live):
        if c is not None and (c.dtype != torch.bool or c.shape != (n,)):
            raise TypeError("segment_reduce_sorted: live and contributor "
                            f"masks must be bool[{n}]")
    for w in words:
        if w.dtype != torch.int64 or w.shape != (n,):
            raise TypeError(f"segment_reduce_sorted: key words must be "
                            f"int64[{n}]")
    for v in values:
        if v is not None and (v.dtype not in (torch.int64, torch.float64)
                              or v.shape != (n,)):
            raise TypeError("segment_reduce_sorted: values must be int64 or "
                            f"float64[{n}]")
    if any(h is not None and (values[k].dtype != torch.int64 or (
            h is not SIGN and (h.dtype != torch.int64 or h.shape != (n,))))
           for k, h in enumerate(his)):
        raise TypeError(f"segment_reduce_sorted: a 128-bit op's lanes must "
                        f"be int64[{n}]")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (n,)):
        raise TypeError(f"segment_reduce_sorted: order must be int32[{n}]")
    dev = lanes[0].device
    st = kernels.stream(lanes[0])
    lib = kernels.library("segment_reduce")
    kinds = tuple(_KIND_POS[op] if op in _KIND_POS else
                  _KIND_COUNT if op == "count" else
                  _KIND_128[op] if h is not None else
                  _KIND_EXTREME[op, v.dtype == torch.float64]
                  if op in ("min", "max") else
                  _KIND_SUM_FLOAT if v.dtype == torch.float64
                  else _KIND_SUM_INT
                  for v, h, op in zip(values, his, names))
    value_keys = [None if v is None else _storage(v) for v in values]
    hi_keys = [h if h is None or h is SIGN else _storage(h) for h in his]
    by_key = values + his                   # a plan's lane index -> lane
    mask_keys = [None if c is None else _storage(c) for c in contribs]
    word_ptrs = _word_pointers(words, dev)
    look = path in ("record", "run") or (path is None and k3_may_pack(
        n, value_keys, mask_keys, order is not None, hi_keys))
    look = look and not global_agg and n > 0
    # the varying key words, then the order's descents (up to 64) and
    # where they are: known flags that no launch writes to are a shared,
    # read-only copy
    known = varying_words is not None and len(varying_words) == len(words)
    if global_agg or (known and not look):
        varying = _shared_varying(
            () if global_agg else tuple(bool(f) for f in varying_words),
            dev)
    else:
        varying = torch.empty(len(words) + 1 + _K3_FEW_RUNS,
                              dtype=torch.int32, device=dev)
        if known:
            varying[:len(words)].copy_(torch.tensor(
                [int(bool(f)) for f in varying_words], dtype=torch.int32,
                pin_memory=True), non_blocking=True)
        # the words not known (or none), then the order's descents
        skip = len(words) if known else 0
        kernels.check(lib, lib.srt_segment_reduce_varying(
            word_ptrs.data_ptr(), len(words) - skip,
            None if order is None or not look else order.data_ptr(), n,
            varying.data_ptr() + 4 * skip, st), "segment_reduce_sorted")
    keys = []       # the varying words, which a record may carry
    runs = None     # the order's increasing runs, where few
    begins = []     # where they begin, and n
    if look:
        flags = varying.tolist()
        nw = len(words)
        keys = [w for w, f in zip(words, flags[:nw]) if f]
        if order is not None:
            runs = flags[nw] + 1
            if runs <= _K3_FEW_RUNS:
                begins = [0] + sorted(i + 1 for i in
                                      flags[nw + 1:nw + runs]) + [n]
    plan = k3_plan(n, value_keys, mask_keys, len(keys), order is not None,
                   live is not None, path, runs if begins else None, hi_keys)
    blocks = _k3_call_args(plan, kinds, global_agg)
    # one buffer of every output: a row of m int64 each for the counts,
    # the results (int32, int64 or float64) and the 128-bit high words,
    # and one for first_row and groups (int32); the kernels take the rows'
    # addresses, and the views are made once the group count is known
    m = max(n, 2)
    m += m % 2                                  # rows 16-byte aligned
    nops = len(values)
    results = [k for k, op in enumerate(names) if op != "count"]
    wide = [k for k, h in enumerate(his) if h is not None]
    out = torch.empty(nops + len(results) + len(wide) + 1, m,
                      dtype=torch.int64, device=dev)
    scratch = torch.empty(max(plan.scratch_bytes // 8, 2), dtype=torch.int64,
                          device=dev)
    base, row = out.data_ptr(), 8 * m
    sum_row = [None] * nops
    for r, k in enumerate(results, nops):
        sum_row[k] = r
    hi_row = [None] * nops
    for r, k in enumerate(wide, nops + len(results)):
        hi_row[k] = r
    tail = base + row * (out.shape[0] - 1)     # first_row, then groups
    runs = begins if plan.run_path else []
    S = _k3_slots()
    for i, (x, block) in enumerate(zip(plan.sets, blocks)):
        a = array.array("q", block)
        a[S.words] = word_ptrs.data_ptr()
        a[S.nwords] = len(words)
        a[S.varying] = varying.data_ptr()
        a[S.n] = n
        for j, w in enumerate(keys if i == 0 and x.key_offsets else ()):
            a[S.key_w + j] = w.data_ptr()
        a[S.live] = 0 if live is None else live.data_ptr()
        a[S.order] = 0 if order is None else order.data_ptr()
        for j, k in enumerate(x.ops):
            a[S.counts + j] = base + row * k
            if sum_row[k] is not None:
                a[S.sums + j] = base + row * sum_row[k]
            if hi_row[k] is not None:
                a[S.sums_hi + j] = base + row * hi_row[k]
        for j, lane in enumerate(x.lanes):
            a[S.lanes + j] = by_key[lane].data_ptr()
        for j, k in enumerate(x.masks):
            a[S.masks + j] = contribs[k].data_ptr()
        a[S.first_row] = tail
        a[S.groups] = tail + 4 * m
        a[S.scratch] = scratch.data_ptr()
        a[S.nruns] = max(len(runs) - 1, 0)
        a[S.run_begin:S.run_begin + len(runs)] = array.array("q", runs)
        kernels.check(lib, lib.srt_segment_reduce_packed(
            a.buffer_info()[0], st), "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    segment_reduce_sorted.last_plan = plan
    # the buffer as each type while the card folds, then every row cut to
    # the groups at once
    as32 = out.view(torch.int32)
    as_f = out.view(torch.float64) if any(
        r is not None and values[k] is not None
        and values[k].dtype == torch.float64
        for k, r in enumerate(sum_row)) else None
    g, bad = as32[-1, m:m + 2].tolist()
    if plan.run_path and bad:
        raise RuntimeError("segment_reduce_sorted: the run path takes a "
                           "permutation for the order")
    c64 = out.narrow(1, 0, g).unbind(0)
    c32 = as32.narrow(1, 0, g).unbind(0)
    cf = None if as_f is None else as_f.narrow(1, 0, g).unbind(0)

    def result(k):
        r = sum_row[k]
        if r is None:
            return None
        x = (c32 if names[k] in _KIND_POS else c64
             if values[k].dtype == torch.int64 else cf)[r]
        return x if hi_row[k] is None else (x, c64[hi_row[k]])
    return (c32[-1], [result(k) for k in range(nops)], list(c64[:nops]), g)


segment_reduce_sorted.launches = 0
segment_reduce_sorted.last_plan = None     # the plan of the last launch


_WORD_POINTERS = collections.OrderedDict()
_VARYING = collections.OrderedDict()


def _shared_varying(flags: Tuple[bool, ...], dev) -> torch.Tensor:
    """A device copy of the key words' varying flags, kept for the last
    64 lists, for the calls that read the flags and write nothing there."""
    key = (dev, flags)
    got = _VARYING.get(key)
    if got is None:
        got = torch.zeros(len(flags) + 1 + _K3_FEW_RUNS, dtype=torch.int32)
        got[:len(flags)] = torch.tensor(flags, dtype=torch.int32)
        got = got.to(dev)
        _VARYING[key] = got
        if len(_VARYING) > 64:
            _VARYING.popitem(last=False)
    return got


def _word_pointers(words, dev) -> torch.Tensor:
    """The key words' device pointers as an int64 array on ``dev``, kept
    for the last 64 lists: a call over the same words copies none."""
    key = (dev, tuple(w.data_ptr() for w in words))
    got = _WORD_POINTERS.get(key)
    if got is None:
        got = kernels.device_int64s(key[1], dev)
        _WORD_POINTERS[key] = got
        if len(_WORD_POINTERS) > 64:
            _WORD_POINTERS.popitem(last=False)
    return got


# The slots of srt_segment_reduce_packed's argument block (one int64
# each) that the host fills, by name: csrc/segment_reduce.cu owns their
# indices (kSlotNames) and gives each one (srt_segment_reduce_slot); an
# array's name is its first slot, and ``slots`` the block's length.
_K3Slots = collections.namedtuple("_K3Slots", (
    "words", "nwords", "varying", "nkeys", "live", "order", "n",
    "global_agg", "first_set", "nops", "nlanes", "nmasks", "mask_off",
    "record_bytes", "rows", "ops_per_set", "record_max", "bounds_max",
    "first_row", "groups", "scratch", "scratch_bytes", "nruns", "key_w",
    "key_off", "kind", "lane", "lane_hi", "mask", "sums", "sums_hi",
    "counts", "lanes", "lane_off", "masks", "run_begin", "slots"))


@functools.lru_cache(maxsize=1)
def _k3_slots() -> _K3Slots:
    """Each slot's index, as the built library gives it."""
    lib = kernels.library("segment_reduce")
    at = {f: lib.srt_segment_reduce_slot(f.encode())
          for f in _K3Slots._fields}
    missing = [f for f, i in at.items() if i < 0]
    if missing:
        raise RuntimeError(f"segment_reduce_sorted: the library's argument "
                           f"block has no slot {missing}")
    return _K3Slots(**at)


_K3_BLOCKS: dict = {}


def _k3_call_args(plan: K3Plan, kinds: Tuple[int, ...],
                  global_agg: bool) -> list:
    """Each set's argument block with what depends on the plan, the ops'
    kinds and ``global_agg`` alone filled in, kept beside the plan (plans
    are cached, so a shape's calls share them); a call copies its set's
    block and adds its pointers."""
    key = (id(plan), kinds, global_agg)
    got = _K3_BLOCKS.get(key)
    if got is None or got[0] is not plan:
        if len(_K3_BLOCKS) >= 256:
            _K3_BLOCKS.clear()
        S = _k3_slots()
        ops_per_set = max(len(x.ops) for x in plan.sets)
        record_max = max(x.record_bytes for x in plan.sets)
        blocks = []
        for i, x in enumerate(plan.sets):
            a = array.array("q", bytes(8 * S.slots))
            a[S.nkeys] = len(x.key_offsets) if i == 0 else 0
            a[S.global_agg] = int(global_agg)
            a[S.first_set] = int(i == 0)
            a[S.nops] = len(x.ops)
            a[S.nlanes] = len(x.lanes)
            a[S.nmasks] = len(x.masks)
            a[S.mask_off] = x.mask_offset
            a[S.record_bytes] = x.record_bytes
            a[S.rows] = plan.rows_per_thread
            a[S.ops_per_set] = ops_per_set
            a[S.record_max] = record_max
            a[S.bounds_max] = int(plan.bounds)
            a[S.scratch_bytes] = plan.scratch_bytes
            for field, values in ((S.key_off, x.key_offsets),
                                  (S.kind, [kinds[k] for k in x.ops]),
                                  (S.lane, x.op_lane),
                                  (S.lane_hi, x.op_lane_hi),
                                  (S.mask, x.op_mask),
                                  (S.lane_off, x.lane_offsets)):
                a[field:field + len(values)] = array.array("q", values)
            blocks.append(a)
        got = (plan, blocks)
        _K3_BLOCKS[key] = got
    return got[1]


# ---------------------------------------------------------------------------
# the grouped reduce around K2 and K3
# ---------------------------------------------------------------------------

def _prefix(col: DeviceColumn, n: int) -> DeviceColumn:
    """A column's first n rows (a span column's bytes or children
    unchanged)."""
    if col.offsets is not None:
        return DeviceColumn(col.dtype, col.data, col.validity[:n],
                            col.offsets[:n + 1], None, col.children)
    if col.children:                                  # a STRUCT
        return DeviceColumn(col.dtype, None, col.validity[:n], None, None,
                            [_prefix(k, n) for k in col.children])
    return DeviceColumn(col.dtype, col.data[:n], col.validity[:n], None,
                        None if col.data_hi is None else col.data_hi[:n])


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def _padded_column(col: DeviceColumn, cap: int) -> DeviceColumn:
    """A column of G rows padded to ``cap`` rows; a span column's offsets
    repeat its last offset, a STRUCT pads each child."""
    if col.offsets is None and col.children:
        return DeviceColumn(col.dtype, None, _padded(col.validity, cap),
                            None, None,
                            [_padded_column(k, cap) for k in col.children])
    if col.offsets is None:
        return DeviceColumn(col.dtype, _padded(col.data, cap),
                            _padded(col.validity, cap), None,
                            None if col.data_hi is None
                            else _padded(col.data_hi, cap))
    g = col.offsets.shape[0] - 1
    offs = torch.empty(cap + 1, dtype=col.offsets.dtype,
                       device=col.offsets.device)
    offs[:g + 1] = col.offsets
    offs[g + 1:] = col.offsets[g]
    return DeviceColumn(col.dtype, col.data, _padded(col.validity, cap),
                        offs, None, col.children)


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
    """A min/max input as K3 reads it: float64 as it is, float32 widened
    to float64 (exactly; Spark's total order is the same), any other flat
    type widened to int64; the result narrows back bit for bit."""
    if col.data.dtype == torch.float64:
        return col.data
    if col.data.dtype == torch.float32:
        return col.data.to(torch.float64)
    return col.data.to(torch.int64)


_POSITIONAL = {"first": "first", "last": "last", "first_any": "first",
               "last_any": "last"}
_COLLECT = ("collect_list", "collect_set", "collect_concat",
            "collect_concat_set")


def k3_ops(vals: List[DeviceColumn], ops: List[str],
           wide: Optional[Sequence] = None,
           every: Optional[Sequence[bool]] = None, keyed: bool = True):
    """K3's value lanes, contributor masks and op names for ``vals``
    reduced by ``ops`` (sum, countvalid, min, max, the positional ops and
    the collects), for each op the index of the K3 op whose result it
    takes, and K3's high lanes (a DECIMAL128 column's ``data_hi``, SIGN
    for a DECIMAL64 sum into a DECIMAL128 buffer, ``wide[i]`` set, else
    None).  A count of a lane's valid rows is also the contributor count
    of an earlier op over the same validity lane (avg's sum and count),
    so K3 folds that lane once; a min and a max of one column read one
    widened lane.  ``first`` and ``last`` are positional ops over the
    column's validity, ``first_any`` and ``last_any`` over every row; a
    collect_list or collect_set counts its valid rows, and a collect's
    merge sums its arrays' lengths.  A count, first or last over every
    row (``first_any``, ``last_any``, or a column whose ``every[i]`` says
    its validity holds every row: count(*)'s literal) has no mask (None):
    K3 derives it from the group's bounds.  Without a key (``keyed``
    False) those take a mask of every row (one for the call), so that
    K3 has a lane to count the rows by."""
    k3_vals, k3_contribs, k3_names, take, by_lane = [], [], [], [], {}
    k3_his, extreme = [], {}
    ones = None
    wide = wide or [None] * len(vals)
    every = every or [False] * len(vals)
    for v, op, w, all_valid in zip(vals, ops, wide, every):
        lane = v.validity.data_ptr()
        counts_valid = op in ("countvalid", "collect_list", "collect_set")
        if counts_valid and lane in by_lane:
            take.append(by_lane[lane])
            continue
        take.append(len(k3_vals))
        value, name, mask, hi = None, "sum", v.validity, None
        bounds = op.endswith("_any") or (all_valid and (
            counts_valid or op in _POSITIONAL))
        if bounds:
            if ones is None and not keyed:
                ones = torch.ones_like(v.validity)
            mask = ones
        if op in _POSITIONAL:
            name = _POSITIONAL[op]
        elif op in ("collect_concat", "collect_concat_set"):
            value = (v.offsets[1:] - v.offsets[:-1]).to(torch.int64)
        else:
            by_lane.setdefault(lane, len(k3_vals))
            # a count, or a string min or max: K3 counts the contributors,
            # and the value comes from the ordered pick (_ordered_pick)
            if not counts_valid and v.offsets is None:
                name = op
                hi = SIGN if w is not None and op == "sum" else v.data_hi
                if op == "sum" or v.data_hi is not None:
                    value = v.data
                else:
                    key = (v.data.data_ptr(), v.data.dtype, v.data.shape)
                    if key not in extreme or not v.data.numel():
                        extreme[key] = _extreme_lane(v)
                    value = extreme[key]
        k3_vals.append(value)
        k3_names.append(name)
        k3_contribs.append(mask)
        k3_his.append(hi)
    return k3_vals, k3_contribs, k3_names, take, k3_his


def _collected(vc: DeviceColumn, op: str, order: Optional[torch.Tensor],
               cnt: torch.Tensor, cap: int) -> DeviceColumn:
    """A collect op's ARRAY column of G groups padded to ``cap``: each
    group's elements one after another, groups in key order, from the
    per-group element counts ``cnt`` (K3's).  collect_list keeps each
    group's valid values in sorted order: the order's valid rows moved
    to the front by K1, then gathered; collect_concat gathers the arrays
    in sorted order, which lays their elements out group after group
    (K16's offsets, K18's child rows).  The set ops then drop repeats
    (``_dedupe``)."""
    dev = cnt.device
    rows = order if order is not None else torch.arange(
        vc.validity.shape[0], dtype=torch.int32, device=dev)
    if op in ("collect_list", "collect_set"):
        keep = vc.validity if order is None else \
            vc.validity.index_select(0, order.to(torch.int64))
        (moved,), kept = compact_lanes(keep, [rows], [False])
        child = gather_columns([vc], moved[:kept])[0]
        elem_type = vc.dtype
    else:
        child = gather_columns([vc], rows)[0].children[0]
        elem_type = vc.dtype.element_type
    offs = torch.zeros(cnt.shape[0] + 1, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(cnt, 0).to(torch.int32)
    if op in ("collect_set", "collect_concat_set"):
        child, offs = _dedupe(child, offs)
    g = cnt.shape[0]
    return _padded_column(DeviceColumn(
        t.ArrayType(elem_type), None, torch.ones(g, dtype=torch.bool,
                                                 device=dev),
        offs, None, [child]), cap)


def _dedupe(child: DeviceColumn, offs: torch.Tensor):
    """A collected child's repeats within each group dropped: the
    elements sorted (K2) by (group, value words: the grouping words, as
    the reference's), the first of each run kept and moved to the front
    (K1), and each group's new count.  Returns (child, offsets)."""
    total = int(offs[-1])
    dev = offs.device
    if total == 0:
        return child, offs
    pos = torch.arange(total, dtype=torch.int64, device=dev)
    grp = torch.searchsorted(offs[1:].to(torch.int64), pos, right=True)
    vwords = seg.key_words_for_column(_prefix(child, total))
    order = sort_order([grp] + vwords)
    idx = order.to(torch.int64)
    first = seg.segment_boundaries([grp[idx]] + [w[idx] for w in vwords],
                                   torch.ones(total, dtype=torch.bool,
                                              device=dev))
    (moved, grp_kept), kept = compact_lanes(
        first, [order, grp.to(torch.int32)[idx]], [False, False])
    groups = offs.shape[0] - 1
    cnt = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(
        0, grp_kept[:kept].to(torch.int64),
        torch.ones(kept, dtype=torch.int64, device=dev))
    new_offs = torch.zeros_like(offs)
    new_offs[1:] = torch.cumsum(cnt, 0).to(offs.dtype)
    return gather_columns([child], moved[:kept])[0], new_offs


def _group_reduce(key_cols: List[DeviceColumn],
                  value_cols: List[DeviceColumn], ops: List[str],
                  num_rows: int, global_agg: bool,
                  order: Optional[torch.Tensor] = None,
                  wide: Optional[Sequence] = None,
                  every: Optional[Sequence[bool]] = None
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn], int]:
    """Group the first ``num_rows`` rows by ``key_cols`` and reduce each
    value column with its op (``sum``, ``countvalid``, ``min``, ``max``,
    ``first``, ``last``, ``first_any``, ``last_any``, or a collect; a
    min, max, first or last keeps the column's type; ``every[i]``, where
    set, says value column i's validity holds every row: count(*)'s
    literal, which K3 counts by the groups' bounds; ``wide[i]``, where
    set, is the DECIMAL128 type that the DECIMAL64 column i sums into).
    ``order``, when given, is a permutation that already sorts the rows
    by key; else the rows are sorted here (K2).  Returns (key columns,
    value columns, group count); the outputs hold one row per group,
    padded to a capacity bucket.

    The reference sorts every row with a leading live word so padding
    sorts last, and carries every lane through the sort; live rows are
    always a prefix here, so only the prefix is sorted, which gives the
    same order, and K3 reads the lanes through the order.  A first or
    last picks a row by K3's positional kind and gathers the column
    there, whatever its type."""
    for op in ops:
        if op not in ("sum", "countvalid", "min", "max") + \
                tuple(_POSITIONAL) + _COLLECT:
            raise NotImplementedError(f"aggregate op {op!r} is not ported")
    n = num_rows
    keys = [_prefix(c, n) for c in key_cols]
    vals = [_prefix(c, n) for c in value_cols]
    words = [w for kc in keys for w in seg.key_words_for_column(kc)]
    varying = None
    if order is None and words:
        order, varying = sort_order_and_varying(words)
    wide = wide or [None] * len(vals)
    k3_vals, k3_contribs, k3_names, take, k3_his = k3_ops(
        vals, ops, wide, every, keyed=bool(words))
    first_row, sums, counts, groups = segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order, k3_names,
        values_hi=k3_his, varying=varying)
    cap = bucket_for(groups)
    # each group's key is read at its first row, in input order
    out_keys = [_padded_column(g, cap)
                for g in gather_columns(keys, first_row)]
    out_vals = []
    for vc, full, op, i, w in zip(vals, value_cols, ops, take, wide):
        s, cnt = sums[i], counts[i]
        if op in _COLLECT:
            out_vals.append(_collected(vc, op, order, s if op.startswith(
                "collect_concat") else cnt, cap))
        elif op in _POSITIONAL:
            # (the whole column: a global pick over no rows reads row 0)
            out_vals.append(_padded_column(
                gather_columns([full], s, cnt > 0)[0], cap))
        elif vc.offsets is not None and op in ("min", "max"):
            pick = _ordered_pick(words, vc, op, global_agg, order)
            out_vals.append(_padded_column(
                gather_columns([vc], pick, cnt > 0)[0], cap))
        elif op == "countvalid":
            out_vals.append(DeviceColumn(
                t.LONG, _padded(cnt, cap),
                _padded(torch.ones_like(cnt, dtype=torch.bool), cap)))
        elif isinstance(s, tuple):          # a DECIMAL128 (lo, hi) pair
            out_vals.append(DeviceColumn(
                w or vc.dtype, _padded(s[0], cap), _padded(cnt > 0, cap),
                None, _padded(s[1], cap)))
        elif op in ("min", "max"):
            out_vals.append(DeviceColumn(
                vc.dtype, _padded(s.to(vc.dtype.torch_dtype), cap),
                _padded(cnt > 0, cap)))
        else:
            out_vals.append(DeviceColumn(vc.dtype, _padded(s, cap),
                                         _padded(cnt > 0, cap)))
    return out_keys, out_vals, groups


def _widening_sum(bound: Expression, op: str) -> Optional[Expression]:
    """The input of a sum's same-scale cast from DECIMAL64 to a DECIMAL128
    with as many integer digits or more (``Sum.update``'s cast to its
    buffer type, which can never overflow: ``expr/cast.py:_to_decimal``),
    else None.  The aggregate hands K3 that input with SIGN as its high
    lane, so the cast's (lo, sign) pair is never built."""
    if op != "sum" or not isinstance(bound, Cast):
        return None
    src, dst = bound.child.data_type(), bound.data_type()
    if not (isinstance(src, t.DecimalType) and src.is64
            and isinstance(dst, t.DecimalType) and not dst.is64):
        return None
    if dst.scale != src.scale or \
            dst.precision - dst.scale < src.precision - src.scale:
        return None
    return bound.child


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
            self._update_wide = []
            for ae in self.aggregates:
                for expr, op in ae.func.update():
                    bound = bind_expression(expr, cn, ct)
                    widened = _widening_sum(bound, op)
                    self._update_inputs.append(widened or bound)
                    self._update_wide.append(
                        None if widened is None else bound.data_type())
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
        if any(isinstance(ae.func, CollectList) for ae in self.aggregates):
            return Determinism(
                ORDER_DEPENDENT, "collect_list/collect_set element "
                "order follows batch arrival", partition_scoped=scoped)
        if any(t.is_fractional(bt) for bt in self._buffer_types) and \
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
        val_cols, every = [], []
        for b in self._update_inputs:
            v = b.eval(ctx)
            # a literal that is not null: valid in every row
            every.append(not isinstance(v, ColumnValue)
                         and v.value is not None)
            if not isinstance(v, ColumnValue):
                v = make_column(ctx, b.data_type(), v.value,
                                None if v.value is not None else False)
            val_cols.append(v.col)
        return key_cols, val_cols, every

    def _update_batch(self, batch: DeviceBatch) -> DeviceBatch:
        key_cols, val_cols, every = self._update_columns(batch)
        ok, ov, n = _group_reduce(key_cols, val_cols, self._update_ops,
                                  batch.num_rows, not self.grouping,
                                  wide=self._update_wide, every=every)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _merge_batch(self, batch: DeviceBatch) -> DeviceBatch:
        k = len(self.grouping)
        order = self._canonical_order(batch) if self.stable_merge else None
        ok, ov, n = _group_reduce(list(batch.columns[:k]),
                                  list(batch.columns[k:]), self._merge_ops,
                                  batch.num_rows, not self.grouping, order)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _canonical_order(self, batch: DeviceBatch
                         ) -> Optional[torch.Tensor]:
        """The live rows' order by key and buffer value words, so the fold
        order within a group is a function of content (stable_merge).  The
        key words lead, so the order also sorts the rows by key, as the
        stable key sort of rows put in this order would.  A nested buffer
        (a collect's array) gives no words, as in the reference: its
        element order is order-dependent anyway."""
        n = batch.num_rows
        k = len(self.grouping)
        words = [w for j, c in enumerate(batch.columns)
                 if j < k or not isinstance(c.dtype, (t.ArrayType,
                                                      t.MapType))
                 for w in seg.key_words_for_column(_prefix(c, n))]
        # no words (an ungrouped collect alone): arrival order, as the
        # reference's sort by its live word alone gives
        return seg.lexsort(words) if words else None

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
           Max: "max", First: "first", Last: "last", StddevSamp: "stddev",
           StddevPop: "stddev", VarianceSamp: "variance",
           VariancePop: "variance", CollectSet: "distinct",
           CollectList: "list", PivotFirst: "first",
           ApproximatePercentile: "list"}
_PA_SCALAR = {"sum": pc.sum, "count": pc.count, "mean": pc.mean,
              "min": pc.min, "max": pc.max, "stddev": pc.stddev,
              "variance": pc.variance, "first": pc.first, "last": pc.last}


def _pa_options(fn):
    """pyarrow's options for an aggregate: the degrees of freedom of a
    variance, whether first and last skip nulls."""
    if isinstance(fn, (StddevSamp, StddevPop, VarianceSamp, VariancePop)):
        return pc.VarianceOptions(
            ddof=0 if isinstance(fn, (StddevPop, VariancePop)) else 1)
    if isinstance(fn, (First, PivotFirst)):
        return pc.ScalarAggregateOptions(
            skip_nulls=isinstance(fn, PivotFirst) or fn.ignore_nulls)
    return None


def _percentile_host(col, p: float, dtype: t.DataType):
    """Each collected group's inverted-CDF element of rank ceil(p n) - 1
    among its n sorted non-null values; null for an empty group."""
    vals = []
    for row in col.to_pylist():
        grp = sorted(v for v in row if v is not None)
        k = max(math.ceil(p * len(grp)) - 1, 0)
        vals.append(grp[min(k, len(grp) - 1)] if grp else None)
    return pa.chunked_array([pa.array(vals, type=to_arrow_type(dtype))])


def _widen_decimal_inputs(table: pa.Table, aggregates) -> pa.Table:
    """A decimal SUM or AVG input as decimal256, so pyarrow's hash sum
    cannot wrap modulo 2^128 (``_fit_result`` then nulls what passes the
    result's precision)."""
    for i, ae in enumerate(aggregates):
        name = f"__in{i}"
        if type(ae.func) in (Sum, Average) and \
                pa.types.is_decimal(table.schema.field(name).type):
            scale = table.schema.field(name).type.scale
            table = table.set_column(
                table.schema.get_field_index(name), name,
                table.column(name).cast(pa.decimal256(76, scale)))
    return table


def _fit_result(arr, dtype: t.DataType):
    """An aggregate's pyarrow result cast to its column type; a decimal
    that passes its precision is null, as Spark's CheckOverflow gives."""
    if isinstance(dtype, t.DecimalType) and pa.types.is_decimal256(arr.type):
        wide = arr.cast(pa.decimal256(76, dtype.scale))
        lim = pa.scalar(decimal.Decimal(10) ** (dtype.precision - dtype.scale),
                        pa.decimal256(76, dtype.scale))
        fits = pc.and_(pc.less(wide, lim), pc.greater(wide, pc.negate(lim)))
        arr = pc.if_else(fits, wide, pa.scalar(None, wide.type))
    return arr.cast(to_arrow_type(dtype))


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

    def partition_use(self):
        return MERGES       # rows regroup by the grouping keys

    def determinism(self):
        floaty = any(t.is_fractional(bt) for ae in self.aggregates
                     for bt in ae.func.buffer_types())
        if floaty or any(isinstance(ae.func, CollectList)
                         for ae in self.aggregates):
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
            arr = column_to_arrow(g.eval(ec).col, n)
            if pa.types.is_struct(arr.type):
                # pyarrow cannot group struct keys: each field (null under
                # a null struct) and a null flag, rebuilt after the
                # aggregate (the reference's CPU engine)
                for j in range(arr.type.num_fields):
                    cols[f"__{nm}__f{j}"] = pc.struct_field(arr, j)
                cols[f"__{nm}__null"] = pc.is_null(arr)
            else:
                cols[nm] = arr
        for i, ae in enumerate(self.aggregates):
            fn = ae.func
            if fn.children:
                inp = fn._masked() if isinstance(fn, PivotFirst) \
                    else fn.child
                v = inp.eval(ec)
                if isinstance(v, ScalarValue):
                    v = make_column(ec, inp.data_type(),
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
            [a.func._masked().data_type() if isinstance(a.func, PivotFirst)
             else a.func.child.data_type() if a.func.children else t.INT
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
        table = _widen_decimal_inputs(table, self.aggregates)
        for ae in self.aggregates:
            if type(ae.func) not in _PA_AGG:
                raise NotImplementedError(
                    f"aggregate {type(ae.func).__name__} is not ported")
        aggs = [(f"__in{i}", _PA_AGG[type(ae.func)], _pa_options(ae.func))
                for i, ae in enumerate(self.aggregates)]
        structs = {nm: to_arrow_type(g.data_type())
                   for g, nm in zip(self._bound_grouping, self._group_names)
                   if isinstance(g.data_type(), t.StructType)}
        group_cols = []
        for nm in self._group_names:
            if nm in structs:
                group_cols += [f"__{nm}__f{j}"
                               for j in range(structs[nm].num_fields)]
                group_cols.append(f"__{nm}__null")
            else:
                group_cols.append(nm)
        if self.grouping:
            res = pa.TableGroupBy(table, group_cols,
                                  use_threads=False).aggregate(aggs)
        elif table.num_rows == 0:
            # Spark: a global aggregate over empty input yields one row
            cols = {}
            for cname, kind, opts in aggs:
                if kind in ("list", "distinct"):
                    # Spark's collect_* over no rows: the empty array
                    cols[f"{cname}_{kind}"] = pa.array(
                        [[]], type=pa.list_(table.column(cname).type))
                    continue
                scalar = _PA_SCALAR[kind](table.column(cname), options=opts)
                cols[f"{cname}_{kind}"] = pa.array([scalar.as_py()],
                                                   type=scalar.type)
            res = pa.table(cols)
        else:
            res = pa.TableGroupBy(
                table.append_column("__g", pa.array([1] * table.num_rows)),
                ["__g"], use_threads=False).aggregate(aggs)
            res = res.drop_columns(["__g"])
        out_cols = []
        for nm in self._group_names:
            if nm in structs:
                st = structs[nm]
                out_cols.append(pa.StructArray.from_arrays(
                    [res.column(f"__{nm}__f{j}").combine_chunks()
                     for j in range(st.num_fields)], fields=list(st),
                    mask=res.column(f"__{nm}__null").combine_chunks()))
            else:
                out_cols.append(res.column(nm))
        for (cname, kind, _), ae in zip(aggs, self.aggregates):
            col = res.column(f"{cname}_{kind}")
            if isinstance(ae.func, ApproximatePercentile):
                col = _percentile_host(col, ae.func.percentage,
                                       ae.data_type())
            elif type(ae.func) is CollectList:
                # Spark's collect_list drops nulls; pyarrow's keeps them
                col = pa.chunked_array([pa.array(
                    [[v for v in row if v is not None]
                     for row in chunk.to_pylist()], type=chunk.type)
                    for chunk in col.chunks], type=col.type)
            out_cols.append(_fit_result(col, ae.data_type()))
        out = pa.table(dict(zip(self.output_names, out_cols)))
        for rb in out.combine_chunks().to_batches():
            yield batch_to_device(rb, self.device(ctx))
