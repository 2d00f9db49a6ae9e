"""Prefix sums, the window operator's segmented scans (K11, K12) and its
first/last pick over a frame (K23).

Counterpart of spark_rapids_tpu/ops/scan.py.  The reference builds its
scans from pad-shift doubling steps, a workaround for the TPU's slow
scan lowering; here a plain scan is ``torch.cumsum``.  The reference's
grouped float scan (``segmented_cumsum_fast``) has no counterpart: the
grouped float sums it served are folded per group by kernel K3
(exec/aggregate.py).

The window operator (exec/window.py) works over rows sorted by
(partition keys, order keys), with ``new_seg`` set on the first row of
each partition and ``new_run`` on the first row of each peer run (rows
tied on every key).  Two kernels, both in ``csrc/window_scan.cu``, give
it what the reference computes with ``cummax`` and ``cumsum`` tricks
(spark_rapids_tpu/exec/window.py ``_seg_start_positions``, ``_running``,
DenseRank's ``runs_cum`` and ``_run_end_positions``):

- K11 ``segment_scan``: per row, the start of its partition and of its
  peer run, the running count of run starts, and for each (value, valid)
  pair the running sum of the valid values and their count, both
  restarting at each partition;
- K12 ``run_ends``: per row, the last row of its partition and of its
  peer run, never beyond the last live row (rows at or after ``n_live``
  are padding).

A third, K23 ``frame_pick`` (``csrc/frame_pick.cu``), gives First and
Last over each row's frame [lo, hi] the row they pick and whether it is
a value (the reference's ``searchsorted`` over the valid-count prefix,
exec/window.py:338-355).

Each wrapper takes its plain PyTorch version for CPU tensors only; for
CUDA tensors it launches the kernel or raises, and counts its launches
in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels

_MAX_PAIRS = 4           # (value, valid) pairs a K11 launch (kMaxPairs)
_KIND = {None: 0, torch.int64: 1, torch.float64: 2}
_INT32_MAX = 2**31 - 1


def cumsum(v: torch.Tensor, dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """Inclusive prefix sum (integer sums wrap mod 2^64)."""
    return torch.cumsum(v, dim=0, dtype=dtype)


class SegmentScan(NamedTuple):
    """K11's results; None where not asked for.  ``sums[i]`` is None for a
    pair given without values (a count only)."""
    seg_start: Optional[torch.Tensor]
    run_start: Optional[torch.Tensor]
    runs_cum: Optional[torch.Tensor]
    sums: List[Optional[torch.Tensor]]
    counts: List[torch.Tensor]


def _start_positions(flags: torch.Tensor) -> torch.Tensor:
    """int32 position of the last set flag at or before each row, -1
    before the first."""
    pos = torch.arange(flags.shape[0], dtype=torch.int32,
                       device=flags.device)
    starts = torch.where(flags, pos, torch.full_like(pos, -1))
    return torch.cummax(starts, 0).values


def segmented_doubling_scan(v: torch.Tensor, new_seg: torch.Tensor, op,
                            init) -> torch.Tensor:
    """Inclusive scan of ``v`` by ``op`` (identity ``init``) restarting at
    each set flag, by doubling steps: v[i] = op(v[i], v[i - d]) unless a
    partition starts in between.  Each partial result covers one
    partition only, so a float sum has no difference of two large prefix
    sums to cancel."""
    n = v.shape[0]
    f = new_seg.clone()
    d = 1
    while d < n:
        pv = torch.cat([torch.full((d,), init, dtype=v.dtype,
                                   device=v.device), v[:-d]])
        pf = torch.cat([torch.ones(d, dtype=torch.bool, device=v.device),
                        f[:-d]])
        v = torch.where(f, v, op(v, pv))
        f = f | pf
        d *= 2
    return v


def segment_scan_plain(new_seg: torch.Tensor,
                       new_run: Optional[torch.Tensor] = None,
                       pairs: Sequence[Tuple[Optional[torch.Tensor],
                                             torch.Tensor]] = (),
                       seg_start: bool = True, run_start: bool = False,
                       runs_cum: bool = False) -> SegmentScan:
    """Plain version of K11 with ``torch.cummax`` and ``torch.cumsum``:
    integer running sums and counts are differences of prefix sums
    (exact, wrapping mod 2^64, as the reference's); a float running sum
    is a segmented doubling scan."""
    ss = _start_positions(new_seg)
    base_at = torch.clamp(ss - 1, min=0).to(torch.int64)
    first = ss <= 0                     # no row of the partition before
    sums, counts = [], []
    for value, valid in pairs:
        c = cumsum(valid.to(torch.int32), dtype=torch.int32)
        counts.append(c - torch.where(first, torch.zeros_like(c),
                                      c[base_at]))
        if value is None:
            sums.append(None)
        elif value.dtype == torch.float64:
            sums.append(segmented_doubling_scan(
                torch.where(valid, value, torch.zeros_like(value)), new_seg,
                torch.add, 0.0))
        else:
            cs = cumsum(torch.where(valid, value, torch.zeros_like(value)))
            sums.append(cs - torch.where(first, torch.zeros_like(cs),
                                         cs[base_at]))
    return SegmentScan(
        ss if seg_start else None,
        _start_positions(new_run) if run_start else None,
        cumsum(new_run.to(torch.int32), dtype=torch.int32)
        if runs_cum else None,
        sums, counts)


def _aligned(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``x``, or a copy of it when its address is not a multiple of 16
    bytes: K11 and K12 read their lanes as 8- and 16-byte vectors."""
    return x if x is None or x.data_ptr() % 16 == 0 else x.clone()


def _check_scan_args(new_seg, new_run, pairs, run_start, runs_cum):
    if new_seg.dtype != torch.bool or new_seg.dim() != 1:
        raise TypeError(f"segment_scan: new_seg must be bool[n], got "
                        f"{new_seg.dtype}{tuple(new_seg.shape)}")
    n = new_seg.shape[0]
    if (run_start or runs_cum) and new_run is None:
        raise ValueError("segment_scan: run outputs need new_run")
    if new_run is not None and (new_run.dtype != torch.bool or
                                new_run.shape != (n,)):
        raise TypeError(f"segment_scan: new_run must be bool[{n}]")
    for value, valid in pairs:
        if valid.dtype != torch.bool or valid.shape != (n,):
            raise TypeError(f"segment_scan: a valid lane must be bool[{n}]")
        if value is not None and (value.dtype not in _KIND or
                                  value.shape != (n,)):
            raise TypeError(f"segment_scan: a value lane must be int64 or "
                            f"float64[{n}], got {value.dtype}"
                            f"{tuple(value.shape)}")


def segment_scan(new_seg: torch.Tensor,
                 new_run: Optional[torch.Tensor] = None,
                 pairs: Sequence[Tuple[Optional[torch.Tensor],
                                       torch.Tensor]] = (),
                 seg_start: bool = True, run_start: bool = False,
                 runs_cum: bool = False) -> SegmentScan:
    """K11 over sorted rows: ``seg_start`` and ``run_start`` (int32, the
    position of the row's partition start and peer-run start, -1 before
    the first), ``runs_cum`` (int32, run starts up to the row), and for
    each (value or None, valid) pair the running sum of the valid values
    (the value's dtype; int64 wraps mod 2^64) and their count (int32),
    both restarting where ``new_seg`` is set.  Up to four pairs a
    launch; the positions come with the first."""
    _check_scan_args(new_seg, new_run, pairs, run_start, runs_cum)
    if new_seg.device.type == "cpu":
        return segment_scan_plain(new_seg, new_run, pairs, seg_start,
                                  run_start, runs_cum)
    lanes = [new_seg] + ([new_run] if new_run is not None else []) + [
        x for v, ok in pairs for x in (v, ok) if x is not None]
    kernels.require_cuda("segment_scan", *lanes)
    new_seg, new_run = _aligned(new_seg), _aligned(new_run)
    pairs = [(_aligned(v), _aligned(ok)) for v, ok in pairs]
    n = int(new_seg.shape[0])
    dev = new_seg.device

    def out(want, dtype=torch.int32):
        return torch.empty(n, dtype=dtype, device=dev) if want else None
    res = SegmentScan(out(seg_start), out(run_start), out(runs_cum),
                      [out(v is not None, v.dtype if v is not None else None)
                       for v, _ in pairs],
                      [out(True) for _ in pairs])
    if n == 0:
        return res
    lib = kernels.library("window_scan")
    scratch_bytes = lib.srt_segment_scan_scratch_bytes(n)
    st = kernels.stream(new_seg)
    positions = seg_start or run_start or runs_cum
    chunks = [list(range(s, min(s + _MAX_PAIRS, len(pairs))))
              for s in range(0, len(pairs), _MAX_PAIRS)]
    if not chunks and positions:
        chunks = [[]]
    for c, idx in enumerate(chunks):
        first = c == 0
        scratch = torch.zeros(scratch_bytes, dtype=torch.uint8, device=dev)
        kernels.check(lib, lib.srt_segment_scan(
            new_seg.data_ptr(),
            None if new_run is None else new_run.data_ptr(), n,
            res.seg_start.data_ptr() if first and seg_start else None,
            res.run_start.data_ptr() if first and run_start else None,
            res.runs_cum.data_ptr() if first and runs_cum else None,
            len(idx), kernels.pointers([pairs[i][0] for i in idx]),
            kernels.ints(_KIND[None if pairs[i][0] is None
                               else pairs[i][0].dtype] for i in idx),
            kernels.pointers([pairs[i][1] for i in idx]),
            kernels.pointers([res.sums[i] for i in idx]),
            kernels.pointers([res.counts[i] for i in idx]),
            scratch.data_ptr(), st), "segment_scan")
        segment_scan.launches += 1
    return res


segment_scan.launches = 0


def _ends_plain(flags: torch.Tensor, n_live: int) -> torch.Tensor:
    n = flags.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=flags.device)
    nxt = torch.zeros(n, dtype=torch.bool, device=flags.device)
    nxt[:-1] = flags[1:]
    if 0 < n_live <= n:
        nxt[n_live - 1] = True
    ends = torch.where(nxt & (pos < n_live), pos,
                       torch.full_like(pos, _INT32_MAX))
    out = torch.flip(torch.cummin(torch.flip(ends, [0]), 0).values, [0])
    return torch.clamp(torch.clamp(out, max=n_live - 1), min=0)


def run_ends_plain(new_seg: Optional[torch.Tensor],
                   new_run: Optional[torch.Tensor], n_live: int
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of K12: a reversed ``torch.cummin`` of each row's
    position where the next row starts a new partition (run) or is the
    first padding row."""
    return (None if new_seg is None else _ends_plain(new_seg, n_live),
            None if new_run is None else _ends_plain(new_run, n_live))


# K12's look-back state per (device, stream): zero between calls, since
# the last tile of each call clears what the call wrote.
_ENDS_STATE: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ends_state(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    """K12's look-back state of at least ``words`` int64 words, zero on
    entry: zeroed once when it is made or grown, then kept clear by the
    kernel itself."""
    key = (dev, stream)
    state = _ENDS_STATE.get(key)
    if state is None or state.shape[0] < words:
        state = torch.zeros(max(words, 2 * (0 if state is None
                                            else state.shape[0])),
                            dtype=torch.int64, device=dev)
        _ENDS_STATE[key] = state
    return state


def run_ends(new_seg: Optional[torch.Tensor],
             new_run: Optional[torch.Tensor], n_live: int
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K12: (seg_end, run_end), int32, the last row of each row's
    partition and peer run (None for a flag lane not given).  Rows from
    ``n_live`` on are padding: a partition or run ends at ``n_live - 1``
    at the latest, and a padding row reads ``n_live - 1`` (0 when no row
    is live).  The reference's ``_run_end_positions`` is this with
    ``n_live`` equal to the array's length."""
    given = [x for x in (new_seg, new_run) if x is not None]
    if not given:
        raise ValueError("run_ends needs new_seg or new_run")
    n = int(given[0].shape[0])
    for x in given:
        if x.dtype != torch.bool or x.shape != (n,):
            raise TypeError(f"run_ends: flags must be bool[{n}], got "
                            f"{x.dtype}{tuple(x.shape)}")
    if not 0 <= n_live <= n:
        raise ValueError(f"run_ends: n_live {n_live} outside [0, {n}]")
    if given[0].device.type == "cpu":
        return run_ends_plain(new_seg, new_run, n_live)
    kernels.require_cuda("run_ends", *given)
    new_seg, new_run = _aligned(new_seg), _aligned(new_run)
    dev = given[0].device
    seg_end = None if new_seg is None else torch.empty(
        n, dtype=torch.int32, device=dev)
    run_end = None if new_run is None else torch.empty(
        n, dtype=torch.int32, device=dev)
    if n == 0:
        return seg_end, run_end
    lib = kernels.library("window_scan")
    state = _ends_state(dev, kernels.stream(given[0]),
                        2 + kernels.num_tiles(lib, n))
    kernels.check(lib, lib.srt_run_ends(
        None if new_seg is None else new_seg.data_ptr(),
        None if new_run is None else new_run.data_ptr(), n, n_live,
        None if seg_end is None else seg_end.data_ptr(),
        None if run_end is None else run_end.data_ptr(),
        state.data_ptr(), kernels.stream(given[0])), "run_ends")
    run_ends.launches += 1
    return seg_end, run_end


run_ends.launches = 0


def frame_pick_plain(valid: torch.Tensor, lo: Optional[torch.Tensor],
                     hi: Optional[torch.Tensor], last: bool,
                     ignore_nulls: bool, n_live: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K23, the reference's formula: a row is valid where
    ``valid`` holds and it is one of the first ``n_live`` (None: every
    row); over the valid-count prefix ``cpre``, first ignoring nulls is
    ``searchsorted(cpre, cpre[lo] + 1) - 1`` and last
    ``searchsorted(cpre, cpre[hi + 1]) - 1``; with nulls counted, the
    bound itself."""
    n, dev = int(valid.shape[0]), valid.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    if n_live is not None:
        valid = valid & (pos < n_live)
    lo_c = torch.clamp(pos if lo is None else lo.to(torch.int64), 0,
                       max(n - 1, 0))
    hi_c = torch.clamp(pos if hi is None else hi.to(torch.int64), -1, n - 1)
    empty = hi_c < lo_c
    if ignore_nulls:
        cpre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        cpre[1:] = torch.cumsum(valid.to(torch.int64), 0)
        target = cpre[hi_c + 1] if last else cpre[lo_c] + 1
        idx = torch.searchsorted(cpre, target) - 1
    else:
        idx = hi_c if last else lo_c
    idx = torch.clamp(idx, 0, max(n - 1, 0))
    flag = (idx >= lo_c) & (idx <= hi_c) & ~empty & valid[idx]
    return idx.to(torch.int32), flag


FRAME_PICK_PLANS = ("bound", "bitmap", "fused")


def frame_pick_plan(lo: Optional[torch.Tensor], hi: Optional[torch.Tensor],
                    last: bool, ignore_nulls: bool) -> str:
    """K23's launch plan (``csrc/frame_pick.cu``): with nulls counted the
    bound itself (one launch); ignoring them, ``fused`` (one launch: the
    scan picks at the row itself, so last takes no ``hi`` and first no
    ``lo``) where the frames allow it, else ``bitmap`` (the scan writes
    the valid bits and a nearest valid row a 32-row word, then the
    pick)."""
    return _frame_pick_plans(lo, hi, last, ignore_nulls)[0]


def _frame_pick_plans(lo, hi, last, ignore_nulls) -> Tuple[str, ...]:
    """The launch plans that serve a frame, the planned one first: the
    bitmap plan serves every frame that ignores nulls, the fused one
    those that fuse."""
    if not ignore_nulls:
        return ("bound",)
    if (hi is None) if last else (lo is None):
        return ("fused", "bitmap")
    return ("bitmap",)


def frame_pick(valid: torch.Tensor, lo: Optional[torch.Tensor],
               hi: Optional[torch.Tensor], last: bool, ignore_nulls: bool,
               n_live: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K23: (idx int32[n], flag bool[n]) of First (``last`` False) or Last
    over each sorted row's inclusive frame [lo, hi] (int32[n] each, or
    None for the row itself): the first valid row at or after lo (last:
    at or before hi) where ``ignore_nulls``, else the bound itself; idx
    clamped into [0, n), flag set where the frame is not empty, the pick
    lies in it and is valid: ``valid`` (the column's validity) holds
    there and the row is one of the first ``n_live`` (the live rows;
    None: every row), which the kernel ANDs in itself.  The launch plan
    is ``frame_pick_plan``'s."""
    n = int(valid.shape[0])
    if valid.dtype != torch.bool:
        raise TypeError("frame_pick: valid must be bool")
    for b in (lo, hi):
        if b is not None and (b.dtype != torch.int32 or b.shape != (n,)):
            raise TypeError(f"frame_pick: bounds must be int32[{n}]")
    if valid.device.type == "cpu":
        return frame_pick_plain(valid, lo, hi, last, ignore_nulls, n_live)
    return _frame_pick_launch(valid, lo, hi, last, ignore_nulls, n_live,
                              frame_pick_plan(lo, hi, last, ignore_nulls))


def _frame_pick_launch(valid, lo, hi, last, ignore_nulls, n_live, plan):
    """K23's launch on the card with the launch plan ``plan``, one of
    ``_frame_pick_plans``' (chip_smoke.py holds each against the plain
    version)."""
    if plan not in _frame_pick_plans(lo, hi, last, ignore_nulls):
        raise ValueError(f"frame_pick: the {plan} plan does not serve "
                         f"this frame")
    kernels.require_cuda("frame_pick", valid,
                         *[b for b in (lo, hi) if b is not None])
    n = int(valid.shape[0])
    dev = valid.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    lib = kernels.library("frame_pick")
    scratch = None
    if plan != "bound":
        scratch = torch.empty(lib.srt_frame_pick_scratch_words(n),
                              dtype=torch.int64, device=dev)
    vec = all(b is None or b.data_ptr() % 16 == 0 for b in (lo, hi, idx)) \
        and flag.data_ptr() % 4 == 0
    kernels.check(lib, lib.srt_frame_pick(
        valid.data_ptr(), None if lo is None else lo.data_ptr(),
        None if hi is None else hi.data_ptr(), n,
        n if n_live is None else int(n_live), int(last),
        FRAME_PICK_PLANS.index(plan),
        None if scratch is None else scratch.data_ptr(), int(vec),
        idx.data_ptr(), flag.data_ptr(), kernels.stream(valid)),
        "frame_pick")
    frame_pick.launches += 1
    return idx, flag


frame_pick.launches = 0
