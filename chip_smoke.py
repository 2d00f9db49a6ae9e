#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from csrc/ with nvcc, holds each
against its plain PyTorch version at the main paths' shapes and at edge
cases (the join kernels K6, K4, K7 and K5 on 27 join cases and a hot
key, K7 and K5 on the shapes K5's merge-path tiles must get right; K3 on
both of its paths, the records and the direct reads, and the planned
one, also on a group-by of 9 columns with 17 sums, its two paths timed
in turns at q1's and q1x's shapes and around the plan's crossover), then
drives the main paths.
Bench q1, scan -> filter(v > -500000) -> group by k: sum(v), avg(f),
count(*) -> collect, over 2^25 rows: through the DataFrame API as one
batch and as 4 partitions, and at exec level as 8 batches of 4,194,304
rows (update -> concat -> merge -> evaluate).  Bench q2, the 2^25-row
fact table inner-joined USING k with the 100,000-row dimension -> group
by k: sum(w) -> collect, through the DataFrame API, and the hash join
alone at exec level.  Bench q6, q2 over a 4-partition fact table and a
2-partition dimension, through the DataFrame API: the plan rewrite
strips its exchanges (a broadcast hash join over the gathered probe
side, one COMPLETE aggregate).  Each result is compared with pyarrow on
the host.  Then the plan rewrite itself: q1 and q2 plan GPU-only with
the final download as their one transition; a conditional full join
falls back to the CPU engine between device operators, with the
reference's reason; and q1 under spark.rapids.sql.enabled=false (every
operator on the CPU, no kernel launched) equals the card's result.
Bench q3, the fact table sorted by (k, v) and collected whole, through
the DataFrame API over 1 and 4 partitions, equal to pyarrow's stable
sort row for row; a TopN, sort(v desc, k).limit(1000), against pyarrow;
three sort orders with nulls, NaN, -0.0 and +-inf against the CPU
engine; K8 (row gather), K9 (lane stats) and K10 (lane pack) against
their plain versions at q3's shapes, at K8's edges (both of its paths,
the single pass and the row records, around its blocks and the plan's
crossover) and on a fetch fuzz, and K8's two paths timed in turns over
a sweep of sizes;
every download split step by step against the per-lane copies it
replaced.  Bench q4, row_number and the running RANGE sum of v over
(partition by k order by v) on the fact table, through the DataFrame
API over 1 and 4 partitions, equal to a numpy oracle row for row, with
its stages (words, K2, K8, boundaries, K11, K12, the results, K13, the
mask, the download) and a trace; K11 (segmented scan), K12 (peer-run
ends) and K13 (row scatter) against their plain versions at q4's shapes
and on edge cases (K11 and K12 either side of their 2,048-, 4,096- and
8,192-row tiles, K12 also with its live rows ending there), K8 at q4's
four lanes on both paths, K13 on both of its paths
(single pass and binned by destination) around its buckets, tiles and
single-pass window; every
window function over 5 specs at 2^20 rows against the CPU engine.
q1x, the TPC-H Q1 shape on the fact table (filter, k % 3, CASE WHEN,
Q1's price arithmetic, group by two keys with sums, averages, count,
min and max, sort), over 1 and 4 partitions,
equal to a numpy oracle, with K3's min and max folds against their plain
version at q1x's shapes and on edge cases (NaN, -0.0, the int64 edges,
BOOLEAN, an all-null group, one group over 2^22 rows, tile edges, 27
ops); every expression of the flat surface at 2^20 rows on the card
against the CPU placement; the right, full, left_semi and left_anti
joins at 2^20 rows against pyarrow.  q3 both ways: the host-assisted
collect (the default: a row-id query, then a host take) and the direct
collect over 1 and 4 partitions, each equal to pyarrow's sort.  Bench q5,
bench's 4 parquet files (written to a temporary directory) -> filter
f < 0.5 -> group by k: sum(v), count, through the DataFrame API: cold
(the file-scan pin cleared) split into host decode, upload and the
rest, warm with the pin (no file may be read) and without it, and over
4 partitions (PERFILE, a GPU-only plan), each equal to pyarrow.  Bench
q7, filter(v > 0) -> parquet write, host-assisted (the keep mask only)
and direct: the footers must count the rows with v > 0 and the file
read back must equal fact.filter(v > 0).  q5 at 2^20 rows with the
parquet scan switched off: the scan on the CPU under GPU operators.
Strings: the fact table gains bench-scale string columns built from
numpy buffers (s, TPC-H's c_name of k, 18 bytes, 100,000 distinct; rf
and ls, Q1's one-byte flags; c, a 10-43 byte comment, 5 % null, some
multi-byte UTF-8) and the dimension its names.  K14 (string hashes),
K15 (murmur3 over bytes), K16 (span gather) and K17 (prefix words)
against their plain versions on edge cases (0 rows, all empty, all
null, a 1 MB string among short ones, 40 bytes of shared prefix,
multi-byte UTF-8, counts around the block and tile sizes, invalid
gather slots; K16 at every source alignment 0-15, on 16-byte rows, on
stretches that end mid-row and a 1 MB row over many stretches), then
qs1 (Q1 grouped by the string flags, 1 and 4 partitions, q1x's numpy
oracle under the mapping; K16 timed on the two flag columns through the
filter's kept rows), qs2 (q1 grouped by
s, pyarrow's group_by), qs3 (the fact joined to the dimension on s,
c riding on the probe side, pyarrow's join row for row) and qs4 (sort
by (s, v) carrying c, and its TopN, pyarrow's sort_by row for row),
each kernel call of those runs against its plain version, and at 2^20
rows the comparisons and IN on s and rf, c IS NULL, F.hash(s, k), a
window by s, MIN/MAX of c by rf and a parquet write of (s, c, v)
against the CPU engine or pyarrow.
Launch counts are reset just before each main-path run and must be > 0
after it for every kernel of that path.
Needs one CUDA card; exits non-zero and prints no result without one,
or when any phase fails.
The last line is a JSON object.
"""

import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

ROWS = 1 << 25            # about TPC-H SF5 lineitem's row count
BATCH_ROWS = 4194304      # the largest DEFAULT_ROW_BUCKETS capacity
THRESHOLD = -(10**6) // 2  # bench.py q1's filter constant
SEED = 42                 # bench.py make_tables' seed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FLOAT_RTOL = 1e-9          # float sums add in another order than the oracle
DIM_ROWS = 100_000         # bench.py make_tables' dimension
HOT_COPIES = 10_000        # build rows of the hot key in K5's skew check
HOT_PROBE_ROWS = 1 << 20   # probe rows of that check, 1 % on the hot key
WIDE_ROWS = 1 << 20        # rows of the wide group-by check
WIDE_KEYS = 9              # its grouping columns: 18 key words
WIDE_SUMS = 17             # its sums: 17 K3 ops, two sets of launches
K3_PATHS = (None, False, True)  # K3's planned path, the direct, the records
PIN_KEY = "spark.rapids.sql.fileScan.pinDeviceBatches"
COLLECT_KEY = "spark.rapids.sql.collect.hostAssisted"
WRITE_KEY = "spark.rapids.sql.write.hostAssisted"
READER_KEY = "spark.rapids.sql.format.parquet.reader.type"


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nodes(root):
    out = []
    root.foreach(out.append)
    return out


def _placements(root):
    out = []
    root.foreach(lambda e: out.append((type(e).__name__, e.placement)))
    return out


def _make_tables(n):
    """bench.py make_tables' fact and dimension tables, from the same
    seed (the dimension drawn after the fact, from the same generator)."""
    rng = np.random.default_rng(SEED)
    fact = pa.table({
        "k": pa.array(rng.integers(0, 100_000, n).astype(np.int64)),
        "v": pa.array(rng.integers(-(10**6), 10**6, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
    })
    dim = pa.table({
        "k": pa.array(np.arange(DIM_ROWS, dtype=np.int64)),
        "w": pa.array(rng.random(DIM_ROWS)),
    })
    return fact, dim


def _oracle(table):
    ft = table.filter(pc.greater(table["v"], THRESHOLD))
    return ft.group_by("k").aggregate(
        [("v", "sum"), ("f", "mean"), ("k", "count")]).sort_by("k")


def _check_q1(got, want, what):
    got = got.sort_by("k")
    if got.column_names != ["k", "sv", "af", "c"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{want.num_rows}")
    for mine, theirs in (("k", "k"), ("sv", "v_sum"), ("c", "k_count")):
        if not np.array_equal(got[mine].to_numpy(), want[theirs].to_numpy()):
            raise AssertionError(f"{what}: column {mine} differs")
    af, wf = got["af"].to_numpy(), want["f_mean"].to_numpy()
    if not np.all(np.isfinite(af)) or not np.allclose(af, wf, rtol=FLOAT_RTOL,
                                                      atol=0.0):
        raise AssertionError(f"{what}: avg differs by up to "
                             f"{np.max(np.abs(af - wf))}")


def _profile(torch, fn):
    """Wall time, device-busy time (union of kernel and copy intervals)
    and the top device kernels of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, per_name, named = [], {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        named.append((start, e.name[:48], (end - start) / 1e3))
        per_name[e.name] = per_name.get(e.name, 0.0) + (end - start) / 1e3
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is not None and start < last:
            start = last
        if end > start:
            busy += end - start
        last = end if last is None else max(last, end)
    busy /= 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    gathers = sum(ms for name, ms in per_name.items()
                  if "gather" in name or "index_elementwise" in name)
    return dict(wall_ms=wall, busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall),
                top=[(name[:60], ms) for name, ms in top],
                gather_ms=gathers,
                before_probe=list(itertools.takewhile(
                    lambda e: "probe_kernel" not in e[0],
                    [(name, ms) for _, name, ms in sorted(named)])))


def _k3_diff(torch, a, b, what):
    """Raises unless K3's result ``a`` equals its plain version's ``b``:
    groups, first rows, counts and int sums exactly, float sums to
    FLOAT_RTOL.  Returns the largest float difference."""
    if a[3] != b[3] or not torch.equal(a[0], b[0]):
        raise AssertionError(f"K3 groups or first rows differ {what}")
    err = 0.0
    for s, s_p, c, c_p in zip(a[1], b[1], a[2], b[2]):
        if not torch.equal(c, c_p):
            raise AssertionError(f"K3 counts differ {what}")
        if s is None:
            continue
        if s.dtype == torch.int64:
            if not torch.equal(s, s_p):
                raise AssertionError(f"K3 integer sums differ {what}")
            continue
        finite = torch.isfinite(s_p)
        if finite.any():
            err = max(err, float((s - s_p)[finite].abs().max()))
        if not torch.allclose(s, s_p, rtol=FLOAT_RTOL, atol=0.0,
                              equal_nan=True):
            raise AssertionError(f"K3 float sums differ {what} by {err}")
    return err


def _k3_same_bits(torch, a, b):
    """Two K3 results are the same bits (float sums compared as int64)."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return a[3] == b[3] and torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[2], b[2])) and all(
        (x is None and y is None) or torch.equal(bits(x), bits(y))
        for x, y in zip(a[1], b[1]))


def _k3_turns(torch, agg_mod, cuda_ms, args, card, what):
    """K3's planned path and the other one timed in turns (planned,
    other, other, planned) on ``args``; each must equal the plain version.
    Returns the kernel line's ``extra``: the paths' times, the plan's
    device-memory traffic of each path (a read through the order counted
    as the 32-byte sector it pulls) and its scratch."""
    k3 = agg_mod.segment_reduce_sorted
    want = agg_mod.segment_reduce_sorted_plain(*args)
    k3(*args)
    plan = k3.last_plan
    ops = args[6] if len(args) > 6 else [
        "sum" if v is not None else None for v in args[2]]
    for packed in (plan.packed, not plan.packed):
        _k3_minmax_diff(torch, k3(*args, packed=packed), want,
                        [op or "count" for op in ops],
                        f"{what}, packed={packed}")
    turns = [cuda_ms(lambda p=p: k3(*args, packed=p))
             for p in (plan.packed, not plan.packed) * 2]
    n = int(args[3][0].shape[0])
    record = max(s.record_bytes for s in plan.sets)
    print(f"K3 {what}: planned path {'records' if plan.packed else 'direct'}"
          f" ({record}-byte records, {plan.rows_per_thread} rows a thread, "
          f"{len(plan.sets)} set(s)); planned / other in turns "
          f"{', '.join(f'{x:.3f}' for x in turns)} ms; traffic: records "
          f"{plan.packed_bytes / max(n, 1):.1f} B a row "
          f"({plan.packed_bytes / 3.35e9:.3f} ms at 3.35 TB/s), direct "
          f"{plan.direct_bytes / max(n, 1):.1f} B a row "
          f"({plan.direct_bytes / 3.35e9:.3f} ms); scratch "
          f"{plan.scratch_bytes} bytes; {card}")
    return dict(path="record" if plan.packed else "direct",
                record_bytes=record, rows_per_thread=plan.rows_per_thread,
                planned_other_in_turns_ms=turns,
                record_traffic_bytes=plan.packed_bytes,
                direct_traffic_bytes=plan.direct_bytes,
                scratch_bytes=plan.scratch_bytes)


def _edge_cases(torch, dev, carry, agg_mod):
    """Each kernel against its plain version on the card at shapes the
    full-size run does not reach: partial and single tiles, no rows,
    more lanes than one launch takes, extreme and tied keys, nulls,
    +-inf and NaN, dead rows, the ungrouped aggregate, groups that end
    at, before and after a tile edge.  Returns the number of cases
    checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def rand_bool(n, p):
        return torch.rand(n, generator=gen, device=dev) < p

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    cases = 0
    for n in (0, 1, 31, 4095, 4096, 4097, 8193, 100_003):
        # K1: every lane width, 20 lanes (two launches), some rows kept
        keep = rand_bool(n, 0.3)
        lanes = [rand_ints(n, -2**62, 2**62) for _ in range(6)]
        lanes += [rand_ints(n, -2**31, 2**31).to(torch.int32)
                  for _ in range(4)]
        lanes += [torch.rand(n, generator=gen, device=dev,
                             dtype=torch.float64) for _ in range(4)]
        lanes += [rand_bool(n, 0.5) for _ in range(6)]
        clear = [x.dtype == torch.bool for x in lanes]
        got, n_got = carry.compact_lanes(keep, lanes, clear)
        want, n_want = carry.compact_lanes_plain(keep, lanes, clear)
        if n_got != n_want or not all(torch.equal(a, b)
                                      for a, b in zip(got, want)):
            raise AssertionError(f"K1 differs at n={n}")
        # K2: three words -- ties, extremes, negatives
        words = [rand_ints(n, 0, 2),
                 extremes[rand_ints(n, 0, len(extremes))],
                 rand_ints(n, -5, 5)]
        if not torch.equal(carry.sort_order(words),
                           carry.sort_order_plain(words)):
            raise AssertionError(f"K2 differs at n={n}")
        # K3: keys with a null word read through the order, dead rows,
        # wrapping int sums, floats with +-inf and NaN; and the same rows
        # already in key order (no order)
        order = carry.sort_order_plain(words[:2])
        live = rand_bool(n, 0.85)
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        pick = torch.rand(n, generator=gen, device=dev)
        f = torch.where(pick < 0.02, float("inf"), f)
        f = torch.where((pick > 0.02) & (pick < 0.04), float("-inf"), f)
        f = torch.where((pick > 0.04) & (pick < 0.05), float("nan"), f)
        vals = [rand_ints(n, 2**61, 2**62), f, None]
        contribs = [live & rand_bool(n, 0.9) for _ in vals]
        idx = order.long()
        for global_agg in (False, True):
            for args in ((words[:2], live, vals, contribs, global_agg,
                          order),
                         ([w[idx] for w in words[:2]], live[idx],
                          [None if v is None else v[idx] for v in vals],
                          [c[idx] for c in contribs], global_agg, None)):
                want = agg_mod.segment_reduce_sorted_plain(*args)
                for packed in K3_PATHS:
                    _k3_diff(torch, agg_mod.segment_reduce_sorted(
                        *args, packed=packed), want,
                        f"at n={n}, global={global_agg}, packed={packed}")
        cases += 1
    # K3 at its tile edges (4,096 rows on the direct path; 2,048 on the
    # record path with these ops' 32-byte records): groups of these sizes
    # in key order, rows shuffled; one group over rows 4000-8190; one
    # group over 100,003 rows that is not the ungrouped aggregate
    for sizes in ([4095], [4096], [4097], [8193], [4095, 4096, 4097, 8193, 7],
                  [4000, 4191, 100], [100_003], [2047, 2049, 2048]):
        n = sum(sizes)
        perm = torch.randperm(n, generator=gen, device=dev)
        key = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev))[perm]
        words = [torch.ones(n, dtype=torch.int64, device=dev), key * 7 - 3]
        order = carry.sort_order_plain(words)
        vals = [rand_ints(n, -2**62, 2**62),
                torch.rand(n, generator=gen, device=dev,
                           dtype=torch.float64), None]
        contribs = [rand_bool(n, 0.9) for _ in vals]
        args = (words, None, vals, contribs, False, order)
        want = agg_mod.segment_reduce_sorted_plain(*args)
        for packed in K3_PATHS:
            a = agg_mod.segment_reduce_sorted(*args, packed=packed)
            _k3_diff(torch, a, want,
                     f"for groups of {sizes} rows, packed={packed}")
            if a[3] != len(sizes):
                raise AssertionError(f"K3 found {a[3]} groups in {sizes}")
        cases += 1
    return cases


def _k3_minmax_diff(torch, a, b, ops, what):
    """Raises unless K3's result ``a`` equals its plain version's ``b``
    with min and max ops among ``ops``: groups, first rows and counts
    exactly, every min and max bit for bit (float64 viewed as int64, so
    -0.0 differs from 0.0 and NaN payloads count), sums as
    ``_k3_diff``."""
    if a[3] != b[3] or not torch.equal(a[0], b[0]):
        raise AssertionError(f"K3 groups or first rows differ {what}")
    for k, op in enumerate(ops):
        if not torch.equal(a[2][k], b[2][k]):
            raise AssertionError(f"K3 counts of op {k} ({op}) differ {what}")
        if op not in ("min", "max"):
            continue
        x, y = a[1][k], b[1][k]
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        if not torch.equal(x, y):
            bad = int((x != y).nonzero()[0])
            raise AssertionError(f"K3 {op} of op {k} differs {what}: group "
                                 f"{bad} {a[1][k][bad].item()!r} vs "
                                 f"{b[1][k][bad].item()!r}")
    _k3_diff(torch, (a[0], [s for s, op in zip(a[1], ops)
                             if op not in ("min", "max")],
                     [c for c, op in zip(a[2], ops)
                      if op not in ("min", "max")], a[3]),
             (b[0], [s for s, op in zip(b[1], ops)
                     if op not in ("min", "max")],
              [c for c, op in zip(b[2], ops)
               if op not in ("min", "max")], b[3]), what)


def _k3_minmax_cases(torch, dev, carry, agg_mod):
    """K3's min and max folds against their plain version on the card:
    NaN (two payloads), +-inf and -0.0 beside 0.0 compared by bits,
    INT64_MIN and INT64_MAX, BOOLEAN lanes, an all-null group, a global
    min over no rows, one group over every tile (2^22 rows), group
    boundaries on and around tile boundaries, more than 16 ops (a second
    op set), with sums and counts in the same sets.  Returns the number
    of cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nan2 = torch.tensor([0x7FF8000000000001], dtype=torch.int64).view(
        torch.float64).item()
    specials = torch.tensor([float("nan"), nan2, float("inf"),
                             float("-inf"), -0.0, 0.0, 1.0, -1.0, 5e-324],
                            dtype=torch.float64, device=dev)
    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1], device=dev)

    def lanes(n):
        """(values, ops): float, int and bool min/max lanes drawn from the
        specials, a float and an int sum, and a count."""
        pick = torch.randint(0, len(specials), (n,), generator=gen,
                             device=dev)
        f = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                        specials[pick],
                        torch.randint(-3, 3, (n,), generator=gen,
                                      device=dev).to(torch.float64))
        i = extremes[torch.randint(0, len(extremes), (n,), generator=gen,
                                   device=dev)]
        b = torch.randint(0, 2, (n,), generator=gen, device=dev)
        vals = [f, f, i, i, b, b, f, i, None]
        ops = ["min", "max", "min", "max", "min", "max", "sum", "sum", None]
        return vals, ops

    def check(words, n, vals, ops, global_agg, order, what, p=0.8):
        contribs = [torch.rand(n, generator=gen, device=dev) < p
                    for _ in vals]
        args = (words, None, vals, contribs, global_agg, order, ops)
        want = agg_mod.segment_reduce_sorted_plain(*args)
        for packed in K3_PATHS:
            _k3_minmax_diff(torch, agg_mod.segment_reduce_sorted(
                *args, packed=packed), want, ops, f"{what}, packed={packed}")

    cases = 0
    for n in (0, 1, 31, 4095, 4096, 4097, 8193, 100_003):
        vals, ops = lanes(n)
        key = torch.randint(0, 5, (n,), generator=gen, device=dev)
        words = [torch.ones(n, dtype=torch.int64, device=dev), key]
        order = carry.sort_order_plain(words)
        for global_agg in (False, True):
            check(words, n, vals, ops, global_agg, order,
                  f"at n={n}, global={global_agg}")
            cases += 1
    # a group whose rows never contribute is null; so is a global min
    # over no rows (one group, count 0)
    n = 10_000
    vals, ops = lanes(n)
    key = torch.randint(0, 3, (n,), generator=gen, device=dev)
    words = [key]
    contribs = [(key != 1) for _ in vals]
    args = (words, None, vals, contribs, False, carry.sort_order_plain(words),
            ops)
    for packed in K3_PATHS:
        got = agg_mod.segment_reduce_sorted(*args, packed=packed)
        _k3_minmax_diff(torch, got, agg_mod.segment_reduce_sorted_plain(
            *args), ops, f"with an all-null group, packed={packed}")
        if any(int(c[1]) != 0 for c in got[2]):
            raise AssertionError("K3 counted rows of the all-null group")
    empty = [torch.empty(0, dtype=torch.float64, device=dev)]
    for packed in K3_PATHS:
        got = agg_mod.segment_reduce_sorted(
            [], None, empty, [torch.empty(0, dtype=torch.bool, device=dev)],
            True, None, ["min"], packed=packed)
        if got[3] != 1 or int(got[2][0][0]) != 0:
            raise AssertionError("K3's global min over no rows is not one "
                                 "null group")
    cases += 2
    # one group over every tile of 2^22 rows; groups that end on, before
    # and after a tile edge (4,096 rows on the direct path; 1,024 with
    # these ops' 64-byte records)
    for sizes in ([1 << 22], [4096, 4096, 1], [4095, 4097, 8192],
                  [4096 * 3, 5], [1024, 1023, 1025, 2048]):
        n = sum(sizes)
        perm = torch.randperm(n, generator=gen, device=dev)
        key = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev))[perm]
        vals, ops = lanes(n)
        check([key], n, vals, ops, False, carry.sort_order_plain([key]),
              f"for groups of {sizes} rows")
        cases += 1
    # more than 16 ops: 27, so the min and max folds run in two sets
    n = 50_000
    vals, ops = [], []
    for _ in range(3):
        v, o = lanes(n)
        vals += v
        ops += o
    key = torch.randint(0, 40, (n,), generator=gen, device=dev)
    check([key], n, vals, ops, False, carry.sort_order_plain([key]),
          f"with {len(ops)} ops")
    cases += 1
    return cases


def _wide_table(n):
    """WIDE_KEYS grouping columns of every key type (a few values each,
    some nulls) and WIDE_SUMS int and float columns to sum."""
    rng = np.random.default_rng(SEED + 5)
    cols = {}
    for i in range(WIDE_KEYS):
        kind = i % 4
        if kind == 0:
            vals = rng.integers(0, 3, n)
        elif kind == 1:
            vals = rng.integers(-1, 2, n).astype(np.int32)
        elif kind == 2:
            vals = rng.random(n) < 0.5
        else:
            vals = rng.choice([0.5, -1.5, 2.0], n)
        cols[f"k{i}"] = pa.array(vals, mask=rng.random(n) < 0.02)
    for j in range(WIDE_SUMS):
        vals = rng.random(n) if j % 3 == 2 else rng.integers(-10**6, 10**6, n)
        cols[f"v{j}"] = pa.array(vals, mask=rng.random(n) < 0.05)
    return pa.table(cols)


def _wide_group_by(torch, dev, carry, agg_mod, seg, batch_to_device,
                   session, F, col, rows=WIDE_ROWS):
    """A group-by of WIDE_KEYS columns with WIDE_SUMS sums, more key words
    and ops than one K3 launch set takes: K3 against its plain version,
    and the query through the session against pyarrow (keys and int sums
    exactly, float sums to FLOAT_RTOL).  K3 must launch in both."""
    table = _wide_table(rows)
    keys = [f"k{i}" for i in range(WIDE_KEYS)]
    batch = batch_to_device(pa.RecordBatch.from_arrays(
        [c.combine_chunks() for c in table.columns],
        names=table.column_names), dev)
    n = batch.num_rows
    words = [w for c in batch.columns[:WIDE_KEYS]
             for w in seg.key_words_for_column(agg_mod._prefix(c, n))]
    vals = [agg_mod._prefix(c, n) for c in batch.columns[WIDE_KEYS:]]
    sums, contribs, _, _ = agg_mod.k3_ops(vals, ["sum"] * WIDE_SUMS)
    args = (words, None, sums, contribs, False, carry.sort_order(words))
    k3 = agg_mod.segment_reduce_sorted
    want = agg_mod.segment_reduce_sorted_plain(*args)
    for packed in K3_PATHS:
        before = k3.launches
        res = k3(*args, packed=packed)
        if dev.type == "cuda" and k3.launches <= before:
            raise AssertionError("K3 did not launch on the wide group-by")
        _k3_diff(torch, res, want, f"with {WIDE_KEYS} grouping columns and "
                 f"{WIDE_SUMS} sums, packed={packed}")
    before = k3.launches
    got = (session.create_dataframe(table)
           .group_by(*[col(k) for k in keys])
           .agg(*[F.sum(col(f"v{j}")).alias(f"s{j}")
                  for j in range(WIDE_SUMS)])).collect()
    if dev.type == "cuda" and k3.launches <= before:
        raise AssertionError("K3 did not launch on the wide group-by "
                             "through the session")
    want = table.group_by(keys).aggregate(
        [(f"v{j}", "sum") for j in range(WIDE_SUMS)])

    order_by = [(k, "ascending") for k in keys]
    got, want = got.sort_by(order_by), want.sort_by(order_by)
    if got.num_rows != want.num_rows or got.num_rows != res[3]:
        raise AssertionError(f"wide group-by: {got.num_rows} groups, "
                             f"pyarrow {want.num_rows}, K3 {res[3]}")
    for k in keys:
        if not got[k].combine_chunks().equals(want[k].combine_chunks()):
            raise AssertionError(f"wide group-by: key {k} differs")
    for j in range(WIDE_SUMS):
        a = got[f"s{j}"].combine_chunks()
        b = want[f"v{j}_sum"].combine_chunks()
        if not a.is_null().equals(b.is_null()):
            raise AssertionError(f"wide group-by: nulls of s{j} differ")
        a, b = a.drop_null().to_numpy(), b.drop_null().to_numpy()
        same = np.array_equal(a, b) if j % 3 != 2 else np.allclose(
            a, b, rtol=FLOAT_RTOL, atol=0.0)
        if not same:
            raise AssertionError(f"wide group-by: s{j} differs")
    print(f"K3 wide group-by: {rows} rows, {WIDE_KEYS} grouping columns "
          f"({len(words)} key words), {WIDE_SUMS} sums, {res[3]} groups: "
          f"K3 equals its plain version on both paths (the record path in "
          f"{len(k3.last_plan.sets)} sets) and the session's result equals "
          f"pyarrow's")


def _k2_edge_cases(torch, dev, carry, tile):
    """K2 against its plain version around its tile of ``tile`` rows:
    three words with ties and extremes, a word varying in all 64 bits,
    all-equal keys (the order must be the identity) and 12 words, each
    varying in two digits, so later words are read through the order.
    Returns the number of cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    cases = 0
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1):
        full = rand_ints(n, -2**63, 2**63 - 1)
        full[:2] = extremes[:2]
        for what, words in (
                ("three words", [rand_ints(n, 0, 2),
                                 extremes[rand_ints(n, 0, len(extremes))],
                                 rand_ints(n, -5, 5)]),
                ("a word varying in all 64 bits", [full]),
                ("all-equal keys",
                 [torch.full((n,), -7, dtype=torch.int64, device=dev)] * 2),
                ("12 words", [rand_ints(n, 0, 7) << (8 * (j % 7) + 6)
                              for j in range(12)])):
            order = carry.sort_order(words)
            if not torch.equal(order, carry.sort_order_plain(words)):
                raise AssertionError(f"K2 differs on {what} at n={n}")
            if what == "all-equal keys" and not torch.equal(
                    order, torch.arange(n, dtype=torch.int32, device=dev)):
                raise AssertionError(f"K2 moved equal keys at n={n}")
            cases += 1
    return cases


def _k2_passes(carry, words):
    """The passes K2 runs on ``words`` (its pass counter over one call),
    after checking them against the plan from the plain histogram."""
    carry.sort_order.passes = 0
    carry.sort_order(words)
    ran = carry.sort_order.passes
    n = int(words[0].shape[0])
    planned = len(carry.plan_passes(carry.varying_digits(
        carry.digit_histogram_plain(words), n)))
    if ran != planned:
        raise AssertionError(f"K2 ran {ran} passes, the plain histogram "
                             f"plans {planned}")
    return ran


def _same_expansion(torch, a, b):
    """Two results of expand_pairs are the same: indices, and every
    column's data bits and validity."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and all(
        torch.equal(bits(x.data), bits(y.data))
        and torch.equal(x.validity, y.validity)
        for x, y in zip(list(a[2]) + list(a[3]), list(b[2]) + list(b[3]))))


def _join_case(torch, jk, bucket_for, build_cols, n_b, probe_cols, n_p,
               what, nkeys=1, null_matches=False):
    """K6 on both sides' keys, K6 + K2 + K4 (count_matches), K7
    (expand_ends) and K5 (expand_pairs) against their plain versions on
    one build and probe side whose first ``nkeys`` columns are the key,
    for inner, left and full joins, at an output capacity equal to the
    total and at its capacity bucket.  Fails unless K6 launched (for each
    side with rows), K4 and K7 (where there are probe rows) and K5.
    Returns the inner total."""
    cap_b, cap_p = build_cols[0].capacity, probe_cols[0].capacity
    bkeys, pkeys = build_cols[:nkeys], probe_cols[:nkeys]
    for side, keys, cap in (("build", bkeys, cap_b), ("probe", pkeys, cap_p)):
        before = jk.combined_key_hash.launches
        got = jk.combined_key_hash(keys, cap, null_matches, side)
        if cap and jk.combined_key_hash.launches <= before:
            raise AssertionError(f"K6 (key_hash) did not launch on the "
                                 f"{side} side {what}")
        if not torch.equal(got, jk.combined_key_hash_plain(
                keys, cap, null_matches, side)):
            raise AssertionError(f"K6 (key_hash) differs on the {side} side "
                                 f"{what}")
    before = jk.join_probe.launches
    got = jk.count_matches(bkeys, n_b, pkeys, n_p, null_matches)
    if cap_p and jk.join_probe.launches <= before:
        raise AssertionError(f"K4 (join_probe) did not launch {what}")
    want = jk.count_matches_plain(bkeys, n_b, pkeys, n_p, null_matches)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"K6 + K2 + K4 (count_matches) differ {what}")
    order, lo, counts = got
    plive = torch.arange(cap_p, device=lo.device) < n_p
    inner = None
    for how in ("inner", "left", "full"):
        ends, total = _same_ends(torch, jk, counts, plive, how)
        inner = total if inner is None else inner
        for out_cap in sorted({max(total, 1), bucket_for(max(total, 1))}):
            args = (ends, lo, counts, order, total, out_cap, probe_cols,
                    build_cols)
            before = jk.expand_pairs.launches
            got = jk.expand_pairs(*args)
            if jk.expand_pairs.launches <= before:
                raise AssertionError(f"K5 (expand_pairs) did not launch "
                                     f"{what}, {how} join")
            if not _same_expansion(torch, got,
                                   jk.expand_pairs_plain(*args)):
                raise AssertionError(f"K5 (expand_pairs) differs {what}, "
                                     f"{how} join, capacity {out_cap}")
    return inner


def _join_edge_cases(torch, dev, jk, t, DeviceColumn, bucket_for):
    """K6, K4 and K5 against their plain versions on the card at shapes q2
    does not reach: empty and dead build and probe sides, all-null keys
    on either side, build keys repeated 1-64 times, half the probe keys
    missing, probe and output counts around the kernels' blocks of 256,
    keys at +-2^63; INT, BOOLEAN and DOUBLE keys (+-0.0, NaN, +-inf, a
    subnormal), keys of 2 and 3 columns, null keys on both sides with
    nulls matching or not, one key on every live build row, all-distinct
    keys, and a capacity far above the live rows.  Returns the number of
    cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def column(dtype, data, valid):
        return DeviceColumn(dtype, torch.where(
            valid, data, torch.zeros_like(data)), valid)

    def side(keys, null_frac=0.0, build=False):
        """Key column(s) (a tensor, or a list of (type, data) key columns),
        then payload columns."""
        if isinstance(keys, torch.Tensor):
            keys = [(t.LONG, keys)]
        n = int(keys[0][1].shape[0])
        cols = [column(dtype, data, torch.rand(
                    n, generator=gen, device=dev) >= null_frac)
                for dtype, data in keys]
        some = torch.rand(n, generator=gen, device=dev) >= 0.2
        cols.append(column(t.DOUBLE, torch.rand(
            n, generator=gen, device=dev, dtype=torch.float64), some))
        if not build:
            cols += [column(t.INT, rand_ints(n, -2**31, 2**31).to(
                         torch.int32), some),
                     column(t.BOOLEAN, torch.rand(
                         n, generator=gen, device=dev) < 0.5, some)]
        return cols

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    doubles = torch.tensor([0.0, -0.0, float("nan"), -float("nan"),
                            float("inf"), -float("inf"), 1e-310, -1.5, 2.5,
                            1e300], dtype=torch.float64, device=dev)
    many = torch.repeat_interleave(torch.arange(500, device=dev),
                                   rand_ints(500, 1, 65))
    many = many[torch.randperm(many.shape[0], generator=gen, device=dev)]
    uniq = torch.arange(1000, device=dev)

    def ints(n, hi):
        return (t.INT, rand_ints(n, -hi, hi).to(torch.int32))

    def bools(n):
        return (t.BOOLEAN, torch.rand(n, generator=gen, device=dev) < 0.5)

    def dbls(n):
        return (t.DOUBLE, doubles[rand_ints(n, 0, len(doubles))])

    def longs(n, hi):
        return (t.LONG, rand_ints(n, 0, hi))

    # (what, build columns, live build rows, probe columns, live probe
    # rows, key columns, nulls match)
    cases = [
        ("with no build rows", side(uniq[:0], build=True), 0,
         side(rand_ints(1000, 0, 1000), 0.1), 1000, 1, False),
        ("with 1,024 dead build rows",
         side(torch.arange(1024, device=dev), build=True), 0,
         side(rand_ints(1000, 0, 1000)), 1000, 1, False),
        ("with no probe rows", side(uniq, build=True), 1000,
         side(uniq[:0]), 0, 1, False),
        ("with 1,024 dead probe rows", side(uniq, build=True), 1000,
         side(rand_ints(1024, 0, 1000)), 0, 1, False),
        ("with all-null build keys", side(uniq, 1.0, build=True), 1000,
         side(rand_ints(3000, 0, 1000)), 3000, 1, False),
        ("with all-null probe keys", side(uniq, build=True), 1000,
         side(rand_ints(3000, 0, 1000), 1.0), 3000, 1, False),
        ("on build keys repeated 1-64 times", side(many, 0.05, build=True),
         int(many.shape[0]) - 7, side(rand_ints(5000, 0, 520), 0.05), 4990,
         1, False),
        ("with half the probe keys missing", side(uniq, build=True), 1000,
         side(rand_ints(5000, 0, 2000), 0.1), 5000, 1, False),
        ("on keys at +-2^63", side(extremes[rand_ints(300, 0, 6)], 0.1,
                                   build=True), 300,
         side(extremes[rand_ints(2000, 0, 6)], 0.1), 2000, 1, False),
    ]
    # probe and output counts at and around the blocks of 256
    for n in (1, 255, 256, 257, 511, 512, 513, 4097):
        cases.append((f"at {n} probe rows and pairs",
                      side(uniq, build=True), 1000,
                      side(rand_ints(n, 0, 1000)), n, 1, False))
    cases += [
        ("on INT keys", side([ints(2000, 300)], 0.05, build=True), 1990,
         side([ints(4000, 400)], 0.05), 4000, 1, False),
        ("on BOOLEAN keys", side([bools(50)], 0.1, build=True), 50,
         side([bools(3000)], 0.1), 2990, 1, False),
        ("on DOUBLE keys with +-0.0, NaN, +-inf and a subnormal",
         side([dbls(200)], 0.05, build=True), 200,
         side([dbls(3000)], 0.05), 3000, 1, False),
        ("on 2-column keys", side([longs(3000, 40), ints(3000, 5)], 0.02,
                                  build=True), 3000,
         side([longs(6000, 50), ints(6000, 6)], 0.02), 6000, 2, False),
        ("on 3-column keys",
         side([ints(1500, 4), dbls(1500), bools(1500)], 0.02, build=True),
         1500, side([ints(4000, 5), dbls(4000), bools(4000)], 0.02), 4000,
         3, False),
        ("on null keys of both sides, nulls not matching",
         side([longs(800, 60), dbls(800)], 0.2, build=True), 800,
         side([longs(3000, 70), dbls(3000)], 0.2), 3000, 2, False),
        ("on null keys of both sides, nulls matching",
         side([longs(800, 60), dbls(800)], 0.2, build=True), 800,
         side([longs(3000, 70), dbls(3000)], 0.2), 3000, 2, True),
        ("on one key on every live build row",
         side(torch.full((2048,), 7, device=dev), build=True), 2000,
         side(rand_ints(3000, 5, 9)), 3000, 1, False),
        ("on all-distinct build keys",
         side(torch.randperm(50_000, generator=gen, device=dev) * 3,
              build=True), 50_000,
         side(rand_ints(20_000, 0, 150_000)), 20_000, 1, False),
        ("at a capacity far above the live rows",
         side(rand_ints(65_536, 0, 100), build=True), 37,
         side(rand_ints(65_536, 0, 100)), 1000, 1, False),
    ]
    for what, bcols, n_b, pcols, n_p, nkeys, null_matches in cases:
        total = _join_case(torch, jk, bucket_for, bcols, n_b, pcols, n_p,
                           what, nkeys, null_matches)
        if what.startswith("at ") and "probe rows" in what and total != n_p:
            raise AssertionError(f"{total} pairs {what}")
    return len(cases)


def _hot_key(torch, dev, jk, t, DeviceColumn, bucket_for):
    """K4 and K5 on a hot key: HOT_COPIES build rows share one key that 1 %
    of HOT_PROBE_ROWS probe rows hit; the other build keys are
    0..99,999 once and the other probe rows hit them uniformly.  Checks K4
    and K5 against their plain versions; returns (pairs, output capacity,
    K5's arguments, K4's arguments)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    hot = DIM_ROWS
    bkeys = torch.cat([torch.arange(DIM_ROWS, device=dev),
                       torch.full((HOT_COPIES,), hot, device=dev)])
    nb = int(bkeys.shape[0])
    pkeys = torch.where(
        torch.rand(HOT_PROBE_ROWS, generator=gen, device=dev) < 0.01,
        torch.full((HOT_PROBE_ROWS,), hot, device=dev),
        torch.randint(0, DIM_ROWS, (HOT_PROBE_ROWS,), generator=gen,
                      device=dev))

    def col(dtype, data):
        return DeviceColumn(dtype, data, torch.ones(
            data.shape[0], dtype=torch.bool, device=dev))
    build = [col(t.LONG, bkeys), col(t.DOUBLE, torch.rand(
        nb, generator=gen, device=dev, dtype=torch.float64))]
    probe = [col(t.LONG, pkeys), col(t.LONG, torch.randint(
        -10**6, 10**6, (HOT_PROBE_ROWS,), generator=gen, device=dev)),
        col(t.DOUBLE, torch.rand(HOT_PROBE_ROWS, generator=gen, device=dev,
                                 dtype=torch.float64))]
    live_p = torch.ones(HOT_PROBE_ROWS, dtype=torch.bool, device=dev)
    side = jk.sort_build(jk.combined_key_hash(build[:1], nb, side="build"),
                         torch.ones(nb, dtype=torch.bool, device=dev))
    k4_args = (side, probe[:1], HOT_PROBE_ROWS)
    lo, counts = jk.join_probe(*k4_args)
    if not all(torch.equal(x, y) for x, y in zip(
            (lo, counts), jk.join_probe_keys_plain(side.sorted_hash,
                                                   *k4_args[1:]))):
        raise AssertionError("K4 differs from its plain version on the hot "
                             "key")
    ends, total = _same_ends(torch, jk, counts, live_p, "inner")
    out_cap = bucket_for(total)
    args = (ends, lo, counts, side.order, total, out_cap, probe, build)
    if not _same_expansion(torch, jk.expand_pairs(*args),
                           jk.expand_pairs_plain(*args)):
        raise AssertionError("K5 differs from its plain version on the hot "
                             "key")
    return total, out_cap, args, k4_args


def _same_ends(torch, jk, counts, live, how):
    """K7 against its plain version: the running sums and the total,
    exactly.  Fails unless K7 launched.  Returns (ends, total)."""
    before = jk.expand_ends.launches
    ends, total = jk.expand_ends(counts, live, how)
    if counts.shape[0] and jk.expand_ends.launches <= before:
        raise AssertionError(f"K7 (expand_ends) did not launch on "
                             f"{counts.shape[0]} rows, {how} join")
    want = jk.expand_ends_plain(counts, live, how)
    if not (torch.equal(ends, want[0]) and torch.equal(total, want[1])):
        raise AssertionError(f"K7 (expand_ends) differs on "
                             f"{counts.shape[0]} rows, {how} join")
    return ends, int(total)


def _expand_cases(torch, dev, jk, t, DeviceColumn, tile):
    """K7 and K5 against their plain versions on the shapes K5's merge-path
    tiles must get right, on counts made here (not by K4): K7 around its
    tile of 4,096 rows, with dead rows and all misses; K5 behind a run of
    zero-count rows longer than K5's tile of ``tile`` merge items, on one
    row with more pairs than a tile, at a capacity far above the total,
    and with 40 columns of every width, all in one launch.  Returns the
    number of cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def columns(n, k):
        cols = []
        for i in range(k):
            kind = i % 4
            if kind == 0:
                dtype, data = t.LONG, rand_ints(n, -2**62, 2**62)
            elif kind == 1:
                dtype, data = t.INT, rand_ints(n, -2**31, 2**31).to(
                    torch.int32)
            elif kind == 2:
                dtype, data = t.BOOLEAN, torch.rand(
                    n, generator=gen, device=dev) < 0.5
            else:
                dtype, data = t.DOUBLE, torch.rand(
                    n, generator=gen, device=dev, dtype=torch.float64)
            valid = torch.rand(n, generator=gen, device=dev) >= 0.1
            cols.append(DeviceColumn(dtype, torch.where(
                valid, data, torch.zeros_like(data)), valid))
        return cols

    cases = 0
    for n in (1, 4095, 4096, 4097, 3 * 4096 + 5, 100_003):
        # matches, and all misses
        for counts in (rand_ints(n, 0, 4),
                       torch.zeros(n, dtype=torch.int64, device=dev)):
            live = torch.rand(n, generator=gen, device=dev) < 0.9
            for how in ("inner", "left", "full"):
                _same_ends(torch, jk, counts, live, how)
                cases += 1
    nb = 20_000
    order = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    zero_run = rand_ints(6 * tile, 0, 3)
    zero_run[tile // 3:tile // 3 + 3 * tile] = 0
    hot_row = rand_ints(3000, 0, 3)
    hot_row[1234] = 4 * tile
    for what, counts, extra, ncols in (
            ("behind a run of zero-count rows longer than a tile",
             zero_run, 0, 4),
            ("on one row with more pairs than a tile", hot_row, 0, 4),
            ("at a capacity far above the total", rand_ints(5000, 0, 3),
             7 * 5000, 4),
            ("with 40 columns", rand_ints(5000, 0, 4), 100, 20)):
        n = int(counts.shape[0])
        live = torch.rand(n, generator=gen, device=dev) < 0.95
        lo = rand_ints(n, 0, nb - int(counts.max())).to(torch.int32)
        probe, build = columns(n, ncols), columns(nb, ncols)
        for how in ("inner", "left"):
            ends, total = _same_ends(torch, jk, counts, live, how)
            out_cap = total + extra if total + extra else 1
            args = (ends, lo, counts, order, total, out_cap, probe, build)
            before = jk.expand_pairs.launches
            got = jk.expand_pairs(*args)
            if jk.expand_pairs.launches != before + 1:
                raise AssertionError(f"K5 (expand_pairs) did not launch once "
                                     f"{what}, {how} join")
            if not _same_expansion(torch, got, jk.expand_pairs_plain(*args)):
                raise AssertionError(f"K5 (expand_pairs) differs {what}, "
                                     f"{how} join")
            cases += 1
    return cases


def _same_lanes(torch, a, b):
    """Two lists of lanes hold the same bits."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(a, b))


class _Capture:
    """While open, keeps the arguments of every call of the wrappers
    ``names`` of ``module``; each call still launches its kernel.  A
    wrapper counts its launches through its module's name, so the spy
    carries a count that goes back to the wrapper on exit."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls = module, names, []

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            def spy(*args, _fn=fn, _n=n):
                self.calls.append((_n, args))
                return _fn(*args)
            spy.launches = 0
            setattr(self.module, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            if hasattr(fn, "launches"):
                fn.launches += getattr(self.module, n).launches
            setattr(self.module, n, fn)


def _check_captured(torch, cap, carry, gather_mod, fetch, what):
    """Every call a path made of K1, K8, K9 or K10, run again through the
    kernel and its plain version on the same inputs, bit for bit.
    Returns a description of each call."""
    seen = []
    for name, args in cap.calls:
        got = cap.orig[name](*args)
        if name == "compact_lanes":
            want = carry.compact_lanes_plain(*args)
            same = got[1] == want[1] and _same_lanes(torch, got[0], want[0])
            shape = (f"{int(args[0].shape[0])} rows, {got[1]} kept, "
                     f"{len(args[1])} lanes")
        elif name == "gather_rows":
            want = gather_mod.gather_rows_plain(*args)
            same = _same_lanes(torch, got, want)
            shape = (f"{int(args[0].shape[0])} rows, lanes "
                     f"{[str(x.dtype)[6:] for x in args[1]]}")
        elif name == "lane_stats":
            want = fetch.lane_stats_plain(*args)
            same = torch.equal(got, want)
            shape = (f"{args[1]} rows, lanes "
                     f"{[str(x.dtype)[6:] for x in args[0]]}")
        else:
            want = fetch.pack_lanes_plain(*args)
            same = torch.equal(got, want)
            shape = f"{args[3]} rows, plan {args[1]}"
        if not same:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {what} ({shape})")
        seen.append(f"{name} ({shape})")
        del got, want
    if not seen:
        raise AssertionError(f"{what} made no call to capture")
    return seen


def _row_lanes(torch, gen, dev, m, widths):
    """Lanes of ``m`` rows, one a width: int64, int32 or bool."""
    out = []
    for w in widths:
        if w == 8:
            out.append(torch.randint(-2**62, 2**62, (m,), generator=gen,
                                     device=dev))
        elif w == 4:
            out.append(torch.randint(-2**31, 2**31 - 1, (m,), generator=gen,
                                     device=dev, dtype=torch.int32))
        else:
            out.append(torch.rand(m, generator=gen, device=dev) < 0.5)
    return out


def _k8_crossover(gather, m, widths):
    """The fewest rows out of ``m`` that gather_plan sends through the
    records (``m`` rows of the lanes must outgrow L2)."""
    lo, hi = 1, 4 * m
    if not gather.gather_plan(hi, m, widths).packed:
        raise ValueError(f"K8's plan never packs {m} rows of {widths}")
    while lo < hi:
        mid = (lo + hi) // 2
        if gather.gather_plan(mid, m, widths).packed:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _k8_edge_cases(torch, dev, gather):
    """K8 on the single pass, the record path and the planned one against
    its plain version, bit for bit: no rows (no launch), one row, 255-257
    and 2^k +- 1 rows (its 256-row blocks), a random permutation, the
    identity, the reverse, every row reading one source row, orders with
    repeats over lanes 3x and 7x longer and over 7 rows, n either side of
    the plan's crossover (the record path packs the whole source), every
    lane-width mix (one lane of each width, 8+1, 4+8+1, 16 one-byte, 7 and
    8 eight-byte lanes: a full 64-byte record), q3's and q4's lanes, and
    17 and 40 lanes (chunks).  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    q3, q4 = [8, 1] * 3, [8, 1, 8, 1]
    mixes = ([8], [4], [1], [8, 1], [4, 8, 1], [1] * 16, [8] * 7, [8] * 8,
             q3, q4, [1, 4, 8] * 5 + [8, 4], [8, 4, 1] * 13 + [8])
    cases = []
    for n, m, kind in ((1, 1, "perm"), (255, 255, "perm"), (256, 256, "perm"),
                       (257, 257, "perm"), (4095, 4095, "perm"),
                       ((1 << 16) + 1, (1 << 16) + 1, "perm"),
                       ((1 << 20) - 1, (1 << 20) - 1, "perm"),
                       (100_003, 100_003, "identity"),
                       (100_003, 100_003, "reverse"),
                       (100_003, 100_003, "one row"),
                       (100_003, 300_009, "repeats"),
                       (100_003, 700_021, "repeats"),
                       (100_003, 7, "repeats")):
        for widths in mixes:
            cases.append((n, m, kind, widths))
    for widths in (q3, q4, [8, 1]):
        m = 1 << 24
        c = _k8_crossover(gather, m, widths)
        cases += [(c - 1, m, "repeats", widths), (c, m, "repeats", widths)]
    cases.append((0, 3, "perm", q3))
    for n, m, kind, widths in cases:
        if kind == "perm":
            order = torch.randperm(m, generator=gen, device=dev)[:n]
        elif kind == "identity":
            order = torch.arange(n, device=dev)
        elif kind == "reverse":
            order = torch.arange(n - 1, -1, -1, device=dev)
        elif kind == "one row":
            order = torch.full((n,), n // 2, device=dev)
        else:
            order = torch.randint(0, m, (n,), generator=gen, device=dev)
        order = order.to(torch.int32)
        ls = _row_lanes(torch, gen, dev, m, widths)
        want = gather.gather_rows_plain(order, ls)
        plan = gather.gather_plan(n, m, widths)
        for packed in (None, False, True):
            use = plan.packed if packed is None else packed
            before = gather.gather_rows.launches
            got = gather.gather_rows(order, ls, packed=packed)
            launched = gather.gather_rows.launches - before
            want_launches = len(gather.gather_chunks(widths, use)) if n \
                else 0
            if launched != want_launches:
                raise AssertionError(
                    f"K8 with {n} rows and {len(widths)} lanes "
                    f"(packed={packed}) launched {launched} times, not "
                    f"{want_launches}")
            if not _same_lanes(torch, got, want):
                raise AssertionError(
                    f"K8 differs from its plain version with {n} rows of "
                    f"{m}, lanes {widths}, {kind} order, packed={packed}")
    return len(cases)


def _k8_sweep(torch, dev, gather, cuda_ms):
    """The single pass and the record path timed in turns on q3's lanes:
    a permutation of n = m rows, 2^16 to 2^24 (the plan keeps the single
    pass up to 96 MiB of lanes, 3,728,270 rows), then n rows of m = 2^24
    around the plan's crossover (the record path packs all m)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q3 = [8, 1] * 3
    out = []
    for n, m in [(1 << k, 1 << k) for k in (16, 18, 20, 21, 22, 24)] + [
            (1 << 21, 1 << 24), (1 << 22, 1 << 24), (3 << 21, 1 << 24),
            (1 << 23, 1 << 24)]:
        order = torch.randperm(m, generator=gen, device=dev)[:n].to(
            torch.int32)
        ls = _row_lanes(torch, gen, dev, m, q3)
        times = [cuda_ms(lambda p=p: gather.gather_rows(order, ls, packed=p))
                 for p in (False, True, False, True)]
        out.append((n, m, gather.gather_plan(n, m, q3).packed, times))
        del order, ls
    return out


def _k3_sweep(torch, dev, carry, agg_mod, cuda_ms):
    """K3's direct path and its record path timed in turns (direct,
    records, direct, records) around the plan's crossover (96 MiB of
    distinct inputs): a sum of one float lane (q2's and q6's shape) and
    q1's two lanes and count, grouped by 100,000 keys through K2's order,
    2^22 to 2^24 rows; each result equals the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    out = []
    for n in (1 << 22, 6_000_000, 1 << 23, 12_000_000, 1 << 24):
        key = torch.randint(0, 100_000, (n,), generator=gen, device=dev)
        words = [torch.zeros(n, dtype=torch.int64, device=dev), key]
        order = carry.sort_order(words)
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        v = torch.randint(-10**6, 10**6, (n,), generator=gen, device=dev)
        masks = [torch.rand(n, generator=gen, device=dev) < 0.95
                 for _ in range(3)]
        for what, args in (
                ("one lane", (words, None, [f], masks[:1], False, order)),
                ("q1's lanes", (words, None, [v, f, None], masks, False,
                                order))):
            want = agg_mod.segment_reduce_sorted_plain(*args)
            for packed in (False, True):
                _k3_diff(torch, agg_mod.segment_reduce_sorted(
                    *args, packed=packed), want, f"sweep {what} n={n}")
            agg_mod.segment_reduce_sorted(*args)
            plan = agg_mod.segment_reduce_sorted.last_plan
            times = [cuda_ms(lambda p=p: agg_mod.segment_reduce_sorted(
                *args, packed=p)) for p in (False, True, False, True)]
            inputs = n * (8 * len(plan.sets[0].lanes)
                          + len(plan.sets[0].masks))
            out.append((what, n, inputs, plan.packed, times))
        del key, words, order, f, v, masks, args, want
    return out


FUZZ_SPANS = (0, 2**8 - 1, 2**8, 2**16 - 1, 2**16, 2**32 - 1, 2**32)


def _fuzz_array(rng, n, kind):
    """One column of the fetch fuzz: nulls (none, some or all), BOOLEAN
    data lanes, INT and LONG at their extremes and at the narrowing
    boundaries of their span, DOUBLE with NaN, -0.0 and +-inf."""
    null_frac = float(rng.choice([0.0, 0.0, 0.1, 1.0]))
    mask = (rng.random(n) < null_frac) if null_frac else None
    if kind == "boolean":
        vals = rng.random(n) < float(rng.choice([0.5, 1.0]))
    elif kind == "int":
        vals = (rng.integers(-2**31, 2**31, n) if rng.random() < 0.3
                else rng.integers(-300, 300, n)).astype(np.int32)
    elif kind == "long_extremes":
        vals = rng.choice(np.array([-2**63, 2**63 - 1, 0, -1],
                                   dtype=np.int64), n)
    elif kind == "long_span":
        base = int(rng.integers(-2**40, 2**40))
        span = int(rng.choice(FUZZ_SPANS))
        vals = base + rng.integers(0, span + 1, n, dtype=np.int64)
        if n >= 2:
            vals[:2] = [base, base + span]
    elif kind == "long_wide":
        vals = rng.integers(-2**62, 2**62, n)
    else:
        vals = rng.normal(size=n)
        pick = rng.random(n)
        vals[pick < 0.05] = np.nan
        vals[(pick >= 0.05) & (pick < 0.1)] = -0.0
        vals[(pick >= 0.1) & (pick < 0.15)] = np.inf
        vals[(pick >= 0.15) & (pick < 0.2)] = -np.inf
    return pa.array(vals, mask=mask)


def _fetch_fuzz(torch, dev, fetch, batch_to_device, batch_to_arrow,
                move_batch, cases=48):
    """K9 and K10 against their plain versions, bit for bit, and
    fetch_batch against batch_to_arrow(move_batch(...)), on seeded
    batches of BOOLEAN, INT, LONG and DOUBLE columns: empty batches, row
    counts that are not a multiple of 8, all-null columns, values at
    +-2^63 and spans of exactly 2^8 - 1, 2^8, 2^16 - 1, 2^16, 2^32 - 1
    and 2^32.  Returns (cases, the row counts seen)."""
    kinds = ("boolean", "int", "long_extremes", "long_span", "long_wide",
             "double")
    sizes = []
    for seed in range(cases):
        rng = np.random.default_rng(SEED + 100 + seed)
        n = int(rng.choice([0, 1, 7, 9, 31, 33, 1023,
                            int(rng.integers(2, 200_000))]))
        picked = [kinds[seed % len(kinds)]] + [
            str(rng.choice(kinds)) for _ in range(int(rng.integers(0, 5)))]
        rb = pa.RecordBatch.from_pydict(
            {f"c{i}_{k}": _fuzz_array(rng, n, k)
             for i, k in enumerate(picked)})
        batch = batch_to_device(rb, dev)
        lanes = fetch.batch_lanes(batch)
        stats = fetch.lane_stats(lanes, n)
        if not torch.equal(stats, fetch.lane_stats_plain(lanes, n)):
            raise AssertionError(f"K9 differs from its plain version: "
                                 f"{picked}, {n} rows")
        plan, mins = fetch.build_plan(lanes, stats.tolist())
        packed = fetch.pack_lanes(lanes, plan, mins, n)
        if not torch.equal(packed, fetch.pack_lanes_plain(lanes, plan, mins,
                                                          n)):
            raise AssertionError(f"K10 differs from its plain version: "
                                 f"{picked}, {n} rows, plan {plan}")
        got = batch_to_arrow(fetch.fetch_batch(batch))
        want = batch_to_arrow(move_batch(batch, torch.device("cpu"),
                                         live_only=True))
        if not (got.schema == want.schema and all(
                _same_arrow(a, b) for a, b in zip(got.columns,
                                                  want.columns))):
            raise AssertionError(f"fetch_batch differs from move_batch: "
                                 f"{picked}, {n} rows, plan {plan}")
        sizes.append(n)
    return cases, sizes


def _same_arrow(a, b):
    """Two Arrow arrays hold the same values and nulls (NaN equal to
    NaN, -0.0 told from 0.0)."""
    if len(a) != len(b) or a.type != b.type:
        return False
    va = np.asarray(a.is_valid())
    if not np.array_equal(va, np.asarray(b.is_valid())):
        return False
    x = a.fill_null(False if pa.types.is_boolean(a.type) else 0)
    y = b.fill_null(False if pa.types.is_boolean(b.type) else 0)
    x, y = x.to_numpy(zero_copy_only=False), y.to_numpy(zero_copy_only=False)
    if x.dtype == np.float64:
        x, y = x.view(np.int64), y.view(np.int64)
    return np.array_equal(x, y)


def _write_parquet_input(fact, root, n_files=4):
    """bench.py write_parquet_input's layout: fact.slice(i * per, per) as
    part-NN.parquet under root/fact_pq, default row groups."""
    path = os.path.join(root, "fact_pq")
    os.makedirs(path, exist_ok=True)
    per = -(-fact.num_rows // n_files)
    for i in range(n_files):
        pq.write_table(fact.slice(i * per, per),
                       os.path.join(path, f"part-{i:02d}.parquet"))
    return path


def _q5_df(session, path, F, col):
    """bench.py q5: read the files, f < 0.5, group by k: sum(v), count."""
    return (session.read.parquet(path)
            .filter(col("f") < 0.5)
            .group_by(col("k"))
            .agg(F.sum(col("v")).alias("sv"), F.count("*").alias("c")))


def _q5_oracle(path):
    files = sorted(os.path.join(path, f) for f in os.listdir(path))
    t = pa.concat_tables([pq.read_table(f) for f in files])
    ft = t.filter(pc.less(t["f"], 0.5))
    return ft.group_by("k").aggregate(
        [("v", "sum"), ("k", "count")]).sort_by("k")


def _check_q5(got, want, what):
    got = got.sort_by("k")
    if got.column_names != ["k", "sv", "c"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{want.num_rows}")
    for mine, theirs in (("k", "k"), ("sv", "v_sum"), ("c", "k_count")):
        if not np.array_equal(got[mine].to_numpy(), want[theirs].to_numpy()):
            raise AssertionError(f"{what}: column {mine} differs")


def _footer_rows(out):
    """(rows the footers count, the parquet files) of a write's output."""
    files = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith(".parquet"))
    return sum(pq.ParquetFile(f).metadata.num_rows for f in files), files


class _FetchTap:
    """While open, records every packed fetch's transfer plan and the
    bytes of its packed buffer (wraps fetch.build_plan and fetch.layout,
    which count no launches)."""

    def __init__(self, fetch):
        self.fetch = fetch
        self.plans = []              # kept alive, so their ids stay unique
        self._sizes = {}

    @property
    def bytes(self):
        return sum(self._sizes.values())

    def __enter__(self):
        build, layout = self._orig = (self.fetch.build_plan,
                                      self.fetch.layout)

        def build_plan(lanes, stats, *offsets_lanes):
            out = build(lanes, stats, *offsets_lanes)
            self.plans.append(out[0])
            return out

        def layout_(lanes, plan, n):
            out = layout(lanes, plan, n)    # called again inside K10's
            self._sizes[id(plan)] = out[1]  # wrapper: count a plan once
            return out
        self.fetch.build_plan, self.fetch.layout = build_plan, layout_
        return self

    def __exit__(self, *exc):
        self.fetch.build_plan, self.fetch.layout = self._orig


class _ScanTap:
    """While open, times every file scan's host decode
    (FileScanExec._read_file) and upload (io/scan.py's batch_to_device,
    between synchronisations), and lists the files read."""

    def __init__(self, torch, scan_mod):
        self.torch = torch
        self.scan_mod = scan_mod
        self.files = []
        self.decode_ms = self.upload_ms = 0.0
        self.upload_bytes = 0

    def __enter__(self):
        cls = self.scan_mod.FileScanExec
        read, up = self._orig = (cls._read_file,
                                 self.scan_mod.batch_to_device)

        def _read_file(exec_, path):
            t0 = time.perf_counter()
            out = read(exec_, path)
            self.decode_ms += (time.perf_counter() - t0) * 1e3
            self.files.append(path)
            return out

        def batch_to_device(rb, device=None, capacity=None):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = up(rb, device, capacity)
            self.torch.cuda.synchronize()
            self.upload_ms += (time.perf_counter() - t0) * 1e3
            self.upload_bytes += rb.nbytes
            return out
        cls._read_file = _read_file
        self.scan_mod.batch_to_device = batch_to_device
        return self

    def __exit__(self, *exc):
        (self.scan_mod.FileScanExec._read_file,
         self.scan_mod.batch_to_device) = self._orig


def _same_table(got, want):
    """Same column names and, column by column, the same values and nulls
    in the same order."""
    return got.column_names == want.column_names and \
        got.num_rows == want.num_rows and all(
            _same_arrow(got[c].combine_chunks(), want[c].combine_chunks())
            for c in want.column_names)


def _orders_table(n):
    """The orders-and-nulls check's table: nulls in an INT column; NaN,
    -0.0, +-inf and nulls in a DOUBLE column; the row number."""
    rng = np.random.default_rng(SEED + 9)
    d = rng.normal(size=n)
    pick = rng.random(n)
    d[pick < 0.02] = np.nan
    d[(pick >= 0.02) & (pick < 0.04)] = -0.0
    d[(pick >= 0.04) & (pick < 0.06)] = 0.0
    d[(pick >= 0.06) & (pick < 0.08)] = np.inf
    d[(pick >= 0.08) & (pick < 0.1)] = -np.inf
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "d": pa.array(d, mask=rng.random(n) < 0.05),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })


def _download_split(torch, fetch, batch_to_arrow, move_batch, batch):
    """The download of one device batch, step by step (ms, the second of
    two passes): the former path (``moved``: one copy a lane, then
    Arrow), then the packed fetch's steps: K9 and the stats read, the
    plan and K10, the copy into the pinned staging buffer, the host
    rebuild and Arrow.  Returns (ms by step, packed bytes, plan)."""
    host = torch.device("cpu")
    n = batch.num_rows
    for _ in range(2):
        ms, st = {}, {}

        def pack():
            st["plan"], st["mins"] = fetch.build_plan(st["lanes"],
                                                      st["stats"])
            st["slices"], st["total"] = fetch.layout(st["lanes"],
                                                     st["plan"], n)
            st["packed"] = fetch.pack_lanes(st["lanes"], st["plan"],
                                            st["mins"], n)

        def copy():
            buf = fetch.staging_buffer(batch.device, st["total"])
            buf[:st["total"]].copy_(st["packed"], non_blocking=True)
            torch.cuda.synchronize()
            st["host"] = buf

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for name, step in (
                ("moved", lambda: batch_to_arrow(move_batch(
                    batch, host, live_only=True))),
                ("stats_read", lambda: st.update(
                    lanes=fetch.batch_lanes(batch),
                    stats=fetch.lane_stats(fetch.batch_lanes(batch),
                                           n).tolist())),
                ("K10", pack),
                ("copy", copy),
                ("rebuild", lambda: st.update(out=fetch.rebuild_batch(
                    batch, st["lanes"], st["plan"], st["mins"], st["stats"],
                    st["slices"], st["host"], n))),
                ("arrow", lambda: batch_to_arrow(st["out"]))):
            step()
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms[name] = (now - t1) * 1e3
            t1 = now
    return ms, st["total"], st["plan"]


def _split_line(ms):
    fetched = sum(v for k, v in ms.items() if k != "moved")
    return (" ".join(f"{k}={v:.2f}" for k, v in ms.items())
            + f" (packed fetch {fetched:.2f} against {ms['moved']:.2f})")


def _close(torch, a, b, rtol):
    """Float lanes equal to a relative ``rtol`` (of at least 1)."""
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.ones_like(a))
    return bool(((a - b).abs() <= rtol * scale).all())


def _same_scan(torch, got, want, what):
    """K11's result against its plain version's: positions, counts and
    int64 sums exactly, float64 sums to FLOAT_RTOL."""
    for name in ("seg_start", "run_start", "runs_cum"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and
                                          not torch.equal(a, b)):
            raise AssertionError(f"K11 {name} differs {what}")
    for i, (a, b) in enumerate(zip(got.counts, want.counts)):
        if not torch.equal(a, b):
            raise AssertionError(f"K11 count {i} differs {what}")
    err = 0.0
    for i, (a, b) in enumerate(zip(got.sums, want.sums)):
        if (a is None) != (b is None):
            raise AssertionError(f"K11 sum {i} given and missing {what}")
        if a is None:
            continue
        if a.dtype == torch.float64:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
            if not _close(torch, a, b, FLOAT_RTOL):
                raise AssertionError(f"K11 float sum {i} differs {what}")
        elif not torch.equal(a, b):
            raise AssertionError(f"K11 int sum {i} differs {what}")
    return err


def _window_flags(torch, dev, kind, n, seed):
    """Sorted-row flags for K11 and K12: (new_seg, new_run, n_live)."""
    gen = torch.Generator().manual_seed(seed)
    n_live = n
    rand = torch.rand(n, generator=gen)
    if kind == "one partition":            # spans every tile
        seg = torch.zeros(n, dtype=torch.bool)
        run = rand < 0.3
    elif kind == "all tied":               # one partition, one run
        seg = torch.zeros(n, dtype=torch.bool)
        run = seg.clone()
    elif kind == "own partitions":         # every row its own
        seg = torch.ones(n, dtype=torch.bool)
        run = seg.clone()
    else:
        seg = rand < 0.001
        run = seg | (torch.rand(n, generator=gen) < 0.3)
        if kind == "padded":               # padding rows at the tail
            n_live = n - n // 3 - 1
            seg[n_live:] = False
            run[n_live:] = False
    seg[0] = run[0] = n_live > 0
    return seg.to(dev), run.to(dev), n_live


def _window_kernel_cases(torch, dev, scan, gather):
    """K11, K12 and K13 against their plain versions on the edge cases:
    n = 1, n on either side of K11's tiles (2,048 rows with three or four
    pairs, 4,096 with two, 8,192 with one) and of K12's (8,192), one
    partition over every tile (2^22 rows, and at the tile edges), every
    row tied in one run, every row its own partition (also at the tile
    edges), padding rows at the tail, one to five pairs (more than a K11
    launch takes); K12 with its rows and its live rows on either side of
    a tile edge.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = 0
    edges = [n for t in (2048, 4096, 8192) for n in (t - 1, t + 1)]
    for kind, n in [("random", 1), ("random", 3 * 2048 + 5),
                    ("one partition", 1 << 22), ("all tied", 100_003),
                    ("own partitions", 100_003), ("padded", 100_003),
                    ("padded", 2048), ("random", 1 << 20)] + [
                        (k, n) for n in edges + [16_385]
                        for k in ("one partition", "own partitions")]:
        seg, run, n_live = _window_flags(torch, dev, kind, n, n + cases)
        live = torch.arange(n, device=dev) < n_live
        valid = (torch.rand(n, generator=gen, device=dev) < 0.9) & live
        ints = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev)
        floats = torch.rand(n, generator=gen, device=dev,
                            dtype=torch.float64) * 1e3
        what = f"({kind}, n={n})"
        for pairs, kw in (
                ([(ints, valid), (floats, valid), (None, valid)],
                 dict(run_start=True, runs_cum=True)),
                ([(ints, valid)], {}),
                ([(floats, valid), (ints, valid)],
                 dict(run_start=True)),
                ([(ints, valid)] * 3 + [(floats, valid), (None, valid)],
                 dict(runs_cum=True))):
            before = scan.segment_scan.launches
            got = scan.segment_scan(seg, run, pairs, **kw)
            if scan.segment_scan.launches - before != -(-len(pairs) // 4):
                raise AssertionError(f"K11 launches {what}")
            _same_scan(torch, got, scan.segment_scan_plain(seg, run, pairs,
                                                           **kw), what)
        for flags in ((seg, run), (None, run), (seg, None)):
            got = scan.run_ends(*flags, n_live)
            want = scan.run_ends_plain(*flags, n_live)
            for a, b in zip(got, want):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"K12 differs {what}")
        order = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        lanes = [ints, floats, valid, ints.to(torch.int32)]
        got = gather.scatter_rows(order, lanes)
        if not _same_lanes(torch, got,
                           gather.scatter_rows_plain(order, lanes)) or \
                not _same_lanes(torch, gather.gather_rows(order, got), lanes):
            raise AssertionError(f"K13 differs {what}")
        cases += 1
    # K12 at its 8,192-row tiles (taken from the array's end): the rows
    # and the live rows on either side of a tile edge
    for n in (8191, 8192, 8193, 16_384, 16_385, 3 * 8192 + 7):
        for n_live in sorted({n, n - 1, 8191, 8192, 8193, 16_384} &
                             set(range(1, n + 1))):
            seg, run, _ = _window_flags(torch, dev, "random", n, n + n_live)
            seg[n_live:] = False
            run[n_live:] = False
            for flags in ((seg, run), (None, run), (seg, None)):
                got = scan.run_ends(*flags, n_live)
                want = scan.run_ends_plain(*flags, n_live)
                for a, b in zip(got, want):
                    if (a is None) != (b is None) or (
                            a is not None and not torch.equal(a, b)):
                        raise AssertionError(
                            f"K12 differs at n={n}, n_live={n_live}")
            cases += 1
    return cases


K13_BINNED_FROM = (48 << 20) // 13 + 1  # q4's 13 B of lanes: binned from here


def _k13_cases(torch, dev, gather):
    """K13 on both of its paths (and the one its plan picks) against its
    plain version: n = 1, 255-257, either side of a bucket (512 / 513:
    the shift grows; 2^20 / 2^20 + 1) and of a 3,072-row tile, either
    side of the single-pass window at q4's lanes; random, identity and
    reversed orders; q4's lanes (int32, int64, bool), one int32 lane and
    16 mixed 1-, 4- and 8-byte lanes.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cases = 0
    for n in (1, 255, 256, 257, 512, 513, 3071, 3072, 3073, 1 << 20,
              (1 << 20) + 1, K13_BINNED_FROM - 1, K13_BINNED_FROM):
        for kind in ("random", "identity", "reversed"):
            if kind == "random":
                order = torch.randperm(n, generator=gen, device=dev)
            elif kind == "identity":
                order = torch.arange(n, device=dev)
            else:
                order = torch.arange(n - 1, -1, -1, device=dev)
            order = order.to(torch.int32)
            for widths in ((4, 8, 1), (4,), (1, 4, 8, 8, 4, 1) * 2 +
                           (8, 1, 4, 8)):
                lanes = _row_lanes(torch, gen, dev, n, widths)
                want = gather.scatter_rows_plain(order, lanes)
                for binned in (None, False, True):
                    before = gather.scatter_rows.launches
                    got = gather.scatter_rows(order, lanes, binned=binned)
                    if gather.scatter_rows.launches - before != 1:
                        raise AssertionError("K13 launches")
                    if not _same_lanes(torch, got, want):
                        raise AssertionError(
                            f"K13 differs (n={n}, {kind}, {len(widths)} "
                            f"lanes, binned={binned})")
                cases += 1
    return cases


def _k16_cases(torch, dev, sops):
    """K16's two launches against the plain versions bit for bit, at
    three caps (the total, 5 past it, three stretches and 7 bytes past
    it: the zero tail and a partial last chunk): every source alignment
    0-15 for rows of 1-40 bytes, rows of exactly 16 bytes, 100-byte rows
    (stretches end mid-row), a 1 MB row straddling 256 stretches, a run
    of 29,900 invalid slots (staged over several rounds), one-byte flags
    through a kept index, and n = 1.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def column(lens):
        offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=offs[1:])
        chars = torch.randint(0, 256, (max(int(offs[-1]), 1),),
                              generator=gen, device=dev, dtype=torch.uint8)
        return offs.to(torch.int32), chars

    def check(lens, idx, ok, what):
        offs, chars = column(lens)
        o, t, st = sops.gather_offsets(offs, idx, ok)
        o_p, t_p = sops.gather_offsets_plain(offs, idx, ok)
        if not (torch.equal(o, o_p) and torch.equal(t, t_p) and torch.equal(
                st, sops.span_starts_plain(offs, idx, ok))):
            raise AssertionError(f"K16's offsets differ ({what})")
        total = int(t)
        for cap in sorted({max(total, 1), total + 5, total + 3 * 4096 + 7}):
            got = sops.gather_chars(chars, st, o, total, cap)
            if not torch.equal(got, sops.gather_chars_plain(
                    offs, chars, idx, o_p, cap)):
                raise AssertionError(f"K16's copy differs ({what}, cap "
                                     f"{cap}, {total} bytes)")

    def rand_idx(rows, n):
        return torch.randint(0, rows, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)
    cases = 0
    for width in (1, 3, 7, 8, 15, 16, 17, 31, 40):
        for align in range(16):
            lens = torch.full((300,), width, dtype=torch.int64, device=dev)
            lens[0] = align      # every later row's source moves by align
            check(lens, rand_idx(300, 500),
                  torch.rand(500, generator=gen, device=dev) < 0.9,
                  f"{width}-byte rows, sources at {align} mod 16")
            cases += 1
    check(torch.full((10000,), 16, dtype=torch.int64, device=dev),
          torch.arange(10000, dtype=torch.int32, device=dev), ones(10000),
          "16-byte rows")
    check(torch.full((5000,), 100, dtype=torch.int64, device=dev),
          rand_idx(5000, 7000), ones(7000), "100-byte rows")
    lens = torch.randint(0, 30, (3000,), generator=gen, device=dev)
    lens[1234] = MB_STRING
    idx = rand_idx(3000, 4000)
    idx[::500] = 1234
    check(lens, idx, ones(4000), "a 1 MB row, 8 times")
    ok = ones(50000)
    ok[100:30000] = False
    check(torch.randint(1, 5, (50000,), generator=gen, device=dev),
          rand_idx(50000, 50000), ok, "a run of invalid slots")
    kept = (torch.rand(100000, generator=gen, device=dev) < 0.98).nonzero(
    ).flatten().to(torch.int32)
    flags = torch.ones(100000, dtype=torch.int64, device=dev)
    check(flags, kept, ones(kept.shape[0]), "one-byte flags")
    check(flags, kept[:1], ones(1), "n = 1")
    return cases + 6


def _q4_layout(torch, window_mod, EvalContext, wexec, batch):
    """The q4 WindowExec's sorted layout of ``batch``, with K11's and
    K12's results as the main path computes them, and the result lanes
    that K13 moves (rn, rs and rs's validity: rn's is the live mask).
    Returns (layout, K11 pairs, result lanes)."""
    ctx = EvalContext(batch)
    g_inputs, members = [], []
    for w in wexec.window_exprs:
        cols = [window_mod._eval_col(ctx, e) for e in wexec._input_exprs(w)]
        members.append((w, len(g_inputs), len(cols)))
        g_inputs += cols
    lay = wexec._build_layout(batch, ctx, wexec.window_exprs[0].spec,
                              g_inputs, carry_okeys=False)
    pair_of = wexec._scan(lay, members)
    lanes = []
    for w, s, c in members:
        d, v = wexec._compute_one(batch, w, lay, lay.input_sorted[s:s + c],
                                  pair_of)
        lanes += [d] if v is lay.live_s else [d, v]
    pairs = [(lay.input_sorted[0].data,
              lay.input_sorted[0].validity & lay.live_s)]
    return lay, pairs, lanes


def _q4_oracle(table):
    """q4's rn and rs in input order: a stable lexsort by (k, v);
    row_number the position within k plus one; the running sum within k
    read at the end of each (k, v) run.  Returns (rn, rs, tied rows,
    partitions)."""
    k, v = table["k"].to_numpy(), table["v"].to_numpy()
    n = len(k)
    # one stable argsort of (k, v) packed into one word: k below 2^20 and
    # v within +-2^20 (bench's ranges), checked
    if k.min() < 0 or k.max() >= 1 << 20 or np.abs(v).max() >= 1 << 20:
        raise AssertionError("q4 oracle: k or v outside its packing range")
    o = np.argsort((k << 21) | (v + (1 << 20)), kind="stable")
    ks, vs = k[o], v[o]
    pos = np.arange(n)
    new_k = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(new_k, pos, 0))
    cs = np.cumsum(vs)
    run = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    new_run = new_k | np.r_[True, vs[1:] != vs[:-1]]
    ends = np.where(np.r_[new_run[1:], True], pos, n)
    end = np.minimum.accumulate(ends[::-1])[::-1]
    rn, rs = np.empty(n, np.int32), np.empty(n, np.int64)
    rn[o] = pos - start + 1
    rs[o] = run[end]
    # rows tied with the row before on (k, v), and the partitions
    return rn, rs, int(np.sum(~new_run)), int(new_k.sum())


def _check_q4(got, table, rn, rs, what):
    if got.column_names != ["k", "v", "rn", "rs"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != table.num_rows or got.column("rn").null_count or \
            got.column("rs").null_count:
        raise AssertionError(f"{what}: {got.num_rows} rows or nulls")
    for name, want in (("k", table["k"].to_numpy()),
                       ("v", table["v"].to_numpy()), ("rn", rn),
                       ("rs", rs)):
        if not np.array_equal(got.column(name).to_numpy(), want):
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"numpy oracle")


def _window_oracle_table(n):
    """The CPU-engine window check's table: nulls in the partition key,
    the order key and the values, a float column."""
    rng = np.random.default_rng(SEED + 10)
    return pa.table({
        "k": pa.array(rng.integers(0, 2000, n).astype(np.int64),
                      mask=rng.random(n) < 0.02),
        "o": pa.array(rng.integers(-500, 500, n).astype(np.int64),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-(10**6), 10**6, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.random(n)),
    })


def _window_oracle_query(df, F, col, W):
    """Every window function of the slice over three specs: ranks, lead
    and lag, whole-partition sum and avg, bounded ROWS and RANGE sums,
    counts, min and max, a descending order."""
    w = W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
    wd = W.WindowBuilder().partition_by(col("k")).order_by(
        col("o").desc(), col("f"))
    whole = W.WindowBuilder().partition_by(col("k"))
    rows = (W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
            .rows_between(-3, 2))
    rng = (W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
           .range_between(-20, 10))
    return df.select(
        col("k"), col("o"), col("v"), col("f"),
        F.rank().over(w).alias("rk"), F.dense_rank().over(w).alias("drk"),
        F.percent_rank().over(w).alias("pr"),
        F.cume_dist().over(w).alias("cd"), F.ntile(4).over(w).alias("nt"),
        F.lead(col("v")).over(wd).alias("ld"),
        F.lag(col("f"), 2).over(wd).alias("lg"),
        F.row_number().over(wd).alias("rnd"),
        F.sum(col("v")).over(whole).alias("ts"),
        F.avg(col("f")).over(whole).alias("ta"),
        F.sum(col("v")).over(rows).alias("rws"),
        F.count(col("v")).over(rows).alias("rwc"),
        F.max(col("f")).over(rows).alias("rwx"),
        F.sum(col("v")).over(rng).alias("rgs"),
        F.count(col("v")).over(rng).alias("rgc"),
        F.min(col("v")).over(rng).alias("rgn"),
        F.max(col("v")).over(rng).alias("rgx"))


def _same_window_tables(got, want):
    """Column by column: everything but doubles exactly, doubles to
    FLOAT_RTOL; the same nulls."""
    if got.column_names != want.column_names or got.num_rows != want.num_rows:
        return False
    for c in want.column_names:
        a, b = got[c].combine_chunks(), want[c].combine_chunks()
        if not a.is_valid().equals(b.is_valid()):
            return False
        if pa.types.is_floating(a.type):
            x = a.fill_null(0).to_numpy()
            y = b.fill_null(0).to_numpy()
            if not np.allclose(x, y, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
                return False
        elif not a.equals(b):
            return False
    return True


def _q1x_df(session, table, parts, F, col, lit):
    """The TPC-H Q1 shape on the fact table: a filter on f and v, a
    projection with a remainder, CASE WHEN and Q1's price arithmetic,
    then by (rf, ls): three sums, two averages, count(*), and the min and
    max of disc and v, sorted."""
    fact = session.create_dataframe(table, num_partitions=parts)
    return (fact.filter((col("f") <= 0.98) & col("v").is_not_null())
            .select((col("k") % 3).alias("rf"),
                    F.when(col("v") > 0, lit(1)).otherwise(lit(0))
                    .alias("ls"),
                    col("v"), col("f"),
                    (col("v") * (lit(1.0) - col("f"))).alias("disc"),
                    (col("v") * (lit(1.0) - col("f"))
                     * (lit(1.0) + col("f") / lit(10))).alias("charge"))
            .group_by("rf", "ls")
            .agg(F.sum("v"), F.sum("disc"), F.sum("charge"), F.avg("v"),
                 F.avg("f"), F.count("*"), F.min("disc"), F.max("disc"),
                 F.min("v"), F.max("v"))
            .sort("rf", "ls"))


def _q1x_oracle(table):
    """q1x in numpy: per (rf, ls) in order, the ten aggregates."""
    k = table["k"].to_numpy()
    v = table["v"].to_numpy()
    f = table["f"].to_numpy()
    keep = f <= 0.98
    k, v, f = k[keep], v[keep], f[keep]
    disc = v.astype(np.float64) * (1.0 - f)
    charge = disc * (1.0 + f / 10.0)
    gid = (k % 3) * 2 + (v > 0)
    rows = []
    for g in range(6):
        m = gid == g
        vv, dd = v[m], disc[m]
        rows.append(dict(rf=g // 2, ls=g % 2, sv=int(vv.sum()),
                         sd=float(dd.sum()), sc=float(charge[m].sum()),
                         av=float(vv.sum()) / len(vv), af=float(f[m].mean()),
                         c=int(m.sum()), mind=float(dd.min()),
                         maxd=float(dd.max()), minv=int(vv.min()),
                         maxv=int(vv.max())))
    return rows


def _check_q1x(got, want, what):
    """Keys, integer sums, counts and every min and max exactly (doubles
    by bits); float sums and averages to FLOAT_RTOL."""
    if got.num_rows != len(want):
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{len(want)}")
    cols = got.columns
    names = ["rf", "ls", "sv", "sd", "sc", "av", "af", "c", "mind", "maxd",
             "minv", "maxv"]
    exact = {"rf", "ls", "sv", "c", "minv", "maxv", "mind", "maxd"}
    for i, name in enumerate(names):
        mine = cols[i].to_pylist()
        theirs = [r[name] for r in want]
        if name in exact:
            if mine != theirs or (name in ("mind", "maxd") and [
                    np.float64(x).view(np.int64) for x in mine] != [
                    np.float64(x).view(np.int64) for x in theirs]):
                raise AssertionError(f"{what}: column {name} "
                                     f"({got.column_names[i]}) {mine} vs "
                                     f"{theirs}")
        elif not np.allclose(mine, theirs, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"{what}: column {name} differs by up to "
                                 f"{np.max(np.abs(np.subtract(mine, theirs)))}")


CATALOGUE_ROWS = 1 << 20


def _catalogue_table(n):
    """Columns for every new expression: a, b LONG with INT64_MIN, -1 and
    0 divisors; i INT with INT32_MIN; d, e DOUBLE with NaN, +-inf, -0.0,
    1e19 and 9.3e18; x BOOLEAN; nulls in each."""
    rng = np.random.default_rng(SEED + 21)

    def mask(p=0.05):
        return rng.random(n) < p
    a = rng.integers(-(10**12), 10**12, n)
    a[rng.random(n) < 0.05] = -2**63
    b = rng.integers(-4, 5, n)
    b[rng.random(n) < 0.05] = -2**63
    i = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    i[rng.random(n) < 0.03] = -2**31
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e19, -1e19,
                         9.3e18, 0.5, -0.5, 2.5, -2.5])
    d = rng.normal(0.0, 1e3, n)
    pick = rng.random(n) < 0.3
    d[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    e = rng.normal(0.0, 10.0, n)
    e[rng.random(n) < 0.05] = 0.0
    return pa.table({
        "a": pa.array(a, mask=mask()), "b": pa.array(b, mask=mask()),
        "i": pa.array(i, mask=mask()), "d": pa.array(d, mask=mask()),
        "e": pa.array(e, mask=mask()),
        "x": pa.array(rng.random(n) < 0.5, mask=mask())})


def _catalogue_columns(F, col, lit, ar, mx, cond, Column):
    """Every expression this port brings, over _catalogue_table."""
    def node(cls, *args):
        return Column(cls(*[a.expr for a in args]))
    a, b, i, d, e, x = (col(c) for c in "abidex")
    cols = {
        "add": a + b, "sub": i - b, "mul": a * b, "mul_d": d * e,
        "div": a / b, "div_d": d / e, "idiv": node(ar.IntegralDivide, a, b),
        "mod": a % b, "mod_i": i % b, "mod_d": d % e,
        "pmod": node(ar.Pmod, a, b), "pmod_d": node(ar.Pmod, d, e),
        "neg": -a, "pos": node(ar.UnaryPositive, i), "abs": F.abs(a),
        "abs_d": F.abs(d), "greatest": F.greatest(d, e, lit(0.0)),
        "least": F.least(a, b), "eqns": d.eq_null_safe(e),
        "isnull": d.is_null(), "isnotnull": a.is_not_null(),
        "isnan": F.isnan(d), "in": b.isin(1, -1, None),
        "in_d": d.isin(float("nan"), 0.0),
        "if": node(cond.If, x, a, b),
        "case": F.when(d > 0, d).when(x, lit(None)).otherwise(e),
        "coalesce": F.coalesce(d, e, lit(1.5)), "nvl": node(cond.Nvl, a, b),
        "nullif": node(cond.NullIf, b, lit(0)),
        "log": F.log(d), "log2": F.log2(e), "log10": F.log10(d),
        "log1p": F.log1p(e), "logb": F.log(e, d), "pow": F.pow(e, lit(3)),
        "atan2": F.atan2(d, e), "floor": F.floor(d), "ceil": F.ceil(d),
        "signum": F.signum(d), "round": F.round(d, 1),
        "round_i": F.round(i, -2), "bround": F.bround(d, 1),
        "d2l": d.cast("long"), "d2i": d.cast("int"), "l2i": a.cast("int"),
        "i2d": i.cast("double"), "b2l": x.cast("long"),
        "d2b": d.cast("boolean"), "n2i": lit(None).cast("int"),
    }
    for name in ("sqrt", "exp", "expm1", "sin", "cos", "tan", "cot", "asin",
                 "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
                 "atanh", "cbrt", "rint", "degrees", "radians"):
        cols[name] = getattr(F, name)(e)
    return [c.alias(name) for name, c in cols.items()]


def _same_catalogue(got, want, rtol):
    """The card's catalogue against the CPU's: integers and booleans
    exactly, doubles by bits or, for a finite pair, to ``rtol`` (libm's
    last bit may differ between the host and the card).  Returns (the
    columns that differ, the largest relative double difference)."""
    bad, worst = [], 0.0
    for name in want.column_names:
        g, w = got[name], want[name]
        if g.type != w.type or g.null_count != w.null_count or not \
                g.is_null().equals(w.is_null()):
            bad.append(name)
            continue
        gn = g.fill_null(False if pa.types.is_boolean(g.type) else 0) \
            .to_numpy()
        wn = w.fill_null(False if pa.types.is_boolean(w.type) else 0) \
            .to_numpy()
        if not pa.types.is_floating(g.type):
            if not np.array_equal(gn, wn):
                bad.append(name)
            continue
        same = gn.view(np.int64) == wn.view(np.int64)
        both_nan = np.isnan(gn) & np.isnan(wn)
        finite = np.isfinite(gn) & np.isfinite(wn)
        with np.errstate(invalid="ignore", over="ignore"):
            rel = np.abs(gn - wn) / np.maximum(np.abs(wn), 1e-300)
        close = finite & (rel <= rtol)
        if not np.all(same | both_nan | close):
            bad.append(name)
        if finite.any():
            worst = max(worst, float(np.max(np.where(finite, rel, 0.0))))
    return bad, worst


def _join_table_pairs(table, dim):
    """A 2^20-row fact slice and a dimension that misses a third of its
    keys and holds keys the fact does not."""
    fact = table.slice(0, 1 << 20).select(["k", "v"])
    keys = np.arange(33_000, 133_000, dtype=np.int64)
    rng = np.random.default_rng(SEED + 31)
    right = pa.table({"k": pa.array(keys),
                      "w": pa.array(rng.random(len(keys)))})
    return fact, right


def _sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


# ---------------------------------------------------------------------------
# the string phase: columns, queries, oracles and kernel cases
# ---------------------------------------------------------------------------

STRING_SMALL = 1 << 20     # rows of the string checks after qs1-qs4
MB_STRING = 1 << 20        # the long string among short ones


def _strings_from(lengths, chars, valid=None):
    """A large_string array from numpy lengths and bytes, through Arrow's
    buffers (no Python str objects); ``valid`` marks the non-null rows."""
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    bitmap = None if valid is None else pa.py_buffer(
        np.packbits(valid, bitorder="little"))
    return pa.LargeStringArray.from_buffers(
        len(lengths), pa.py_buffer(offs), pa.py_buffer(chars), bitmap,
        0 if valid is None else int((~valid).sum()))


def _customer_names(keys):
    """TPC-H c_name, "Customer#%09d" % key: 18 bytes a row."""
    n = len(keys)
    out = np.empty((n, 18), dtype=np.uint8)
    out[:, :9] = np.frombuffer(b"Customer#", dtype=np.uint8)
    k = keys.astype(np.int64)
    for d in range(9):
        out[:, 17 - d] = ord("0") + (k // 10**d) % 10
    return _strings_from(np.full(n, 18, np.int64), out.reshape(-1))


def _one_byte(codes, letters):
    """One letter a row: ``letters[codes[i]]``."""
    chars = np.frombuffer(letters, dtype=np.uint8)[codes]
    return _strings_from(np.ones(len(codes), np.int64), chars)


def _comments(rng, n):
    """TPC-H l_comment-sized text: 10-43 random lowercase bytes a row, 5 %
    of the rows null (empty), 1 % with a two-byte UTF-8 letter (é) at the
    start of the row."""
    lengths = rng.integers(10, 44, n)
    valid = rng.random(n) >= 0.05
    lengths = np.where(valid, lengths, 0)
    chars = rng.integers(ord("a"), ord("z") + 1, int(lengths.sum()),
                         dtype=np.uint8)
    starts = np.cumsum(lengths) - lengths
    accent = valid & (rng.random(n) < 0.01)
    chars[starts[accent]] = 0xC3
    chars[starts[accent] + 1] = 0xA9
    return _strings_from(lengths, chars, valid)


def _string_tables(table, dim):
    """bench's fact and dimension with the string columns: s (c_name of
    the key: 100,000 distinct, FK into the dimension's PK), rf and ls
    (TPC-H Q1's flags, "ARN"[k % 3] and "FO"[v > 0]) and c (a comment);
    the fact also gets its row id."""
    k = table["k"].to_numpy()
    v = table["v"].to_numpy()
    rng = np.random.default_rng(SEED)
    fact = pa.table({
        "id": pa.array(np.arange(len(k), dtype=np.int64)),
        "k": table["k"], "v": table["v"], "f": table["f"],
        "s": _customer_names(k),
        "rf": _one_byte(k % 3, b"ARN"),
        "ls": _one_byte((v > 0).astype(np.int64), b"FO"),
        "c": _comments(rng, len(k))})
    dk = dim["k"].to_numpy()
    sdim = pa.table({"s": _customer_names(dk), "w": dim["w"]})
    return fact, sdim


def _qs1_df(session, fact, parts, F, col, lit):
    """q1x grouped by the string flags rf and ls, then sorted."""
    df = session.create_dataframe(fact.select(["rf", "ls", "v", "f"]),
                                  num_partitions=parts)
    return (df.filter((col("f") <= 0.98) & col("v").is_not_null())
            .select(col("rf"), col("ls"), col("v"), col("f"),
                    (col("v") * (lit(1.0) - col("f"))).alias("disc"),
                    (col("v") * (lit(1.0) - col("f"))
                     * (lit(1.0) + col("f") / lit(10))).alias("charge"))
            .group_by("rf", "ls")
            .agg(F.sum("v"), F.sum("disc"), F.sum("charge"), F.avg("v"),
                 F.avg("f"), F.count("*"), F.min("disc"), F.max("disc"),
                 F.min("v"), F.max("v"))
            .sort("rf", "ls"))


def _qs1_oracle(q1x_rows):
    """q1x's numpy oracle under the flags' mapping, in the flags' order."""
    rows = [dict(r, rf="ARN"[r["rf"]], ls="FO"[r["ls"]]) for r in q1x_rows]
    return sorted(rows, key=lambda r: (r["rf"], r["ls"]))


def _qs2_df(session, fact, F, col):
    """q1 keyed by the customer name s."""
    return (session.create_dataframe(fact.select(["s", "v", "f"]))
            .filter(col("v") > THRESHOLD)
            .group_by(col("s"))
            .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                 F.count("*").alias("c")))


def _qs2_oracle(fact):
    ft = fact.filter(pc.greater(fact["v"], THRESHOLD))
    return ft.group_by("s").aggregate(
        [("v", "sum"), ("f", "mean"), ("s", "count")]).sort_by("s")


def _check_qs2(got, want, what):
    got = got.sort_by("s")
    if got.column_names != ["s", "sv", "af", "c"] or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.column_names}, {got.num_rows} "
                             f"groups, oracle {want.num_rows}")
    for mine, theirs in (("s", "s"), ("sv", "v_sum"), ("c", "s_count")):
        if not got[mine].combine_chunks().equals(
                want[theirs].combine_chunks()):
            raise AssertionError(f"{what}: column {mine} differs")
    af, wf = got["af"].to_numpy(), want["f_mean"].to_numpy()
    if not np.allclose(af, wf, rtol=FLOAT_RTOL, atol=0.0):
        raise AssertionError(f"{what}: avg differs")


def _qs3_df(session, fact, sdim):
    """The fact joined to the dimension on the customer name (FK -> PK),
    the comment c riding along on the probe side."""
    return session.create_dataframe(fact.select(["id", "s", "c"])).join(
        session.create_dataframe(sdim), on="s", how="inner")


def _by_id(t):
    ids = t["id"].to_numpy()
    return t.take(pa.array(np.argsort(ids, kind="stable")))


def _qs4_df(session, fact, col):
    """q3 keyed by (s, v), carrying the comment."""
    return session.create_dataframe(fact.select(["s", "v", "c"])).sort(
        col("s"), col("v"))


def _same_strings_table(got, want):
    """Equal column by column, strings byte for byte."""
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        return False
    return all(got[c].combine_chunks().equals(want[c].combine_chunks())
               for c in want.column_names)


def _string_edge_arrays(rng):
    """Edge cases for K14-K17, each an Arrow string array."""
    def rand(n, lo=0, hi=20, p_null=0.1):
        lengths = rng.integers(lo, hi + 1, n)
        valid = rng.random(n) >= p_null
        lengths = np.where(valid, lengths, 0)
        chars = rng.integers(ord("a"), ord("z") + 1, int(lengths.sum()),
                             dtype=np.uint8)
        return _strings_from(lengths, chars, valid)
    shared = np.frombuffer(b"q" * 40, dtype=np.uint8)
    sp_len = np.array([41, 41, 40, 33, 32, 45])
    sp_chars = np.concatenate([np.concatenate([shared, np.frombuffer(
        bytes([97 + i]) * (L - 40), dtype=np.uint8)]) if L > 40 else
        shared[:L] for i, L in enumerate(sp_len)])
    utf = "é中\U0001F600".encode("utf-8")
    mb_len = np.full(300, len(utf), np.int64)
    long_len = rng.integers(0, 30, 2000)
    long_len[777] = MB_STRING
    long_chars = rng.integers(0, 256, int(long_len.sum()), dtype=np.uint8)
    return {
        "0 rows": _strings_from(np.zeros(0, np.int64),
                                np.zeros(0, np.uint8)),
        "all empty": _strings_from(np.zeros(5000, np.int64),
                                   np.zeros(0, np.uint8)),
        "all null": _strings_from(np.zeros(3000, np.int64),
                                  np.zeros(0, np.uint8),
                                  np.zeros(3000, dtype=bool)),
        "1 MB among short": _strings_from(long_len, long_chars),
        "32+ bytes shared": _strings_from(sp_len, sp_chars),
        "multi-byte": _strings_from(mb_len, np.tile(np.frombuffer(
            utf, dtype=np.uint8), 300)),
        "255 rows": rand(255), "256 rows": rand(256), "257 rows": rand(257),
        "4095 rows": rand(4095, 0, 90), "4096 rows": rand(4096, 0, 90),
        "4097 rows": rand(4097, 0, 90), "9000 rows, 70 B": rand(9000, 60, 80),
    }


def _string_kernel_check(torch, sops, hashfns, offsets, chars, rng, what,
                         n_out=None):
    """K14, K15, K16 and K17 on one span column, each against its plain
    version bit for bit; K16 over a random selection with invalid slots.
    Returns the number of checks."""
    cap = int(offsets.shape[0]) - 1
    got = sops.string_hashes(offsets, chars, join_word=True)
    want = sops.string_hashes_plain(offsets, chars, join_word=True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K14 differs from its plain version ({what})")
    got, want = sops.order_keys(offsets, chars), \
        sops.order_keys_plain(offsets, chars)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K17 differs from its plain version ({what})")
    seed = torch.from_numpy(rng.integers(0, 2**32, cap, dtype=np.int64)
                            ).to(offsets.device)
    valid = torch.from_numpy(rng.random(cap) < 0.9).to(offsets.device)
    got = hashfns.hash_bytes(offsets, chars, seed, valid)
    want = hashfns.hash_bytes_plain(offsets, chars, seed, valid)
    if not torch.equal(got, want):
        raise AssertionError(f"K15 differs from its plain version ({what})")
    m = n_out if n_out is not None else max(cap, 1) + 37
    idx = torch.from_numpy(rng.integers(-3, max(cap, 1) + 3, m
                                        ).astype(np.int32)).to(offsets.device)
    ok = torch.from_numpy(rng.random(m) < 0.8).to(offsets.device)
    ok &= (idx >= 0) & (idx < cap)       # an invalid slot: out of range too
    got = sops.gather_strings(offsets, chars, idx, ok)
    o, total = sops.gather_offsets_plain(offsets, idx, ok)
    want = (o, sops.gather_chars_plain(offsets, chars, idx, o,
                                       int(got[1].shape[0])))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K16 differs from its plain version ({what})")
    return 4


def _check_string_captured(torch, cap, sops, hashfns, what):
    """Every call a string path made of K14, K15, K16 or K17, run again
    through the kernel and its plain version, bit for bit."""
    seen = []
    for name, args in cap.calls:
        got = cap.orig[name](*args)
        if name == "string_hashes":
            want = sops.string_hashes_plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "order_keys":
            want = sops.order_keys_plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "gather_offsets":
            want = sops.gather_offsets_plain(*args) + (
                sops.span_starts_plain(*args),)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "gather_chars":
            want = sops.copy_spans_plain(*args[:3], args[4])
            same = torch.equal(got, want)
        else:
            want = hashfns.hash_bytes_plain(*args)
            same = torch.equal(got, want)
        rows = int(args[0].shape[0]) - 1 if name != "gather_chars" else \
            int(args[1].shape[0])
        if not same:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {what} ({rows} rows)")
        seen.append(f"{name} ({rows} rows)")
        del got, want
    if not seen:
        raise AssertionError(f"{what} made no call to capture")
    return seen


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "spark_rapids_tpu_torch")):
        print("chip_smoke: the spark_rapids_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import Column, col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.columnar import fetch
    from spark_rapids_tpu_torch.columnar.device import (DEFAULT_CHAR_BUCKETS,
                                                        DeviceBatch,
                                                        DeviceColumn,
                                                        batch_to_arrow,
                                                        batch_to_device,
                                                        bucket_for,
                                                        move_batch)
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec import basic as basic_mod
    from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
    from spark_rapids_tpu_torch.exec.filter_common import keep_flags
    from spark_rapids_tpu_torch.expr.aggregates import (
        COMPLETE, AggregateExpression, Average, Count, Sum)
    from spark_rapids_tpu_torch.expr.core import AttributeReference as A
    from spark_rapids_tpu_torch.expr.core import EvalContext
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.exec import window as window_mod
    from spark_rapids_tpu_torch.expr import arithmetic as ar_mod
    from spark_rapids_tpu_torch.expr import conditional as cond_mod
    from spark_rapids_tpu_torch.expr import mathexpr as mx_mod
    from spark_rapids_tpu_torch.expr import window as W
    from spark_rapids_tpu_torch.io import scan as io_scan
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import gather as gather_mod
    from spark_rapids_tpu_torch.ops import join_kernels as jk
    from spark_rapids_tpu_torch.ops import scan as scan_mod
    from spark_rapids_tpu_torch.ops import segmented as seg
    from spark_rapids_tpu_torch.ops import strings as sops
    from spark_rapids_tpu_torch.expr import hashfns as hashfns_mod
    from spark_rapids_tpu_torch.plan import host_assist

    dev = torch.device("cuda")
    host = torch.device("cpu")
    failures = []
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.get_num_threads()} host threads")

    t0 = time.perf_counter()
    secs = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in kernels.SOURCES:
        log = kernels.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    table, dim = _make_tables(ROWS)
    want = _oracle(table)
    t1 = time.perf_counter()
    joined = table.join(dim, "k", join_type="inner")
    q2_want = joined.group_by("k").aggregate([("w", "sum")]).sort_by("k")
    print(f"pyarrow q2 oracle: {joined.num_rows} joined rows, "
          f"{q2_want.num_rows} groups, {time.perf_counter() - t1:.1f} s")
    filt_expr = (col("v") > THRESHOLD).expr
    aggs = [AggregateExpression(Sum(A("v")), "sv"),
            AggregateExpression(Average(A("f")), "af"),
            AggregateExpression(Count(None), "c")]

    # ---- kernel phase: each kernel against its plain version ----------
    kernel_rows = {}
    try:
        scan = LocalScanExec(table)
        filt = FilterExec(filt_expr, scan)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE, filt)
        batch = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        cap = batch.capacity
        keep = keep_flags(batch, filt._bound.eval(EvalContext(batch)))
        lanes, clear = [], []
        for c in batch.columns:
            lanes += [c.data, c.validity]
            clear += [False, True]
        outs, n_kept = carry.compact_lanes(keep, lanes, clear)
        outs_p, n_plain = carry.compact_lanes_plain(keep, lanes, clear)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(outs, outs_p))
        if n_kept != n_plain or not all(torch.equal(a, b)
                                        for a, b in zip(outs, outs_p)):
            raise AssertionError(f"K1 differs from its plain version "
                                 f"(kept {n_kept} vs {n_plain})")
        lane_bytes = sum(x.element_size() for x in lanes) * cap
        kernel_rows["compact_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/compact.cu",
            replaces="spark_rapids_tpu/ops/carry.py:151",
            max_abs_err=err,
            ms=cuda_ms(lambda: carry.compact_lanes(keep, lanes, clear)),
            plain_ms=cuda_ms(lambda: carry.compact_lanes_plain(keep, lanes,
                                                               clear)),
            library_ms=cuda_ms(lambda: [x[keep] for x in lanes]),
            bound_ms=bound(cap + 2 * lane_bytes))
        print(f"K1 compact_rows: rows {cap}, kept {n_kept}, exact")

        filtered = filt._compute(batch)
        n = filtered.num_rows
        key_cols, val_cols = agg._update_columns(filtered)
        words = seg.key_words_for_column(agg_mod._prefix(key_cols[0], n))
        order = carry.sort_order(words)
        order_p = carry.sort_order_plain(words)
        if not torch.equal(order, order_p):
            raise AssertionError("K2 differs from its plain version")
        k2_passes = _k2_passes(carry, words)
        kernel_rows["sort_order"] = dict(
            source="spark_rapids_tpu_torch/csrc/onesweep.cu",
            replaces="spark_rapids_tpu/ops/carry.py:80",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: carry.sort_order(words)),
            plain_ms=cuda_ms(lambda: carry.sort_order_plain(words)),
            # the null word is constant here: one stable sort of the value
            # word gives the same order
            library_ms=cuda_ms(lambda: torch.sort(words[-1], stable=True)),
            bound_ms=bound(8 * len(words) * n + 4 * n))
        print(f"K2 sort_order: rows {n}, words {len(words)}, passes "
              f"{k2_passes}, exact, "
              f"{kernel_rows['sort_order']['ms']:.3f} ms, library "
              f"{kernel_rows['sort_order']['library_ms']:.3f} ms")

        # K2 at the canonical merge's shape: the word list the 8-batch run
        # sorts once it has concatenated the batches' partial results
        merge_agg = GpuHashAggregateExec(
            [A("k")], aggs, COMPLETE,
            FilterExec(filt_expr, LocalScanExec(table,
                                                batch_rows=BATCH_ROWS)))
        merge_words = []
        canonical = merge_agg._canonical_order

        def capture(b):
            merge_words[:] = [w for c in b.columns for w in
                              seg.key_words_for_column(
                                  agg_mod._prefix(c, b.num_rows))]
            return canonical(b)

        merge_agg._canonical_order = capture
        merge_agg.execute_collect(ExecContext(dev))
        if not merge_words:
            raise AssertionError("the 8-batch run made no canonical merge")
        if not torch.equal(carry.sort_order(merge_words),
                           carry.sort_order_plain(merge_words)):
            raise AssertionError("K2 differs at the merge's shape")
        m_passes = _k2_passes(carry, merge_words)
        m_ms = cuda_ms(lambda: carry.sort_order(merge_words))
        m_plain = cuda_ms(lambda: carry.sort_order_plain(merge_words))
        print(f"K2 at the canonical merge's shape: rows "
              f"{merge_words[0].shape[0]}, words {len(merge_words)}, passes "
              f"{m_passes}, exact, {m_ms:.3f} ms, plain {m_plain:.3f} ms")
        del merge_agg, merge_words

        # K3 reads every lane in input order, through K2's order
        vals = [agg_mod._prefix(v, n) for v in val_cols]
        sum_lanes, contribs, _, _ = agg_mod.k3_ops(vals, agg._update_ops)
        k3_args = (words, None, sum_lanes, contribs, False, order)
        res = agg_mod.segment_reduce_sorted(*k3_args)
        k3_err = _k3_diff(torch, res, agg_mod.segment_reduce_sorted_plain(
            *k3_args), "at q1's shapes")
        groups = res[3]
        # group ids in input order, for the library yardstick: one
        # index_add_ of each float lane into its group
        sorted_ids = torch.cumsum(seg.segment_boundaries(
            [w.index_select(0, order) for w in words],
            torch.ones(n, dtype=torch.bool, device=dev)), 0) - 1
        ids = torch.empty_like(sorted_ids).index_put_(
            (order.long(),), sorted_ids)
        float_lanes = [x for x in sum_lanes
                       if x is not None and x.dtype == torch.float64]
        distinct = {x.data_ptr(): x for x in sum_lanes + contribs
                    if x is not None}
        in_bytes = (4 + 8 * len(words)) * n + sum(
            x.element_size() * n for x in distinct.values())
        out_bytes = groups * (4 + 8 * len(sum_lanes)
                              + 8 * sum(x is not None for x in sum_lanes))
        k3_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted(*k3_args))
        k3_extra = _k3_turns(torch, agg_mod, cuda_ms, k3_args, card,
                             "at q1's shapes")
        kernel_rows["segment_reduce_sorted"] = dict(
            source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
            replaces="spark_rapids_tpu/exec/aggregate.py:50",
            max_abs_err=k3_err,
            ms=k3_ms,
            plain_ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
                *k3_args)),
            library_ms=cuda_ms(lambda: [torch.zeros(
                groups, dtype=torch.float64, device=dev).index_add_(
                0, ids, x) for x in float_lanes]),
            bound_ms=bound(in_bytes + out_bytes), extra=k3_extra)
        print(f"K3 segment_reduce_sorted: rows {n}, groups {groups}, ints "
              f"exact, float max abs err {k3_err:.3g}, {k3_ms:.3f} ms, "
              f"bound {kernel_rows['segment_reduce_sorted']['bound_ms']:.3f}"
              f" ms ({in_bytes + out_bytes} bytes)")

        # a hot key: 40 % of the rows in one group
        gen = torch.Generator(device=dev).manual_seed(SEED)
        hot_keys = torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.4,
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.randint(0, 100_000, (n,), generator=gen, device=dev))
        hot_words = [words[0], hot_keys]
        hot_args = (hot_words, None, sum_lanes, contribs, False,
                    carry.sort_order(hot_words))
        hot_plain = agg_mod.segment_reduce_sorted_plain(*hot_args)
        for packed in K3_PATHS:
            hot = agg_mod.segment_reduce_sorted(*hot_args, packed=packed)
            _k3_diff(torch, hot, hot_plain, f"on a hot key, packed={packed}")
        hot = agg_mod.segment_reduce_sorted(*hot_args)
        hot_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted(*hot_args))
        hot_plain_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
            *hot_args))
        ratio = hot_ms / k3_ms
        print(f"K3 hot key: rows {n}, groups {hot[3]}, largest group "
              f"{int(hot[2][-1].max())} rows: {hot_ms:.3f} ms, plain "
              f"{hot_plain_ms:.3f} ms; uniform keys {k3_ms:.3f} ms; hot / "
              f"uniform {ratio:.3f}")
        if ratio > 2.0:
            raise AssertionError(f"K3 on a hot key takes {ratio:.2f}x its "
                                 "time on uniform keys (at most 2x)")
        # the same input gives the same bits on every run, on either path
        for what, args in (("q1", k3_args), ("hot key", hot_args)):
            for packed in (False, True):
                first = agg_mod.segment_reduce_sorted(*args, packed=packed)
                for _ in range(2):
                    if not _k3_same_bits(torch, agg_mod.segment_reduce_sorted(
                            *args, packed=packed), first):
                        raise AssertionError(f"K3 is not deterministic on "
                                             f"{what}, packed={packed}")
        print("K3 deterministic: on q1 and on the hot key, each path gives "
              "the same bits three runs in a row")
        del first
        del batch, filtered, outs, outs_p, lanes, keep, vals, ids
        del key_cols, val_cols, hot_args, k3_args, sorted_ids
    except Exception:
        failures.append("kernel phase")
        traceback.print_exc()

    try:
        cases = _edge_cases(torch, dev, carry, agg_mod)
        print(f"edge cases: K1, K2, K3 equal their plain versions at "
              f"{cases} sizes from 0 to 100,003 rows")
        cases = _k3_minmax_cases(torch, dev, carry, agg_mod)
        print(f"K3 min/max edge cases: {cases} cases equal the plain "
              f"version, every min and max bit for bit (NaN with two "
              f"payloads, +-inf, -0.0 beside 0.0, INT64_MIN and INT64_MAX, "
              f"BOOLEAN lanes, an all-null group, a global min over no "
              f"rows, one group over 2^22 rows, group ends on tile edges, "
              f"27 ops in two launch sets)")
        tile = kernels.library("onesweep").srt_tile_rows()
        cases = _k2_edge_cases(torch, dev, carry, tile)
        print(f"K2 edge cases: {cases} cases equal the plain version around "
              f"its tile of {tile} rows")
    except Exception:
        failures.append("edge cases")
        traceback.print_exc()

    # ---- kernel phase, q2: K6, K4 and K5 against their plain versions --
    q2_pairs = None
    try:
        def upload(tbl):
            return batch_to_device(pa.RecordBatch.from_arrays(
                [c.combine_chunks() for c in tbl.columns],
                names=tbl.column_names), dev)
        fact_b, dim_b = upload(table), upload(dim)
        cap_b, cap_p = dim_b.capacity, fact_b.capacity
        n_b, n_p = dim_b.num_rows, fact_b.num_rows
        bkeys, pkeys = dim_b.columns[:1], fact_b.columns[:1]
        blive = torch.arange(cap_b, device=dev) < n_b
        plive = torch.arange(cap_p, device=dev) < n_p
        # K6 hashes the build side on the main path; the probe side's
        # hashes are checked too, and the probe below is held against
        # them
        bh = jk.combined_key_hash(bkeys, cap_b, side="build")
        ph = jk.combined_key_hash(pkeys, cap_p, side="probe")
        for what, mine, plain in (
                ("build", bh, jk.combined_key_hash_plain(bkeys, cap_b,
                                                         side="build")),
                ("probe", ph, jk.combined_key_hash_plain(pkeys, cap_p,
                                                         side="probe"))):
            if not torch.equal(mine, plain):
                raise AssertionError(f"K6 differs from its plain version on "
                                     f"the {what} side at q2's shapes")
        # per row: the 8 B key, its 1 B validity, the 8 B hash
        k6_bytes = 17 * cap_b
        kernel_rows["key_hash"] = dict(
            source="spark_rapids_tpu_torch/csrc/key_hash.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:43",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.combined_key_hash(bkeys, cap_b,
                                                    side="build")),
            plain_ms=cuda_ms(lambda: jk.combined_key_hash_plain(
                bkeys, cap_b, side="build")),
            # no single PyTorch call computes the hash
            library_ms=None,
            bound_ms=bound(k6_bytes))
        k6_probe_ms = cuda_ms(lambda: jk.combined_key_hash(pkeys, cap_p,
                                                           side="probe"))
        k6_probe_plain_ms = cuda_ms(lambda: jk.combined_key_hash_plain(
            pkeys, cap_p, side="probe"))
        r = kernel_rows["key_hash"]
        print(f"K6 key_hash: build side {cap_b} rows, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k6_bytes} bytes); probe side "
              f"{cap_p} rows (hashed inside K4 on the main path), exact, "
              f"{k6_probe_ms:.3f} ms, plain {k6_probe_plain_ms:.3f} ms, "
              f"bound {bound(17 * cap_p):.3f} ms")

        # K2 and K4's table once per build side, the fused K4 per probe
        # batch
        side = jk.sort_build(bh, blive)
        lo, counts = jk.join_probe(side, pkeys, n_p)
        order = side.order
        for what, plain in (
                ("its plain version",
                 jk.join_probe_keys_plain(side.sorted_hash, pkeys, n_p)),
                ("the searches on K6's probe hashes",
                 jk.join_probe_plain(side.sorted_hash, ph, plive))):
            if not (torch.equal(lo, plain[0]) and torch.equal(counts,
                                                              plain[1])):
                raise AssertionError(f"K4 differs from {what} at q2's "
                                     "shapes")
        if not all(torch.equal(x, y) for x, y in zip(
                (order, lo, counts),
                jk.count_matches_plain(bkeys, n_b, pkeys, n_p))):
            raise AssertionError("K6 + K2 + K4 (count_matches) differ from "
                                 "their plain versions at q2's shapes")

        def k4():
            # the table (one launch a build side) and the probe
            table = jk.hash_table(side.sorted_hash)
            return jk.join_probe(jk.BuildSide(order, side.sorted_hash,
                                              table), pkeys, n_p)
        for _ in range(3):
            if not all(torch.equal(x, y) for x, y in zip(k4(), (lo, counts))):
                raise AssertionError("K4 is not deterministic: a rebuilt "
                                     "table gives other bits")
        print("K4 deterministic: three runs, each with its table rebuilt, "
              "give the same bits")
        slots = int(side.table.shape[0]) // 2
        sw = side.sorted_hash ^ -2**63

        def library():
            # the path K4 replaces: the torch hash composition on the
            # probe side, then two searchsorted
            pw = jk.combined_key_hash_plain(pkeys, cap_p,
                                            side="probe") ^ -2**63
            return (torch.searchsorted(sw, pw),
                    torch.searchsorted(sw, pw, right=True))
        # per probe row: the 8 B key and 1 B validity in, lo 4 B and count
        # 8 B out; per build row its sorted hash 8 B; per slot 16 B
        k4_bytes = 21 * cap_p + 8 * cap_b + 16 * slots
        kernel_rows["join_probe"] = dict(
            source="spark_rapids_tpu_torch/csrc/join_probe.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:73",
            max_abs_err=0.0,
            ms=cuda_ms(k4),
            plain_ms=cuda_ms(lambda: jk.join_probe_keys_plain(
                side.sorted_hash, pkeys, n_p)),
            library_ms=cuda_ms(library),
            bound_ms=bound(k4_bytes),
            table_ms=cuda_ms(lambda: jk.hash_table(side.sorted_hash)),
            probe_ms=cuda_ms(lambda: jk.join_probe(side, pkeys, n_p)),
            probe_rows=cap_p)
        r = kernel_rows["join_probe"]
        print(f"K4 join_probe: probe rows {n_p} (capacity {cap_p}), build "
              f"rows {n_b} (capacity {cap_b}), {slots} slots, exact, "
              f"{r['ms']:.3f} ms (table {r['table_ms']:.3f}, probe "
              f"{r['probe_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
              f"ms ({k4_bytes} bytes)")

        # K7: the running sums of the effective counts, and their total
        ends, q2_pairs = _same_ends(torch, jk, counts, plive, "inner")
        eff = jk.effective_counts(counts, plive, "inner")
        # per probe row: the count 8 B and the live flag 1 B in, the end
        # 8 B out
        k7_bytes = 17 * cap_p
        kernel_rows["expand_ends"] = dict(
            source="spark_rapids_tpu_torch/csrc/expand_ends.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:138",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.expand_ends(counts, plive, "inner")),
            plain_ms=cuda_ms(lambda: jk.expand_ends_plain(counts, plive,
                                                          "inner")),
            # the nearest single call: the scan alone, over effective
            # counts already computed
            library_ms=cuda_ms(lambda: torch.cumsum(eff, 0)),
            bound_ms=bound(k7_bytes))
        r = kernel_rows["expand_ends"]
        print(f"K7 expand_ends: probe rows {n_p} (capacity {cap_p}), total "
              f"{q2_pairs}, exact, {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library (torch.cumsum of the "
              f"effective counts alone) {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k7_bytes} bytes)")
        out_cap = bucket_for(q2_pairs)
        k5_args = (ends, lo, counts, order, q2_pairs, out_cap,
                   fact_b.columns, dim_b.columns)
        res = jk.expand_pairs(*k5_args)
        if not _same_expansion(torch, res, jk.expand_pairs_plain(*k5_args)):
            raise AssertionError("K5 differs from its plain version at q2's "
                                 "shapes")
        bsel = res[1][:q2_pairs].long()
        probe_lanes = [x for c in fact_b.columns for x in (c.data, c.validity)]
        build_lanes = [x for c in dim_b.columns for x in (c.data, c.validity)]

        def library():
            rows = torch.repeat_interleave(torch.arange(cap_p, device=dev),
                                           eff, output_size=q2_pairs)
            return ([x.index_select(0, rows) for x in probe_lanes]
                    + [x.index_select(0, bsel) for x in build_lanes])

        def lane_bytes(lanes, n):
            return sum(x.element_size() for x in lanes) * n
        # in: ends 8 B, lo 4 B, counts 8 B and the probe lanes per probe
        # row, order 4 B and the build lanes per build row; out: the two
        # int32 indices and every lane per output position
        k5_bytes = (20 * cap_p + lane_bytes(probe_lanes, cap_p) + 4 * cap_b
                    + lane_bytes(build_lanes, cap_b) + 8 * out_cap
                    + lane_bytes(probe_lanes + build_lanes, out_cap))
        kernel_rows["expand_pairs"] = dict(
            source="spark_rapids_tpu_torch/csrc/join_expand.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:130",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.expand_pairs(*k5_args)),
            plain_ms=cuda_ms(lambda: jk.expand_pairs_plain(*k5_args)),
            library_ms=cuda_ms(library),
            bound_ms=bound(k5_bytes))
        r = kernel_rows["expand_pairs"]
        print(f"K5 expand_pairs: probe rows {n_p} (capacity {cap_p}), build "
              f"rows {n_b} (capacity {cap_b}), pairs {q2_pairs}, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({k5_bytes} bytes)")
        del fact_b, dim_b, bh, ph, side, order, lo, counts, sw, eff, ends
        del res, bsel, probe_lanes, build_lanes, k5_args, bkeys, pkeys
    except Exception:
        failures.append("kernel phase (q2)")
        traceback.print_exc()

    try:
        hot_pairs, hot_cap, hot_args, hot_k4 = _hot_key(
            torch, dev, jk, t, DeviceColumn, bucket_for)
        hot_ms = cuda_ms(lambda: jk.expand_pairs(*hot_args))
        hot_k4_ms = cuda_ms(lambda: jk.join_probe(*hot_k4))
        # the same draw at q2's probe size, so the launch's fixed cost does
        # not decide the time a row
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        big = [DeviceColumn(t.LONG, torch.where(
            torch.rand(ROWS, generator=gen, device=dev) < 0.01,
            torch.full((ROWS,), DIM_ROWS, device=dev),
            torch.randint(0, DIM_ROWS, (ROWS,), generator=gen, device=dev)),
            torch.ones(ROWS, dtype=torch.bool, device=dev))]
        hot_side = hot_k4[0]
        if not all(torch.equal(x, y) for x, y in zip(
                jk.join_probe(hot_side, big, ROWS),
                jk.join_probe_keys_plain(hot_side.sorted_hash, big, ROWS))):
            raise AssertionError(f"K4 differs from its plain version on the "
                                 f"hot key at {ROWS} probe rows")
        big_k4_ms = cuda_ms(lambda: jk.join_probe(hot_side, big, ROWS))
        del hot_args, hot_k4, hot_side, big
        uniform_ms = kernel_rows["expand_pairs"]["ms"]
        ratio = (hot_ms / hot_pairs) / (uniform_ms / q2_pairs)
        print(f"K5 hot key: {HOT_PROBE_ROWS} probe rows, 1 % on a key with "
              f"{HOT_COPIES} build rows: {hot_pairs} pairs (capacity "
              f"{hot_cap}), exact, {hot_ms:.3f} ms, "
              f"{hot_ms / hot_pairs * 1e6:.3f} ns a pair; uniform (q2) "
              f"{uniform_ms / q2_pairs * 1e6:.3f} ns a pair; hot / uniform "
              f"{ratio:.3f}")
        if ratio > 2.0:
            raise AssertionError(f"K5 on a hot key takes {ratio:.2f}x its "
                                 "time a pair on uniform keys (at most 2x)")
        r = kernel_rows["join_probe"]
        uniform_row = r["probe_ms"] / r["probe_rows"]
        for rows, ms in ((HOT_PROBE_ROWS, hot_k4_ms), (ROWS, big_k4_ms)):
            print(f"K4 hot key: {rows} probe rows, 1 % on the hot key, "
                  f"exact, probe {ms:.3f} ms, {ms / rows * 1e6:.4f} ns a "
                  f"probe row; uniform (q2) {uniform_row * 1e6:.4f} ns a "
                  f"probe row; hot / uniform "
                  f"{ms / rows / uniform_row:.3f}")
    except Exception:
        failures.append("hot key (K4, K5)")
        traceback.print_exc()

    try:
        cases = _join_edge_cases(torch, dev, jk, t, DeviceColumn, bucket_for)
        print(f"join edge cases: K6, K6 + K2 + K4 and K5 (inner, left, full) "
              f"equal their plain versions in {cases} cases, each launching "
              f"K6, K4 (with probe rows) and K5")
    except Exception:
        failures.append("join edge cases")
        traceback.print_exc()

    try:
        tile = kernels.library("join_expand").srt_tile_rows()
        cases = _expand_cases(torch, dev, jk, t, DeviceColumn, tile)
        print(f"K7 and K5 tiling cases: {cases} cases equal their plain "
              f"versions (K7 around its tile of "
              f"{kernels.library('expand_ends').srt_tile_rows()} rows; K5 "
              f"around its tile of {tile} merge items, with 40 columns)")
    except Exception:
        failures.append("K7 and K5 tiling cases")
        traceback.print_exc()

    try:
        _wide_group_by(torch, dev, carry, agg_mod, seg, batch_to_device,
                       GpuSession(), F, col)
    except Exception:
        failures.append("K3 wide group-by")
        traceback.print_exc()

    # ---- kernel phase, q3: K2 on the sort words, K8, K9 and K10 --------
    q3_orders = [(A("k"), True, True), (A("v"), True, True)]
    try:
        q3_in = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        n3 = q3_in.num_rows
        words3 = SortExec(q3_orders, LocalScanExec(table)).sort_words(q3_in)
        order3 = carry.sort_order(words3)
        if not torch.equal(order3, carry.sort_order_plain(words3)):
            raise AssertionError("K2 differs from its plain version on q3's "
                                 "sort words")
        q3_passes = _k2_passes(carry, words3)
        print(f"K2 on q3's sort words: rows {n3}, words {len(words3)} "
              f"(padding, k's null word, k, v's null word, v), passes "
              f"{q3_passes}, exact, "
              f"{cuda_ms(lambda: carry.sort_order(words3)):.3f} ms")
        lanes3 = fetch.batch_lanes(q3_in)
        sorted3 = gather_mod.gather_rows(order3, lanes3)
        if not _same_lanes(torch, sorted3,
                           gather_mod.gather_rows_plain(order3, lanes3)):
            raise AssertionError("K8 differs from its plain version at q3's "
                                 "shapes")
        widths3 = [x.element_size() for x in lanes3]
        plan8 = gather_mod.gather_plan(n3, n3, widths3)
        for packed in (False, True):
            if not _same_lanes(torch, gather_mod.gather_rows(
                    order3, lanes3, packed=packed), sorted3):
                raise AssertionError(f"K8 (packed={packed}) differs from "
                                     f"its plain version at q3's shapes")
        k8_bytes = 4 * n3 + 2 * n3 * sum(widths3)
        idx3 = order3.to(torch.int64)
        # the planned path and the other one, in turns
        turns8 = [cuda_ms(lambda p=p: gather_mod.gather_rows(
            order3, lanes3, packed=p))
            for p in (plan8.packed, not plan8.packed) * 2]
        kernel_rows["gather_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/gather_rows.cu",
            replaces="spark_rapids_tpu/ops/carry.py:80",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: gather_mod.gather_rows(order3, lanes3)),
            plain_ms=cuda_ms(lambda: gather_mod.gather_rows_plain(order3,
                                                                  lanes3)),
            library_ms=cuda_ms(lambda: [x.index_select(0, idx3)
                                        for x in lanes3]),
            bound_ms=bound(k8_bytes),
            extra=dict(packed=plan8.packed,
                       scratch_bytes=plan8.scratch_bytes,
                       single_pass_bytes=plan8.single_bytes,
                       record_path_bytes=plan8.packed_bytes,
                       planned_other_in_turns_ms=turns8))
        r = kernel_rows["gather_rows"]
        print(f"K8 gather_rows: rows {n3}, {len(lanes3)} lanes, exact on "
              f"both paths; {'record path' if plan8.packed else 'single pass'}"
              f" {r['ms']:.3f} ms; planned / other in turns "
              f"{', '.join(f'{x:.3f}' for x in turns8)} ms; device-memory "
              f"bytes with a random read as its 32-byte sector: single pass "
              f"{plan8.single_bytes} ({plan8.single_bytes / n3:.0f} B a row, "
              f"{bound(plan8.single_bytes):.3f} ms), record path "
              f"{plan8.packed_bytes} ({plan8.packed_bytes / n3:.0f} B a row, "
              f"{bound(plan8.packed_bytes):.3f} ms); scratch "
              f"{plan8.scratch_bytes} bytes; plain {r['plain_ms']:.3f} ms, "
              f"library (index_select of each lane) {r['library_ms']:.3f} "
              f"ms, bound {r['bound_ms']:.3f} ms ({k8_bytes} bytes); {card}")

        # K9 and K10 on the sorted batch, the one q3's download fetches
        stats3 = fetch.lane_stats(sorted3, n3)
        if not torch.equal(stats3, fetch.lane_stats_plain(sorted3, n3)):
            raise AssertionError("K9 differs from its plain version at q3's "
                                 "shapes")
        reduced = [x for x in sorted3
                   if fetch.lane_kind(x) != fetch.KIND_OTHER]
        k9_bytes = n3 * sum(x.element_size() for x in reduced) \
            + 16 * len(sorted3)

        def k9_library():
            return [torch.all(x) if x.dtype == torch.bool else
                    torch.aminmax(x) for x in reduced]
        kernel_rows["lane_stats"] = dict(
            source="spark_rapids_tpu_torch/csrc/fetch_pack.cu",
            replaces="spark_rapids_tpu/columnar/fetch.py:158",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: fetch.lane_stats(sorted3, n3)),
            plain_ms=cuda_ms(lambda: fetch.lane_stats_plain(sorted3, n3)),
            library_ms=cuda_ms(k9_library),
            bound_ms=bound(k9_bytes))
        r = kernel_rows["lane_stats"]
        print(f"K9 lane_stats: rows {n3}, {len(sorted3)} lanes "
              f"({len(reduced)} reduced), stats {stats3.tolist()}, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(aminmax and all of each lane) {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({k9_bytes} bytes)")
        plan3, mins3 = fetch.build_plan(sorted3, stats3.tolist())
        packed3 = fetch.pack_lanes(sorted3, plan3, mins3, n3)
        if not torch.equal(packed3, fetch.pack_lanes_plain(sorted3, plan3,
                                                           mins3, n3)):
            raise AssertionError("K10 differs from its plain version at "
                                 "q3's shapes")
        kept = [x for x, st in zip(sorted3, plan3) if st[0] != "skip"]
        k10_bytes = n3 * sum(x.element_size() for x in kept) + \
            packed3.numel()
        kernel_rows["pack_lanes"] = dict(
            source="spark_rapids_tpu_torch/csrc/fetch_pack.cu",
            replaces="spark_rapids_tpu/columnar/fetch.py:346",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: fetch.pack_lanes(sorted3, plan3, mins3, n3)),
            plain_ms=cuda_ms(lambda: fetch.pack_lanes_plain(
                sorted3, plan3, mins3, n3)),
            # no single PyTorch call packs the lanes
            library_ms=None,
            bound_ms=bound(k10_bytes))
        r = kernel_rows["pack_lanes"]
        full = sum(x.element_size() for x in sorted3) * n3
        print(f"K10 pack_lanes: rows {n3}, plan {plan3}, {packed3.numel()} "
              f"bytes packed of {full} in the lanes, exact, {r['ms']:.3f} "
              f"ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k10_bytes} bytes)")
        sorted_batch = DeviceBatch(
            [DeviceColumn(c.dtype, sorted3[2 * i], sorted3[2 * i + 1])
             for i, c in enumerate(q3_in.columns)], n3, q3_in.names)
        got = batch_to_arrow(fetch.fetch_batch(sorted_batch))
        want3 = batch_to_arrow(move_batch(sorted_batch, host,
                                          live_only=True))
        if not all(_same_arrow(a, b) for a, b in zip(got.columns,
                                                     want3.columns)):
            raise AssertionError("fetch_batch differs from move_batch at "
                                 "q3's shapes")
        print("fetch_batch at q3's shapes equals batch_to_arrow(move_batch"
              "(...)) column for column")
        del q3_in, words3, order3, lanes3, sorted3, packed3, sorted_batch
        del got, want3, idx3, reduced, kept
    except Exception:
        failures.append("kernel phase (q3)")
        traceback.print_exc()

    try:
        cases = _k8_edge_cases(torch, dev, gather_mod)
        print(f"K8 edge cases: {cases} cases equal the plain version bit for "
              f"bit on the single pass, the record path and the planned one "
              f"(no rows and no launch, one row, 255-257 and 2^k +- 1 rows, "
              f"permutation, identity, reverse, one source row, repeats "
              f"over longer and shorter lanes, either side of the plan's "
              f"crossover; 12 lane-width mixes from one lane to 40)")
        cases, sizes = _fetch_fuzz(torch, dev, fetch, batch_to_device,
                                   batch_to_arrow, move_batch)
        print(f"fetch fuzz: K9 and K10 equal their plain versions bit for "
              f"bit and fetch_batch equals batch_to_arrow(move_batch(...)) "
              f"in {cases} seeded batches of {min(sizes)} to {max(sizes)} "
              f"rows ({sum(1 for x in sizes if x % 8)} not a multiple of 8)")
    except Exception:
        failures.append("K8, K9 and K10 edge cases")
        traceback.print_exc()

    try:
        sweep3 = _k3_sweep(torch, dev, carry, agg_mod, cuda_ms)
        print("K3 direct path / record path (ms, in turns): " + "; ".join(
            f"{what}, {n} rows, {inputs / 2**20:.0f} MiB of inputs (plan: "
            f"{'records' if p else 'direct'}) {a:.4f} / {b:.4f}, "
            f"{c:.4f} / {d:.4f}"
            for what, n, inputs, p, (a, b, c, d) in sweep3) + f"; {card}")
    except Exception:
        failures.append("K3 sweep")
        traceback.print_exc()

    try:
        sweep8 = _k8_sweep(torch, dev, gather_mod, cuda_ms)
        print("K8 single pass / record path on q3's lanes (ms, in "
              "turns): " + "; ".join(
                  f"{n} of {m} rows (plan: {'record' if p else 'single'}) "
                  f"{a:.4f} / {b:.4f}, {c:.4f} / {d:.4f}"
                  for n, m, p, (a, b, c, d) in sweep8) + f"; {card}")
    except Exception:
        failures.append("K8 sweep")
        traceback.print_exc()

    # ---- kernel phase, q4: K11, K12 and K13 at q4's shapes ------------
    def q4_exec(child):
        spec = W.WindowBuilder().partition_by(col("k")).order_by(
            col("v")).spec
        return window_mod.WindowExec(
            [W.WindowExpression(W.RowNumber(), spec, "rn"),
             W.WindowExpression(Sum(A("v")), spec, "rs")], child)

    try:
        q4_in = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        n4 = q4_in.num_rows
        lay, pairs4, lanes4 = _q4_layout(torch, window_mod, EvalContext,
                                         q4_exec(LocalScanExec(table)), q4_in)
        # K11 as q4 launches it: seg_start, v's running sum and count
        _same_scan(torch, scan_mod.segment_scan(lay.new_seg, None, pairs4),
                   scan_mod.segment_scan_plain(lay.new_seg, None, pairs4),
                   "at q4's shapes")
        # every output, and a float lane (f in the layout's order)
        f4 = gather_mod.gather_rows(lay.order, [q4_in.columns[2].data])[0]
        full = [pairs4[0], (f4, pairs4[0][1]), (None, pairs4[0][1])]
        k11_err = _same_scan(
            torch, scan_mod.segment_scan(lay.new_seg, lay.new_run, full,
                                         run_start=True, runs_cum=True),
            scan_mod.segment_scan_plain(lay.new_seg, lay.new_run, full,
                                        run_start=True, runs_cum=True),
            "at q4's shapes, every output")
        # flags 1 B, value 8 B, valid 1 B read; seg_start 4 B, sum 8 B,
        # count 4 B written, a row
        k11_bytes = n4 * (1 + 8 + 1 + 4 + 8 + 4)
        sum_lane = pairs4[0][0]
        kernel_rows["segment_scan"] = dict(
            source="spark_rapids_tpu_torch/csrc/window_scan.cu",
            replaces="spark_rapids_tpu/exec/window.py:46",
            max_abs_err=k11_err,
            ms=cuda_ms(lambda: scan_mod.segment_scan(lay.new_seg, None,
                                                     pairs4)),
            plain_ms=cuda_ms(lambda: scan_mod.segment_scan_plain(
                lay.new_seg, None, pairs4)),
            library_ms=cuda_ms(lambda: torch.cumsum(sum_lane, 0)),
            bound_ms=bound(k11_bytes))
        r = kernel_rows["segment_scan"]
        print(f"K11 segment_scan: rows {n4}, {int(lay.new_seg.sum())} "
              f"partitions, {int(lay.new_run.sum())} runs; q4's launch "
              f"(seg_start, one int64 pair: tiles of 8,192 rows, "
              f"{-(-n4 // 8192)} tiles) exact; every output with a "
              f"float lane: ints exact, float max abs err {k11_err:.3g}; "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(torch.cumsum of the sum lane) {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({k11_bytes} bytes); {card}")
        # K11 with one to four pairs at q4's shape (tiles of 8,192,
        # 4,096, 2,048 and 2,048 rows)
        run4 = lay.new_run
        sets11 = [(None, pairs4, {}),
                  (run4, [pairs4[0], full[1]], dict(run_start=True)),
                  (run4, full, dict(run_start=True, runs_cum=True)),
                  (run4, full + [pairs4[0]], dict(runs_cum=True))]
        for a in sets11[1:]:
            _same_scan(torch, scan_mod.segment_scan(lay.new_seg, a[0], a[1],
                                                    **a[2]),
                       scan_mod.segment_scan_plain(lay.new_seg, a[0], a[1],
                                                   **a[2]),
                       f"at q4's shapes, {len(a[1])} pairs")
        pairs_ms = [cuda_ms(lambda a=a: scan_mod.segment_scan(
            lay.new_seg, a[0], a[1], **a[2])) for a in sets11]
        kernel_rows["segment_scan"]["extra"] = dict(
            one_to_four_pairs_ms=pairs_ms)
        print(f"K11 at q4's shape with 1, 2, 3 and 4 pairs (and run "
              f"outputs from 2): {', '.join(f'{x:.3f}' for x in pairs_ms)}"
              f" ms, each equal to the plain version; {card}")
        # K8 as q4's window moves its inputs: k and v with their validity
        lanes8 = [x for c in q4_in.columns[:2] for x in (c.data, c.validity)]
        want8 = gather_mod.gather_rows_plain(lay.order, lanes8)
        plan84 = gather_mod.gather_plan(n4, n4, [x.element_size()
                                                  for x in lanes8])
        for packed in (None, False, True):
            if not _same_lanes(torch, gather_mod.gather_rows(
                    lay.order, lanes8, packed=packed), want8):
                raise AssertionError(f"K8 (packed={packed}) differs from "
                                     f"its plain version at q4's shapes")
        turns84 = [cuda_ms(lambda p=p: gather_mod.gather_rows(
            lay.order, lanes8, packed=p))
            for p in (plan84.packed, not plan84.packed) * 2]
        if "gather_rows" in kernel_rows:
            kernel_rows["gather_rows"]["extra"].update(
                q4_planned_other_in_turns_ms=turns84,
                q4_scratch_bytes=plan84.scratch_bytes)
        print(f"K8 at q4's four lanes (k, v and their validity through the "
              f"window's order): exact on both paths; "
              f"{'record path' if plan84.packed else 'single pass'} / the "
              f"other in turns {', '.join(f'{x:.3f}' for x in turns84)} ms;"
              f" scratch {plan84.scratch_bytes} bytes; {card}")
        del lanes8, want8
        # K12 as q4 launches it: the end of each row's peer run
        for flags in ((None, lay.new_run), (lay.new_seg, lay.new_run)):
            ends = scan_mod.run_ends(*flags, lay.n_live)
            ends_plain = scan_mod.run_ends_plain(*flags, lay.n_live)
            if not all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(ends, ends_plain)):
                raise AssertionError("K12 differs from its plain version at "
                                     "q4's shapes")
        pos4 = torch.arange(n4, dtype=torch.int32, device=dev)
        ends_in = torch.where(
            torch.cat([lay.new_run[1:], torch.ones(1, dtype=torch.bool,
                                                   device=dev)]),
            pos4, torch.full_like(pos4, 2**31 - 1))
        k12_bytes = n4 * (1 + 4)
        kernel_rows["run_ends"] = dict(
            source="spark_rapids_tpu_torch/csrc/window_scan.cu",
            replaces="spark_rapids_tpu/exec/window.py:54",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: scan_mod.run_ends(None, lay.new_run,
                                                 lay.n_live)),
            plain_ms=cuda_ms(lambda: scan_mod.run_ends_plain(
                None, lay.new_run, lay.n_live)),
            library_ms=cuda_ms(lambda: torch.flip(torch.cummin(
                torch.flip(ends_in, [0]), 0).values, [0])),
            bound_ms=bound(k12_bytes))
        r = kernel_rows["run_ends"]
        print(f"K12 run_ends: rows {n4}, run_end (and seg_end) exact; "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(flip, cummin, flip) {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k12_bytes} bytes)")
        # K13: rn and rs with their validity back to input order
        back = gather_mod.scatter_rows(lay.order, lanes4)
        if not _same_lanes(torch, back, gather_mod.scatter_rows_plain(
                lay.order, lanes4)):
            raise AssertionError("K13 differs from its plain version at "
                                 "q4's shapes")
        idx4 = lay.order.to(torch.int64)
        outs4 = [torch.empty_like(x) for x in lanes4]
        k13_bytes = 4 * n4 + 2 * n4 * sum(x.element_size() for x in lanes4)
        plan4 = gather_mod.scatter_plan(
            n4, [x.element_size() for x in lanes4])
        if not _same_lanes(torch, gather_mod.scatter_rows(
                lay.order, lanes4, binned=not plan4.binned), back):
            raise AssertionError("K13's other path differs at q4's shapes")
        kernel_rows["scatter_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/scatter_rows.cu",
            replaces="spark_rapids_tpu/exec/window.py:517",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: gather_mod.scatter_rows(lay.order, lanes4)),
            plain_ms=cuda_ms(lambda: gather_mod.scatter_rows_plain(
                lay.order, lanes4)),
            library_ms=cuda_ms(lambda: [o.index_copy_(0, idx4, x)
                                        for o, x in zip(outs4, lanes4)]),
            bound_ms=bound(k13_bytes),
            extra=dict(binned=plan4.binned, shift=plan4.shift,
                       scratch_bytes=plan4.scratch_bytes,
                       other_path_ms=cuda_ms(lambda: gather_mod.scatter_rows(
                           lay.order, lanes4, binned=not plan4.binned))))
        r = kernel_rows["scatter_rows"]
        print(f"K13 scatter_rows: rows {n4}, {len(lanes4)} lanes "
              f"({', '.join(str(x.dtype) for x in lanes4)}), exact on both "
              f"paths; {'binned' if plan4.binned else 'single pass'} "
              f"(256 buckets of 2^{plan4.shift} destinations, "
              f"{plan4.scratch_bytes} bytes of scratch) {r['ms']:.3f} ms, "
              f"the {'single pass' if plan4.binned else 'binned path'} "
              f"{r['extra']['other_path_ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library (index_copy_ of each lane) "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({k13_bytes} bytes); {card}")
        del q4_in, lay, pairs4, lanes4, f4, full, sum_lane, back, idx4
        del run4, sets11, a
        del outs4, pos4, ends_in, ends, ends_plain
    except Exception:
        failures.append("kernel phase (q4)")
        traceback.print_exc()

    try:
        # where the single pass stops winning: q4's lanes at sizes around
        # the 48 MiB window (2^22 rows write 52 MiB)
        gen13 = torch.Generator(device=dev).manual_seed(SEED + 14)
        sweep = []
        for n in (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24):
            order = torch.randperm(n, generator=gen13, device=dev).to(
                torch.int32)
            lanes = [torch.randint(-2**31, 2**31 - 1, (n,), generator=gen13,
                                   device=dev, dtype=torch.int32),
                     torch.randint(-2**62, 2**62, (n,), generator=gen13,
                                   device=dev),
                     torch.rand(n, generator=gen13, device=dev) < 0.5]
            sweep.append((n, *(cuda_ms(lambda: gather_mod.scatter_rows(
                order, lanes, binned=b)) for b in (False, True, False,
                                                   True))))
            del order, lanes
        print("K13 single pass / binned at q4's lanes (ms, in turns): " +
              "; ".join(f"{n} rows {a:.3f} / {b:.3f}, {c:.3f} / {d:.3f}"
                        for n, a, b, c, d in sweep) + f"; {card}")
    except Exception:
        failures.append("K13 window sweep")
        traceback.print_exc()

    try:
        cases = _k13_cases(torch, dev, gather_mod)
        print(f"K13 edge cases: {cases} cases equal the plain version on "
              f"the single pass, the binned path and the planned one (n = "
              f"1, 255-257, 512 and 513, 3,071-3,073, 2^20 and 2^20 + 1, "
              f"{K13_BINNED_FROM - 1} and {K13_BINNED_FROM} (the single "
              f"pass's last n at q4's lanes and the binned path's first); "
              f"random, identity and reversed orders; q4's lanes, one "
              f"int32 lane, 16 mixed lanes)")
    except Exception:
        failures.append("K13 edge cases")
        traceback.print_exc()

    try:
        cases = _window_kernel_cases(torch, dev, scan_mod, gather_mod)
        print(f"K11, K12 and K13 edge cases: {cases} cases equal the plain "
              f"versions (ints exactly, floats to {FLOAT_RTOL:g}): n = 1, "
              f"n either side of the 2,048-, 4,096- and 8,192-row tiles, "
              f"one partition over 2^22 rows and over the tile edges, all "
              f"rows tied, every row its own partition, padding at the "
              f"tail, one, two, three and five pairs")
    except Exception:
        failures.append("K11, K12 and K13 edge cases")
        traceback.print_exc()

    try:
        # each wrapper's time for one row: its launch floor, beside which
        # the rows of K6, K12 and K15 are read
        one = torch.ones(1, dtype=torch.bool, device=dev)
        key1 = DeviceColumn(t.LONG, torch.zeros(1, dtype=torch.int64,
                                                device=dev), one)
        offs1 = torch.tensor([0, 3], dtype=torch.int32, device=dev)
        chars1 = torch.tensor([97, 98, 99], dtype=torch.uint8, device=dev)
        seed1 = torch.full((1,), 42, dtype=torch.int64, device=dev)
        floors = {
            "K6 key_hash": cuda_ms(lambda: jk.combined_key_hash([key1], 1)),
            "K12 run_ends": cuda_ms(lambda: scan_mod.run_ends(one, None,
                                                              1)),
            "K15 hash_bytes": cuda_ms(lambda: hashfns_mod.hash_bytes(
                offs1, chars1, seed1))}
        print("launch floor, one row through each wrapper (ms): " +
              ", ".join(f"{k} {v:.4f}" for k, v in floors.items()) +
              f"; {card}")
        del one, key1, offs1, chars1, seed1
    except Exception:
        failures.append("launch floor")
        traceback.print_exc()

    # ---- main path: DataFrame API, one batch -------------------------
    wrappers = {"compact_rows": carry.compact_lanes,
                "sort_order": carry.sort_order,
                "segment_reduce_sorted": agg_mod.segment_reduce_sorted,
                "key_hash": jk.combined_key_hash,
                "hash_table": jk.hash_table,
                "join_probe": jk.join_probe,
                "expand_ends": jk.expand_ends,
                "expand_pairs": jk.expand_pairs,
                "gather_rows": gather_mod.gather_rows,
                "lane_stats": fetch.lane_stats,
                "pack_lanes": fetch.pack_lanes,
                "segment_scan": scan_mod.segment_scan,
                "run_ends": scan_mod.run_ends,
                "scatter_rows": gather_mod.scatter_rows,
                "string_hashes": sops.string_hashes,
                "hash_bytes": hashfns_mod.hash_bytes,
                "gather_strings": sops.gather_strings,
                "order_keys": sops.order_keys}

    def download_fetched(b):
        return batch_to_arrow(fetch.fetch_batch(b))

    def count_reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    launches = {}
    try:
        session = GpuSession()
        df = (session.create_dataframe(table)
              .filter(col("v") > THRESHOLD)
              .group_by(col("k"))
              .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                   F.count("*").alias("c")))
        t1 = time.perf_counter()
        cold = df.collect()
        cold_wall = time.perf_counter() - t1
        _check_q1(cold, want, "DataFrame q1 (cold)")
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["dataframe"] = counts()
        _check_q1(got, want, "DataFrame q1")
        print(f"main path DataFrame q1 (1 batch of {ROWS} rows): cold wall "
              f"{cold_wall * 1e3:.1f} ms (upload included); warm wall "
              f"{wall * 1e3:.1f} ms (batch kept on the device), "
              f"{ROWS / wall / 1e6:.1f} M rows/s, {got.num_rows} groups, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches['dataframe']}")
    except Exception:
        failures.append("main path (DataFrame)")
        traceback.print_exc()

    # ---- where the time goes: one batch, stage by stage ---------------
    try:
        scan = LocalScanExec(table)
        filt = FilterExec(filt_expr, scan)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE, filt)
        rb = pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names)
        for _ in range(2):                 # the second pass is reported
            stages, val = {}, None
            t1 = time.perf_counter()
            for name, step in (
                    ("upload", lambda _: batch_to_device(rb, dev)),
                    ("filter", filt._compute),
                    ("update", agg._update_batch),
                    ("evaluate", agg._evaluate_batch),
                    ("download", download_fetched)):
                val = step(val)
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("stages (ms): " + " ".join(f"{k}={v:.2f}"
                                         for k, v in stages.items()))
        evaluated = agg._evaluate_batch(agg._update_batch(filt._compute(
            batch_to_device(rb, dev))))
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, evaluated)
        print(f"q1 download (ms): {_split_line(split)}; {nbytes} bytes "
              f"packed, plan {plan}")
        del val, evaluated
        trace = _profile(torch, df.collect)
        print(f"trace of a warm DataFrame q1: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"])
              + f"; torch gather kernels {trace['gather_ms']:.3f} ms")
    except Exception:
        failures.append("stage split")
        traceback.print_exc()

    # ---- main path: exec level, 8 batches ------------------------------
    try:
        scan = LocalScanExec(table, batch_rows=BATCH_ROWS)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE,
                                   FilterExec(filt_expr, scan))
        _check_q1(agg.execute_collect(ExecContext(dev)), want,
                  "exec q1 (cold)")
        count_reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = agg.execute_collect(ExecContext(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["batches"] = counts()
        _check_q1(got, want, "exec q1 (8 batches)")
        print(f"main path exec q1 ({ROWS // BATCH_ROWS} batches of "
              f"{BATCH_ROWS} rows): warm wall {wall * 1e3:.1f} ms, "
              f"{ROWS / wall / 1e6:.1f} M rows/s, launches "
              f"{launches['batches']}")
    except Exception:
        failures.append("main path (8 batches)")
        traceback.print_exc()

    # ---- main path: q2 through the DataFrame API ----------------------
    def check_q2(got, what):
        got = got.sort_by("k")
        if got.column_names != ["k", "sw"]:
            raise AssertionError(f"{what}: columns {got.column_names}")
        if got.num_rows != q2_want.num_rows or not np.array_equal(
                got["k"].to_numpy(), q2_want["k"].to_numpy()):
            raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                                 f"{q2_want.num_rows}, or other keys")
        sw, ww = got["sw"].to_numpy(), q2_want["w_sum"].to_numpy()
        if not np.all(np.isfinite(sw)) or not np.allclose(
                sw, ww, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"{what}: sum(w) differs by up to "
                                 f"{np.max(np.abs(sw - ww))}")

    q2_session = q2df = None
    try:
        q2_session = GpuSession()
        q2df = (q2_session.create_dataframe(table)
                .join(q2_session.create_dataframe(dim), on="k", how="inner")
                .group_by(col("k"))
                .agg(F.sum(col("w")).alias("sw")))
        t1 = time.perf_counter()
        check_q2(q2df.collect(), "DataFrame q2 (cold)")
        cold_wall = time.perf_counter() - t1
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q2df.collect()
        torch.cuda.synchronize()
        launches["q2"] = counts()
        check_q2(got, "DataFrame q2")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q2df.collect()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        print(f"main path DataFrame q2 ({ROWS} fact rows joined with "
              f"{DIM_ROWS} dimension rows, then grouped by k): cold wall "
              f"{cold_wall * 1e3:.1f} ms (upload included); warm wall median "
              f"of 3 {sorted(walls)[1]:.1f} ms ({', '.join(f'{w:.1f}' for w in walls)}), "
              f"{ROWS / sorted(walls)[1] / 1e3:.1f} M fact rows/s, "
              f"{got.num_rows} groups, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches['q2']}")
        # the hash join alone, at exec level
        join = HashJoinExec([A("k")], [A("k")], "inner", None,
                            LocalScanExec(table), LocalScanExec(dim))
        out = join.execute_collect(ExecContext(dev))
        if out.num_rows != joined.num_rows:
            raise AssertionError(f"exec-level join: {out.num_rows} rows, "
                                 f"pyarrow {joined.num_rows}")
        if pc.sum(out["v"]).as_py() != pc.sum(joined["v"]).as_py():
            raise AssertionError("exec-level join: sum(v) differs")
        sw_got, sw_want = pc.sum(out["w"]).as_py(), pc.sum(joined["w"]).as_py()
        if not np.isclose(sw_got, sw_want, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"exec-level join: sum(w) {sw_got} vs "
                                 f"{sw_want}")
        print(f"exec-level HashJoinExec inner: {out.num_rows} rows, sum(v) "
              f"exact, sum(w) within {FLOAT_RTOL:g}")
        del out, join
    except Exception:
        failures.append("main path (q2)")
        traceback.print_exc()

    # ---- where q2's time goes: stage by stage, and a trace -------------
    try:
        by_name = {}
        q2_session.last_plan.foreach(
            lambda e: by_name.setdefault(type(e).__name__, e))
        agg_q2 = by_name["GpuHashAggregateExec"]
        project = by_name["ProjectExec"]
        join = by_name["HashJoinExec"]
        ctx = ExecContext(dev)
        probe = next(iter(join.children[0].execute_partition(0, ctx)))
        build = join._collect_build(ctx)
        for _ in range(2):                 # the second pass is reported
            stages, st = {}, {}
            t1 = time.perf_counter()

            def count():
                st["order"], st["lo"], st["counts"], st["plive"] = \
                    join._count(st["side"], probe)

            def expand():
                st["out"], _ = join._expand(build, probe, st["order"],
                                            st["lo"], st["counts"],
                                            st["plive"], "inner")

            for name, step in (
                    ("hash", lambda: st.update(
                        hashes=join._hash_keys(build))),
                    ("build", lambda: st.update(
                        side=jk.sort_build(*st["hashes"]))),
                    ("count", count),
                    ("expand", expand),
                    ("project", lambda: st.update(
                        out=project._compute(st["out"]))),
                    ("update", lambda: st.update(
                        out=agg_q2._update_batch(st["out"]))),
                    ("evaluate", lambda: st.update(
                        out=agg_q2._evaluate_batch(st["out"]))),
                    ("download", lambda: st.update(
                        ev=st["out"], out=download_fetched(st["out"])))):
                step()
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("q2 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items()))
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, st["ev"])
        print(f"q2 download (ms): {_split_line(split)}; {nbytes} bytes "
              f"packed, plan {plan}")
        del st, probe, build
        trace = _profile(torch, q2df.collect)
        print(f"trace of a warm DataFrame q2: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        before = trace["before_probe"]
        print(f"q2 trace, device work before K4's probe in launch order: "
              f"{len(before)} items, {sum(ms for _, ms in before):.3f} ms, "
              f"the longest {max((ms for _, ms in before), default=0):.3f} "
              f"ms: " + ", ".join(f"{n}={ms:.3f}" for n, ms in before))
    except Exception:
        failures.append("q2 stage split")
        traceback.print_exc()

    # ---- main path: q6 (4-partition fact, 2-partition dimension) -----
    q6_plan = ["DeviceToHostExec", "CoalesceBatchesExec",
               "GpuHashAggregateExec", "CoalesceBatchesExec", "ProjectExec",
               "BroadcastHashJoinExec", "CoalesceBatchesExec",
               "GatherPartitionsExec", "LocalScanExec",
               "BroadcastExchangeExec", "LocalScanExec"]
    try:
        q6_session = GpuSession()
        q6df = (q6_session.create_dataframe(table, num_partitions=4)
                .join(q6_session.create_dataframe(dim, num_partitions=2),
                      on="k", how="inner")
                .group_by(col("k"))
                .agg(F.sum(col("w")).alias("sw")))
        t1 = time.perf_counter()
        check_q2(q6df.collect(), "DataFrame q6 (cold)")
        cold_wall = time.perf_counter() - t1
        nodes = _placements(q6_session.last_plan)
        if [n for n, _ in nodes] != q6_plan:
            raise AssertionError(f"q6 planned {[n for n, _ in nodes]}")
        if nodes[0][1] != "cpu" or any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"q6 placements {nodes}")
        if "!" in q6_session.last_explain:
            raise AssertionError("q6 explain has a CPU fallback:\n"
                                 + q6_session.last_explain)
        print("q6 converted plan (* = GPU):\n"
              + q6_session.last_plan.tree_string())
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q6df.collect()
        torch.cuda.synchronize()
        launches["q6"] = counts()
        check_q2(got, "DataFrame q6")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q6df.collect()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        print(f"main path DataFrame q6 ({ROWS} fact rows in 4 partitions "
              f"joined with {DIM_ROWS} dimension rows in 2, then grouped "
              f"by k): cold wall {cold_wall * 1e3:.1f} ms (upload "
              f"included); warm walls {', '.join(f'{w:.1f}' for w in walls)}"
              f" ms, median {sorted(walls)[1]:.1f}, {got.num_rows} groups, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"probe batches {launches['q6']['join_probe']}, launches "
              f"{launches['q6']}")
        # each probe batch's round: K4's count, the host read, K7 and K5
        by_name = {}
        q6_session.last_plan.foreach(
            lambda e: by_name.setdefault(type(e).__name__, e))
        join = by_name["BroadcastHashJoinExec"]
        ctx = ExecContext(dev, q6_session.conf)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probes = list(join.children[0].execute_partition(0, ctx))
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t1) * 1e3
        build = join._collect_build(ctx)
        side = jk.sort_build(*join._hash_keys(build))
        rounds = []
        for _ in range(2):                 # the second pass is reported
            rounds = []
            for probe in probes:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                order, lo, cnts, plive = join._count(side, probe)
                out, _ = join._expand(build, probe, order, lo, cnts, plive,
                                      "inner")
                torch.cuda.synchronize()
                rounds.append((probe.num_rows, out.num_rows,
                               (time.perf_counter() - t1) * 1e3))
                del out
        print(f"q6 probe side: {len(probes)} coalesced batches from 4 "
              f"partitions in {gather_ms:.2f} ms (gather and coalesce of the "
              f"device-resident partitions, target "
              f"{basic_mod.TARGET_ROWS} rows); rounds "
              f"(count -> host read -> expand): "
              + ", ".join(f"{p} probe rows -> {o} rows {ms:.2f} ms"
                          for p, o, ms in rounds))
        del probes, build, side, join, by_name
        trace = _profile(torch, q6df.collect)
        print(f"trace of a warm DataFrame q6: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q6df, q6_session
    except Exception:
        failures.append("main path (q6)")
        traceback.print_exc()

    # ---- main path: q1 over 4 partitions --------------------------------
    try:
        s4 = GpuSession()
        df4 = (s4.create_dataframe(table, num_partitions=4)
               .filter(col("v") > THRESHOLD)
               .group_by(col("k"))
               .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                    F.count("*").alias("c")))
        _check_q1(df4.collect(), want, "DataFrame q1, 4 partitions (cold)")
        nodes = _placements(s4.last_plan)
        if nodes[0] != ("DeviceToHostExec", "cpu") or \
                any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"q1 over 4 partitions placed {nodes}")
        count_reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = df4.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["q1_4"] = counts()
        _check_q1(got, want, "DataFrame q1, 4 partitions")
        print(f"main path DataFrame q1 (4 partitions of {ROWS // 4} rows): "
              f"warm wall {wall * 1e3:.1f} ms, plan "
              f"{[n for n, _ in nodes]}, launches {launches['q1_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q1, 4 partitions)")
        traceback.print_exc()

    def timed_walls(fn, reps=3):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        return walls

    # ---- main path: q1x, the TPC-H Q1 shape, one partition and four ---
    q1x_want = None
    try:
        t1 = time.perf_counter()
        q1x_want = _q1x_oracle(table)
        print(f"numpy q1x oracle: {sum(r['c'] for r in q1x_want)} rows "
              f"kept in 6 groups of {min(r['c'] for r in q1x_want)} to "
              f"{max(r['c'] for r in q1x_want)} rows, "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            sx = GpuSession()
            dfx = _q1x_df(sx, table, parts, F, col, lit)
            t1 = time.perf_counter()
            _check_q1x(dfx.collect(), q1x_want,
                       f"q1x over {parts} partitions (cold)")
            cold_wall = time.perf_counter() - t1
            nodes = _placements(sx.last_plan)
            if nodes[0] != ("DeviceToHostExec", "cpu") or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sx.last_explain:
                raise AssertionError(f"q1x over {parts} partitions placed "
                                     f"{nodes}:\n{sx.last_explain}")
            run = "q1x" if parts == 1 else "q1x_4"
            count_reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            got = dfx.collect()
            torch.cuda.synchronize()
            launches[run] = counts()
            _check_q1x(got, q1x_want, f"q1x over {parts} partitions")
            walls = timed_walls(dfx.collect)
            trace = _profile(torch, dfx.collect)
            print(f"main path DataFrame q1x ({ROWS} rows in {parts} "
                  f"partition(s): filter f <= 0.98 and v is not null, "
                  f"project k % 3, CASE WHEN, Q1's price arithmetic, group "
                  f"by (rf, ls): 3 sums, 2 averages, count, min and max of "
                  f"disc and v, sort): plan {[n for n, _ in nodes]}, "
                  f"GPU-only; equals the numpy oracle (ints, counts, min "
                  f"and max exactly, float sums and averages to "
                  f"{FLOAT_RTOL:g}); cold wall {cold_wall * 1e3:.1f} ms; "
                  f"warm walls {', '.join(f'{w:.1f}' for w in walls)} ms, "
                  f"median {sorted(walls)[1]:.1f}; peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {launches[run]}; {card}")
            print(f"trace of a warm q1x over {parts} partition(s): wall "
                  f"{trace['wall_ms']:.2f} ms, device busy "
                  f"{trace['busy_ms']:.2f} ms, idle share "
                  f"{trace['idle_share']:.3f}; top kernels (ms): "
                  + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"])
                  + f"; {card}")
            if parts == 1:
                # K3 with the min and max ops at q1x's shapes: the
                # aggregate's update over the projected batch
                by_name = {}
                sx.last_plan.foreach(
                    lambda e: by_name.setdefault(type(e).__name__, e))
                aggx = by_name["GpuHashAggregateExec"]
                ctx = ExecContext(dev, sx.conf)
                inx = next(iter(aggx.children[0].execute_partition(0, ctx)))
                nx = inx.num_rows
                kx, vx = aggx._update_columns(inx)
                wx = [w for c in kx for w in seg.key_words_for_column(
                    agg_mod._prefix(c, nx))]
                ox = carry.sort_order(wx)
                lx, cx, opsx, _ = agg_mod.k3_ops(
                    [agg_mod._prefix(c, nx) for c in vx], aggx._update_ops)
                x_args = (wx, None, lx, cx, False, ox, opsx)
                res = agg_mod.segment_reduce_sorted(*x_args)
                plain = agg_mod.segment_reduce_sorted_plain(*x_args)
                x_err = 0.0
                _k3_minmax_diff(torch, res, plain, opsx, "at q1x's shapes")
                for sv_, sp_, op in zip(res[1], plain[1], opsx):
                    if op == "sum" and sv_ is not None and \
                            sv_.dtype == torch.float64:
                        x_err = max(x_err, float((sv_ - sp_).abs().max()))
                mm = [k for k, op in enumerate(opsx) if op in ("min", "max")]
                ids_sorted = torch.cumsum(seg.segment_boundaries(
                    [w.index_select(0, ox) for w in wx],
                    torch.ones(nx, dtype=torch.bool, device=dev)), 0) - 1
                idsx = torch.empty_like(ids_sorted).index_put_(
                    (ox.long(),), ids_sorted)
                gx = res[3]

                def mm_library():
                    return [torch.full((gx,), 0, dtype=lx[k].dtype,
                                       device=dev).scatter_reduce_(
                        0, idsx, lx[k], "amin" if opsx[k] == "min"
                        else "amax", include_self=False) for k in mm]
                distinct = {x.data_ptr(): x for x in lx + cx
                            if x is not None}
                in_bytes = (4 + 8 * len(wx)) * nx + sum(
                    x.element_size() * nx for x in distinct.values())
                out_bytes = gx * (4 + 8 * len(lx)
                                  + 8 * sum(x is not None for x in lx))
                kernel_rows["segment_reduce_sorted_minmax"] = dict(
                    source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
                    replaces="spark_rapids_tpu/ops/segmented.py:251",
                    max_abs_err=x_err,
                    ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted(
                        *x_args)),
                    plain_ms=cuda_ms(
                        lambda: agg_mod.segment_reduce_sorted_plain(
                            *x_args)),
                    library_ms=cuda_ms(mm_library),
                    bound_ms=bound(in_bytes + out_bytes),
                    extra=_k3_turns(torch, agg_mod, cuda_ms, x_args, card,
                                    "with min/max at q1x's shapes"))
                r = kernel_rows["segment_reduce_sorted_minmax"]
                print(f"K3 with min/max at q1x's shapes: rows {nx}, groups "
                      f"{gx}, {len(opsx)} ops ({', '.join(opsx)}), key "
                      f"words {len(wx)}; min and max bit for bit, float "
                      f"sums max abs err {x_err:.3g}; {r['ms']:.3f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, library "
                      f"(scatter_reduce amin/amax of the {len(mm)} min/max "
                      f"lanes) {r['library_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.3f} ms ({in_bytes + out_bytes} "
                      f"bytes); {card}")
                del by_name, aggx, inx, kx, vx, wx, ox, lx, cx, res, plain
                del ids_sorted, idsx, distinct
            del dfx, sx, got
    except Exception:
        failures.append("main path (q1x)")
        traceback.print_exc()
    q1x_want = None

    # ---- main path: q3, the global sort, through the DataFrame API -----

    q3_want = None
    try:
        t1 = time.perf_counter()
        q3_want = table.sort_by([("k", "ascending"), ("v", "ascending")])
        ks, vs = q3_want["k"].to_numpy(), q3_want["v"].to_numpy()
        ties = int(np.sum((ks[1:] == ks[:-1]) & (vs[1:] == vs[:-1])))
        print(f"pyarrow q3 oracle: {q3_want.num_rows} rows sorted by (k, v) "
              f"in {time.perf_counter() - t1:.1f} s; {ties} rows tie with "
              f"the row before on (k, v), so f's order checks stability")
        del ks, vs
        # the direct collect (every lane fetched); the host-assisted
        # collect, the default, is the "q3 both ways" phase below
        q3_session = GpuSession(conf={COLLECT_KEY: False})
        q3df = q3_session.create_dataframe(table).sort(col("k"), col("v"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = q3df.collect()
        cold_wall = time.perf_counter() - t1
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3 (cold) differs from pyarrow's "
                                 "sort")
        nodes = _placements(q3_session.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("SortExec", "gpu"),
                     ("LocalScanExec", "gpu")] or \
                "!" in q3_session.last_explain:
            raise AssertionError(f"q3 planned {nodes}:\n"
                                 + q3_session.last_explain)
        count_reset()
        carry.sort_order.passes = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q3df.collect()
        torch.cuda.synchronize()
        launches["q3"] = counts()
        q3_run_passes = carry.sort_order.passes
        peak = torch.cuda.max_memory_allocated()
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3 differs from pyarrow's sort")
        for name, want_n in (("lane_stats", 1), ("pack_lanes", 1)):
            if launches["q3"][name] != want_n:
                raise AssertionError(f"{name} launched "
                                     f"{launches['q3'][name]} times on q3, "
                                     f"not {want_n}")
        del got
        walls = timed_walls(q3df.collect)
        wall = sorted(walls)[1]
        print(f"main path DataFrame q3, direct collect ({ROWS} rows, sort "
              f"by k, v -> collect): plan {[n for n, _ in nodes]}, GPU-only, one "
              f"DeviceToHostExec; equals pyarrow's sort exactly (k, v, f); "
              f"cold wall {cold_wall * 1e3:.1f} ms (upload included); warm "
              f"walls {', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{wall:.1f}, {ROWS / wall / 1e3:.1f} M rows/s; peak "
              f"{peak / 2**30:.2f} GiB; K2 passes {q3_run_passes}; launches "
              f"{launches['q3']}")

        # where q3's time goes: stage by stage, then a trace
        scan3 = LocalScanExec(table)
        sorter = SortExec(q3_orders, scan3)
        batch3 = next(scan3.execute_partition(0, ExecContext(dev)))
        for _ in range(2):                 # the second pass is reported
            stages, st = {}, {}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for name, step in (
                    ("words", lambda: st.update(
                        words=sorter.sort_words(batch3))),
                    ("K2", lambda: st.update(
                        order=carry.sort_order(st["words"]))),
                    ("K8", lambda: st.update(lanes=gather_mod.gather_rows(
                        st["order"], fetch.batch_lanes(batch3))))):
                step()
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        sorted3 = DeviceBatch(
            [DeviceColumn(c.dtype, st["lanes"][2 * i], st["lanes"][2 * i + 1])
             for i, c in enumerate(batch3.columns)], batch3.num_rows,
            batch3.names)
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, sorted3)
        # the host rebuild's floor: fresh host pages for the three lanes
        t1 = time.perf_counter()
        touched = [torch.empty(batch3.num_rows, dtype=c.data.dtype).fill_(0)
                   for c in batch3.columns]
        touch_ms = (time.perf_counter() - t1) * 1e3
        full = sum(x.element_size() for x in fetch.batch_lanes(batch3)) \
            * batch3.num_rows
        print("q3 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items())
              + f"; download {_split_line(split)}; packed {nbytes} of "
              f"{full} lane bytes, copy {nbytes / split['copy'] / 1e6:.1f} "
              f"GB/s; plan {plan}; first touch of {len(touched)} fresh "
              f"host lanes of {batch3.num_rows} rows {touch_ms:.2f} ms")
        del st, batch3, scan3, sorter, touched, sorted3
        trace = _profile(torch, q3df.collect)
        print(f"trace of a warm DataFrame q3 (direct collect): wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q3df, q3_session
    except Exception:
        failures.append("main path (q3)")
        traceback.print_exc()

    # ---- main path: q3 over 4 partitions -------------------------------
    try:
        if q3_want is None:
            raise AssertionError("no q3 oracle")
        s4 = GpuSession(conf={COLLECT_KEY: False})
        df4 = s4.create_dataframe(table, num_partitions=4).sort(col("k"),
                                                                col("v"))
        if not _same_table(df4.collect(), q3_want):
            raise AssertionError("DataFrame q3, 4 partitions (cold) differs "
                                 "from pyarrow's sort")
        nodes = _placements(s4.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("SortExec", "gpu"),
                     ("GatherPartitionsExec", "gpu"),
                     ("LocalScanExec", "gpu")] or "!" in s4.last_explain:
            raise AssertionError(f"q3 over 4 partitions planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = df4.collect()
        torch.cuda.synchronize()
        launches["q3_4"] = counts()
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3, 4 partitions, differs from "
                                 "pyarrow's sort")
        del got
        walls = timed_walls(df4.collect)
        print(f"main path DataFrame q3, direct collect (4 partitions of "
              f"{ROWS // 4} rows): "
              f"range exchange stripped, plan {[n for n, _ in nodes]}; "
              f"equals pyarrow's sort; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q3_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q3, 4 partitions)")
        traceback.print_exc()

    # ---- q3 both ways: the host-assisted collect and the direct --------
    try:
        if q3_want is None:
            raise AssertionError("no q3 oracle")
        for parts in (1, 4):
            tag = "" if parts == 1 else f"_{parts}"
            sd = GpuSession(conf={COLLECT_KEY: False})
            sa = GpuSession(conf={COLLECT_KEY: True})
            dfd = sd.create_dataframe(table, num_partitions=parts).sort(
                col("k"), col("v"))
            dfa = sa.create_dataframe(table, num_partitions=parts).sort(
                col("k"), col("v"))
            for way, df_ in (("direct", dfd), ("host-assisted", dfa)):
                with _Capture(carry, "gather_rows") as cap8, \
                        _Capture(fetch, "lane_stats", "pack_lanes") as cap9:
                    if not _same_table(df_.collect(), q3_want):   # cold
                        raise AssertionError(f"q3 over {parts} partitions, "
                                             f"{way} (cold), differs from "
                                             f"pyarrow's sort")
            # the assisted run's K8 (k, v, rid), K9 and K10 (the rid
            # lane) against their plain versions on the same inputs
            seen = []
            for cap in (cap8, cap9):
                seen += _check_captured(torch, cap, carry, gather_mod, fetch,
                                        f"q3 host-assisted x{parts}")
            del cap8, cap9
            print(f"q3 host-assisted over {parts} partition(s), kernels on "
                  f"the path's own inputs, each exact against its plain "
                  f"version: {'; '.join(seen)}")
            count_reset()
            torch.cuda.synchronize()
            with _FetchTap(fetch) as tap:
                got = dfa.collect()
            torch.cuda.synchronize()
            launches["q3_assisted" + tag] = counts()
            if not _same_table(got, q3_want):
                raise AssertionError(f"q3 over {parts} partitions, "
                                     f"host-assisted, differs from "
                                     f"pyarrow's sort")
            del got
            nodes = [n for n, _ in _placements(sa.last_plan)]
            want_nodes = ["DeviceToHostExec", "CoalesceBatchesExec",
                          "ProjectExec", "SortExec"] + (
                ["GatherPartitionsExec"] if parts > 1 else []) + [
                "ProjectExec", "LocalScanExec"]
            if nodes != want_nodes or "!" in sa.last_explain or \
                    "__rid__" not in sa.last_plan.tree_string():
                raise AssertionError(f"the row-id query over {parts} "
                                     f"partitions planned {nodes}")
            (plan,) = tap.plans
            rid_bytes = {"narrow": plan[0][-1], "none": 8}[plan[0][0]]
            if rid_bytes != (4 if parts == 1 else 8):
                raise AssertionError(f"the rid lane travels as {plan[0]}")
            # in turns: direct, assisted, assisted, direct
            walls_d = timed_walls(dfd.collect, 2)
            walls_a = timed_walls(dfa.collect, 3)
            walls_d += timed_walls(dfd.collect, 1)
            # the assisted collect split: the row-id query (device and
            # the rid lane's fetch), then the host take
            split = []
            inner = sa.execute

            def timed_execute(lp):
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out = inner(lp)
                split.append((time.perf_counter() - t2) * 1e3)
                return out
            sa.execute = timed_execute
            takes = []
            for _ in range(2):
                split.clear()
                t1 = time.perf_counter()
                got = host_assist.try_host_assisted_collect(sa, dfa._lp)
                takes.append((split[0], (time.perf_counter() - t1) * 1e3
                              - split[0]))
                if not _same_table(got, q3_want):
                    raise AssertionError("the split run differs")
                del got
            del sa.execute
            trace = _profile(torch, dfa.collect)
            print(f"q3 both ways over {parts} partition(s) ({ROWS} rows): "
                  f"both equal pyarrow's sort exactly; direct warm walls "
                  f"{', '.join(f'{w:.1f}' for w in walls_d)} ms, median "
                  f"{sorted(walls_d)[1]:.1f}; host-assisted "
                  f"{', '.join(f'{w:.1f}' for w in walls_a)} ms, median "
                  f"{sorted(walls_a)[1]:.1f} (two split runs: row-id "
                  f"query + host take "
                  + ", ".join(f"{q:.1f} + {tk:.1f}" for q, tk in takes)
                  + " ms); "
                  f"rid lane {rid_bytes} bytes a row ({plan[0]}), "
                  f"{tap.bytes} bytes fetched; plan {nodes}; trace: busy "
                  f"{trace['busy_ms']:.2f} ms, idle share "
                  f"{trace['idle_share']:.3f}; launches "
                  f"{launches['q3_assisted' + tag]}")
            del dfd, dfa, sd, sa
    except Exception:
        failures.append("q3 both ways")
        traceback.print_exc()
    q3_want = None

    # ---- main path: q5, four parquet files -> filter -> group by k ----
    q5_root = tempfile.mkdtemp(prefix="chip_smoke_q5_")
    try:
        t1 = time.perf_counter()
        q5_path = _write_parquet_input(table, q5_root)
        write_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        q5_want = _q5_oracle(q5_path)
        on_disk = sum(os.path.getsize(os.path.join(q5_path, f))
                      for f in os.listdir(q5_path))
        print(f"q5 input: 4 parquet files of {ROWS // 4} rows written in "
              f"{write_s:.1f} s ({on_disk} bytes); "
              f"pyarrow oracle {q5_want.num_rows} groups in "
              f"{time.perf_counter() - t1:.1f} s")
        s5 = GpuSession()
        q5df = _q5_df(s5, q5_path, F, col)
        q5df.explain()
        nodes = _placements(s5.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"), ("FilterExec", "gpu"),
                     ("FileScanExec", "gpu")] or "!" in s5.last_explain:
            raise AssertionError(f"q5 planned {nodes}")
        scan5 = [e for e in _nodes(s5.last_plan)
                 if type(e).__name__ == "FileScanExec"][0]
        if scan5.reader_type != "COALESCING" or scan5.num_partitions != 1:
            raise AssertionError(f"q5's scan is {scan5.describe()}")
        # cold: the pin cleared, split into decode, upload and the rest
        io_scan.clear_filescan_pin()
        torch.cuda.synchronize()
        with _ScanTap(torch, io_scan) as cold_tap:
            t1 = time.perf_counter()
            got = q5df.collect()
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t1) * 1e3
        _check_q5(got, q5_want, "q5 (cold)")
        if len(cold_tap.files) != 4:
            raise AssertionError(f"the cold q5 read {cold_tap.files}")
        io_scan.clear_filescan_pin()
        cold_trace = _profile(torch, q5df.collect)
        # warm, pinned: reads no file
        count_reset()
        torch.cuda.synchronize()
        with _ScanTap(torch, io_scan) as warm_tap:
            got = q5df.collect()
            torch.cuda.synchronize()
            launches["q5"] = counts()
            _check_q5(got, q5_want, "q5 (warm, pinned)")
            walls = timed_walls(q5df.collect)
        if warm_tap.files:
            raise AssertionError(f"the warm pinned q5 read "
                                 f"{warm_tap.files}")
        trace = _profile(torch, q5df.collect)
        # the pin off: every run decodes and uploads
        soff = GpuSession(conf={PIN_KEY: False})
        q5off = _q5_df(soff, q5_path, F, col)
        with _Capture(carry, "compact_lanes") as cap1:
            _check_q5(q5off.collect(), q5_want, "q5 (pin off)")
        # K1 on the batch the host pushdown left, against its plain version
        seen = _check_captured(torch, cap1, carry, gather_mod, fetch, "q5")
        del cap1
        print(f"q5 K1 on the path's own input, exact against its plain "
              f"version: {'; '.join(seen)}")
        with _ScanTap(torch, io_scan) as off_tap:
            walls_off = timed_walls(q5off.collect)
        if len(off_tap.files) != 12:
            raise AssertionError(f"q5 with the pin off read "
                                 f"{len(off_tap.files)} files in 3 runs")
        print(f"main path q5 ({ROWS} rows in 4 parquet files, COALESCING, "
              f"one partition): equals pyarrow exactly; cold wall "
              f"{cold:.1f} ms = host decode {cold_tap.decode_ms:.1f} "
              f"(the pushed f < 0.5 filters rows on the host) + upload "
              f"{cold_tap.upload_ms:.1f} ({cold_tap.upload_bytes} bytes "
              f"of Arrow) + the rest "
              f"{cold - cold_tap.decode_ms - cold_tap.upload_ms:.1f}; cold "
              f"trace wall {cold_trace['wall_ms']:.1f} ms, device busy "
              f"{cold_trace['busy_ms']:.2f}, idle share "
              f"{cold_trace['idle_share']:.3f}; warm pinned walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}, no file read; busy "
              f"{trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"][:6])
              + f"; pin off walls {', '.join(f'{w:.1f}' for w in walls_off)}"
              f" ms, median {sorted(walls_off)[1]:.1f} (decode "
              f"{off_tap.decode_ms / 3:.1f}, upload "
              f"{off_tap.upload_ms / 3:.1f} a run); launches "
              f"{launches['q5']}")
        del q5df, q5off, s5, soff, got
        io_scan.clear_filescan_pin()
        # PERFILE: 4 partitions; the hash exchange stripped
        sp = GpuSession(conf={READER_KEY: "PERFILE"})
        q5p = _q5_df(sp, q5_path, F, col)
        _check_q5(q5p.collect(), q5_want, "q5 PERFILE (cold)")
        nodes = _placements(sp.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GatherPartitionsExec", "gpu"), ("FilterExec", "gpu"),
                     ("FileScanExec", "gpu")] or "!" in sp.last_explain:
            raise AssertionError(f"q5 PERFILE planned {nodes}")
        count_reset()
        got = q5p.collect()
        launches["q5_4"] = counts()
        _check_q5(got, q5_want, "q5 PERFILE")
        walls = timed_walls(q5p.collect)
        print(f"main path q5 PERFILE (4 partitions): GPU-only plan "
              f"{[n for n, _ in nodes]}, the hash exchange stripped; equals "
              f"pyarrow; warm pinned walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q5_4']}")
        del q5p, sp, got
    except Exception:
        failures.append("main path (q5)")
        traceback.print_exc()
    finally:
        io_scan.clear_filescan_pin()
        shutil.rmtree(q5_root, ignore_errors=True)

    # ---- main path: q7, filter(v > 0) -> parquet write ------------------
    q7_root = tempfile.mkdtemp(prefix="chip_smoke_q7_")
    try:
        want7 = table.filter(pc.greater(table["v"], 0))
        out7 = os.path.join(q7_root, "out")
        ways = {}
        for assisted in (True, False):
            s7 = GpuSession(conf={WRITE_KEY: assisted})
            fdf = s7.create_dataframe(table)

            def write():
                fdf.filter(col("v") > 0).write.mode("overwrite").parquet(
                    out7)
            way = "host-assisted" if assisted else "direct"
            with _Capture(fetch, "lane_stats", "pack_lanes") as cap9:
                write()                             # cold: the upload
            # K9 and K10 on the path's own lanes (the assisted way's
            # bit-packed keep mask) against their plain versions
            seen = _check_captured(torch, cap9, carry, gather_mod, fetch,
                                   f"q7 {way}")
            del cap9
            print(f"q7 {way}, kernels on the path's own inputs, each exact "
                  f"against its plain version: {'; '.join(seen)}")
            count_reset()
            torch.cuda.synchronize()
            with _FetchTap(fetch) as tap:
                write()
            torch.cuda.synchronize()
            run = "q7" if assisted else "q7_direct"
            launches[run] = counts()
            for check in ("checked", "last timed"):
                rows, files = _footer_rows(out7)
                if rows != want7.num_rows or len(files) != 1:
                    raise AssertionError(
                        f"q7 {way} ({check} run): footers count {rows} rows "
                        f"in {len(files)} files, not {want7.num_rows} in 1")
                if not _same_table(pq.read_table(files[0]), want7):
                    raise AssertionError(f"q7 {way} ({check} run) reads "
                                         f"back unlike fact.filter(v > 0)")
                if check == "checked":
                    walls = timed_walls(write)
            if assisted and "__keep__" not in s7.last_plan.tree_string():
                raise AssertionError("the assisted write ran no mask plan")
            # split: the rows to write (mask and host filter, or the
            # device filter and the payload's fetch), then the encode
            writer = fdf.filter(col("v") > 0).write.mode("overwrite")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows7 = writer._collect()
            t2 = time.perf_counter()
            writer._write_one(rows7, q7_root, "parquet")
            split = ((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3)
            del rows7
            ways[way] = (walls, tap.bytes, tap.plans, split)
            del fdf, s7
        print(f"main path q7 ({ROWS} rows, filter(v > 0) -> parquet, "
              f"{want7.num_rows} rows written): footers and read-back equal "
              f"fact.filter(v > 0) both ways; "
              + "; ".join(f"{way}: warm walls "
                          f"{', '.join(f'{w:.1f}' for w in walls)} ms, "
                          f"median {sorted(walls)[1]:.1f} (split: the rows "
                          f"{rows_ms:.1f} + the parquet encode "
                          f"{encode_ms:.1f}), {nbytes} bytes fetched "
                          f"(plan {plans})"
                          for way, (walls, nbytes, plans,
                                    (rows_ms, encode_ms)) in ways.items())
              + f"; launches {launches['q7']} (host-assisted), "
              f"{launches['q7_direct']} (direct)")
    except Exception:
        failures.append("main path (q7)")
        traceback.print_exc()
    finally:
        shutil.rmtree(q7_root, ignore_errors=True)

    # ---- a scan left on the CPU: format.parquet.enabled=false ----------
    cpu_root = tempfile.mkdtemp(prefix="chip_smoke_cpu_scan_")
    try:
        small_path = _write_parquet_input(table.slice(0, 1 << 20), cpu_root)
        sc = GpuSession(conf={"spark.rapids.sql.format.parquet.enabled":
                              False})
        count_reset()
        got = _q5_df(sc, small_path, F, col).collect()
        c = counts()
        _check_q5(got, _q5_oracle(small_path), "q5 with the scan on the CPU")
        nodes = _placements(sc.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"), ("FilterExec", "gpu"),
                     ("HostToDeviceExec", "gpu"), ("FileScanExec", "cpu")] \
                or "parquet scan disabled by config" not in sc.last_explain:
            raise AssertionError(f"q5 with the scan off planned {nodes}:\n"
                                 + sc.last_explain)
        for name in ("compact_rows", "sort_order", "segment_reduce_sorted"):
            if c[name] < 1:
                raise AssertionError(f"{name} not launched above the CPU "
                                     f"scan")
        if io_scan._FILESCAN_PIN:
            raise AssertionError("a CPU-placed scan pinned its batches")
        print(f"q5 at {1 << 20} rows with format.parquet.enabled=false: the "
              f"scan CPU-placed ('parquet scan disabled by config'), a "
              f"HostToDeviceExec above it, the rest on the GPU; equals "
              f"pyarrow; launches {c}")
        del sc, got
    except Exception:
        failures.append("CPU-placed scan")
        traceback.print_exc()
    finally:
        shutil.rmtree(cpu_root, ignore_errors=True)

    # ---- main path: q4, the window, through the DataFrame API --------
    q4_want = None

    def q4_df(session, parts):
        w = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
        return session.create_dataframe(table, num_partitions=parts).select(
            col("k"), col("v"), F.row_number().over(w).alias("rn"),
            F.sum(col("v")).over(w).alias("rs"))

    try:
        t1 = time.perf_counter()
        q4_rn, q4_rs, q4_ties, q4_parts = _q4_oracle(table)
        q4_want = (q4_rn, q4_rs)
        print(f"numpy q4 oracle: {table.num_rows} rows, {q4_parts} "
              f"partitions (about {table.num_rows // q4_parts} rows each), "
              f"{q4_ties} rows tie with the row before on (k, v) and share "
              f"its running sum, {time.perf_counter() - t1:.1f} s")
        q4_session = GpuSession()
        q4df = q4_df(q4_session, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = q4df.collect()
        cold_wall = time.perf_counter() - t1
        _check_q4(got, table, q4_rn, q4_rs, "DataFrame q4 (cold)")
        nodes = _placements(q4_session.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("ProjectExec", "gpu"),
                     ("WindowExec", "gpu"), ("LocalScanExec", "gpu")] or \
                "!" in q4_session.last_explain:
            raise AssertionError(f"q4 planned {nodes}:\n"
                                 + q4_session.last_explain)
        count_reset()
        carry.sort_order.passes = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q4df.collect()
        torch.cuda.synchronize()
        launches["q4"] = counts()
        q4_run_passes = carry.sort_order.passes
        peak = torch.cuda.max_memory_allocated()
        _check_q4(got, table, q4_rn, q4_rs, "DataFrame q4")
        for name in ("sort_order", "gather_rows", "segment_scan", "run_ends",
                     "scatter_rows", "lane_stats", "pack_lanes"):
            if launches["q4"][name] != 1:
                raise AssertionError(f"{name} launched "
                                     f"{launches['q4'][name]} times on q4, "
                                     f"not once")
        del got
        walls = timed_walls(q4df.collect)
        wall = sorted(walls)[1]
        print(f"main path DataFrame q4 ({ROWS} rows, row_number and the "
              f"running RANGE sum of v over (partition by k order by v) -> "
              f"collect): plan {[n for n, _ in nodes]}, GPU-only, one "
              f"DeviceToHostExec; rn and rs equal the numpy oracle row for "
              f"row; cold wall {cold_wall * 1e3:.1f} ms (upload included); "
              f"warm walls {', '.join(f'{w:.1f}' for w in walls)} ms, "
              f"median {wall:.1f}, {ROWS / wall / 1e3:.1f} M rows/s; peak "
              f"{peak / 2**30:.2f} GiB; K2 passes {q4_run_passes}; launches "
              f"{launches['q4']}")

        # where q4's time goes: the window stage by stage, then the
        # download of the projected result, then a trace
        scan4 = LocalScanExec(table)
        wexec4 = q4_exec(scan4)
        batch4 = next(scan4.execute_partition(0, ExecContext(dev)))
        for _ in range(2):                 # the second pass is reported
            stages = {}
            torch.cuda.synchronize()
            clock = [time.perf_counter()]

            def mark(stage):
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[stage] = stages.get(stage, 0.0) + \
                    (now - clock[0]) * 1e3
                clock[0] = now
            out4 = wexec4._compute(batch4, mark)
        proj4 = DeviceBatch([out4.columns[i] for i in (0, 1, 3, 4)],
                            out4.num_rows, ["k", "v", "rn", "rs"])
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, proj4)
        print("q4 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items())
              + f"; download {_split_line(split)}; packed {nbytes} bytes, "
              f"copy {nbytes / split['copy'] / 1e6:.1f} GB/s; plan {plan}")
        del out4, proj4, batch4, scan4, wexec4
        trace = _profile(torch, q4df.collect)
        print(f"trace of a warm DataFrame q4: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q4df, q4_session
    except Exception:
        failures.append("main path (q4)")
        traceback.print_exc()

    # ---- main path: q4 over 4 partitions -------------------------------
    try:
        if q4_want is None:
            raise AssertionError("no q4 oracle")
        s4 = GpuSession()
        df4 = q4_df(s4, 4)
        _check_q4(df4.collect(), table, *q4_want,
                  "DataFrame q4, 4 partitions (cold)")
        nodes = _placements(s4.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("ProjectExec", "gpu"),
                     ("WindowExec", "gpu"), ("GatherPartitionsExec", "gpu"),
                     ("LocalScanExec", "gpu")] or "!" in s4.last_explain:
            raise AssertionError(f"q4 over 4 partitions planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = df4.collect()
        torch.cuda.synchronize()
        launches["q4_4"] = counts()
        _check_q4(got, table, *q4_want, "DataFrame q4, 4 partitions")
        del got
        walls = timed_walls(df4.collect)
        print(f"main path DataFrame q4 (4 partitions of {ROWS // 4} rows): "
              f"hash exchange stripped, plan {[n for n, _ in nodes]}; rn and "
              f"rs equal the numpy oracle; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q4_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q4, 4 partitions)")
        traceback.print_exc()
    q4_want = None

    # ---- TopN: sort(v desc, k).limit(1000) -------------------------------
    try:
        t1 = time.perf_counter()
        topn_want = table.sort_by([("v", "descending"),
                                   ("k", "ascending")]).slice(0, 1000)
        oracle_s = time.perf_counter() - t1
        st_ = GpuSession()
        tdf = st_.create_dataframe(table).sort(col("v").desc(),
                                               col("k")).limit(1000)
        if not _same_table(tdf.collect(), topn_want):
            raise AssertionError("TopN (cold) differs from pyarrow")
        nodes = _placements(st_.last_plan)
        if [n for n, _ in nodes] != [
                "DeviceToHostExec", "CoalesceBatchesExec", "GlobalLimitExec",
                "SortExec", "LocalLimitExec", "SortExec", "LocalScanExec"] \
                or any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"TopN planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = tdf.collect()
        torch.cuda.synchronize()
        launches["topn"] = counts()
        if not _same_table(got, topn_want):
            raise AssertionError("TopN differs from pyarrow")
        walls = timed_walls(tdf.collect)
        print(f"TopN sort(v desc, k).limit(1000) over {ROWS} rows: plan "
              f"{[n for n, _ in nodes]}; equals pyarrow's first 1000 rows "
              f"(oracle {oracle_s:.1f} s); warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms; launches "
              f"{launches['topn']}")
        del tdf, st_, got, topn_want
    except Exception:
        failures.append("TopN")
        traceback.print_exc()

    # ---- orders and nulls: the card against the CPU engine ---------------
    try:
        ot = _orders_table(1 << 20)
        orders = {
            "desc": lambda c: [c("i").desc(), c("d").desc()],
            "asc_nulls_last": lambda c: [c("d").asc_nulls_last(), c("i")],
            "desc_nulls_first": lambda c: [c("d").desc_nulls_first(),
                                           c("i").desc_nulls_first()]}
        cpu_engine = GpuSession(conf={"spark.rapids.sql.enabled": False})
        for name, fn in orders.items():
            count_reset()
            oracle = cpu_engine.create_dataframe(
                ot, num_partitions=4).order_by(*fn(col)).collect()
            if any(counts().values()):
                raise AssertionError(f"the CPU engine launched {counts()}")
            nodes = _placements(cpu_engine.last_plan)
            if any(p != "cpu" for _, p in nodes) or \
                    ("ShuffleExchangeExec", "cpu") not in nodes:
                raise AssertionError(f"CPU engine planned {nodes}")
            for parts, assisted in itertools.product((1, 4), (False, True)):
                count_reset()
                got = GpuSession(conf={COLLECT_KEY: assisted}) \
                    .create_dataframe(ot, num_partitions=parts) \
                    .order_by(*fn(col)).collect()
                if counts()["gather_rows"] < 1:
                    raise AssertionError("the card's sort launched no K8")
                if not _same_table(got, oracle):
                    raise AssertionError(f"order {name} over {parts} "
                                         f"partitions (host-assisted "
                                         f"collect {assisted}) differs "
                                         f"from the CPU engine")
        # pyarrow where its rules agree with Spark's: an INT key with
        # nulls, the row number breaking ties
        for fn, keys, place in (
                (lambda c: [c("i").asc_nulls_last(), c("row")],
                 [("i", "ascending"), ("row", "ascending")], "at_end"),
                (lambda c: [c("i").desc_nulls_first(), c("row")],
                 [("i", "descending"), ("row", "ascending")], "at_start")):
            for assisted in (False, True):
                got = GpuSession(conf={COLLECT_KEY: assisted}) \
                    .create_dataframe(ot).order_by(*fn(col)).collect()
                if not _same_table(got, ot.sort_by(keys,
                                                   null_placement=place)):
                    raise AssertionError(f"{keys} nulls {place} (host-"
                                         f"assisted collect {assisted}) "
                                         f"differs from pyarrow")
        print(f"orders and nulls over {ot.num_rows} rows (nulls in an INT "
              f"column; NaN, -0.0, +-inf and nulls in a DOUBLE column): "
              f"{', '.join(orders)} on the card over 1 and 4 partitions, "
              f"direct and host-assisted collects, equal the CPU engine (every operator on the CPU, the range "
              f"exchange on the host, no kernel launched); INT ascending "
              f"nulls last and descending nulls first equal pyarrow")
        del ot, oracle, got
    except Exception:
        failures.append("orders and nulls")
        traceback.print_exc()

    # ---- the plan rewrite: placements and planning time, one partition --
    try:
        for name, sess, frame in (("q1", session, df),
                                  ("q2", q2_session, q2df)):
            plan = sess.prepare_plan(frame._lp)
            nodes = _placements(plan)
            moves = [n for n, _ in nodes
                     if n in ("HostToDeviceExec", "DeviceToHostExec")]
            if nodes[0][0] != "DeviceToHostExec" or moves != \
                    ["DeviceToHostExec"] or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sess.last_explain:
                raise AssertionError(f"{name} placed {nodes}")
            ms = []
            for _ in range(21):
                t1 = time.perf_counter()
                sess.prepare_plan(frame._lp)
                ms.append((time.perf_counter() - t1) * 1e3)
            print(f"{name} plan: GPU-only, one transition (the final "
                  f"DeviceToHostExec), {len(nodes)} operators; planning "
                  f"(plan + tag + convert + transitions) median of 21 "
                  f"{sorted(ms)[10]:.3f} ms host, min {min(ms):.3f}")
        # the guards: a GPU aggregate over a CPU-placed filter and scan is
        # refused before it runs, and raises on its first batch
        guard = GpuHashAggregateExec(
            [A("k")], aggs, COMPLETE,
            FilterExec(filt_expr, LocalScanExec(table.slice(0, 1024))))
        guard.children[0].foreach(lambda e: setattr(e, "placement", "cpu"))
        for what, call, err in (
                ("collect", lambda: guard.execute_collect(ExecContext(dev)),
                 ValueError),
                ("first batch", lambda: next(guard.execute_partition(
                    0, ExecContext(dev))), RuntimeError)):
            try:
                call()
            except err:
                continue
            raise AssertionError(f"GPU aggregate over CPU-placed children: "
                                 f"{what} did not raise")
        print("placement guards: a GPU aggregate over a CPU-placed filter "
              "and scan is refused at collect and raises on its first batch")
    except Exception:
        failures.append("plan placements (q1, q2)")
        traceback.print_exc()

    # ---- the plan rewrite: CPU fallback between device operators ------
    try:
        fb_rows = 1 << 16
        fb_fact = table.slice(0, fb_rows)
        fb_dim = dim.rename_columns(["k2", "w"])

        def fb_query(s, how, cond_extra):
            return (s.create_dataframe(fb_fact)
                    .filter(col("v") > THRESHOLD)
                    .join(s.create_dataframe(fb_dim),
                          on=(col("k") == col("k2")) & cond_extra(),
                          how=how)
                    .group_by(col("k"))
                    .agg(F.sum(col("v")).alias("sv"),
                         F.count("*").alias("c")))

        full = fb_query(GpuSession(), "full", lambda: col("w") > 0.5)
        text = full.session.explain(full._lp)
        nodes = _placements(full.session.last_plan)
        reason = ("!Exec <CpuJoinExec> cannot run on GPU because "
                  "conditional full join is not supported on GPU")
        want_nodes = [("DeviceToHostExec", "cpu"),
                      ("CoalesceBatchesExec", "gpu"),
                      ("GpuHashAggregateExec", "gpu"),
                      ("HostToDeviceExec", "gpu"), ("CpuJoinExec", "cpu"),
                      ("DeviceToHostExec", "cpu"), ("FilterExec", "gpu"),
                      ("LocalScanExec", "gpu"), ("DeviceToHostExec", "cpu"),
                      ("LocalScanExec", "gpu")]
        if nodes != want_nodes or reason not in [
                ln.strip() for ln in text.splitlines()]:
            raise AssertionError(f"conditional full join placed {nodes}:\n"
                                 + text)
        errors = []
        for conf in ({}, {"spark.rapids.sql.enabled": False}):
            try:
                fb_query(GpuSession(conf=conf), "full",
                         lambda: col("w") > 0.5).collect()
                errors.append(None)
            except NotImplementedError as e:
                errors.append(str(e))
        if errors != ["conditional full join on CPU engine"] * 2:
            raise AssertionError(f"conditional full join: {errors}")
        # a fallback that runs: the CPU join engine disabled for the GPU
        inner = fb_query(GpuSession(
            conf={"spark.rapids.sql.exec.CpuJoinExec": False}), "inner",
            lambda: col("w") > 0.5)
        count_reset()
        got = inner.collect().sort_by("k")
        fb_launches = counts()
        nodes = _placements(inner.session.last_plan)
        if ("CpuJoinExec", "cpu") not in nodes or \
                "CpuJoinExec has been disabled by config" not in \
                inner.session.last_explain:
            raise AssertionError(f"disabled CpuJoinExec placed {nodes}")
        oracle = fb_query(GpuSession(conf={"spark.rapids.sql.enabled":
                                           False}), "inner",
                          lambda: col("w") > 0.5).collect().sort_by("k")
        if not got.equals(oracle):
            raise AssertionError("the CPU join between device operators "
                                 "differs from the CPU engine")
        print(f"fallback: a conditional full join at {fb_rows} fact rows "
              f"plans on CpuJoinExec between HostToDevice and DeviceToHost "
              f"transitions (filter and aggregate on the GPU) with the "
              f"reason '{reason[1:]}', and raises "
              f"'{errors[0]}' as under spark.rapids.sql.enabled=false (the "
              f"reference's CPU engine raises the same); an inner "
              f"conditional join with CpuJoinExec disabled runs on the CPU "
              f"engine between device operators ({got.num_rows} groups, "
              f"launches {fb_launches}) and equals the CPU engine's result")
    except Exception:
        failures.append("fallback")
        traceback.print_exc()

    # ---- the CPU oracle: q1 under spark.rapids.sql.enabled=false ------
    try:
        small = table.slice(0, 1 << 20)

        def q1_df(s):
            return (s.create_dataframe(small)
                    .filter(col("v") > THRESHOLD)
                    .group_by(col("k"))
                    .agg(F.sum(col("v")).alias("sv"),
                         F.avg(col("f")).alias("af"),
                         F.count("*").alias("c")))
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        t1 = time.perf_counter()
        oracle = q1_df(cpu_session).collect()
        cpu_wall = time.perf_counter() - t1
        if any(counts().values()):
            raise AssertionError(f"the CPU engine launched {counts()}")
        nodes = _placements(cpu_session.last_plan)
        if any(p != "cpu" for _, p in nodes):
            raise AssertionError(f"oracle placed {nodes}")
        on_card = q1_df(GpuSession()).collect()
        _check_q1(on_card, _oracle(small), "q1 on the card, 2^20 rows")
        _check_q1(oracle, _oracle(small), "q1 on the CPU engine, 2^20 rows")
        on_card, oracle = on_card.sort_by("k"), oracle.sort_by("k")
        for c in ("k", "sv", "c"):
            if not on_card[c].equals(oracle[c]):
                raise AssertionError(f"oracle column {c} differs")
        if not np.allclose(on_card["af"].to_numpy(), oracle["af"].to_numpy(),
                           rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError("oracle avg differs")
        print(f"oracle: q1 at {small.num_rows} rows under "
              f"spark.rapids.sql.enabled=false ({[n for n, _ in nodes]}, "
              f"every operator on the CPU, no kernel launched, "
              f"{cpu_wall * 1e3:.1f} ms) equals the card's result (keys, "
              f"sums and counts exactly, avg to {FLOAT_RTOL:g})")
    except Exception:
        failures.append("CPU oracle")
        traceback.print_exc()

    # ---- the CPU oracle: every window function at 2^20 rows ----------
    try:
        wt = _window_oracle_table(1 << 20)
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        t1 = time.perf_counter()
        oracle = _window_oracle_query(cpu_session.create_dataframe(wt), F,
                                      col, W).collect()
        cpu_wall = time.perf_counter() - t1
        if any(counts().values()):
            raise AssertionError(f"the CPU engine launched {counts()}")
        nodes = _placements(cpu_session.last_plan)
        if any(p != "cpu" for _, p in nodes):
            raise AssertionError(f"window oracle placed {nodes}")
        card_session = GpuSession()
        count_reset()
        on_card = _window_oracle_query(card_session.create_dataframe(wt), F,
                                       col, W).collect()
        card_nodes = _placements(card_session.last_plan)
        if [p for _, p in card_nodes][1:] != ["gpu"] * (len(card_nodes) - 1) \
                or "!" in card_session.last_explain:
            raise AssertionError(f"window functions planned {card_nodes}")
        for name in ("segment_scan", "run_ends", "scatter_rows"):
            if counts()[name] <= 0:
                raise AssertionError(f"{name} not launched by the window "
                                     f"functions")
        if not _same_window_tables(on_card, oracle):
            bad = [c for c in oracle.column_names if not _same_window_tables(
                on_card.select([c]), oracle.select([c]))]
            raise AssertionError(f"the card's window functions differ from "
                                 f"the CPU engine in {bad}")
        print(f"window oracle: {wt.num_rows} rows, nulls in k, o and v; "
              f"rank, dense_rank, percent_rank, cume_dist, ntile, lead, "
              f"lag, row_number over a descending order, whole-partition "
              f"sum and avg, bounded ROWS sum, count and max, bounded RANGE "
              f"sum, count, min and max ({len(oracle.column_names) - 4} "
              f"columns over 5 specs): the card equals the CPU engine "
              f"(spark.rapids.sql.enabled=false, every operator on the CPU, "
              f"no kernel launched, {cpu_wall:.1f} s), ints exactly, floats "
              f"to {FLOAT_RTOL:g}")
        del wt, oracle, on_card
    except Exception:
        failures.append("window oracle")
        traceback.print_exc()


    # ---- the expression catalogue: the card against the CPU ----------
    try:
        ct = _catalogue_table(CATALOGUE_ROWS)
        cols = _catalogue_columns(F, col, lit, ar_mod, mx_mod, cond_mod,
                                  Column)
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        oracle = cpu_session.create_dataframe(ct).select(*cols).collect()
        if any(counts().values()) or any(
                p != "cpu" for _, p in _placements(cpu_session.last_plan)):
            raise AssertionError("the CPU placement launched a kernel or "
                                 "placed an operator on the GPU")
        card_session = GpuSession()
        on_card = card_session.create_dataframe(ct).select(*cols).collect()
        nodes = _placements(card_session.last_plan)
        if any(p != "gpu" for _, p in nodes[1:]) or \
                "!" in card_session.last_explain:
            raise AssertionError(f"the catalogue placed {nodes}:\n"
                                 + card_session.last_explain)
        bad, worst = _same_catalogue(on_card, oracle, 1e-12)
        if bad:
            raise AssertionError(f"the card's expressions differ from the "
                                 f"CPU placement in {bad}")
        sat = on_card.filter(pc.is_in(ct["d"], pa.array([1e19, 9.3e18])))
        if set(sat["d2l"].to_pylist()) != {2**63 - 1}:
            raise AssertionError(f"1e19 and 9.3e18 cast to LONG give "
                                 f"{set(sat['d2l'].to_pylist())}")
        edge = on_card.filter(pc.and_(pc.equal(ct["a"], -2**63),
                                      pc.equal(ct["b"], -1)))
        if edge.num_rows == 0 or set(edge["idiv"].to_pylist()) != \
                {-2**63} or set(edge["mod"].to_pylist()) != {0}:
            raise AssertionError("INT64_MIN div and % -1 on the card")
        print(f"expression catalogue: {len(cols)} columns over "
              f"{ct.num_rows} rows (INT64_MIN and INT32_MIN operands, "
              f"{edge.num_rows} rows of INT64_MIN over -1, zero divisors, "
              f"NaN, +-inf, -0.0, 1e19 and 9.3e18, nulls): the card "
              f"(GPU-placed, {len(nodes)} operators) equals the CPU "
              f"placement (spark.rapids.sql.enabled=false, no kernel "
              f"launched): integers and booleans exactly, doubles by bits "
              f"or within 1e-12 (largest relative difference {worst:.3g}); "
              f"1e19 and 9.3e18 cast to LONG give INT64_MAX on the card")
        del ct, oracle, on_card
    except Exception:
        failures.append("expression catalogue")
        traceback.print_exc()

    # ---- join types not run on the card before, against pyarrow ------
    try:
        jf, jd = _join_table_pairs(table, dim)
        pa_how = {"right": "right outer", "full": "full outer",
                  "left_semi": "left semi", "left_anti": "left anti"}
        done = []
        for how, pa_name in pa_how.items():
            sj = GpuSession()
            count_reset()
            got = sj.create_dataframe(jf).join(
                sj.create_dataframe(jd), on="k", how=how).collect()
            nodes = _placements(sj.last_plan)
            if any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sj.last_explain:
                raise AssertionError(f"{how} join placed {nodes}")
            # semi and anti joins compact the probe side (K1); the others
            # expand pairs (K7, K5)
            after = "compact_rows" if how.startswith("left_") else \
                "expand_pairs"
            if counts()["join_probe"] < 1 or counts()[after] < 1:
                raise AssertionError(f"{how} join launched {counts()}")
            want = jf.join(jd, "k", join_type=pa_name)
            want = want.select(got.column_names)
            if not _sorted_rows(got).equals(_sorted_rows(want)):
                raise AssertionError(f"{how} join differs from pyarrow: "
                                     f"{got.num_rows} rows vs "
                                     f"{want.num_rows}")
            done.append(f"{how} {got.num_rows} rows")
        print(f"joins through GpuSession at {jf.num_rows} fact rows with a "
              f"{jd.num_rows}-row dimension (a third of the fact's keys "
              f"missing, keys the fact lacks): {', '.join(done)}; each "
              f"GPU-placed, K4 launched and K5 (right, full) or K1 (semi, "
              f"anti), equal to pyarrow's join")
    except Exception:
        failures.append("join types")
        traceback.print_exc()

    # ---- strings: K14-K17, qs1-qs4 at 2^25 rows, checks at 2^20 ------
    st_fact = st_dim = None
    try:
        t1 = time.perf_counter()
        st_fact, st_dim = _string_tables(table, dim)
        sbytes = {c: int(pc.sum(pc.binary_length(st_fact[c])).as_py() or 0)
                  for c in ("s", "rf", "ls", "c")}
        print(f"string tables: fact {st_fact.num_rows} rows with s "
              f"(\"Customer#%09d\" of k, {sbytes['s']} bytes), rf, ls "
              f"(1 byte), c (10-43 bytes, {st_fact['c'].null_count} null, "
              f"{sbytes['c']} bytes); dimension {st_dim.num_rows} names; "
              f"built from numpy buffers in "
              f"{time.perf_counter() - t1:.1f} s")
        rng = np.random.default_rng(SEED + 77)
        checks = 0
        for what, arr in _string_edge_arrays(rng).items():
            n = len(arr)
            colm = batch_to_device(pa.RecordBatch.from_arrays(
                [arr], names=["x"]), dev).columns[0]
            checks += _string_kernel_check(torch, sops, hashfns_mod,
                                           colm.offsets, colm.data, rng,
                                           what)
        k16_cases = _k16_cases(torch, dev, sops)
        torch.cuda.synchronize()
        print(f"K16 edge cases: {k16_cases} cases equal the plain versions "
              f"bit for bit (every source alignment 0-15 for rows of 1-40 "
              f"bytes, 16-byte rows, stretches ending mid-row, a 1 MB row "
              f"over 256 stretches, a run of invalid slots, one-byte "
              f"flags, n = 1; caps at the total, past it and past a "
              f"partial chunk)")
        print(f"K14-K17 edge cases: {checks} checks (0 rows, all empty, "
              f"all null, a 1 MB string among 2,000 short, 40 bytes of "
              f"shared prefix, multi-byte UTF-8, 255-257 and 4,095-4,097 "
              f"rows, invalid and out-of-range gather slots): each kernel "
              f"equals its plain version bit for bit")
    except Exception:
        failures.append("string kernels (edge cases)")
        traceback.print_exc()

    def k16_row(columns, idx, what):
        """K16 over span columns through the rows ``idx`` (valid where
        the row is), each against the plain versions bit for bit, then
        timed: both launches, each launch alone, the plain versions, and
        one random 4-byte read a row of the source offsets through
        ``idx`` (``index_select``) as the card's random-read yardstick.
        Returns the kernel row."""
        n = int(idx.shape[0])
        runs = []
        for c in columns:
            ok = c.validity.index_select(0, idx.long())
            o, t, st = sops.gather_offsets(c.offsets, idx, ok)
            total = int(t)
            cap = bucket_for(max(total, 1), DEFAULT_CHAR_BUCKETS)
            got = sops.gather_chars(c.data, st, o, total, cap)
            o_p, t_p = sops.gather_offsets_plain(c.offsets, idx, ok)
            if not (torch.equal(o, o_p) and torch.equal(t, t_p) and
                    torch.equal(st, sops.span_starts_plain(c.offsets, idx,
                                                           ok)) and
                    torch.equal(got, sops.gather_chars_plain(
                        c.offsets, c.data, idx, o_p, cap))):
                raise AssertionError(f"K16 differs at {what}")
            runs.append((c, ok, o, st, total, cap))
            del got, o_p, t_p

        def both():
            for c, ok, _, _, total, cap in runs:
                o, _, st = sops.gather_offsets(c.offsets, idx, ok)
                sops.gather_chars(c.data, st, o, total, cap)

        def plain():
            for c, ok, _, _, total, cap in runs:
                o, _ = sops.gather_offsets_plain(c.offsets, idx, ok)
                sops.gather_chars_plain(c.offsets, c.data, idx, o, cap)
        idx_l = idx.long()
        # offsets: index, valid flag and two source offsets read, the new
        # offset written, a row; copy: the new offset and source start a
        # row, the selected bytes read, the whole buffer written.  The
        # function: the offsets launch's bytes and the copy's chars (the
        # source starts are this design's own go-between)
        off_bytes = 17 * n * len(runs)
        chars_bytes = sum(total + cap for *_, total, cap in runs)
        copy_bytes = 8 * n * len(runs) + chars_bytes
        row = dict(
            source="spark_rapids_tpu_torch/csrc/gather_strings.cu",
            replaces="spark_rapids_tpu/ops/strings.py:101",
            max_abs_err=0.0, ms=cuda_ms(both),
            plain_ms=cuda_ms(plain, reps=1), library_ms=None,
            bound_ms=bound(off_bytes + chars_bytes),
            extra=dict(
                offsets_ms=cuda_ms(lambda: [sops.gather_offsets(
                    c.offsets, idx, ok) for c, ok, *_ in runs]),
                offsets_bound_ms=bound(off_bytes),
                copy_ms=cuda_ms(lambda: [sops.gather_chars(
                    c.data, st, o, total, cap)
                    for c, _, o, st, total, cap in runs]),
                copy_bound_ms=bound(copy_bytes),
                random_read_ms=cuda_ms(lambda: [c.offsets.index_select(
                    0, idx_l) for c in columns]),
                bytes=[total for *_, total, _ in runs]))
        x = row["extra"]
        print(f"K16 gather_strings at {what}: {len(runs)} column(s) of "
              f"{n} rows, {x['bytes']} bytes: exact; both launches "
              f"{row['ms']:.3f} ms (bound {row['bound_ms']:.3f}), offsets "
              f"{x['offsets_ms']:.3f} (bound {x['offsets_bound_ms']:.3f}), "
              f"copy {x['copy_ms']:.3f} (bound {x['copy_bound_ms']:.3f}); "
              f"plain {row['plain_ms']:.3f}; one random 4-byte read a row "
              f"(index_select of the source offsets) "
              f"{x['random_read_ms']:.3f} ms; {card}")
        return row

    def string_run(run, df, check, what, session):
        """Cold, then the counted warm run, then 3 warm walls and a
        trace; the plan must be GPU-only."""
        t1 = time.perf_counter()
        check(df.collect(), f"{what} (cold)")
        cold_wall = (time.perf_counter() - t1) * 1e3
        nodes = _placements(session.last_plan)
        if nodes[0] != ("DeviceToHostExec", "cpu") or \
                any(p != "gpu" for _, p in nodes[1:]) or \
                "!" in session.last_explain:
            raise AssertionError(f"{what} placed {nodes}:\n"
                                 f"{session.last_explain}")
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = df.collect()
        torch.cuda.synchronize()
        launches[run] = counts()
        check(got, what)
        walls = timed_walls(df.collect)
        trace = _profile(torch, df.collect)
        print(f"main path {what}: plan {[n for n, _ in nodes]}, GPU-only; "
              f"cold wall {cold_wall:.1f} ms; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; busy {trace['busy_ms']:.2f} ms, "
              f"idle share {trace['idle_share']:.3f} (traced wall "
              f"{trace['wall_ms']:.1f} ms); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches[run]}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"][:6])
              + f"; {card}")
        return got

    string_caps = {}

    def capture_strings(key, fn):
        """One run of ``fn`` outside the counted ones, keeping the
        arguments of every K14-K17 call."""
        with _Capture(sops, "string_hashes", "order_keys", "gather_offsets",
                      "gather_chars") as cap, \
                _Capture(hashfns_mod, "hash_bytes") as cap15:
            fn()
        cap.calls += cap15.calls
        cap.orig.update(cap15.orig)
        string_caps[key] = cap

    # qs1: TPC-H Q1 with the real flags, one partition and four
    if st_fact is not None:
        try:
            want1 = _qs1_oracle(_q1x_oracle(table))

            def check1(got, what):
                _check_q1x(got, want1, what)
            for parts in (1, 4):
                s1 = GpuSession()
                df1 = _qs1_df(s1, st_fact, parts, F, col, lit)
                string_run("qs1" if parts == 1 else "qs1_4", df1, check1,
                           f"qs1 (TPC-H Q1 grouped by the string flags rf "
                           f"and ls, {ROWS} rows in {parts} partition(s))",
                           s1)
                if parts == 1:
                    capture_strings("qs1", df1.collect)
                del df1, s1
            # K16 at qs1's shape: the two flag columns through the
            # filter's kept rows
            fl = batch_to_device(pa.RecordBatch.from_arrays(
                [st_fact[c].combine_chunks() for c in ("rf", "ls", "v", "f")],
                names=["rf", "ls", "v", "f"]), dev)
            kept = ((fl.columns[3].data <= 0.98) & fl.columns[3].validity &
                    fl.columns[2].validity).nonzero().flatten().to(
                        torch.int32)
            kernel_rows["gather_strings_flags"] = k16_row(
                fl.columns[:2], kept, "qs1's shape (rf and ls through the "
                "filter's kept rows)")
            del fl, kept
        except Exception:
            failures.append("main path (qs1)")
            traceback.print_exc()

    # qs2: q1 keyed by the customer name
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            want2 = _qs2_oracle(st_fact)
            print(f"pyarrow qs2 oracle: {want2.num_rows} groups, "
                  f"{time.perf_counter() - t1:.1f} s")
            s2 = GpuSession()
            df2 = _qs2_df(s2, st_fact, F, col)
            string_run("qs2", df2, lambda g, w: _check_qs2(g, want2, w),
                       f"qs2 (q1 grouped by the 18-byte name s, {ROWS} "
                       f"rows)", s2)
            capture_strings("qs2", df2.collect)
            # K14 at qs2's shape: the names' hashes, as the group-by asks
            names = batch_to_device(pa.RecordBatch.from_arrays(
                [st_fact["s"].combine_chunks()], names=["s"]),
                dev).columns[0]
            n = names.capacity
            got = sops.string_hashes(names.offsets, names.data)
            want = sops.string_hashes_plain(names.offsets, names.data)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("K14 differs at qs2's shape")
            kernel_rows["string_hashes"] = dict(
                source="spark_rapids_tpu_torch/csrc/string_hashes.cu",
                replaces="spark_rapids_tpu/ops/strings.py:41",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: sops.string_hashes(names.offsets,
                                                      names.data)),
                plain_ms=cuda_ms(lambda: sops.string_hashes_plain(
                    names.offsets, names.data), reps=2),
                library_ms=None,
                bound_ms=bound(4 * (n + 1) + sbytes["s"] + 16 * n))
            # K17 at qs4's key, the same names
            got = sops.order_keys(names.offsets, names.data)
            want = sops.order_keys_plain(names.offsets, names.data)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("K17 differs at qs4's shape")
            lens = np.minimum(pc.binary_length(st_fact["s"]).to_numpy(), 32)
            kernel_rows["order_keys"] = dict(
                source="spark_rapids_tpu_torch/csrc/prefix_words.cu",
                replaces="spark_rapids_tpu/ops/strings.py:76",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: sops.order_keys(names.offsets,
                                                   names.data)),
                plain_ms=cuda_ms(lambda: sops.order_keys_plain(
                    names.offsets, names.data), reps=2),
                library_ms=None,
                bound_ms=bound(4 * (n + 1) + int(lens.sum()) + 40 * n))
            print(f"K14 string_hashes and K17 order_keys at {n} names: "
                  f"exact; K14 {kernel_rows['string_hashes']['ms']:.3f} ms "
                  f"(plain {kernel_rows['string_hashes']['plain_ms']:.3f}, "
                  f"bound {kernel_rows['string_hashes']['bound_ms']:.3f}), "
                  f"K17 {kernel_rows['order_keys']['ms']:.3f} ms (plain "
                  f"{kernel_rows['order_keys']['plain_ms']:.3f}, bound "
                  f"{kernel_rows['order_keys']['bound_ms']:.3f}); {card}")
            del names, got, want, df2, s2
        except Exception:
            failures.append("main path (qs2)")
            traceback.print_exc()

    # qs3: the fact joined to the dimension on the name, c as payload
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            want3 = _by_id(st_fact.select(["id", "s", "c"]).join(
                st_dim, "s", join_type="inner"))
            want3 = want3.select(["s", "id", "c", "w"])
            print(f"pyarrow qs3 oracle: {want3.num_rows} joined rows, "
                  f"{time.perf_counter() - t1:.1f} s")

            def check3(got, what):
                got = _by_id(got).select(want3.column_names)
                if not _same_strings_table(got, want3):
                    raise AssertionError(f"{what}: differs from pyarrow's "
                                         f"join ({got.num_rows} rows)")
            s3 = GpuSession()
            df3 = _qs3_df(s3, st_fact, st_dim)
            string_run("qs3", df3, check3,
                       f"qs3 (the fact joined to the dimension on the name "
                       f"s, FK -> PK, the comment c riding on the probe "
                       f"side, {ROWS} rows)", s3)
            capture_strings("qs3", df3.collect)
            del df3, s3
        except Exception:
            failures.append("main path (qs3)")
            traceback.print_exc()

    # qs4: sort by (s, v) carrying c, and its TopN
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            sub4 = st_fact.select(["s", "v", "c"])
            want4 = sub4.sort_by([("s", "ascending"), ("v", "ascending")])
            print(f"pyarrow qs4 oracle: {want4.num_rows} rows sorted, "
                  f"{time.perf_counter() - t1:.1f} s")

            def check4(got, what):
                if not _same_strings_table(got, want4):
                    raise AssertionError(f"{what}: differs from pyarrow's "
                                         f"sort")
            s4 = GpuSession()
            df4 = _qs4_df(s4, st_fact, col)
            string_run("qs4", df4, check4,
                       f"qs4 (sort by (s, v) carrying c, {ROWS} rows)", s4)
            capture_strings("qs4", df4.collect)
            top4 = want4.slice(0, 1000)

            def check_top(got, what):
                if not _same_strings_table(got, top4):
                    raise AssertionError(f"{what}: differs from pyarrow")
            s5 = GpuSession()
            dft = s5.create_dataframe(sub4).sort(col("s"), col("v")).limit(
                1000)
            string_run("qs4_topn", dft, check_top,
                       "qs4's TopN (sort(s, v).limit(1000))", s5)
            # K16 at qs4's shape: c through the sort's order
            sc = batch_to_device(pa.RecordBatch.from_arrays(
                [sub4[c].combine_chunks() for c in ("s", "v", "c")],
                names=["s", "v", "c"]), dev)
            words = [w for ccol in sc.columns[:2]
                     for w in seg.sort_key_words(ccol)]
            order = carry.sort_order(words)
            kernel_rows["gather_strings"] = k16_row(
                [sc.columns[2]], order, "qs4's shape (c through the sort "
                "order)")
            del sc, words, order, df4, s4, dft, s5, want4, sub4
        except Exception:
            failures.append("main path (qs4)")
            traceback.print_exc()

    # the captured K14-K17 calls of qs1-qs4, against their plain versions
    for key, cap in string_caps.items():
        try:
            seen = _check_string_captured(torch, cap, sops, hashfns_mod, key)
            print(f"captured at {key}: {len(seen)} calls equal their plain "
                  f"versions bit for bit: {', '.join(seen[:8])}"
                  + (" ..." if len(seen) > 8 else ""))
        except Exception:
            failures.append(f"captured string kernels ({key})")
            traceback.print_exc()
    string_caps.clear()

    # ---- strings at 2^20 rows against the CPU engine and pyarrow ----
    if st_fact is not None:
        try:
            small = st_fact.slice(0, STRING_SMALL).combine_chunks()
            cpu = GpuSession(conf={"spark.rapids.sql.enabled": False})
            card_s = GpuSession()

            def both(query, what, run=None):
                count_reset()
                want = query(cpu.create_dataframe(small)).collect()
                if any(counts().values()) or any(
                        p != "cpu" for _, p in _placements(cpu.last_plan)):
                    raise AssertionError(f"{what}: the CPU engine launched "
                                         f"a kernel or placed on the GPU")
                count_reset()
                got = query(card_s.create_dataframe(small)).collect()
                if run is not None:
                    launches[run] = counts()
                nodes = _placements(card_s.last_plan)
                if any(p != "gpu" for _, p in nodes[1:]) or \
                        "!" in card_s.last_explain:
                    raise AssertionError(f"{what} placed {nodes}")
                if not _same_window_tables(got, want):
                    raise AssertionError(f"{what}: the card differs from "
                                         f"the CPU engine")
                return got
            done = []
            preds = {
                "s = 'Customer#000000042'":
                    col("s") == lit("Customer#000000042"),
                "s <> 'Customer#000000042'":
                    col("s") != lit("Customer#000000042"),
                "s < 'Customer#000050000'":
                    col("s") < lit("Customer#000050000"),
                "s >= 'Customer#000099990'":
                    col("s") >= lit("Customer#000099990"),
                "rf IN ('A', 'N')": col("rf").isin("A", "N"),
                "s IN (3 names)": col("s").isin(
                    "Customer#000000001", "Customer#000012345",
                    "Customer#000099999"),
                "rf > ls": col("rf") > col("ls"),
                "c IS NULL": col("c").is_null()}
            for what, pred in preds.items():
                got = both(lambda d, p=pred: d.filter(p).select(
                    "id", "s", "rf"), what)
                done.append(f"{what}: {got.num_rows}")
            got = both(lambda d: d.select(
                col("id"), F.hash(col("s"), col("k")).alias("h"),
                F.hash(col("c")).alias("hc")), "F.hash(s, k)", "hash_s")
            capture_strings("hash", lambda: card_s.create_dataframe(
                small).select(F.hash(col("s"), col("k"))).collect())
            done.append(f"F.hash(s, k) and F.hash(c): {got.num_rows}")
            wspec = W.WindowBuilder().partition_by(col("s")).order_by(
                col("v"), col("id"))
            got = both(lambda d: d.select(
                col("id"), col("s"), col("v"),
                F.row_number().over(wspec).alias("rn"),
                F.sum(col("v")).over(wspec).alias("rs"),
                F.lag(col("c"), 1).over(wspec).alias("lc")),
                "window by s")
            done.append(f"window by s ordered by v: {got.num_rows}")
            got = both(lambda d: d.group_by(col("rf")).agg(
                F.min(col("c")).alias("mn"), F.max(col("c")).alias("mx"),
                F.count(col("c")).alias("n")).sort(col("rf")),
                "min/max of c by rf")
            done.append(f"min and max of c by rf: {got.num_rows} groups")
            with tempfile.TemporaryDirectory() as td:
                out = os.path.join(td, "scv")
                card_s.create_dataframe(small.select(["s", "c", "v"])) \
                    .write.mode("overwrite").parquet(out)
                back = pq.read_table(out).select(["s", "c", "v"])
                want_w = small.select(["s", "c", "v"])
                if not _same_strings_table(
                        back.cast(want_w.schema).combine_chunks(),
                        want_w.combine_chunks()):
                    raise AssertionError("the parquet write of (s, c, v) "
                                         "reads back different")
                got = card_s.read.parquet(out).collect()
                if not _same_strings_table(got.cast(want_w.schema),
                                           want_w):
                    raise AssertionError("the parquet scan of (s, c, v) "
                                         "differs")
            done.append("parquet write of (s, c, v) reads back equal "
                        "(pyarrow and the port's scan)")
            print(f"strings at {STRING_SMALL} rows, the card (GPU-placed) "
                  f"against the CPU engine (no kernel launched), exactly: "
                  + "; ".join(done))
            hash_cap = string_caps.pop("hash")
            seen = _check_string_captured(torch, hash_cap, sops,
                                          hashfns_mod, "F.hash")
            for name, args in hash_cap.calls:
                if name != "hash_bytes":
                    continue
                offs, chars = args[0], args[1]
                n = int(offs.shape[0]) - 1
                nb = int(offs[-1])
                kernel_rows["hash_bytes"] = dict(
                    source="spark_rapids_tpu_torch/csrc/hash_bytes.cu",
                    replaces="spark_rapids_tpu/expr/hashfns.py:72",
                    max_abs_err=0.0,
                    ms=cuda_ms(lambda: hashfns_mod.hash_bytes(*args)),
                    plain_ms=cuda_ms(lambda: hashfns_mod.hash_bytes_plain(
                        *args), reps=1),
                    library_ms=None,
                    bound_ms=bound(4 * (n + 1) + nb + 4 * n + 4 * n))
                r15 = kernel_rows["hash_bytes"]
                print(f"K15 hash_bytes at F.hash's shape ({n} rows, {nb} "
                      f"bytes): exact; {r15['ms']:.3f} ms (plain "
                      f"{r15['plain_ms']:.3f}, bound {r15['bound_ms']:.3f}"
                      f"); {card}")
                break
            del small, cpu, card_s
        except Exception:
            failures.append("strings at 2^20 rows")
            traceback.print_exc()
    del st_fact, st_dim

    path_kernels = {
        "dataframe": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "batches": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q2": ("key_hash", "sort_order", "hash_table", "join_probe",
               "expand_ends", "expand_pairs", "segment_reduce_sorted"),
        "q6": ("key_hash", "sort_order", "hash_table", "join_probe",
               "expand_ends", "expand_pairs", "segment_reduce_sorted"),
        "q1_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q1x": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q1x_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q3": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "q3_4": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "topn": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "q4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
               "scatter_rows", "lane_stats", "pack_lanes"),
        "q4_4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
                 "scatter_rows", "lane_stats", "pack_lanes"),
        "q3_assisted": ("sort_order", "gather_rows", "lane_stats",
                        "pack_lanes"),
        "q3_assisted_4": ("sort_order", "gather_rows", "lane_stats",
                          "pack_lanes"),
        "q5": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q5_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q7": ("lane_stats", "pack_lanes"),
        "q7_direct": ("compact_rows", "lane_stats", "pack_lanes"),
        "qs1": ("compact_rows", "sort_order", "segment_reduce_sorted",
                "string_hashes", "gather_strings"),
        "qs1_4": ("compact_rows", "sort_order", "segment_reduce_sorted",
                  "string_hashes", "gather_strings"),
        "qs2": ("compact_rows", "sort_order", "segment_reduce_sorted",
                "string_hashes", "gather_strings"),
        "qs3": ("string_hashes", "key_hash", "sort_order", "hash_table",
                "join_probe", "expand_ends", "expand_pairs",
                "gather_strings"),
        "qs4": ("order_keys", "sort_order", "gather_rows",
                "gather_strings"),
        "qs4_topn": ("order_keys", "sort_order", "gather_rows",
                     "gather_strings"),
        "hash_s": ("hash_bytes",)}
    # every download through DeviceToHostExec is the packed fetch now
    for run in ("dataframe", "q2", "q6", "q1_4", "q1x", "q1x_4", "q5",
                "q5_4", "qs1", "qs1_4", "qs2", "qs3", "qs4", "qs4_topn",
                "hash_s"):
        path_kernels[run] += ("lane_stats", "pack_lanes")
    for run, names in path_kernels.items():
        if run not in launches:
            failures.append(f"launch counts of the {run} run missing")
            continue
        for name in names:
            if launches[run][name] <= 0:
                failures.append(f"{name} not launched on the {run} run")
    if "batches" in launches and \
            launches["batches"]["sort_order"] != ROWS // BATCH_ROWS + 1:
        # one sort per batch and the canonical merge's, which K3 then
        # reads through: no second sort of the merge input
        failures.append(f"sort_order launched "
                        f"{launches['batches']['sort_order']} times on the "
                        f"batches run, not {ROWS // BATCH_ROWS + 1}")

    if kernel_rows:
        # launches on the main path each kernel belongs to: q1 for K1-K3,
        # q2 for K4-K7, q3 for K8-K10, q4 for K11-K13, qs2 for K14, the
        # 2^20-row F.hash for K15, qs4 for K16 and K17
        run_of = {"key_hash": "q2", "join_probe": "q2", "expand_ends": "q2",
                  "expand_pairs": "q2", "gather_rows": "q3",
                  "segment_reduce_sorted_minmax": "q1x",
                  "lane_stats": "q3", "pack_lanes": "q3",
                  "segment_scan": "q4", "run_ends": "q4",
                  "scatter_rows": "q4", "string_hashes": "qs2",
                  "hash_bytes": "hash_s", "gather_strings": "qs4",
                  "gather_strings_flags": "qs1", "order_keys": "qs4"}
        counted_as = {"segment_reduce_sorted_minmax": "segment_reduce_sorted",
                      "gather_strings_flags": "gather_strings"}
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=r["source"],
                 replaces=r["replaces"],
                 launches=launches.get(run_of.get(name, "dataframe"),
                                       {}).get(counted_as.get(name, name),
                                               0),
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by="bytes", library_ms=r["library_ms"],
                 **r.get("extra", {}))
            for name, r in kernel_rows.items()]}))
    print(card)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
