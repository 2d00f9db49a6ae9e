#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from csrc/ with nvcc, holds each
against its plain PyTorch version at the main path's shapes, then drives
the main path -- bench q1, scan -> filter(v > -500000) -> group by k:
sum(v), avg(f), count(*) -> collect -- over 2^25 rows, twice: through
the DataFrame API as one batch, and at exec level as 8 batches of
4,194,304 rows (update -> concat -> merge -> evaluate).  Each result is
compared with pyarrow's group-by on the host.  Launch counts are reset
just before each main-path run and must be > 0 for every kernel after
it.  Needs one CUDA card; exits non-zero and prints no result without
one, or when any phase fails.  The last line is a JSON object.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

ROWS = 1 << 25            # about TPC-H SF5 lineitem's row count
BATCH_ROWS = 4194304      # the largest DEFAULT_ROW_BUCKETS capacity
THRESHOLD = -(10**6) // 2  # bench.py q1's filter constant
SEED = 42                 # bench.py make_tables' seed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FLOAT_RTOL = 1e-9          # float sums add in another order than the oracle


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _make_table(n):
    """bench.py make_tables' fact table, from the same seed."""
    rng = np.random.default_rng(SEED)
    return pa.table({
        "k": pa.array(rng.integers(0, 100_000, n).astype(np.int64)),
        "v": pa.array(rng.integers(-(10**6), 10**6, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
    })


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
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
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
                gather_ms=gathers)


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
                _k3_diff(torch, agg_mod.segment_reduce_sorted(*args),
                         agg_mod.segment_reduce_sorted_plain(*args),
                         f"at n={n}, global={global_agg}")
        cases += 1
    # K3 at tile edges (4096 rows): groups of these sizes in key order,
    # rows shuffled; one group over rows 4000-8190; one group over 100,003
    # rows that is not the ungrouped aggregate
    for sizes in ([4095], [4096], [4097], [8193], [4095, 4096, 4097, 8193, 7],
                  [4000, 4191, 100], [100_003]):
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
        a = agg_mod.segment_reduce_sorted(*args)
        _k3_diff(torch, a, agg_mod.segment_reduce_sorted_plain(*args),
                 f"for groups of {sizes} rows")
        if a[3] != len(sizes):
            raise AssertionError(f"K3 found {a[3]} groups in {sizes}")
        cases += 1
    return cases


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
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.columnar.device import (batch_to_arrow,
                                                        batch_to_device)
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
    from spark_rapids_tpu_torch.exec.filter_common import keep_flags
    from spark_rapids_tpu_torch.expr.aggregates import (
        COMPLETE, AggregateExpression, Average, Count, Sum)
    from spark_rapids_tpu_torch.expr.core import AttributeReference as A
    from spark_rapids_tpu_torch.expr.core import EvalContext
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import segmented as seg

    dev = torch.device("cuda")
    failures = []
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

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

    table = _make_table(ROWS)
    want = _oracle(table)
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
        kernel_rows["sort_order"] = dict(
            source="spark_rapids_tpu_torch/csrc/radix_sort.cu",
            replaces="spark_rapids_tpu/ops/carry.py:80",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: carry.sort_order(words)),
            plain_ms=cuda_ms(lambda: carry.sort_order_plain(words)),
            # the null word is constant here: one stable sort of the value
            # word gives the same order
            library_ms=cuda_ms(lambda: torch.sort(words[-1], stable=True)),
            bound_ms=bound(8 * len(words) * n + 4 * n))
        print(f"K2 sort_order: rows {n}, words {len(words)}, exact")

        # K3 reads every lane in input order, through K2's order
        vals = [agg_mod._prefix(v, n) for v in val_cols]
        sum_lanes, contribs, _ = agg_mod.k3_ops(vals, agg._update_ops)
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
            bound_ms=bound(in_bytes + out_bytes))
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
        hot = agg_mod.segment_reduce_sorted(*hot_args)
        _k3_diff(torch, hot, agg_mod.segment_reduce_sorted_plain(*hot_args),
                 "on a hot key")
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
        # the same input gives the same bits on every run
        for what, args, first in (("q1", k3_args, res), ("hot key", hot_args,
                                                          hot)):
            for _ in range(2):
                if not _k3_same_bits(torch, agg_mod.segment_reduce_sorted(
                        *args), first):
                    raise AssertionError(f"K3 is not deterministic on "
                                         f"{what}")
        print("K3 deterministic: two more runs on q1 and on the hot key "
              "give the same bits")
        del batch, filtered, outs, outs_p, lanes, keep, vals, ids
        del key_cols, val_cols, hot_args, k3_args, sorted_ids
    except Exception:
        failures.append("kernel phase")
        traceback.print_exc()

    try:
        cases = _edge_cases(torch, dev, carry, agg_mod)
        print(f"edge cases: K1, K2, K3 equal their plain versions at "
              f"{cases} sizes from 0 to 100,003 rows")
    except Exception:
        failures.append("edge cases")
        traceback.print_exc()

    # ---- main path: DataFrame API, one batch -------------------------
    def count_reset():
        for fn in (carry.compact_lanes, carry.sort_order,
                   agg_mod.segment_reduce_sorted):
            fn.launches = 0

    def counts():
        return {"compact_rows": carry.compact_lanes.launches,
                "sort_order": carry.sort_order.launches,
                "segment_reduce_sorted":
                    agg_mod.segment_reduce_sorted.launches}

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
                    ("download", batch_to_arrow)):
                val = step(val)
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("stages (ms): " + " ".join(f"{k}={v:.2f}"
                                         for k, v in stages.items()))
        del val
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

    for run, per in launches.items():
        for name, count in per.items():
            if count <= 0:
                failures.append(f"{name} not launched on the {run} run")
    if len(launches) < 2:
        failures.append("launch counts missing")
    elif launches["batches"]["sort_order"] != ROWS // BATCH_ROWS + 1:
        # one sort per batch and the canonical merge's, which K3 then
        # reads through: no second sort of the merge input
        failures.append(f"sort_order launched "
                        f"{launches['batches']['sort_order']} times on the "
                        f"batches run, not {ROWS // BATCH_ROWS + 1}")

    if kernel_rows:
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=r["source"],
                 replaces=r["replaces"],
                 launches=launches.get("dataframe", {}).get(name, 0),
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by="bytes", library_ms=r["library_ms"])
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
