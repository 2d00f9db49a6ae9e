#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from csrc/ with nvcc, holds each
against its plain PyTorch version at the main paths' shapes and at edge
cases (the join kernels K6, K4 and K5 on 27 join cases and a hot key;
K3 on a group-by of 9 columns with 17 sums), then drives the two main
paths.  Bench q1, scan -> filter(v > -500000) -> group by k: sum(v),
avg(f), count(*) -> collect, over 2^25 rows, twice: through the
DataFrame API as one batch, and at exec level as 8 batches of 4,194,304
rows (update -> concat -> merge -> evaluate).  Bench q2, the 2^25-row
fact table inner-joined USING k with the 100,000-row dimension -> group
by k: sum(w) -> collect, through the DataFrame API, and the hash join
alone at exec level.  Each result is compared with pyarrow on the host.
Launch counts are reset just before each main-path run and must be > 0
after it for every kernel of that path.  Needs one CUDA card; exits
non-zero and prints no result without one, or when any phase fails.
The last line is a JSON object.
"""

import itertools
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
DIM_ROWS = 100_000         # bench.py make_tables' dimension
HOT_COPIES = 10_000        # build rows of the hot key in K5's skew check
HOT_PROBE_ROWS = 1 << 20   # probe rows of that check, 1 % on the hot key
WIDE_ROWS = 1 << 20        # rows of the wide group-by check
WIDE_KEYS = 9              # its grouping columns: 18 key words
WIDE_SUMS = 17             # its sums: 17 K3 ops, two sets of launches


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    sums, contribs, _ = agg_mod.k3_ops(vals, ["sum"] * WIDE_SUMS)
    args = (words, None, sums, contribs, False, carry.sort_order(words))
    k3 = agg_mod.segment_reduce_sorted
    before = k3.launches
    res = k3(*args)
    if dev.type == "cuda" and k3.launches <= before:
        raise AssertionError("K3 did not launch on the wide group-by")
    _k3_diff(torch, res, agg_mod.segment_reduce_sorted_plain(*args),
             f"with {WIDE_KEYS} grouping columns and {WIDE_SUMS} sums")
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
          f"K3 equals its plain version and the session's result equals "
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
    """K6 on both sides' keys, K6 + K2 + K4 (count_matches) and K5
    (expand_pairs) against their plain versions on one build and probe
    side whose first ``nkeys`` columns are the key, for inner, left and
    full joins, at an output capacity equal to the total and at its
    capacity bucket.  Fails unless K6 launched (for each side with rows),
    K4 (where there are probe rows) and K5.  Returns the inner total."""
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
        ends = torch.cumsum(jk.effective_counts(counts, plive, how), 0)
        total = int(ends[-1]) if cap_p else 0
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
    ends = torch.cumsum(jk.effective_counts(counts, live_p, "inner"), 0)
    total = int(ends[-1])
    out_cap = bucket_for(total)
    args = (ends, lo, counts, side.order, total, out_cap, probe, build)
    if not _same_expansion(torch, jk.expand_pairs(*args),
                           jk.expand_pairs_plain(*args)):
        raise AssertionError("K5 differs from its plain version on the hot "
                             "key")
    return total, out_cap, args, k4_args


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
    from spark_rapids_tpu_torch.api.column import col
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.columnar.device import (DeviceColumn,
                                                        batch_to_arrow,
                                                        batch_to_device,
                                                        bucket_for)
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
    from spark_rapids_tpu_torch.exec.filter_common import keep_flags
    from spark_rapids_tpu_torch.expr.aggregates import (
        COMPLETE, AggregateExpression, Average, Count, Sum)
    from spark_rapids_tpu_torch.expr.core import AttributeReference as A
    from spark_rapids_tpu_torch.expr.core import EvalContext
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import join_kernels as jk
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
            FilterExec(filt_expr, LocalScanExec(table, batch_rows=BATCH_ROWS)))
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

        eff = jk.effective_counts(counts, plive, "inner")
        ends = torch.cumsum(eff, 0)
        q2_pairs = int(ends[-1])
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
        _wide_group_by(torch, dev, carry, agg_mod, seg, batch_to_device,
                       GpuSession(), F, col)
    except Exception:
        failures.append("K3 wide group-by")
        traceback.print_exc()

    # ---- main path: DataFrame API, one batch -------------------------
    wrappers = {"compact_rows": carry.compact_lanes,
                "sort_order": carry.sort_order,
                "segment_reduce_sorted": agg_mod.segment_reduce_sorted,
                "key_hash": jk.combined_key_hash,
                "hash_table": jk.hash_table,
                "join_probe": jk.join_probe,
                "expand_pairs": jk.expand_pairs}

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
        agg_q2 = q2_session.last_plan
        project = agg_q2.children[0]
        join = project.children[0]
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
                        out=batch_to_arrow(st["out"])))):
                step()
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("q2 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items()))
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

    path_kernels = {
        "dataframe": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "batches": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q2": ("key_hash", "sort_order", "hash_table", "join_probe",
               "expand_pairs", "segment_reduce_sorted")}
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
        # q2 for K4-K6
        run_of = {"key_hash": "q2", "join_probe": "q2", "expand_pairs": "q2"}
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=r["source"],
                 replaces=r["replaces"],
                 launches=launches.get(run_of.get(name, "dataframe"),
                                       {}).get(name, 0),
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
