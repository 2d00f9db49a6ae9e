"""The port's window operator against the reference, on the CPU.

Every case of tests/test_window.py runs through the reference's
TpuSession and the port's GpuSession(device="cpu") on the same table
(the reference's data generators, or numpy draws from a seed), and the
two results are compared with the reference's ``assert_tables_equal``,
row for row in input order: integers exactly, floats to a relative 1e-9
(the tolerance of the reference's own window differential).  The
reference's single-device exchange fusion is forced on
(spark.rapids.tpu.singleChipFuse=on; its tests see 8 CPU devices), as
the port's is whenever it drives one device.  Bench q4 runs at 2^14 rows
over 64 keys through both sessions, and against a numpy oracle.

Below the sessions: the plain versions of K11 (``segment_scan``), K12
(``run_ends``) and K13 (``scatter_rows``) against the reference's
``_seg_start_positions``, ``_running``, DenseRank's ``runs_cum``,
``_run_end_positions`` and ``carry.sort_lanes``, under numpy and jnp, on
random, hot-key, all-tied, one-row-partition and padded inputs; the
window operator's determinism declaration; and its placements and
fallback reasons in the plan rewrite.
"""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.exec import basic as rbasic
from spark_rapids_tpu.exec import window as rwin
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import window as rwexpr
from spark_rapids_tpu.ops import carry as rcarry
from spark_rapids_tpu.ops.scan import cumsum_fast
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import IntegerGen, gen_table
from spark_rapids_tpu_torch.analysis import determinism as pdet
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec import basic as pbasic
from spark_rapids_tpu_torch.exec import window as pwin
from spark_rapids_tpu_torch.exec.base import CPU
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import window as pwexpr
from spark_rapids_tpu_torch.ops import gather as pgather
from spark_rapids_tpu_torch.ops import scan as pscan

FLOAT_RTOL = 1e-9
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
REF = (RF, rcol, rwexpr)
PORT = (PF, pcol, pwexpr)


def sessions(conf=None):
    conf = dict(conf or {})
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def shape(session):
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return nodes


def both(table, query, partitions=1, conf=None):
    """Each package's collect of ``query(df, F, col, W)``, compared row
    for row; returns (reference result, port result, the two sessions)."""
    ref, port = sessions(conf)
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 *REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                *PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=FLOAT_RTOL)
    return want, got, ref, port


def gen_data(length=256, seed=0):
    """tests/test_window.py's _data: nullable k in [0, 10), o, v."""
    return gen_table([("k", IntegerGen(lo=0, hi=10, null_prob=0.1)),
                      ("o", IntegerGen(lo=0, hi=1000)),
                      ("v", IntegerGen(lo=-1000, hi=1000))],
                     length=length, seed=seed)


def window_df(n=200, seed=7):
    """tests/test_window.py's _window_df."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n).astype(np.int64)),
        "o": pa.array(rng.integers(0, 50, n).astype(np.int64)),
        "v": pa.array([None if i % 11 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-100, 100, n))],
                      type=pa.int64()),
        "rid": pa.array(np.arange(n, dtype=np.int64)),
    })


def fuzz_df(seed, n=150):
    """tests/test_window.py's test_bounded_range_fuzz table."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n).astype(np.int64)),
        "o": pa.array([None if i % 13 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-30, 30, n))],
                      type=pa.int64()),
        "v": pa.array([None if i % 9 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-50, 50, n))],
                      type=pa.int64()),
        "rid": pa.array(np.arange(n, dtype=np.int64)),
    })


def ranks_table():
    """test_percent_rank_and_cume_dist's table: ties, a one-row
    partition's neighbour, and the largest partition sorted last."""
    return pa.table({
        "k": pa.array([1, 1, 1, 1, 2, 2, 3, 3], type=pa.int64()),
        "v": pa.array([10, 20, 20, 30, 5, 5, 7, 9], type=pa.int64()),
    })


def wide_table(n):
    """test_window_scale_multi_spec_differential's table: a 30 % hot key,
    nulls in v, a float column."""
    rng = np.random.default_rng(77)
    hot = rng.random(n) < 0.3
    k = np.where(hot, 3, rng.integers(0, 200, n)).astype(np.int64)
    v = rng.integers(-(10**9), 10**9, n).astype(np.int64)
    vmask = rng.random(n) < 0.08
    f = rng.random(n) * 1e6
    return pa.table({"k": pa.array(k), "v": pa.array(v, mask=vmask),
                     "f": pa.array(f)})


def q4_table(n=1 << 14, keys=64, seed=42):
    """bench.py's fact table at 2^14 rows over 64 keys (many ties)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, keys, n).astype(np.int64)),
        "v": pa.array(rng.integers(-300, 300, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
    })


def q4(df, F, col, W):
    w = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
    return df.select(col("k"), col("v"),
                     F.row_number().over(w).alias("rn"),
                     F.sum(col("v")).over(w).alias("rs"))


# ---------------------------------------------------------------------------
# tests/test_window.py's cases, through both sessions
# ---------------------------------------------------------------------------

def _row_number(df, F, col, W):
    w = W.Window.partition_by(col("k")).order_by(col("o"), col("v"))
    return df.select("k", "o", "v", F.row_number().over(w).alias("rn"))


def _rank_dense_rank(df, F, col, W):
    w = W.Window.partition_by(col("k")).order_by(col("o"))
    return df.select("k", "o", F.rank().over(w).alias("r"),
                     F.dense_rank().over(w).alias("dr"),
                     F.row_number().over(w).alias("rn"))


def _running_sum_count(df, F, col, W):
    w = (W.Window.partition_by(col("k")).order_by(col("o"), col("v"))
         .rows_between(W.Window.unboundedPreceding, W.Window.currentRow))
    return df.select("k", "o", "v", F.sum(col("v")).over(w).alias("rs"),
                     F.count(col("v")).over(w).alias("rc"))


def _whole_partition(df, F, col, W):
    w = W.Window.partition_by(col("k"))
    return df.select("k", "v", F.sum(col("v")).over(w).alias("ts"),
                     F.max(col("v")).over(w).alias("tm"),
                     F.avg(col("v")).over(w).alias("ta"))


def _lead_lag(df, F, col, W):
    w = W.Window.partition_by(col("k")).order_by(col("o"), col("v"))
    return df.select("k", "o", "v", F.lead(col("v")).over(w).alias("ld"),
                     F.lag(col("v")).over(w).alias("lg"))


def _sliding_sum(df, F, col, W):
    w = (W.Window.partition_by(col("k")).order_by(col("o"), col("v"))
         .rows_between(-2, 2))
    return df.select("k", "o", "v", F.sum(col("v")).over(w).alias("ss"))


def _differential(df, F, col, W):
    w = W.Window.partition_by(col("k")).order_by(col("o"), col("v"))
    return df.select("k", "o", "v", F.row_number().over(w).alias("rn"),
                     F.sum(col("v")).over(
                         W.Window.partition_by(col("k"))).alias("ts"))


GEN_CASES = {
    "row_number": (_row_number, 256, 0),
    "rank_dense_rank": (_rank_dense_rank, 256, 0),
    "running_sum_and_count": (_running_sum_count, 256, 0),
    "whole_partition_agg": (_whole_partition, 256, 0),
    "lead_lag": (_lead_lag, 256, 0),
    "sliding_sum": (_sliding_sum, 128, 0),
    "window_differential": (_differential, 512, 3),
}


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_window_cases_match_reference(case, partitions):
    query, length, seed = GEN_CASES[case]
    _, got, _, port = both(gen_data(length, seed), query, partitions)
    assert got.num_rows == length
    assert [p for _, p in shape(port)][1:] == ["gpu"] * (
        len(shape(port)) - 1)


def test_window_differential_port_engines_agree():
    """test_window_differential's own check, in the port: the CPU engine
    (spark.rapids.sql.enabled=false) and the rewritten plan agree."""
    table = gen_data(512, 3)
    on = GpuSession(device="cpu")
    off = GpuSession(device="cpu",
                     conf={"spark.rapids.sql.enabled": False})
    a = _differential(on.create_dataframe(table), *PORT).collect()
    b = _differential(off.create_dataframe(table), *PORT).collect()
    assert_tables_equal(b, a, ignore_order=False)
    assert all(p == CPU for _, p in shape(off))


def _bounded(frame, fns):
    def q(df, F, col, W):
        order = [col("o"), col("rid")] if frame[0] == "rows" else [col("o")]
        w = W.WindowBuilder().partition_by(col("k")).order_by(*order)
        w = w.rows_between(*frame[1:]) if frame[0] == "rows" else \
            w.range_between(*frame[1:])
        return df.select(col("rid"), *[getattr(F, fn)(col("v")).over(w)
                                        .alias(fn) for fn in fns])
    return q


def _brute_frame(k, o, lo_b, hi_b):
    """Per-row RANGE frame of tests/test_window.py's oracle: the rows of
    the row's partition whose order key lies within [o + lo_b, o + hi_b];
    a null order key frames over the null peers."""
    frames = {}
    for i in range(len(k)):
        if o[i] is None:
            frames[i] = [j for j in range(len(k))
                         if k[j] == k[i] and o[j] is None]
        else:
            frames[i] = [j for j in range(len(k))
                         if k[j] == k[i] and o[j] is not None and
                         o[i] + lo_b <= o[j] <= o[i] + hi_b]
    return frames


@pytest.mark.parametrize("case,seed,frame,fns", [
    ("bounded_rows_min_max", 7, ("rows", -2, 2), ("min", "max")),
    ("bounded_range_sum_count", 7, ("range", -5, 5), ("sum", "count")),
    ("bounded_range_min_max", 13, ("range", -3, 0), ("min", "max")),
])
def test_bounded_frames_match_reference(case, seed, frame, fns):
    tb = window_df(seed=seed)
    _, got, _, port = both(tb, _bounded(frame, fns))
    assert shape(port)[3] == ("WindowExec", "gpu")
    if frame[0] == "range":
        k, o, v = (tb.column(c).to_pylist() for c in ("k", "o", "v"))
        frames = _brute_frame(k, o, frame[1], frame[2])
        for fn in fns:
            want = []
            for i in range(tb.num_rows):
                vals = [v[j] for j in frames[i] if v[j] is not None]
                agg = {"sum": sum, "min": min, "max": max}.get(fn)
                want.append(len(vals) if fn == "count" else
                            agg(vals) if vals else None)
            assert got.column(fn).to_pylist() == want, fn


@pytest.mark.parametrize("seed,lo_b,hi_b", [
    (1, -5, 5), (2, -3, 0), (3, 0, 4), (4, -7, -2), (5, 2, 6),
])
def test_bounded_range_fuzz_matches_reference(seed, lo_b, hi_b):
    """test_bounded_range_fuzz: null order keys frame over their peer
    run, and padding rows park at the largest value so every search
    window stays ascending (without that, frames of the last partition
    come out empty); against the reference and the brute-force oracle."""
    tb = fuzz_df(seed)
    _, got, _, _ = both(tb, _bounded(("range", lo_b, hi_b),
                                     ("sum", "count", "min")))
    k, o, v = (tb.column(c).to_pylist() for c in ("k", "o", "v"))
    frames = _brute_frame(k, o, lo_b, hi_b)
    for i in range(tb.num_rows):
        vals = [v[j] for j in frames[i] if v[j] is not None]
        assert got.column("count")[i].as_py() == len(vals), i
        assert got.column("sum")[i].as_py() == (sum(vals) if vals else None)
        assert got.column("min")[i].as_py() == (min(vals) if vals else None)


@pytest.mark.parametrize("enabled", [True, False])
def test_percent_rank_and_cume_dist_match_reference(enabled):
    """Ties, and the largest partition sorted last, where padding rows
    would inflate an unmasked partition count; with and without
    partition keys."""
    conf = {"spark.rapids.sql.enabled": enabled}

    def q(df, F, col, W):
        w = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
        return df.select(col("k"), col("v"),
                         F.percent_rank().over(w).alias("pr"),
                         F.cume_dist().over(w).alias("cd"))

    def q_global(df, F, col, W):
        w = W.WindowBuilder().order_by(col("v"))
        return df.select(col("v"), F.cume_dist().over(w).alias("cd"))

    _, got, _, _ = both(ranks_table(), q, conf=conf)
    assert got.column("pr").to_pylist() == [0.0, 1 / 3, 1 / 3, 1.0, 0.0,
                                            0.0, 0.0, 1.0]
    assert got.column("cd").to_pylist() == [0.25, 0.75, 0.75, 1.0, 1.0,
                                            1.0, 0.5, 1.0]
    both(ranks_table(), q_global, conf=conf)


def _multi_spec(df, F, col, W):
    w1 = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
    w2 = W.WindowBuilder().partition_by(col("k")).order_by(col("f").desc())
    w3 = (W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
          .rows_between(-2, 2))
    return df.select(
        col("k"), col("v"), col("f"),
        F.row_number().over(w1).alias("rn"),
        F.sum(col("v")).over(w1).alias("rs"),
        F.rank().over(w2).alias("rk"),
        F.avg(col("f")).over(w2).alias("ra"),
        F.min(col("v")).over(w3).alias("m3"),
        F.count(col("v")).over(w3).alias("c3"),
        F.lag(col("v"), 1).over(w1).alias("lg"))


def test_multi_spec_differential_matches_reference():
    """test_window_scale_multi_spec_differential at 50,000 rows: three
    specs, nulls, a descending float order, a bounded ROWS frame."""
    _, got, _, _ = both(wide_table(50_000), _multi_spec)
    assert got.num_rows == 50_000


def test_more_functions_match_reference():
    """The functions test_window.py leaves out: ntile, lead and lag by 2,
    dense_rank over two order keys, count(*), a running RANGE min and a
    whole-partition min, under nulls in the partition and order keys and
    a descending, nulls-last order."""
    def q(df, F, col, W):
        w = W.WindowBuilder().partition_by(col("k")).order_by(
            col("o").desc(), col("v").asc_nulls_last())
        return df.select(
            col("k"), col("o"), col("v"),
            F.ntile(3).over(w).alias("nt"),
            F.lead(col("v"), 2).over(w).alias("ld2"),
            F.lag(col("o"), 2).over(w).alias("lg2"),
            F.dense_rank().over(w).alias("dr"),
            F.count("*").over(w).alias("cs"),
            F.min(col("v")).over(w).alias("rmin"),
            F.min(col("v")).over(W.Window.partition_by(col("k")))
            .alias("pmin"))
    table = gen_table([("k", IntegerGen(lo=0, hi=6, null_prob=0.1)),
                       ("o", IntegerGen(lo=0, hi=8, null_prob=0.1)),
                       ("v", IntegerGen(lo=-9, hi=9, null_prob=0.2))],
                      length=300, seed=11)
    both(table, q)
    both(table, q, partitions=2)


@pytest.mark.parametrize("partitions", [1, 4])
def test_q4_matches_reference_and_numpy(partitions):
    """Bench q4 at 2^14 rows over 64 keys: row_number and the running
    RANGE sum (peers share the value at their run's end) equal the
    reference's output and a numpy oracle row for row."""
    table = q4_table()
    _, got, _, port = both(table, q4, partitions)
    want_rn, want_rs = q4_oracle(table)
    assert np.array_equal(got.column("rn").to_numpy(), want_rn)
    assert np.array_equal(got.column("rs").to_numpy(), want_rs)
    nodes = shape(port)
    assert nodes[:4] == [("DeviceToHostExec", "cpu"),
                         ("CoalesceBatchesExec", "gpu"),
                         ("ProjectExec", "gpu"), ("WindowExec", "gpu")]
    assert ("ShuffleExchangeExec", "gpu") not in nodes
    if partitions > 1:
        assert nodes[4] == ("GatherPartitionsExec", "gpu")


def q4_oracle(table):
    """A stable lexsort by (k, v); row_number the position within k plus
    one; the running sum within k read at each (k, v) run's end; back to
    input order."""
    k, v = table.column("k").to_numpy(), table.column("v").to_numpy()
    n = len(k)
    o = np.lexsort((v, k))
    ks, vs = k[o], v[o]
    pos = np.arange(n)
    new_k = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(new_k, pos, 0))
    cs = np.cumsum(vs)
    run = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    new_run = new_k | np.r_[True, vs[1:] != vs[:-1]]
    ends = np.where(np.r_[new_run[1:], True], pos, n)
    end = np.minimum.accumulate(ends[::-1])[::-1]
    rn, rs = np.empty(n, np.int64), np.empty(n, np.int64)
    rn[o] = pos - start + 1
    rs[o] = run[end]
    return rn, rs


def test_select_expr_window_and_default_names():
    """select_expr_window keeps every column and names an unaliased
    window expression after its function, as the reference does."""
    table = q4_table(300, 7)

    def q(df, F, col, W):
        w = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
        return df.select_expr_window(
            F.row_number().over(w).expr,
            F.max(col("f")).over(w).expr)
    want, got, _, _ = both(table, q)
    assert got.column_names == ["k", "v", "f", "rownumber_w", "max_w"]


# ---------------------------------------------------------------------------
# K11, K12 and K13's plain versions against the reference's functions
# ---------------------------------------------------------------------------

def flag_inputs(kind, n=3000, seed=0):
    """Sorted-row flags (new_seg, new_run) and the live row count."""
    rng = np.random.default_rng(seed)
    n_live = n
    if kind == "random":
        seg = rng.random(n) < 0.02
        run = seg | (rng.random(n) < 0.3)
    elif kind == "hot_key":           # one partition over 90 % of rows
        seg = np.zeros(n, bool)
        seg[rng.choice(np.arange(n // 10), 20, replace=False)] = True
        run = seg | (rng.random(n) < 0.05)
    elif kind == "all_ties":          # one partition, one peer run
        seg = np.zeros(n, bool)
        run = seg.copy()
    elif kind == "one_row_partitions":
        seg = np.ones(n, bool)
        run = seg.copy()
    else:                             # padded: dead rows at the tail
        n_live = n - 777
        seg = rng.random(n) < 0.01
        run = seg | (rng.random(n) < 0.2)
        seg[n_live:] = False
        run[n_live:] = False
    seg[0] = run[0] = n_live > 0
    return seg, run, n_live


FLAG_KINDS = ["random", "hot_key", "all_ties", "one_row_partitions",
              "padded"]
XPS = {"numpy": np, "jnp": jnp}


def to_ref(xp, a):
    return a if xp is np else jnp.asarray(a)


@pytest.mark.parametrize("xp_name", sorted(XPS))
@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_k11_positions_match_reference(kind, xp_name):
    xp = XPS[xp_name]
    seg, run, _ = flag_inputs(kind)
    got = pscan.segment_scan(torch.from_numpy(seg), torch.from_numpy(run),
                             seg_start=True, run_start=True, runs_cum=True)
    assert np.array_equal(got.seg_start.numpy(), np.asarray(
        rwin._seg_start_positions(xp, to_ref(xp, seg))))
    assert np.array_equal(got.run_start.numpy(), np.asarray(
        rwin._seg_start_positions(xp, to_ref(xp, run))))
    assert np.array_equal(got.runs_cum.numpy(), np.asarray(cumsum_fast(
        xp, to_ref(xp, run.astype(np.int32)))))
    assert got.seg_start.dtype == got.runs_cum.dtype == torch.int32


def value_inputs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.85
    if dtype == np.int64:
        v = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    else:
        v = rng.random(n) * 1e3
    return v, valid


@pytest.mark.parametrize("xp_name", sorted(XPS))
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_k11_running_sums_match_reference(kind, dtype, xp_name):
    """Running sums and valid counts against the reference's _running:
    int64 exactly (both wrap mod 2^64: the values reach 2^62), float64
    to a relative 1e-9."""
    xp = XPS[xp_name]
    seg, _, n_live = flag_inputs(kind)
    n = len(seg)
    v, valid = value_inputs(n, np.dtype(dtype))
    valid &= np.arange(n) < n_live
    got = pscan.segment_scan(torch.from_numpy(seg), pairs=[
        (torch.from_numpy(v), torch.from_numpy(valid)),
        (None, torch.from_numpy(valid))])
    vv = np.where(valid, v, 0).astype(v.dtype)
    ss = rwin._seg_start_positions(xp, to_ref(xp, seg))
    want_s, want_c = rwin.WindowExec._running(
        None, xp, "sum", to_ref(xp, vv), to_ref(xp, valid), to_ref(xp, seg),
        ss)
    want_s, want_c = np.asarray(want_s), np.asarray(want_c)
    assert np.array_equal(got.counts[0].numpy(), want_c)
    assert np.array_equal(got.counts[1].numpy(), want_c)
    assert got.sums[1] is None
    if dtype == "int64":
        assert np.array_equal(got.sums[0].numpy(), want_s)
    else:
        np.testing.assert_allclose(got.sums[0].numpy(), want_s,
                                   rtol=FLOAT_RTOL, atol=1e-9)


def test_k11_float_sum_does_not_cancel():
    """A float running sum adds its own partition's rows only.  The
    reference's difference of two global prefix sums cancels when an
    earlier partition is large (1e17 here): the small values vanish in
    the global sum, and the reference reads 0 where K11's plain version
    equals math.fsum."""
    small = np.array([0.1, 0.2, 0.3, 0.4], dtype=np.float64)
    v = np.concatenate([[1e17], small])
    seg = np.array([True, True, False, False, False])
    valid = np.ones(len(v), bool)
    got = pscan.segment_scan(torch.from_numpy(seg), pairs=[
        (torch.from_numpy(v), torch.from_numpy(valid))]).sums[0].numpy()
    want = [math.fsum(small[:i + 1]) for i in range(len(small))]
    np.testing.assert_allclose(got[1:], want, rtol=1e-15)
    ref, _ = rwin.WindowExec._running(
        None, np, "sum", v, valid, seg, rwin._seg_start_positions(np, seg))
    assert ref[1:].tolist() == [0.0] * len(small)


@pytest.mark.parametrize("kind", ["one_partition", "one_row_partitions",
                                  "random"])
@pytest.mark.parametrize("n", [2047, 2048, 2049, 4095, 4096, 4097, 8191,
                               8192, 8193, 16385])
def test_k11_around_its_tiles_matches_reference(n, kind):
    """K11's positions, run count, int64 running sum and counts at n on
    either side of its tiles (2,048 rows with three or four pairs, 4,096
    with two, 8,192 with one; the old design's were 2,048), with one
    partition spanning every tile and with every row its own partition,
    against the reference."""
    rng = np.random.default_rng(n)
    if kind == "one_partition":
        seg = np.zeros(n, bool)
        run = rng.random(n) < 0.3
    elif kind == "one_row_partitions":
        seg = np.ones(n, bool)
        run = seg.copy()
    else:
        seg = rng.random(n) < 0.01
        run = seg | (rng.random(n) < 0.3)
    seg[0] = run[0] = True
    v, valid = value_inputs(n, np.dtype(np.int64), seed=n)
    pairs = [(torch.from_numpy(v), torch.from_numpy(valid))]
    for npairs in (1, 2, 3):
        got = pscan.segment_scan(torch.from_numpy(seg), torch.from_numpy(run),
                                 pairs * npairs, seg_start=True,
                                 run_start=True, runs_cum=True)
        ss = rwin._seg_start_positions(np, seg)
        assert np.array_equal(got.seg_start.numpy(), ss)
        assert np.array_equal(got.run_start.numpy(),
                              rwin._seg_start_positions(np, run))
        assert np.array_equal(got.runs_cum.numpy(),
                              cumsum_fast(np, run.astype(np.int32)))
        want_s, want_c = rwin.WindowExec._running(
            None, np, "sum", np.where(valid, v, 0), valid, seg, ss)
        for s, c in zip(got.sums, got.counts):
            assert np.array_equal(s.numpy(), want_s)
            assert np.array_equal(c.numpy(), want_c)


@pytest.mark.parametrize("xp_name", sorted(XPS))
@pytest.mark.parametrize("kind", FLAG_KINDS)
def test_k12_ends_match_reference(kind, xp_name):
    """K12's plain version against _run_end_positions: every row when
    all rows are live; on padded input the live rows (the reference's
    last run reaches into the padding, K12's stops at the last live
    row, and padding rows read it)."""
    xp = XPS[xp_name]
    seg, run, n_live = flag_inputs(kind)
    seg_end, run_end = pscan.run_ends(torch.from_numpy(seg),
                                      torch.from_numpy(run), n_live)
    for got, flags in ((seg_end, seg), (run_end, run)):
        want = np.asarray(rwin._run_end_positions(xp, to_ref(xp, flags)))
        got = got.numpy()
        assert got.dtype == np.int32
        if n_live == len(flags):
            assert np.array_equal(got, want)
        else:
            last = want[:n_live] == len(flags) - 1
            assert np.array_equal(got[:n_live][~last], want[:n_live][~last])
            assert (got[:n_live][last] == n_live - 1).all()
            assert (got[n_live:] == n_live - 1).all()


@pytest.mark.parametrize("n,n_live", [
    (8191, 8191), (8192, 8192), (8193, 8193),
    (8193, 8192), (8193, 8191), (8200, 8193),
    (16385, 8192), (16385, 8193), (16385, 16384)])
def test_k12_ends_at_its_tile_edges(n, n_live):
    """K12 (tiles of 8,192 rows, taken from the array's end)
    around its tile edges and with the live rows ending on either side
    of them, against _run_end_positions over the live rows; padding rows
    read the last live row."""
    rng = np.random.default_rng(n + n_live)
    seg = rng.random(n) < 0.001
    run = seg | (rng.random(n) < 0.2)
    seg_end, run_end = pscan.run_ends(torch.from_numpy(seg),
                                      torch.from_numpy(run), n_live)
    for got, flags in ((seg_end, seg), (run_end, run)):
        want = np.asarray(rwin._run_end_positions(np, flags[:n_live]))
        got = got.numpy()
        assert np.array_equal(got[:n_live], want)
        assert (got[n_live:] == n_live - 1).all()


def test_k12_edges():
    one = torch.tensor([True])
    assert pscan.run_ends(one, one, 1)[0].tolist() == [0]
    none_live = torch.zeros(5, dtype=torch.bool)
    assert pscan.run_ends(none_live, None, 0)[0].tolist() == [0] * 5
    assert pscan.run_ends(None, none_live, 0)[0] is None
    with pytest.raises(ValueError):
        pscan.run_ends(none_live, None, 6)


@pytest.mark.parametrize("xp_name", sorted(XPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_k13_matches_reference_sort_lanes(seed, xp_name):
    """K13's plain version (out[order[i]] = lane[i]) against the
    reference's carry.sort_lanes keyed by the layout's order, over 1-, 4-
    and 8-byte lanes."""
    xp = XPS[xp_name]
    rng = np.random.default_rng(seed)
    n = 2048
    order = rng.permutation(n).astype(np.int32)
    lanes = [rng.integers(-2**40, 2**40, n).astype(np.int64),
             rng.random(n) < 0.5, rng.integers(0, 99, n).astype(np.int32),
             rng.random(n)]
    got = pgather.scatter_rows(torch.from_numpy(order),
                               [torch.from_numpy(x) for x in lanes])
    _, want = rcarry.sort_lanes(
        xp, [to_ref(xp, order.astype(np.uint32))],
        [to_ref(xp, x) for x in lanes], n)
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    back = pgather.gather_rows(torch.from_numpy(order), got)
    assert all(torch.equal(b, torch.from_numpy(x))
               for b, x in zip(back, lanes))


@pytest.mark.parametrize("n,shift", [
    (0, 0), (1, 0), (2, 0), (256, 0), (257, 1), (512, 1), (513, 2),
    (1 << 20, 12), ((1 << 20) + 1, 13), (1 << 25, 17), ((1 << 25) + 1, 18)])
def test_k13_bucket_shift(n, shift):
    """K13 bins destinations into at most 256 buckets of 2^shift."""
    plan = pgather.scatter_plan(n, [4, 8, 1])
    assert plan.shift == shift
    assert n == 0 or (n - 1) >> plan.shift < 256
    assert n <= 256 or (n - 1) >> plan.shift >= 128


@pytest.mark.parametrize("n,widths,binned,scratch", [
    (0, [4, 8, 1], False, 0),
    (1, [4, 8, 1], False, 0),
    # q4's lanes: the single pass while 13 B a row fits in 48 MiB
    ((48 << 20) // 13, [4, 8, 1], False, 0),
    ((48 << 20) // 13 + 1, [4, 8, 1], True, ((48 << 20) // 13 + 1) * 17),
    (12 << 20, [4], False, 0),
    ((12 << 20) + 1, [4], True, ((12 << 20) + 1) * 8),
    (1 << 25, [4, 8, 1], True, (1 << 25) * 17),
    (1 << 21, [8] * 8 + [1] * 8, True, (1 << 21) * 76)])
def test_k13_single_pass_threshold_and_scratch(n, widths, binned, scratch):
    """The single pass serves outputs up to 48 MiB (they merge in L2);
    the binned path takes 4 B of destination and the lanes a row of
    scratch."""
    plan = pgather.scatter_plan(n, widths)
    assert (plan.binned, plan.scratch_bytes) == (binned, scratch)


@pytest.mark.parametrize("binned", [None, False, True])
def test_k13_path_choice_is_the_plain_version_on_cpu(binned):
    rng = np.random.default_rng(3)
    n = 513
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    lanes = [torch.from_numpy(rng.integers(-9, 9, n)),
             torch.from_numpy(rng.random(n) < 0.5)]
    before = pgather.scatter_rows.launches
    got = pgather.scatter_rows(order, lanes, binned=binned)
    assert pgather.scatter_rows.launches == before
    assert all(torch.equal(g, w) for g, w in zip(
        got, pgather.scatter_rows_plain(order, lanes)))


def test_wrappers_check_their_arguments():
    b = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        pscan.segment_scan(b.to(torch.int8))
    with pytest.raises(ValueError):
        pscan.segment_scan(b, run_start=True)
    with pytest.raises(TypeError):
        pscan.segment_scan(b, pairs=[(torch.zeros(4, dtype=torch.int32), b)])
    with pytest.raises(TypeError):
        pgather.scatter_rows(torch.arange(4), [b])
    with pytest.raises(TypeError):
        pgather.scatter_rows(torch.arange(4, dtype=torch.int32),
                             [torch.zeros(3, dtype=torch.bool)])
    empty = pscan.segment_scan(torch.zeros(0, dtype=torch.bool))
    assert empty.seg_start.shape == (0,)


# ---------------------------------------------------------------------------
# determinism and the plan rewrite
# ---------------------------------------------------------------------------

def test_window_determinism_matches_reference():
    def plan(basic, core, win_exec, wexpr, funcs):
        scan = basic.LocalScanExec(ranks_table())
        w = wexpr.WindowExpression(
            funcs.RowNumber(), wexpr.WindowSpec(
                [core.AttributeReference("k")],
                [(core.AttributeReference("v"), True, True)]), "rn")
        return win_exec.WindowExec([w], scan)
    ref = plan(rbasic, rcore, rwin, rwexpr, rwexpr).determinism()
    port = plan(pbasic, pcore, pwin, pwexpr, pwexpr).determinism()
    assert port.cls == ref.cls == pdet.ORDER_STABLE
    assert port.reason == ref.reason
    for flag in ("order_sensitive_selection", "establishes_order",
                 "partition_scoped", "canonicalizable"):
        assert getattr(port, flag) == getattr(ref, flag)


def _explain_lines(session):
    return [ln.strip() for ln in
            session.last_explain.replace("TPU", "GPU").splitlines()]


def test_bounded_range_on_two_order_keys_falls_back_like_reference():
    """A bounded RANGE frame over two order keys stays on the CPU engine
    with the reference's reason, between device operators, and both
    engines compute the same result."""
    def q(df, F, col, W):
        w = (W.WindowBuilder().partition_by(col("k"))
             .order_by(col("o"), col("rid")).range_between(-3, 3))
        return df.filter(col("rid") > 5).select(
            col("rid"), F.sum(col("v")).over(w).alias("s"))
    _, _, ref, port = both(window_df(), q)
    assert shape(port) == shape(ref)
    assert _explain_lines(port) == _explain_lines(ref)
    assert ("!Exec <WindowExec> cannot run on GPU because bounded range "
            "frames need a single ascending numeric/date/timestamp order "
            "key") in _explain_lines(port)
    assert ("WindowExec", CPU) in shape(port)


def test_unsupported_function_falls_back_and_raises_like_reference():
    """A literal over a window is no window function: the WindowExec
    stays on the CPU with the reference's reason, and running it raises
    there, in both packages, with the same words."""
    outcomes = []
    ref, port = sessions()
    for s, (F, col, W) in ((ref, REF), (port, PORT)):
        w = W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
        df = s.create_dataframe(window_df()).select(
            col("k"), F.lit(1).over(w).alias("x"))
        s.explain(df._lp)
        with pytest.raises(NotImplementedError) as err:
            df.collect()
        outcomes.append(str(err.value))
    assert outcomes[0] == outcomes[1]
    assert shape(port) == shape(ref)
    assert ("!Exec <WindowExec> cannot run on GPU because window function "
            "Literal not supported") in _explain_lines(port)


def test_fuse_off_keeps_the_window_on_the_cpu():
    """With spark.rapids.tpu.singleChipFuse=off the hash exchange under
    a multi-partition window is not stripped; it runs on the host, so
    the window stays on the CPU with the reason, and the result is the
    reference's."""
    table = q4_table(2000, 16)
    ref, _ = sessions()
    port = GpuSession(device="cpu",
                      conf={"spark.rapids.tpu.singleChipFuse": "off"})
    want = q4(ref.create_dataframe(table, num_partitions=3), *REF).collect()
    got = q4(port.create_dataframe(table, num_partitions=3),
             *PORT).collect()
    assert_tables_equal(want, got, ignore_order=True)
    assert ("WindowExec", CPU) in shape(port)
    assert ("ShuffleExchangeExec", CPU) in shape(port)
    assert any("singleChipFuse=off" in ln for ln in _explain_lines(port))


def test_grouped_min_stays_unported():
    """Min and Max were window aggregates only until the grouped min and
    max came to K3: a grouped min now runs on the GPU and equals the
    reference.  The grouped first and last came later (K3's positional
    kinds); an op no aggregate has stays unported."""
    ref, port = sessions()
    t = q4_table(100, 4)
    want = ref.create_dataframe(t).group_by(rcol("k")).agg(
        RF.min(rcol("v")).alias("m")).collect()
    got = port.create_dataframe(t).group_by(pcol("k")).agg(
        PF.min(pcol("v")).alias("m")).collect()
    assert_tables_equal(want, got)
    assert "!" not in port.last_explain
    with pytest.raises(NotImplementedError, match="not ported"):
        pagg._group_reduce([], [], ["median"], 0, True)


def test_bounded_range_over_nan_sorting_last():
    """A bounded RANGE frame over a DOUBLE key whose last partition holds
    +inf and NaN: Spark's frame of the +inf row, [inf - 1, inf + 1],
    holds the +inf row alone (NaN sorts above +inf), so its sum is 6.
    The reference's search reaches into its padding, parked at +inf, and
    also sums the NaN row: 13 (recorded, ROADMAP.md Queue 3).  With the
    partition first in sort order both give 6."""
    table = pa.table({
        "k": pa.array([1, 1, 2, 2, 2], type=pa.int64()),
        "d": pa.array([0.5, 1.0, float("inf"), float("nan"), -1.0]),
        "v": pa.array([1, 2, 6, 7, 8], type=pa.int64())})

    def query(df, F, col, W):
        w = W.WindowBuilder().partition_by(col("k")).order_by(
            col("d")).range_between(-1, 1)
        return df.select(col("k"), col("d"), col("v"),
                         F.sum(col("v")).over(w).alias("s"))
    ref, port = sessions()
    got = query(port.create_dataframe(table), *PORT).collect()
    want = query(ref.create_dataframe(table), *REF).collect()
    inf_row = [i for i, d in enumerate(got["d"].to_pylist())
               if d == float("inf")]
    assert got["s"].to_pylist()[inf_row[0]] == 6
    assert want["s"].to_pylist()[inf_row[0]] == 13
    assert "!" not in port.last_explain
    # k=2 first in sort order: both give 6
    first = table.set_column(0, "k", pa.array([3, 3, 2, 2, 2]))
    both(first, query)


@pytest.mark.parametrize("inflated", [False, True])
def test_cost_optimizer_places_the_window_like_reference(inflated):
    """With spark.rapids.sql.optimizer.enabled the window node gets its
    child's rows from the static row model: default costs keep q4 on the
    GPU; a window cost inflated on the device side moves it to the CPU,
    with the reference's explain."""
    conf = {"spark.rapids.sql.optimizer.enabled": True}
    ref_conf, port_conf = dict(conf), dict(conf)
    if inflated:
        ref_conf["spark.rapids.sql.optimizer.tpu.exec.WindowExec"] = 1e9
        port_conf["spark.rapids.sql.optimizer.gpu.exec.WindowExec"] = 1e9
    ref, _ = sessions(ref_conf)
    port = GpuSession(device="cpu", conf=port_conf)
    table = q4_table(3000, 20)
    want = q4(ref.create_dataframe(table), *REF).collect()
    got = q4(port.create_dataframe(table), *PORT).collect()
    assert_tables_equal(want, got, ignore_order=False)
    assert shape(port) == shape(ref)
    assert _explain_lines(port) == _explain_lines(ref)
    assert (("WindowExec", CPU) in shape(port)) == inflated


def test_nan_order_value_gets_an_empty_bounded_range_frame():
    """A row whose DOUBLE order key is NaN, under a bounded RANGE frame:
    both packages give it a null sum and a count of 0, since the bounds
    NaN - 1 and NaN + 1 compare false with every key.  Under Spark's
    ordering, where NaN equals NaN, its frame would hold its NaN peers
    (recorded in ROADMAP.md Queue 3)."""
    table = pa.table({
        "k": pa.array([1, 1, 1, 1, 2], type=pa.int64()),
        "d": pa.array([0.5, 1.0, float("nan"), float("nan"), 3.0]),
        "v": pa.array([1, 2, 4, 8, 16], type=pa.int64())})

    def query(df, F, col, W):
        w = W.WindowBuilder().partition_by(col("k")).order_by(
            col("d")).range_between(-1, 1)
        return df.select(col("k"), col("d"), col("v"),
                         F.sum(col("v")).over(w).alias("s"),
                         F.count(col("v")).over(w).alias("c"))
    ref, port = sessions()
    got = query(port.create_dataframe(table), *PORT).collect()
    want = query(ref.create_dataframe(table), *REF).collect()
    assert "!" not in port.last_explain
    for t in (got, want):
        rows = sorted(zip(t["v"].to_pylist(), t["s"].to_pylist(),
                          t["c"].to_pylist()))
        assert rows == [(1, 3, 2), (2, 3, 2), (4, None, 0), (8, None, 0),
                        (16, 16, 1)]
