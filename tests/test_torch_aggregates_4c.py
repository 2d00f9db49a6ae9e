"""The aggregates of ROADMAP Queue 1 item 4c against the reference, on the
CPU: first, last, collect_list, collect_set, the moments (stddev,
variance: sample and population), pivot (PivotFirst) and
approx_percentile.

Inputs are numpy draws from a seed, run through the reference's
TpuSession (its exchange fusion forced on, as the port's is on one
device) and the port's GpuSession(device="cpu"), and compared with the
reference's ``assert_tables_equal``: integers, strings, dates and
decimals exactly, floats to a relative 1e-9 (the moments are
differences of float sums that the two engines add in another order).
Both engines: the device path (``spark.rapids.sql.enabled`` on; K3's
plain folds and positional kinds, the gathers, K1/K2's plain versions)
and the CPU engine (off; pyarrow in both packages).

Below the sessions: the merge of many batches at exec level, where the
canonical keyed merge decides which partial comes first (the probe table
of four two-row batches, pinned row for row); K3's plain positional kinds
against the reference's ``segment_reduce(np, "first"|"last", ...)``;
``k3_ops``; the rule count; determinism.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.exec import aggregate as ragg
from spark_rapids_tpu.exec.base import TPU
from spark_rapids_tpu.exec.base import ExecContext as RExecContext
from spark_rapids_tpu.exec.basic import LocalScanExec as RLocalScanExec
from spark_rapids_tpu.expr import aggregates as raggs
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu.plan import overrides as roverrides
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.analysis import determinism as pdet
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.device import DeviceColumn
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec.base import ExecContext as PExecContext
from spark_rapids_tpu_torch.exec.basic import LocalScanExec as PLocalScanExec
from spark_rapids_tpu_torch.expr import aggregates as paggs
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.ops import segmented as pseg
from spark_rapids_tpu_torch.plan import overrides as poverrides
from spark_rapids_tpu_torch import types as pt

FLOAT_RTOL = 1e-9
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


def sessions(enabled=True):
    conf = {"spark.rapids.sql.enabled": enabled}
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def run_both(table, query, enabled=True, partitions=1):
    ref, port = sessions(enabled)
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 RF, rcol).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                PF, pcol).collect()
    return want, got, port


def placements(port):
    out = []
    port.last_plan.foreach(lambda e: out.append((type(e).__name__,
                                                 e.placement)))
    return out


def _nullify(rng, values, frac):
    out = list(values)
    for i in np.nonzero(rng.random(len(out)) < frac)[0]:
        out[i] = None
    return out


def make_table(seed=7, n=600, keys=25, null_frac=0.2):
    """k INT keys; x LONG, f DOUBLE, s STRING, d DATE, m DECIMAL(12, 2),
    w DECIMAL(30, 4), b BOOLEAN, each with nulls; key 99 holds only
    nulls."""
    import datetime
    import decimal
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    k[:10] = 99
    null = rng.random(n) < null_frac
    null[:10] = True

    def col(vals):
        return [None if z else v for v, z in zip(vals, null)]
    x = rng.integers(-1000, 1000, n)
    f = np.round(rng.normal(0, 100, n), 3)
    s = [f"s{v % 37}" for v in rng.integers(0, 10**6, n)]
    d = [datetime.date(1995, 1, 1) + datetime.timedelta(days=int(v))
         for v in rng.integers(0, 3000, n)]
    m = [decimal.Decimal(int(v)).scaleb(-2) for v in
         rng.integers(-10**9, 10**9, n)]
    w = [decimal.Decimal(int(v) * 10**12 + int(u)).scaleb(-4)
         for v, u in zip(rng.integers(-10**9, 10**9, n),
                         rng.integers(0, 10**6, n))]
    b = rng.random(n) < 0.5
    return pa.table({
        "k": pa.array(k, pa.int32()),
        "x": pa.array(col(x.tolist()), pa.int64()),
        "f": pa.array(col(f.tolist()), pa.float64()),
        "s": pa.array(col(s), pa.string()),
        "d": pa.array(col(d), pa.date32()),
        "m": pa.array(col(m), pa.decimal128(12, 2)),
        "w": pa.array(col(w), pa.decimal128(30, 4)),
        "b": pa.array(col(b.tolist()), pa.bool_()),
        "p": pa.array([["A", "N", "R", None][i % 4]
                       for i in rng.integers(0, 4, n)], pa.string()),
    })


def _aggs(name):
    """The aggregate of each parametrised case, for either package."""
    return {
        "first": lambda F, c: [F.first(c("x")).alias("r")],
        "last": lambda F, c: [F.last(c("x")).alias("r")],
        "first_ignore": lambda F, c: [F.first(c("x"), True).alias("r")],
        "last_ignore": lambda F, c: [F.last(c("x"), True).alias("r")],
        "collect_list": lambda F, c: [F.collect_list(c("x")).alias("r")],
        "collect_set": lambda F, c: [F.collect_set(c("x")).alias("r")],
        "stddev_samp": lambda F, c: [F.stddev(c("f")).alias("r")],
        "stddev_pop": lambda F, c: [F.stddev_pop(c("f")).alias("r")],
        "var_samp": lambda F, c: [F.variance(c("x")).alias("r")],
        "var_pop": lambda F, c: [F.var_pop(c("f")).alias("r")],
        "percentile": lambda F, c: [
            F.approx_percentile(c("x"), 0.5).alias("r"),
            F.approx_percentile(c("f"), 0.9).alias("r9")],
    }[name]


FUNCTIONS = ["first", "last", "first_ignore", "last_ignore", "collect_list",
             "collect_set", "stddev_samp", "stddev_pop", "var_samp",
             "var_pop", "percentile"]


def _grouped(name):
    def q(df, F, col):
        return df.group_by(col("k")).agg(*_aggs(name)(F, col))
    return q


def _global(name):
    def q(df, F, col):
        return df.agg(*_aggs(name)(F, col))
    return q


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("enabled", [True, False], ids=["device", "cpu"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_grouped_matches_reference(name, enabled, partitions):
    t = make_table()
    want, got, port = run_both(t, _grouped(name), enabled, partitions)
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    if enabled:
        assert "!" not in port.last_explain
        assert ("GpuHashAggregateExec", "gpu") in placements(port)
    else:
        assert all(p == "cpu" for _, p in placements(port))


@pytest.mark.parametrize("rows", [600, 0], ids=["rows", "empty"])
@pytest.mark.parametrize("enabled", [True, False], ids=["device", "cpu"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_global_matches_reference(name, enabled, rows):
    """An ungrouped aggregate; over empty input one row: null, or [] for
    a collect."""
    t = make_table().slice(0, rows)
    want, got, _ = run_both(t, _global(name), enabled, 2)
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    if rows == 0 and name.startswith("collect"):
        assert got.column("r").to_pylist() == [[]]


@pytest.mark.parametrize("column", ["s", "d", "m", "w", "b", "f"])
@pytest.mark.parametrize("partitions", [1, 4])
def test_first_last_every_type(column, partitions):
    """first and last, with and without ignorenulls, over every type the
    rule admits: a string, a DATE, DECIMAL64, DECIMAL128, BOOLEAN,
    DOUBLE."""
    def q(df, F, col):
        return df.group_by(col("k")).agg(
            F.first(col(column)).alias("f"), F.last(col(column)).alias("l"),
            F.first(col(column), True).alias("fi"),
            F.last(col(column), True).alias("li"))
    want, got, port = run_both(make_table(11), q, True, partitions)
    assert got.schema == want.schema
    assert_tables_equal(want, got)
    assert "!" not in port.last_explain


@pytest.mark.parametrize("column", ["s", "d", "b"])
def test_collect_every_type(column):
    def q(df, F, col):
        return df.group_by(col("k")).agg(
            F.collect_list(col(column)).alias("cl"),
            F.collect_set(col(column)).alias("cs"))
    want, got, port = run_both(make_table(12), q, True, 1)
    assert got.schema == want.schema
    assert_tables_equal(want, got)
    assert "!" not in port.last_explain


def test_all_null_and_single_row_groups():
    t = pa.table({"k": pa.array([1, 1, 2, 3, 3, 3], pa.int32()),
                  "x": pa.array([None, None, 5, None, 4, None], pa.int64()),
                  "f": pa.array([None, None, 1.5, 2.0, None, 2.0])})

    def q(df, F, col):
        return df.group_by(col("k")).agg(
            F.first(col("x"), True).alias("fi"), F.last(col("x")).alias("l"),
            F.collect_list(col("x")).alias("cl"),
            F.collect_set(col("x")).alias("cs"),
            F.stddev(col("f")).alias("sd"), F.var_pop(col("f")).alias("vp"),
            F.approx_percentile(col("x"), 0.25).alias("p"))
    for enabled in (True, False):
        want, got, _ = run_both(t, q, enabled, 1)
        assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
        rows = {r["k"]: r for r in got.to_pylist()}
        assert rows[1]["cl"] == [] and rows[1]["fi"] is None
        assert rows[1]["sd"] is None and rows[2]["sd"] is None
        assert rows[2]["vp"] == 0.0 and rows[3]["p"] == 4


def test_moments_are_sum_of_squares_formula():
    """The buffers are (count, sum, sum of squares) and M2 is clamped at
    0: a group of equal large values whose M2 cancels gives 0, not a
    negative variance (Welford's method is not what the reference
    does)."""
    t = pa.table({"k": pa.array([1] * 3 + [2] * 4, pa.int32()),
                  "f": pa.array([1e8 + 0.1] * 3 + [1.0, 2.0, 3.0, 4.0])})

    def q(df, F, col):
        return df.group_by(col("k")).agg(F.var_pop(col("f")).alias("v"),
                                         F.stddev(col("f")).alias("s"))
    want, got, _ = run_both(t, q)
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    rows = {r["k"]: r for r in got.to_pylist()}
    ss = 3 * (1e8 + 0.1) ** 2
    s = 3 * (1e8 + 0.1)
    assert rows[1]["v"] == max(ss - s * s / 3, 0.0) / 3
    assert math.isclose(rows[2]["s"], np.std([1, 2, 3, 4], ddof=1))


# ---------------------------------------------------------------------------
# pivot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values", [["A", "N", "R"], None],
                         ids=["values", "collected"])
@pytest.mark.parametrize("enabled", [True, False], ids=["device", "cpu"])
def test_pivot_matches_reference(values, enabled):
    def q(df, F, col):
        return df.group_by(col("k")).pivot(col("p"), values).agg(
            F.first(col("x")).alias("fx"), F.sum(col("f")).alias("sf"))
    want, got, port = run_both(make_table(13), q, enabled, 2)
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    expect = (values or ["A", "N", "R", None])
    assert got.schema.names == ["k"] + [f"{v}_{a}" for v in expect
                                        for a in ("fx", "sf")]
    if enabled:
        assert "!" not in port.last_explain


def test_pivot_one_aggregate_names_columns_by_value():
    def q(df, F, col):
        return df.group_by(col("k")).pivot(col("p"), ["A", "R"]).agg(
            F.first(col("x"), True))
    want, got, _ = run_both(make_table(14), q)
    assert got.schema.names == ["k", "A", "R"]
    assert_tables_equal(want, got)


def test_pivot_first_function():
    def q(df, F, col):
        return df.group_by(col("k")).agg(
            F.pivot_first(col("p"), col("x"), "N").alias("pf"))
    want, got, _ = run_both(make_table(15), q, True, 4)
    assert_tables_equal(want, got)


# ---------------------------------------------------------------------------
# exec level: the canonical keyed merge of many batches
# ---------------------------------------------------------------------------

PROBE = pa.table({"k": [1, 1, 1, 1, 2, 2, 2, 2],
                  "x": [9, None, 3, 7, None, 5, 1, None]})


def _probe_aggs(A, C):
    x = C.AttributeReference("x")
    return [A.AggregateExpression(A.First(x), "f"),
            A.AggregateExpression(A.Last(x), "l"),
            A.AggregateExpression(A.First(x, True), "fi"),
            A.AggregateExpression(A.Last(x, True), "li"),
            A.AggregateExpression(A.CollectList(x), "cl"),
            A.AggregateExpression(A.CollectSet(x), "cs"),
            A.AggregateExpression(A.StddevSamp(x), "sd"),
            A.AggregateExpression(A.ApproximatePercentile(x, 0.5), "p")]


def _ref_exec(table, batch_rows, modes, aggs):
    scan = RLocalScanExec(table, batch_rows=batch_rows)
    scan.placement = TPU
    keys = [rcore.AttributeReference("k")]
    node = ragg.TpuHashAggregateExec(keys, aggs(raggs, rcore), modes[0],
                                     scan)
    if len(modes) > 1:
        node = ragg.TpuHashAggregateExec(keys, node.aggregates, modes[1],
                                         node)
    return node


def _port_exec(table, batch_rows, modes, aggs):
    scan = PLocalScanExec(table, batch_rows=batch_rows)
    keys = [pcore.AttributeReference("k")]
    node = pagg.GpuHashAggregateExec(keys, aggs(paggs, pcore), modes[0],
                                     scan)
    if len(modes) > 1:
        node = pagg.GpuHashAggregateExec(keys, node.aggregates, modes[1],
                                         node)
    return node


@pytest.mark.parametrize("modes", [("Complete",), ("Partial", "Final")])
def test_probe_four_batches_pinned(modes):
    """Four two-row batches: the merge orders the partials by key and
    buffer words before it folds them, so first and last follow the
    values, not arrival (first 3, last null, last ignoring nulls 9 and
    collect_list [3, 7, 9] for k = 1); the port gives the reference's
    rows."""
    want = _ref_exec(PROBE, 2, modes, _probe_aggs).execute_collect(
        RExecContext())
    got = _port_exec(PROBE, 2, modes, _probe_aggs).execute_collect(
        PExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    rows = {r["k"]: r for r in got.to_pylist()}
    assert (rows[1]["f"], rows[1]["l"], rows[1]["fi"], rows[1]["li"]) == \
        (3, None, 3, 9)
    assert rows[1]["cl"] == [3, 7, 9] and rows[1]["cs"] == [3, 7, 9]
    assert (rows[2]["f"], rows[2]["fi"], rows[2]["li"]) == (None, 5, 1)
    assert rows[1]["p"] == 7 and rows[2]["p"] == 1


def test_probe_one_batch_pinned():
    """One batch keeps arrival order: first 9, last 7, [9, 3, 7]."""
    got = _port_exec(PROBE, 8, ("Complete",), _probe_aggs).execute_collect(
        PExecContext("cpu"))
    rows = {r["k"]: r for r in got.to_pylist()}
    assert (rows[1]["f"], rows[1]["l"], rows[1]["cl"]) == (9, 7, [9, 3, 7])
    assert rows[2]["cs"] == [1, 5]


def _wide_aggs(A, C):
    x, s = C.AttributeReference("x"), C.AttributeReference("s")
    return [A.AggregateExpression(A.First(x), "f"),
            A.AggregateExpression(A.Last(s, True), "ls"),
            A.AggregateExpression(A.First(s), "fs"),
            A.AggregateExpression(A.CollectSet(s), "cs"),
            A.AggregateExpression(A.CollectSet(x), "cx"),
            A.AggregateExpression(A.VariancePop(x), "v"),
            A.AggregateExpression(A.ApproximatePercentile(x, 0.3), "p")]


@pytest.mark.parametrize("modes", [("Complete",), ("Partial",),
                                   ("Partial", "Final")])
def test_many_batches_match_reference(modes):
    """Eleven batches of random rows in every mode: the positional picks,
    the string first and last, the sets and the moments agree with the
    reference (a collect_list's order is order-dependent and left out)."""
    t = make_table(16, n=1100).select(["k", "x", "s"])
    want = _ref_exec(t, 100, modes, _wide_aggs).execute_collect(
        RExecContext())
    got = _port_exec(t, 100, modes, _wide_aggs).execute_collect(
        PExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)


# ---------------------------------------------------------------------------
# K3's positional kinds: plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["first", "last"])
@pytest.mark.parametrize("n,groups", [(1, 1), (50, 3), (4000, 40),
                                      (3000, 2999)])
def test_segment_pick_matches_reference_segment_reduce(op, n, groups):
    rng = np.random.default_rng(n + groups)
    seg = np.sort(rng.integers(0, groups, n)).astype(np.int32)
    valid = rng.random(n) < 0.4
    pos = np.arange(n, dtype=np.int32)
    want, wcnt = rseg.segment_reduce(np, op, pos, seg, groups, valid)
    got, cnt = pseg.segment_pick(op, torch.from_numpy(seg), groups,
                                 torch.from_numpy(valid))
    assert np.array_equal(cnt.numpy(), wcnt)
    some = wcnt > 0
    assert np.array_equal(got.numpy()[some], want[some])
    assert not got.numpy()[~some].any()


@pytest.mark.parametrize("global_agg", [False, True])
@pytest.mark.parametrize("ordered", [False, True])
def test_k3_plain_positional_kinds(global_agg, ordered):
    """segment_reduce_sorted's first and last (plain) give each group's
    input row at its least / greatest sorted contributing position,
    beside other ops, read through an order or not."""
    rng = np.random.default_rng(5)
    n = 3000
    k = torch.from_numpy(rng.integers(0, 30, n))
    v = torch.from_numpy(rng.integers(-9, 9, n))
    m = torch.from_numpy(rng.random(n) < 0.3)
    ones = torch.ones(n, dtype=torch.bool)
    words = [] if global_agg else [k]
    order = None
    if ordered and not global_agg:
        order = torch.from_numpy(np.argsort(k.numpy(), kind="stable")
                                 .astype(np.int32))
    if not ordered and not global_agg:
        idx = torch.from_numpy(np.argsort(k.numpy(), kind="stable"))
        k, v, m = k[idx], v[idx], m[idx]
        words = [k]
    got = pagg.segment_reduce_sorted(
        words, None, [v, None, None, None], [m, m, m, ones], global_agg,
        order, ["sum", "first", "last", "last"])
    _, sums, counts, g = got
    ids = (np.zeros(n, np.int64) if global_agg else
           np.unique(k.numpy(), return_inverse=True)[1])
    rows = np.arange(n) if order is None else order.numpy()
    for gi in range(g):
        sel = np.nonzero((ids[rows] == gi) & m.numpy()[rows])[0]
        assert int(counts[1][gi]) == len(sel)
        if len(sel):
            assert int(sums[1][gi]) == rows[sel[0]]
            assert int(sums[2][gi]) == rows[sel[-1]]
        allrows = np.nonzero(ids[rows] == gi)[0]
        assert int(sums[3][gi]) == rows[allrows[-1]]
    assert pagg.segment_reduce_sorted.launches == 0


def test_k3_positional_reads_no_value():
    with pytest.raises(ValueError):
        pagg.segment_reduce_sorted([], None, [torch.zeros(3, dtype=
                                                         torch.int64)],
                                   [torch.ones(3, dtype=torch.bool)], True,
                                   None, ["first"])


def test_k3_ops_positional_and_collect():
    """A first and a last of one column share its validity mask; the
    _any ops take every row, which K3 reads from the groups' bounds (no
    mask), or without a key one shared mask of every row; a collect_list
    counts the valid rows, sharing a count of the same lane."""
    x = DeviceColumn(pt.LONG, torch.arange(6), torch.tensor(
        [True, False, True, True, False, True]))
    ops = ["first", "last", "first_any", "last_any", "countvalid",
           "collect_list"]
    vals, contribs, names, take, his = pagg.k3_ops([x] * 6, ops)
    assert names == ["first", "last", "first", "last", "sum"]
    assert vals == [None] * 5 and his == [None] * 5
    assert contribs[0] is contribs[1] is x.validity
    assert contribs[2] is None and contribs[3] is None
    assert contribs[4] is x.validity
    assert take == [0, 1, 2, 3, 4, 4]
    _, keyless, _, _, _ = pagg.k3_ops([x] * 6, ops, keyed=False)
    assert keyless[2] is keyless[3] and bool(keyless[2].all())


# ---------------------------------------------------------------------------
# registration and determinism
# ---------------------------------------------------------------------------

def test_rules_cover_all_but_items_4d_4e_7():
    ref = {c.__name__: c for c in roverrides.EXPR_RULES}
    port = {c.__name__ for c in poverrides.EXPR_RULES}
    assert len(ref) == 199 and len(port) == 172
    missing = {n: ref[n].__module__.rsplit(".", 1)[-1] for n in ref
               if n not in port}
    assert len(missing) == 27
    assert set(missing.values()) <= {"collection", "higher_order", "regex",
                                     "json_expr", "native", "python_udf"}
    for name in ("First", "Last", "CollectList", "CollectSet", "StddevPop",
                 "StddevSamp", "VariancePop", "VarianceSamp", "PivotFirst",
                 "ApproximatePercentile"):
        assert name in port


@pytest.mark.parametrize("fn,cls", [
    ("collect_list", pdet.ORDER_DEPENDENT),
    ("collect_set", pdet.ORDER_DEPENDENT),
    ("first", pdet.ORDER_STABLE)])
def test_determinism_matches_reference(fn, cls):
    def build(A, C, E, mode):
        x = C.AttributeReference("x")
        f = {"collect_list": A.CollectList, "collect_set": A.CollectSet,
             "first": A.First}[fn](x)
        return [A.AggregateExpression(f, "r")]
    t = PROBE
    ref = _ref_exec(t, 8, ("Complete",), lambda A, C: build(A, C, None, 0))
    port = _port_exec(t, 8, ("Complete",), lambda A, C: build(A, C, None, 0))
    assert port.determinism().cls == ref.determinism().cls == cls
