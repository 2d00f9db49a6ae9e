"""Grouped and global MIN/MAX of the port against the reference, on the
CPU.

Two places, as the two packages' engines differ on NaN:
  * the device path: the port's GPU-placed aggregate (on CPU tensors,
    K3's plain fold) against the reference's TpuHashAggregateExec (its
    jax branch, ``segment_reduce`` over ``_ordered_words32`` and
    ``_argext_rows``): NaN is the greatest value, and a tie (-0.0 beside
    0.0, two NaN payloads) goes to the first row; held bit for bit;
  * the CPU engine (``spark.rapids.sql.enabled`` false): pyarrow's min
    and max in both packages, which skip NaN.
The sessions mirror tests/test_hash_aggregate.py::test_group_by_min_max
and the global min/max (integers exactly, doubles exactly: a min or max
picks a value, it computes none); below them, K3's plain fold and
``ops/segmented.py:segment_reduce`` against the reference's jax-branch
``segment_reduce`` on random, tied and special values, and the exec-level
merge of many batches in every mode.
"""

import math
import struct

import jax.numpy as jnp
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
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (BooleanGen, DoubleGen,
                                               IntegerGen, LongGen,
                                               gen_table)
from spark_rapids_tpu_torch.analysis import determinism as pdet
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec.base import ExecContext as PExecContext
from spark_rapids_tpu_torch.exec.basic import LocalScanExec as PLocalScanExec
from spark_rapids_tpu_torch.expr import aggregates as paggs
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import segmented as pseg

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
NAN2 = struct.unpack("<d", struct.pack("<q", 0x7FF8000000000001))[0]


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


def bits(values):
    """Each value's identity: a double by its 64 bits (so -0.0 and 0.0,
    and two NaN payloads, differ), anything else as it is."""
    return [struct.unpack("<q", struct.pack("<d", v))[0]
            if isinstance(v, float) else v for v in values]


def placements(port):
    out = []
    port.last_plan.foreach(lambda e: out.append((type(e).__name__,
                                                 e.placement)))
    return out


# ---------------------------------------------------------------------------
# sessions: tests/test_hash_aggregate.py's min/max, both engines
# ---------------------------------------------------------------------------

def _min_max_query(df, F, col):
    return df.group_by(col("k")).agg(
        F.min(col("v")).alias("mn"), F.max(col("v")).alias("mx"),
        F.min(col("f")).alias("fmn"), F.max(col("f")).alias("fmx"),
        F.min(col("b")).alias("bmn"), F.max(col("i")).alias("imx"))


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("enabled", [True, False], ids=["device", "cpu"])
def test_group_by_min_max(enabled, partitions):
    t = gen_table([("k", IntegerGen(lo=0, hi=20)), ("v", LongGen()),
                   ("f", DoubleGen(no_nans=True)), ("b", BooleanGen()),
                   ("i", IntegerGen())], length=1024)
    want, got, port = run_both(t, _min_max_query, enabled, partitions)
    assert got.schema == want.schema
    assert_tables_equal(want, got)
    if enabled:
        assert all(p == "gpu" for _, p in placements(port)[1:])
        assert "!" not in port.last_explain
    else:
        assert all(p == "cpu" for _, p in placements(port))


@pytest.mark.parametrize("enabled", [True, False], ids=["device", "cpu"])
@pytest.mark.parametrize("rows", [777, 0], ids=["rows", "empty"])
def test_global_min_max(enabled, rows):
    """A global min/max; over empty input, one row of nulls."""
    t = gen_table([("v", LongGen()), ("f", DoubleGen(no_nans=True)),
                   ("b", BooleanGen())], length=max(rows, 1))
    t = t.slice(0, rows)

    def q(df, F, col):
        return df.agg(F.min(col("v")).alias("mn"),
                      F.max(col("f")).alias("fmx"),
                      F.max(col("b")).alias("bmx"),
                      F.count("*").alias("c"))
    want, got, _ = run_both(t, q, enabled)
    assert got.schema == want.schema
    assert_tables_equal(want, got)
    assert got.num_rows == 1
    if rows == 0:
        assert got.to_pylist() == [{"mn": None, "fmx": None, "bmx": None,
                                    "c": 0}]


def _special_table():
    """Groups whose min and max meet NaN, +-inf and -0.0 beside 0.0, an
    all-null group, INT64_MIN and INT64_MAX."""
    rows = [  # (k, f, v)
        (0, 1.0, 5), (0, float("nan"), -2**63),
        (1, -0.0, 2**63 - 1), (1, 0.0, 3),
        (2, 0.0, 1), (2, -0.0, 1),
        (3, float("inf"), None), (3, float("-inf"), None),
        (4, None, None), (4, None, None),
        (5, NAN2, 0), (5, float("nan"), 0),
    ]
    k, f, v = zip(*rows)
    return pa.table({"k": pa.array(k, type=pa.int64()),
                     "f": pa.array(f, type=pa.float64()),
                     "v": pa.array(v, type=pa.int64())})


def _special_query(df, F, col):
    return df.group_by(col("k")).agg(
        F.min(col("f")).alias("fmn"), F.max(col("f")).alias("fmx"),
        F.min(col("v")).alias("mn"), F.max(col("v")).alias("mx")).sort(
        col("k"))


def test_special_values_on_the_device_path():
    """The port's device path equals the reference's jax branch bit for
    bit: NaN is the greatest value, -0.0 and 0.0 tie and the first row
    wins, the first NaN payload wins a NaN tie."""
    want, got, port = run_both(_special_table(), _special_query)
    assert "!" not in port.last_explain
    for c in got.column_names:
        assert bits(got[c].to_pylist()) == bits(want[c].to_pylist()), c
    fmn, fmx = got["fmn"].to_pylist(), got["fmx"].to_pylist()
    assert fmn[0] == 1.0 and math.isnan(fmx[0])
    assert bits(fmn[1:3] + fmx[1:3]) == bits([-0.0, 0.0, -0.0, 0.0])
    assert (fmn[3], fmx[3]) == (float("-inf"), float("inf"))
    assert fmn[4] is None and fmx[4] is None
    assert bits([fmn[5], fmx[5]]) == bits([NAN2, NAN2])
    assert got["mn"].to_pylist()[:2] == [-2**63, 3]
    assert got["mx"].to_pylist()[:2] == [5, 2**63 - 1]


def test_special_values_on_the_cpu_engine():
    """Both CPU engines run pyarrow's min and max, which skip NaN: the
    (1.0, NaN) group's max is 1.0 there (NaN on the device path)."""
    want, got, port = run_both(_special_table(), _special_query,
                               enabled=False)
    assert all(p == "cpu" for _, p in placements(port))
    assert_tables_equal(want, got, ignore_order=False)
    for c in ("mn", "mx"):
        assert got[c].to_pylist() == want[c].to_pylist()
    assert got["fmx"].to_pylist()[0] == 1.0


# ---------------------------------------------------------------------------
# K3's plain fold and segment_reduce against the reference's jax branch
# ---------------------------------------------------------------------------

def _values(rng, n, kind):
    if kind == "float64":
        pool = np.array([np.nan, NAN2, np.inf, -np.inf, -0.0, 0.0, 1.0,
                         -1.0, 5e-324])
        return np.where(rng.random(n) < 0.5, pool[rng.integers(0, 9, n)],
                        rng.integers(-3, 3, n).astype(np.float64))
    if kind == "int64":
        pool = np.array([-2**63, 2**63 - 1, -1, 0, 1], dtype=np.int64)
        return pool[rng.integers(0, 5, n)]
    return rng.random(n) < 0.5


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["float64", "int64", "bool"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_matches_reference_jax_branch(op, kind, seed):
    """``ops/segmented.py:segment_reduce`` against the reference's
    ``segment_reduce(jnp, op, ...)`` (``_argext_rows``) over sorted
    segment ids with invalid rows and an empty segment, by bits."""
    rng = np.random.default_rng(seed)
    n, segs = 2000, 40
    seg_ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    seg_ids[seg_ids == 7] = 8                         # segment 7 is empty
    values = _values(rng, n, kind)
    valid = rng.random(n) < 0.8
    want, want_cnt = rseg.segment_reduce(
        jnp, op, jnp.asarray(values), jnp.asarray(seg_ids), segs,
        jnp.asarray(valid), sorted_ids=True)
    got, cnt = pseg.segment_reduce(
        op, torch.from_numpy(np.asarray(values)),
        torch.from_numpy(seg_ids), segs, torch.from_numpy(valid))
    assert cnt.tolist() == np.asarray(want_cnt).tolist()
    have = cnt.numpy() > 0
    w, g = np.asarray(want)[have], got.numpy()[have]
    if kind == "float64":
        w, g = w.view(np.int64), g.view(np.int64)
    assert np.array_equal(w, g)
    assert not have[7]


@pytest.mark.parametrize("global_agg", [False, True])
@pytest.mark.parametrize("kind", ["float64", "int64"])
def test_k3_plain_min_max_matches_reference_group_reduce(kind, global_agg):
    """The port's ``_group_reduce`` with min and max ops (K2's order and
    K3's plain fold) against the reference's ``_group_reduce`` (its jax
    branch), on shuffled keys with nulls, bit for bit."""
    from test_torch_aggregate import _columns
    rng = np.random.default_rng(21)
    n = 3000
    values = _values(rng, n, kind)
    table = pa.table({
        "k": pa.array(rng.integers(0, 30, n), mask=rng.random(n) < 0.05),
        "x": pa.array(values, mask=rng.random(n) < 0.1)})
    ref, mine = _columns(table, n)
    r_keys = [] if global_agg else [ref.columns[0]]
    p_keys = [] if global_agg else [mine.columns[0]]
    ops = ["min", "max", "countvalid"]
    live = jnp.arange(ref.capacity) < ref.num_rows
    rk, rv, rn = ragg._group_reduce(jnp, r_keys, [ref.columns[1]] * 3, ops,
                                    ref.capacity, live, global_agg)
    pk, pv, pn = pagg._group_reduce(p_keys, [mine.columns[1]] * 3, ops, n,
                                    global_agg)
    groups = int(rn)
    assert pn == groups == (1 if global_agg else 31)
    for rc, pc_ in zip(rk + rv, pk + pv):
        valid = np.asarray(rc.validity)[:groups]
        assert valid.tolist() == pc_.validity[:groups].tolist()
        rd, pd = np.asarray(rc.data)[:groups], pc_.data[:groups].numpy()
        if rd.dtype == np.float64:
            rd, pd = rd.view(np.int64), pd.view(np.int64)
        assert np.array_equal(rd[valid], pd[valid])
    assert pagg.segment_reduce_sorted.launches == 0       # plain version


def test_k3_plain_ties_go_to_the_first_sorted_row():
    """Equal words keep the earliest row in K2's stable order: -0.0
    before 0.0 keeps -0.0 for min and max; read through an order, the
    earliest input row of the group wins."""
    words = [torch.tensor([3, 1, 3, 1, 3], dtype=torch.int64)]
    vals = torch.tensor([0.0, -0.0, -0.0, 0.0, 0.0], dtype=torch.float64)
    order = pcarry.sort_order(words)
    ones = torch.ones(5, dtype=torch.bool)
    first, out, counts, groups = pagg.segment_reduce_sorted(
        words, None, [vals, vals], [ones, ones], False, order,
        ["min", "max"])
    assert groups == 2 and first.tolist() == [1, 0]
    assert bits(out[0].tolist()) == bits([-0.0, 0.0])
    assert bits(out[1].tolist()) == bits([-0.0, 0.0])
    assert counts[0].tolist() == [2, 3]


def test_k3_ops_take_more_than_one_set():
    """27 ops (more than K3's 16 a launch set): every min and max equals
    its own single-op result."""
    rng = np.random.default_rng(5)
    n = 500
    words = [torch.from_numpy(rng.integers(0, 9, n))]
    order = pcarry.sort_order(words)
    lanes = [torch.from_numpy(_values(rng, n, k))
             for k in ("float64", "int64")] * 9
    lanes = [x.to(torch.int64) if x.dtype == torch.bool else x
             for x in lanes]
    ops = ["min", "max", "sum"] * 6
    contribs = [torch.from_numpy(rng.random(n) < 0.7) for _ in lanes]
    many = pagg.segment_reduce_sorted(words, None, lanes, contribs, False,
                                      order, ops)
    for k, (v, c, op) in enumerate(zip(lanes, contribs, ops)):
        one = pagg.segment_reduce_sorted(words, None, [v], [c], False,
                                         order, [op])
        assert torch.equal(many[2][k], one[2][0])
        a, b = many[1][k], one[1][0]
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        assert torch.equal(a, b)


def test_segment_reduce_sorted_rejects_unknown_ops():
    words = [torch.zeros(3, dtype=torch.int64)]
    v = torch.zeros(3, dtype=torch.int64)
    c = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="op"):
        pagg.segment_reduce_sorted(words, None, [v], [c], False, None,
                                   ["median"])
    with pytest.raises(ValueError, match="one op per value lane"):
        pagg.segment_reduce_sorted(words, None, [v], [c], False, None,
                                   ["min", "max"])


# ---------------------------------------------------------------------------
# exec level: the merge of many batches, every mode
# ---------------------------------------------------------------------------

def _aggs(lib_aggs, lib_core):
    A = lib_core.AttributeReference
    return [lib_aggs.AggregateExpression(lib_aggs.Min(A("v")), "mn"),
            lib_aggs.AggregateExpression(lib_aggs.Max(A("f")), "fmx"),
            lib_aggs.AggregateExpression(lib_aggs.Min(A("f")), "fmn"),
            lib_aggs.AggregateExpression(lib_aggs.Max(A("b")), "bmx")]


def _plan(lib, table, batch_rows, modes):
    Scan, Agg, aggs, core = lib
    scan = Scan(table, batch_rows=batch_rows)
    if Scan is RLocalScanExec:
        scan.placement = TPU
    keys = [core.AttributeReference("k")]
    node = Agg(keys, _aggs(aggs, core), modes[0], scan)
    if len(modes) > 1:
        node = Agg(keys, node.aggregates, modes[1], node)
    return node


@pytest.mark.parametrize("modes", [("Complete",), ("Partial",),
                                   ("Partial", "Final")])
def test_many_batches_match_reference(modes):
    """Partial buffers of 7 batches merge by min and max through the
    canonical keyed order; integers and doubles exactly."""
    rng = np.random.default_rng(31)
    n = 2100
    table = pa.table({
        "k": pa.array(rng.integers(0, 25, n), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-10**9, 10**9, n),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(np.where(rng.random(n) < 0.02, np.inf,
                               rng.random(n)), mask=rng.random(n) < 0.1),
        "b": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.1)})
    ref = (RLocalScanExec, ragg.TpuHashAggregateExec, raggs, rcore)
    port = (PLocalScanExec, pagg.GpuHashAggregateExec, paggs, pcore)
    want = _plan(ref, table, 300, modes).execute_collect(RExecContext())
    got = _plan(port, table, 300, modes).execute_collect(
        PExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got)


def test_min_max_determinism_matches_reference():
    """A double min buffer is a float partial: the same class and flags
    as the reference's, with the canonical merge on and off."""
    from test_torch_determinism import FLAGS
    ref = (RLocalScanExec, ragg.TpuHashAggregateExec, raggs, rcore)
    port = (PLocalScanExec, pagg.GpuHashAggregateExec, paggs, pcore)
    table = _special_table().append_column(
        "b", pa.array([True, False] * 6))
    classes = set()
    for stable in (True, False):
        for modes in (("Complete",), ("Partial",)):
            r, p = _plan(ref, table, 4, modes), _plan(port, table, 4, modes)
            r.stable_merge = p.stable_merge = stable
            want, got = r.determinism(), p.determinism()
            assert [getattr(got, f) for f in FLAGS] == \
                [getattr(want, f) for f in FLAGS]
            classes.add(got.cls)
    assert classes == {pdet.ORDER_STABLE, pdet.ORDER_DEPENDENT}
