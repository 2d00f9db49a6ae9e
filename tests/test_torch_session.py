"""Bench q1 through both sessions: the JAX reference's TpuSession and the
PyTorch port's GpuSession on ``device="cpu"``.

    create_dataframe(t).filter(col("v") > c).group_by(col("k"))
        .agg(sum(v), avg(f), count(*)).collect()

Results are compared with the reference's assert_tables_equal; float
results to a relative 1e-9 (the two add a group's values in different
orders).  Sessions plan one batch per partition, so the many-batch run
goes through LocalScanExec(batch_rows=...) on both sides.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
from spark_rapids_tpu_torch.expr.aggregates import (COMPLETE,
                                                    AggregateExpression,
                                                    Average, Count, Sum)
from spark_rapids_tpu_torch.expr.core import AttributeReference as A

FLOAT_RTOL = 1e-9


def make_table(seed, n=1000, nulls=False, specials=False, narrow=False):
    """q1's columns; ``narrow`` makes k BOOLEAN and v, f INT, so the
    aggregates cast their input (sum: INT -> LONG, avg: INT -> DOUBLE)."""
    rng = np.random.default_rng(seed)
    if narrow:
        return pa.table({
            "k": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.1),
            "v": pa.array(rng.integers(-10**6, 10**6, n).astype(np.int32)),
            "f": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                          mask=rng.random(n) < 0.1),
        })

    def mask(frac):
        return (rng.random(n) < frac) if nulls else None

    f = rng.random(n)
    if specials:
        pick = rng.random(n)
        f = np.where(pick < 0.02, np.inf, f)
        f = np.where((pick >= 0.02) & (pick < 0.04), -np.inf, f)
        f = np.where((pick >= 0.04) & (pick < 0.05), np.nan, f)
    return pa.table({
        "k": pa.array(rng.integers(0, 60, n), mask=mask(0.05)),
        "v": pa.array(rng.integers(-10**6, 10**6, n), mask=mask(0.1)),
        "f": pa.array(f),
    })


def q1(session, F, col, table, threshold, grouped=True):
    df = session.create_dataframe(table).filter(col("v") > threshold)
    if grouped:
        df = df.group_by(col("k"))
    return df.agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                  F.count("*").alias("c")).collect()


@pytest.fixture(scope="module")
def sessions():
    return TpuSession.builder().get_or_create(), GpuSession(device="cpu")


CASES = {
    "plain": dict(seed=21, threshold=-500000),
    "nulls_in_k_and_v": dict(seed=22, threshold=-500000, nulls=True),
    "inf_and_nan_in_f": dict(seed=23, threshold=-500000, specials=True),
    "filter_keeps_nothing": dict(seed=24, threshold=10**7),
    "global_aggregate": dict(seed=25, threshold=-500000, nulls=True,
                             grouped=False),
    "global_aggregate_of_nothing": dict(seed=26, threshold=10**7,
                                        grouped=False),
    "bool_key_int_values": dict(seed=30, threshold=-500000, narrow=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_q1_matches_reference(sessions, case):
    spec = dict(CASES[case])
    threshold = spec.pop("threshold")
    grouped = spec.pop("grouped", True)
    table = make_table(**spec)
    ref_session, port_session = sessions
    want = q1(ref_session, RF, rcol, table, threshold, grouped)
    got = q1(port_session, PF, pcol, table, threshold, grouped)
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    if grouped and threshold < 0:
        nulls = spec.get("nulls") or spec.get("narrow")
        keys = 2 if spec.get("narrow") else 60
        assert got.num_rows == keys + bool(nulls)     # the null key too


def test_q1_plan_is_one_complete_aggregate(sessions):
    port_session = sessions[1]
    q1(port_session, PF, pcol, make_table(27), -500000)
    names = []
    port_session.last_plan.foreach(
        lambda e: names.append((type(e).__name__, getattr(e, "mode", None))))
    assert names == [("GpuHashAggregateExec", "Complete"),
                     ("FilterExec", None), ("LocalScanExec", None)]


def test_dataframe_keeps_its_upload_on_the_device(sessions):
    """A DataFrame queried again reuses its uploaded batches (the
    reference's pinned scan cache)."""
    port_session = sessions[1]
    df = (port_session.create_dataframe(make_table(31))
          .filter(pcol("v") > 0).group_by(pcol("k"))
          .agg(PF.count("*").alias("c")))
    first = df.collect()
    cache = df._lp.children[0].children[0].device_cache
    assert len(cache) == 1
    (batches,) = cache.values()
    assert df.collect().equals(first)
    (again,) = cache.values()
    assert again is batches


def test_q1_many_batches_matches_reference(sessions):
    """update per batch -> concat -> merge -> evaluate, against the
    reference session's one-batch result."""
    table = make_table(28, n=3000, nulls=True, specials=True)
    want = q1(sessions[0], RF, rcol, table, -500000)
    aggs = [AggregateExpression(Sum(A("v")), "sv"),
            AggregateExpression(Average(A("f")), "af"),
            AggregateExpression(Count(None), "c")]
    scan = LocalScanExec(table, batch_rows=400)
    plan = GpuHashAggregateExec([A("k")], aggs, COMPLETE,
                                FilterExec((pcol("v") > -500000).expr, scan))
    got = plan.execute_collect(ExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)


def test_outside_the_slice_raises(sessions):
    port_session = sessions[1]
    table = make_table(29)
    with pytest.raises(NotImplementedError, match="partition"):
        (port_session.create_dataframe(table, num_partitions=2)
         .group_by(pcol("k")).agg(PF.count("*")).collect())
    with pytest.raises(NotImplementedError, match="not ported"):
        (port_session.create_dataframe(table)
         .filter(pcol("v") > None).collect())


def test_wide_group_by_matches_reference():
    """A group-by of 9 columns of every key type (18 key words) with 17
    sums, more than one set of K3 launches takes on the card; here the
    plain versions, against the reference session."""
    rng = np.random.default_rng(31)
    n = 3000
    cols = {}
    for i in range(9):
        kind = i % 4
        vals = (rng.integers(0, 3, n) if kind == 0 else
                rng.integers(-1, 2, n).astype(np.int32) if kind == 1 else
                rng.random(n) < 0.5 if kind == 2 else
                rng.choice([0.5, -1.5, 2.0], n))
        cols[f"k{i}"] = pa.array(vals, mask=rng.random(n) < 0.05)
    for j in range(17):
        vals = rng.random(n) if j % 3 == 2 else rng.integers(-10**6, 10**6, n)
        cols[f"v{j}"] = pa.array(vals, mask=rng.random(n) < 0.1)
    table = pa.table(cols)
    outs = []
    for session, F, col in ((TpuSession.builder().get_or_create(), RF, rcol),
                            (GpuSession(device="cpu"), PF, pcol)):
        outs.append(session.create_dataframe(table)
                    .group_by(*[col(f"k{i}") for i in range(9)])
                    .agg(*[F.sum(col(f"v{j}")).alias(f"s{j}")
                           for j in range(17)]).collect())
    want, got = outs
    assert got.schema == want.schema
    assert got.num_rows > 1000
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
