"""Single-device exchange fusion (spark.rapids.tpu.singleChipFuse).

Mirrors the join and aggregate cases of tests/test_single_chip_fuse.py:
with the fusion on, a multi-partition aggregate and a multi-partition
join keep no exchange, and their results equal the CPU engine's
(spark.rapids.sql.enabled=false, fusion off) and the reference's.  Bench
q6's shape (a 4-partition fact table joined USING k with a 2-partition
dimension, then sum(w) by k) plans the broadcast hash join over the
gathered, coalesced probe side under one COMPLETE aggregate.  With the
fusion off the exchanges and their consumers stay on the host: the
reference's device exchange is not ported.  Integer weights keep sums
exact.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.column import col
from spark_rapids_tpu_torch.api.session import GpuSession


def _tables(n=20_000, nkeys=500):
    rng = np.random.default_rng(11)
    fact = pa.table({
        "k": pa.array(rng.integers(0, nkeys, n).astype(np.int64)),
        "v": pa.array(rng.integers(-1000, 1000, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
    })
    dim = pa.table({
        "k": pa.array(np.arange(nkeys, dtype=np.int64)),
        "w": pa.array(rng.integers(0, 10**6, nkeys).astype(np.int64)),
    })
    return fact, dim


def _session(fuse: str, enabled=True) -> GpuSession:
    return GpuSession(device="cpu", conf={
        "spark.rapids.sql.enabled": enabled,
        "spark.rapids.tpu.singleChipFuse": fuse})


def _ref_session(fuse: str) -> TpuSession:
    return (TpuSession.builder()
            .config("spark.rapids.tpu.singleChipFuse", fuse)
            .get_or_create())


def _names(session, df):
    plan = session.prepare_plan(df._lp)
    names = []
    plan.foreach(lambda e: names.append(type(e).__name__))
    return names


def _join(s, F, col, fact, dim, parts=(4, 2)):
    return (s.create_dataframe(fact, num_partitions=parts[0])
            .join(s.create_dataframe(dim, num_partitions=parts[1]),
                  on="k", how="inner")
            .group_by(col("k")).agg(F.sum(col("w")).alias("sw")))


def _aggregate(s, F, col, fact, dim, parts=(4, 1)):
    return (s.create_dataframe(fact, num_partitions=parts[0])
            .filter(col("v") > 0).group_by(col("k"))
            .agg(F.sum(col("v")).alias("sv"), F.count("*").alias("c")))


@pytest.fixture(scope="module")
def data():
    return _tables()


@pytest.mark.parametrize("query", [_join, _aggregate])
def test_fused_plan_and_result(data, query):
    fact, dim = data
    s = _session("on")
    q = query(s, F, col, fact, dim)
    names = _names(s, q)
    assert "ShuffleExchangeExec" not in names, names
    got = q.collect().sort_by("k")
    c = _session("off", enabled=False)
    want = query(c, F, col, fact, dim).collect().sort_by("k")
    assert got.equals(want)
    ref = query(_ref_session("on"), RF, rcol, fact, dim).collect()
    assert_tables_equal(ref, got)


Q6_PLAN = ["DeviceToHostExec", "CoalesceBatchesExec", "GpuHashAggregateExec",
           "CoalesceBatchesExec", "ProjectExec", "BroadcastHashJoinExec",
           "CoalesceBatchesExec", "GatherPartitionsExec", "LocalScanExec",
           "BroadcastExchangeExec", "LocalScanExec"]


def test_q6_shape_plans_one_device_stage(data):
    """q6 at 4 and 2 partitions: every operator but the final download
    on the GPU, no CPU fallback in the explain, the COMPLETE aggregate,
    and the reference's plan."""
    fact, dim = data
    s = _session("auto")
    q = _join(s, F, col, fact, dim)
    got = q.collect()
    nodes = []
    s.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement, getattr(e, "mode", None))))
    assert [n for n, _, _ in nodes] == Q6_PLAN
    assert [p for _, p, _ in nodes] == ["cpu"] + ["gpu"] * (len(nodes) - 1)
    assert nodes[2][2] == "Complete"
    assert "!" not in s.last_explain
    ref = _ref_session("on")
    want = _join(ref, RF, rcol, fact, dim).collect()
    assert_tables_equal(want, got)
    ref_names = []
    ref.last_plan.foreach(lambda e: ref_names.append(
        type(e).__name__.replace("Tpu", "Gpu")))
    assert ref_names == Q6_PLAN


def test_q6_probe_side_batches_follow_the_coalesce_target(data,
                                                        monkeypatch):
    """The gathered probe side reaches the join in as few batches as the
    coalesce's row target allows: under the reference's 4,194,304 rows
    the 4 partitions arrive as one batch; with a target of two
    partitions' rows, as 2 batches; a partition that reaches the target
    alone passes through as it came."""
    fact, dim = data
    s = GpuSession(device="cpu")
    _join(s, F, col, fact, dim).collect()
    from spark_rapids_tpu_torch.exec import basic
    from spark_rapids_tpu_torch.exec.base import ExecContext
    assert basic.TARGET_ROWS == 1 << 22
    join = []
    s.last_plan.foreach(lambda e: join.append(e) if type(e).__name__ ==
                        "BroadcastHashJoinExec" else None)
    probe = join[0].children[0]
    assert type(probe).__name__ == "CoalesceBatchesExec"
    ctx = ExecContext("cpu", s.conf)
    per_part = fact.num_rows // 4
    for target, want in ((1 << 22, [fact.num_rows]),
                         (2 * per_part, [2 * per_part] * 2),
                         (per_part, [per_part] * 4)):
        monkeypatch.setattr(basic, "TARGET_ROWS", target)
        assert [b.num_rows for b in probe.execute_partition(0, ctx)] == want


@pytest.mark.parametrize("query", [_join, _aggregate])
def test_unfused_plan_matches_reference(data, query):
    """Fusion off: the result is the reference's, but the exchanges stay
    on the host and so do their consumers, each with its reason (the
    reference's device exchange between a PARTIAL and a FINAL aggregate,
    and its co-partitioned shuffled hash join, are not ported)."""
    fact, dim = data
    conf = {"spark.rapids.tpu.singleChipFuse": "off",
            "spark.rapids.sql.autoBroadcastJoinThreshold": -1}
    s = GpuSession(device="cpu", conf=conf)
    b = TpuSession.builder()
    for k, v in conf.items():
        b = b.config(k, v)
    ref = b.get_or_create()
    got = query(s, F, col, fact, dim, parts=(3, 2)).collect()
    want = query(ref, RF, rcol, fact, dim, parts=(3, 2)).collect()
    assert_tables_equal(want, got)
    nodes = []
    s.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    exchanges = [p for n, p in nodes if n == "ShuffleExchangeExec"]
    assert exchanges and set(exchanges) == {"cpu"}
    consumers = {"CpuHashAggregateExec"} | (
        {"CpuJoinExec"} if query is _join else set())
    assert consumers <= {n for n, p in nodes if p == "cpu"}
    lines = [ln.strip() for ln in s.last_explain.splitlines()]
    for name in consumers:
        assert (f"!Exec <{name}> cannot run on GPU because "
                f"spark.rapids.tpu.singleChipFuse=off keeps the shuffle "
                f"exchange below, which runs on the host only") in lines
    assert (f"!Exec <ShuffleExchangeExec> cannot run on GPU because the "
            f"shuffle exchange runs on the host only (its consumer "
            f"CpuHashAggregateExec stays on the CPU)") in lines
