"""The port's parquet cached batch (io/cached_batch.py) against the
reference's, on the CPU.

The six tests of tests/test_cache.py run through both the reference's
TpuSession and the port's GpuSession(device="cpu"): the same plans
(CacheWriteExec on the first action, CachedScanExec after it, the source
again after unpersist), the same results, the limit that must not
materialize the entry, nulls and strings through the blobs, and the
Spark 3.0.x dialect under which cache() does nothing.  Also here: the
entry's flags, the blobs' round trip, the placements (GPU after the
rewrite, CPU under spark.rapids.sql.enabled=false), the dialect
predicate against the reference's shims, and the plans of both
packages, operator for operator.  The CacheManager of each package is
process-wide, so every test starts and ends with both cleared.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.io.cached_batch import CacheManager as RCacheManager
from spark_rapids_tpu.shims import ShimLoader
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import CPU, GPU
from spark_rapids_tpu_torch.io import cached_batch as pcb

REF = (RF, rcol)
PORT = (PF, pcol)


@pytest.fixture(autouse=True)
def _clear_caches():
    RCacheManager.clear()
    pcb.CacheManager.clear()
    yield
    RCacheManager.clear()
    pcb.CacheManager.clear()


def _ref_session(**extra):
    b = TpuSession.builder().config("spark.rapids.sql.enabled", True) \
        .config("spark.rapids.tpu.singleChipFuse", "on")
    for k, v in extra.items():
        b = b.config(k, v)
    return b.get_or_create()


def _port_session(**extra):
    return GpuSession(device="cpu", conf={"spark.rapids.sql.enabled": True,
                                          **extra})


def _sessions(**extra):
    return ((_ref_session(**extra), REF), (_port_session(**extra), PORT))


def _table(n=500):
    rng = np.random.default_rng(0)
    return pa.table({"k": pa.array(rng.integers(0, 10, n).astype(np.int64)),
                     "v": pa.array(rng.random(n))})


def _plan_names(s):
    out = []
    s.last_plan.foreach(lambda e: out.append(
        type(e).__name__.replace("Tpu", "Gpu")))
    return out


def _shape(s):
    out = []
    s.last_plan.foreach(lambda e: out.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return out


# ---------------------------------------------------------------------------
# tests/test_cache.py, through both packages
# ---------------------------------------------------------------------------

def test_cache_materializes_then_serves_cached_scan():
    results = []
    for s, _ in _sessions():
        df = s.create_dataframe(_table(), num_partitions=3).cache()
        assert df.is_cached
        first = df.collect()
        assert "CacheWriteExec" in _plan_names(s)
        second = df.collect()
        assert "CachedScanExec" in _plan_names(s)
        assert "LocalScanExec" not in _plan_names(s)
        assert second.sort_by("v").equals(first.sort_by("v"))
        results.append((first, _shape(s)))
    assert_tables_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_cached_subtree_reused_by_downstream_query():
    results = []
    for s, (F, col) in _sessions():
        df = s.create_dataframe(_table()).cache()
        df.collect()
        out = df.group_by(col("k")).agg(F.count("*").alias("c")).collect()
        assert sum(out.column("c").to_pylist()) == 500
        assert "CachedScanExec" in _plan_names(s)
        results.append((out, _shape(s)))
    assert_tables_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_unpersist_recomputes_from_source():
    for s, _ in _sessions():
        df = s.create_dataframe(_table()).cache()
        df.collect()
        df.unpersist()
        assert not df.is_cached
        df.collect()
        assert "CachedScanExec" not in _plan_names(s)
        assert "LocalScanExec" in _plan_names(s)


def test_limit_does_not_poison_cache():
    for s, _ in _sessions():
        df = s.create_dataframe(_table(), num_partitions=4).cache()
        df.limit(5).collect()
        full = df.collect()
        assert full.num_rows == 500


def test_cache_gated_by_shim_dialect():
    for s, _ in _sessions(**{"spark.rapids.tpu.sparkVersion": "3.0.1"}):
        df = s.create_dataframe(_table()).cache()
        assert not df.is_cached
        assert df.collect().num_rows == 500


def test_cache_preserves_nulls_and_strings():
    tb = pa.table({"s": pa.array(["a", None, "ccc", "dd", None]),
                   "v": pa.array([1, 2, None, 4, 5], type=pa.int64())})
    for s, _ in _sessions():
        df = s.create_dataframe(tb).cache()
        df.collect()
        out = df.collect()
        assert "CachedScanExec" in _plan_names(s)
        assert out.column("s").to_pylist() == ["a", None, "ccc", "dd", None]
        assert out.column("v").to_pylist() == [1, 2, None, 4, 5]


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", ["3.0.0", "3.0.1", "3.0.3-SNAPSHOT",
                                     "3.1.0", "3.1.1", "3.2.0", "3.3.2"])
def test_dialect_predicate_matches_reference_shims(version):
    want = ShimLoader.get_shim(version).cached_batch_serializer_supported()
    got = pcb.cached_batch_supported(RapidsConf(
        {"spark.rapids.tpu.sparkVersion": version}))
    assert got == want
    assert pcb.cached_batch_supported(RapidsConf())


def test_limit_leaves_the_entry_unmaterialized():
    s = _port_session()
    df = s.create_dataframe(_table(), num_partitions=4).filter(
        pcol("v") > 0.2).cache()
    entry = pcb.CacheManager.lookup(df._lp)
    df.limit(5).collect()
    assert not entry.materialized
    assert "CacheWriteExec" in _plan_names(s)
    want = _table().filter(pa.compute.greater(_table()["v"], 0.2))
    got = df.collect()
    assert entry.materialized and len(entry.partitions) == 4
    assert all(p.complete for p in entry.partitions)
    assert entry.size_bytes > 0
    assert_tables_equal(want, got)
    assert_tables_equal(want, df.collect())
    assert "CachedScanExec" in _plan_names(s)


def test_cut_second_write_keeps_the_first():
    """c.union(c) under a limit: the first write completes c's partition,
    the second is cut after its first batch; the entry keeps the first
    write's blobs, so a later scan of c returns every row."""
    s = _port_session()
    n = (1 << 20) + 1000                    # two range batches
    c = s.range(0, n).cache()
    entry = pcb.CacheManager.lookup(c._lp)
    assert c.union(c).limit(n + 10).count() == n + 10
    assert entry.materialized
    assert c.count() == n
    assert "CachedScanExec" in _plan_names(s)
    got = c.collect()["id"].to_numpy()
    np.testing.assert_array_equal(got, np.arange(n))


def test_cache_of_a_repartition_keeps_its_partitions():
    """The cache write reads the repartition's partitions: a sample over
    the cached frame keeps the rows the reference's CPU engine keeps, on
    the write and on the scan."""
    t = _table(600)
    ref = TpuSession.builder().config("spark.rapids.sql.enabled",
                                      False).get_or_create()
    want = ref.create_dataframe(t, num_partitions=2).repartition(
        4, rcol("k")).sample(0.5, seed=3).collect()
    s = _port_session()
    c = s.create_dataframe(t, num_partitions=2).repartition(
        4, pcol("k")).cache()
    for run in ("CacheWriteExec", "CachedScanExec"):
        got = c.sample(0.5, seed=3).collect()
        assert run in _plan_names(s)
        assert_tables_equal(want, got)
    assert len(pcb.CacheManager.lookup(c._lp).partitions) == 4


def test_entry_holds_its_plan():
    s = _port_session()
    df = s.create_dataframe(_table()).cache()
    lp = df._lp
    del df
    entry = pcb.CacheManager.lookup(lp)
    assert entry is not None and entry.lp is lp
    pcb.CacheManager.uncache(lp)
    assert pcb.CacheManager.lookup(lp) is None


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_blob_round_trip(n):
    rng = np.random.default_rng(n)
    rb = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.2),
        pa.array(rng.random(n)),
        pa.array([f"s{i}" if i % 7 else None for i in range(n)],
                 type=pa.large_string()),
        pa.array(rng.random(n) < 0.5)], names=["a", "b", "c", "d"])
    back = pcb.decode_blob(pcb.encode_batch(rb))
    assert pa.Table.from_batches(back, rb.schema).equals(
        pa.Table.from_batches([rb])) if n else \
        sum(b.num_rows for b in back) == 0


def _cache_strings():
    rng = np.random.default_rng(5)
    n = 700
    return pa.table({
        "s": pa.array([f"Customer#{int(i):09d}" for i in
                       rng.integers(0, 50, n)]),
        "c": pa.array([("é中" * int(i % 4)) + f"x{int(i)}" for i in
                       rng.integers(0, 99, n)], mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-10**6, 10**6, n))})


@pytest.mark.parametrize("parts", [1, 3])
def test_strings_with_nulls_come_back_equal(parts):
    t = _cache_strings()
    s = _port_session()
    df = s.create_dataframe(t, num_partitions=parts).select(
        pcol("s"), pcol("c"), pcol("v")).cache()
    first = df.collect()
    second = df.collect()
    assert "CachedScanExec" in _plan_names(s)
    assert_tables_equal(t, first)
    assert_tables_equal(t, second)


@pytest.mark.parametrize("enabled", [True, False])
def test_cache_placements(enabled):
    """CacheWriteExec is placed with its child and CachedScanExec on the
    GPU after the rewrite; both on the CPU under
    spark.rapids.sql.enabled=false."""
    s = GpuSession(device="cpu", conf={"spark.rapids.sql.enabled": enabled})
    df = s.create_dataframe(_table(), num_partitions=2).filter(
        pcol("v") > 0.5).cache()
    for scan in ("CacheWriteExec", "CachedScanExec"):
        out = df.group_by(pcol("k")).agg(PF.count("*").alias("c")).collect()
        assert sum(out["c"].to_pylist()) == sum(
            1 for v in _table()["v"].to_pylist() if v > 0.5)
        places = dict(_shape(s))
        assert scan in places
        want = GPU if enabled else CPU
        assert places[scan] == want
        assert {p for n, p in _shape(s)[1:]} == {want}


def test_cache_write_follows_a_cpu_child():
    """A cache write over a scan that stays on the CPU stays there too,
    with its reason; the plan above reads it through an upload."""
    s = _port_session(**{"spark.rapids.sql.exec.FilterExec": False})
    df = s.create_dataframe(_table()).filter(pcol("v") > 0.5).cache()
    df.select(pcol("k")).collect()
    places = dict(_shape(s))
    assert places["CacheWriteExec"] == CPU
    assert "the cache write runs where its child does" in s.last_explain
    assert_tables_equal(df.collect().select(["k"]),
                        _table().filter(pa.compute.greater(
                            _table()["v"], 0.5)).select(["k"]))
    assert "CachedScanExec" in _plan_names(s)


def test_cache_explain_matches_reference():
    """The first and second action's plans and explain lines are the
    reference's, operator for operator."""
    shapes, explains = [], []
    for s, (F, col) in _sessions():
        df = s.create_dataframe(_table(), num_partitions=2).filter(
            col("v") > 0.3).cache()
        q = df.group_by(col("k")).agg(F.sum(col("v")).alias("sv"))
        runs = []
        for _ in range(2):
            s.explain(q._lp)
            runs.append((_shape(s), s.last_explain.replace("TPU", "GPU")))
            q.collect()
        shapes.append([r[0] for r in runs])
        explains.append([r[1] for r in runs])
    assert shapes[0] == shapes[1]
    assert explains[0] == explains[1]
