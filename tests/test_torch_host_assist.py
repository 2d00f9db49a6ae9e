"""The port's host-assisted collect and write, and the row id, against
the reference, on the CPU.

A global sort of an in-memory table fetches only a row-id lane and
``take``s the host copy (``spark.rapids.sql.collect.hostAssisted``); a
write that only filters and prunes fetches only the keep mask and
filters the host copy (``spark.rapids.sql.write.hostAssisted``).  Every
case of tests/test_host_assist_collect.py and
tests/test_host_assisted_write.py runs through the port's
GpuSession(device="cpu") both ways, and against the reference's
TpuSession (single-device exchange fusion forced on) once per kind of
case; that the assisted path ran is read from ``last_plan``.  The row id
itself, monotonically_increasing_id(), is held against the reference
over 1 and 3 partitions with several batches a partition, and through
the assisted collect's own row-id plan.  Tables hold int, long, double
and bool columns with nulls.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.exec import basic as rbasic
from spark_rapids_tpu.exec.base import ExecContext as RCtx
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import hashfns as rhash
from spark_rapids_tpu.expr import predicates as rpred
from spark_rapids_tpu.io import scan as rscan
from spark_rapids_tpu.io import writer as rwriter
from spark_rapids_tpu.plan import host_assist as rassist
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec import basic as pbasic
from spark_rapids_tpu_torch.exec.base import ExecContext as PCtx
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import hashfns as phash
from spark_rapids_tpu_torch.expr import predicates as ppred
from spark_rapids_tpu_torch.expr.window import Window as PWindow
from spark_rapids_tpu_torch.io import scan as pscan
from spark_rapids_tpu_torch.io import writer as pwriter
from spark_rapids_tpu_torch.plan import host_assist as passist

N = 70_000     # above the 64Ki rows below which the direct path is kept
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on",
            "spark.rapids.sql.enabled": True}
COLLECT = "spark.rapids.sql.collect.hostAssisted"
WRITE = "spark.rapids.sql.write.hostAssisted"


def flat_table(n, seed, key_hi=50):
    rng = np.random.default_rng(seed)

    def nulls(p=0.05):
        return rng.random(n) < p
    return pa.table({
        # a narrow key range: many ties, so stability shows
        "k": pa.array(rng.integers(0, key_hi, n).astype(np.int64),
                      mask=nulls()),
        "v": pa.array(rng.integers(-1000, 1000, n).astype(np.int64),
                      mask=nulls()),
        "f": pa.array(rng.random(n), mask=nulls()),
        "i": pa.array(rng.integers(-9, 9, n).astype(np.int32),
                      mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


@pytest.fixture(scope="module")
def fact():
    return flat_table(N, 9)


def port(conf=None):
    return GpuSession(device="cpu", conf=conf)


def ref(conf=None):
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **(conf or {})}.items():
        b = b.config(k, v)
    return b.get_or_create()


def plan_names(session):
    names = []
    session.last_plan.foreach(lambda e: names.append(e.describe()))
    return names


def assisted_ran(session) -> bool:
    return any("__rid__" in n for n in plan_names(session))


# ---------------------------------------------------------------------------
# the host-assisted collect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4])
def test_sorted_collect_matches_direct(fact, parts):
    s = port({COLLECT: True})
    got = s.create_dataframe(fact, num_partitions=parts).sort(
        pcol("k"), pcol("v")).collect()
    assert assisted_ran(s)
    d = port({COLLECT: False})
    want = d.create_dataframe(fact, num_partitions=parts).sort(
        pcol("k"), pcol("v")).collect()
    assert not assisted_ran(d)
    assert got.equals(want), f"mismatch at num_partitions={parts}"
    r = ref({COLLECT: True}).create_dataframe(
        fact, num_partitions=parts).sort(rcol("k"), rcol("v")).collect()
    assert got.equals(r)


def test_sorted_collect_with_filter_and_pruning(fact):
    def q(s, col):
        return (s.create_dataframe(fact, num_partitions=2)
                .filter(col("v") > 0).select(col("k"), col("v"), col("b"))
                .filter(col("b") | col("k").is_null())
                .sort(col("k"), col("v").desc()).collect())
    s = port({COLLECT: True})
    got = q(s, pcol)
    assert assisted_ran(s)
    assert got.schema.names == ["k", "v", "b"]
    assert got.equals(q(port({COLLECT: False}), pcol))
    assert got.equals(q(ref(), rcol))
    # only the columns the filters and sort keys read ride the sort
    (proj,) = [n for n in plan_names(s) if "monotonically" in n]
    assert proj == ("Project [k, v, b, monotonically_increasing_id() "
                    "AS __rid__]")


def test_descending_and_stability(fact):
    def q(s, col):
        return s.create_dataframe(fact).sort(col("k").desc()).collect()
    s = port({COLLECT: True})
    got = q(s, pcol)
    assert assisted_ran(s)
    assert got.equals(q(port({COLLECT: False}), pcol))
    assert got.equals(q(ref(), rcol))


def test_small_results_use_direct_path():
    small = pa.table({"k": pa.array(np.arange(100, dtype=np.int64))})
    s = port({COLLECT: True})
    df = s.create_dataframe(small).sort(pcol("k"))
    assert passist.try_host_assisted_collect(s, df._lp) is None
    assert df.collect().equals(small)
    assert not assisted_ran(s)


def test_assist_declines_other_plans(fact):
    """Anything but a global sort over filters and attribute-only
    projections of an in-memory table takes the direct path, as in the
    reference."""
    cases = {
        "computed": lambda df, col: df.select((col("v") + 1).alias("w"))
        .sort(col("w")),
        "within_partitions": lambda df, col: df.sort_within_partitions(
            col("k")),
        "limit": lambda df, col: df.sort(col("k")).limit(5),
        "aggregate": lambda df, col: df.group_by(col("k")).agg(
            (RF if col is rcol else PF).count("*").alias("c"))
        .sort(col("k")),
        "no_sort": lambda df, col: df.filter(col("v") > 0),
    }
    for name, q in cases.items():
        s = port({COLLECT: True})
        lp = q(s.create_dataframe(fact), pcol)._lp
        assert passist.try_host_assisted_collect(s, lp) is None, name
        r = ref()
        assert rassist.try_host_assisted_collect(
            r, q(r.create_dataframe(fact), rcol)._lp) is None, name
    s = port({"spark.rapids.sql.enabled": False, COLLECT: True})
    lp = s.create_dataframe(fact).sort(pcol("k"))._lp
    assert passist.try_host_assisted_collect(s, lp) is None


# ---------------------------------------------------------------------------
# the row id
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts,batch_rows", [(1, None), (1, 7), (3, 7),
                                              (3, 1000)])
def test_row_id_matches_reference(parts, batch_rows):
    t = flat_table(100, 3)
    got = pbasic.ProjectExec(
        [pcore.Alias(phash.MonotonicallyIncreasingID(), "id"),
         pcore.AttributeReference("v")],
        pbasic.LocalScanExec(t, parts, batch_rows)).execute_collect(
            PCtx("cpu"))
    want = rbasic.ProjectExec(
        [rcore.Alias(rhash.MonotonicallyIncreasingID(), "id"),
         rcore.AttributeReference("v")],
        rbasic.LocalScanExec(t, parts, batch_rows)).execute_collect(RCtx())
    assert got.equals(want)
    per = -(-100 // parts)
    ids = got.column("id").to_numpy()
    rows = np.arange(100)
    assert np.array_equal(ids, ((rows // per) << 33) + rows % per)


def test_row_id_through_dataframes():
    t = flat_table(500, 4)
    for parts in (1, 3):
        got = port().create_dataframe(t, num_partitions=parts).select(
            PF.monotonically_increasing_id().alias("id"), "k").collect()
        want = ref().create_dataframe(t, num_partitions=parts).select(
            RF.monotonically_increasing_id().alias("id"), rcol("k")) \
            .collect()
        assert_tables_equal(want, got, ignore_order=False)


@pytest.mark.parametrize("parts,batch_rows", [(1, 7), (3, 7), (3, 16)])
def test_row_id_in_a_filter_matches_reference(parts, batch_rows):
    """A filter on the row id carries the projection's running base over
    every batch of its partition, not 0 a batch."""
    t = flat_table(100, 6)
    cut = ((parts - 1) << 33) + 20   # the last partition's first 21 rows
    got = pbasic.FilterExec(
        ppred.LessThan(phash.MonotonicallyIncreasingID(),
                       pcore.Literal(cut)),
        pbasic.LocalScanExec(t, parts, batch_rows)).execute_collect(
            PCtx("cpu"))
    want = rbasic.FilterExec(
        rpred.LessThan(rhash.MonotonicallyIncreasingID(),
                       rcore.Literal(cut)),
        rbasic.LocalScanExec(t, parts, batch_rows)).execute_collect(RCtx())
    assert got.equals(want)
    per = -(-100 // parts)
    rows = np.arange(100)
    ids = ((rows // per) << 33) + rows % per
    assert got.equals(t.filter(pa.array(ids < cut)))


def test_row_id_filter_over_file_partitions(tmp_path):
    """filter(monotonically_increasing_id() < k) over 3 files read
    PERFILE (3 partitions) cut into several batches each, through both
    sessions and both engines."""
    t = flat_table(90, 7)
    for i in range(3):
        papq.write_table(t.slice(30 * i, 30),
                         str(tmp_path / f"part-{i}.parquet"))
    conf = {"spark.rapids.sql.format.parquet.reader.type": "PERFILE",
            "spark.rapids.sql.reader.batchSizeRows": 8}
    cut = (2 << 33) + 11
    want = t.filter(pa.array(
        ((np.arange(90) // 30) << 33) + np.arange(90) % 30 < cut))
    for c in (conf, {**conf, "spark.rapids.sql.enabled": False}):
        pscan.clear_filescan_pin()
        got = port(c).read.parquet(str(tmp_path)).filter(
            PF.monotonically_increasing_id() < cut).collect()
        assert got.equals(want)
    rscan._FILESCAN_PIN.clear()
    r = ref(conf).read.parquet(str(tmp_path)).filter(
        RF.monotonically_increasing_id() < cut).collect()
    rscan._FILESCAN_PIN.clear()
    assert_tables_equal(r, got, ignore_order=False)


def test_row_id_refused_where_no_base_is_carried(fact):
    """Outside a projection and a filter the row id has no running base,
    so the planner refuses it on both engines."""
    mid = PF.monotonically_increasing_id
    small = fact.slice(0, 100)
    cases = {
        "sort": lambda df: df.sort(mid()),
        "group": lambda df: df.group_by(mid()).agg(
            PF.count("*").alias("c")),
        "agg": lambda df: df.group_by(pcol("k")).agg(
            PF.sum(mid()).alias("s")),
        "window": lambda df: df.select(
            pcol("k"), PF.row_number().over(
                PWindow.partition_by(mid()).order_by(pcol("v")))
            .alias("r")),
        "join": lambda df: df.join(
            df.select(pcol("k").alias("k2")),
            (pcol("k") == pcol("k2")) & (mid() > 3), "inner"),
    }
    for name, q in cases.items():
        for c in ({}, {"spark.rapids.sql.enabled": False}):
            with pytest.raises(NotImplementedError,
                               match="monotonically_increasing_id"):
                q(port(c).create_dataframe(small, 2)).collect()
    # projected into a column first, the same sort runs
    s = port()
    got = s.create_dataframe(small, 2).with_column("id", mid()).sort(
        pcol("id").desc()).collect()
    assert got.column("id").to_pylist() == sorted(
        [(r // 50 << 33) + r % 50 for r in range(100)], reverse=True)


def test_defaults_take_the_direct_paths(fact, tmp_path):
    """Both elisions are off by default on the port."""
    s = port()
    got = s.create_dataframe(fact).sort(pcol("k"), pcol("v")).collect()
    assert not assisted_ran(s)
    assert got.equals(port({COLLECT: True}).create_dataframe(fact).sort(
        pcol("k"), pcol("v")).collect())
    out = str(tmp_path / "w")
    s.create_dataframe(fact).filter(pcol("v") > 0).write.mode(
        "overwrite").parquet(out)
    assert not _mask_plan_ran(s)
    assert _read_back(out).equals(
        fact.filter(pc.fill_null(pc.greater(fact["v"], 0), False)))


def test_row_ids_under_the_fusion(fact):
    """The assisted collect's own row-id plan over 3 partitions: the
    projection runs below the partition gather, once a partition, so
    its ids map back to the table's rows."""
    t = fact.slice(0, N - 5)
    s = port({COLLECT: True})
    got = s.create_dataframe(t, num_partitions=3).filter(
        pcol("v") > 0).sort(pcol("k"), pcol("v")).collect()
    names = [type(e).__name__ for e in _nodes(s.last_plan)]
    assert names.index("GatherPartitionsExec") < names.index("ProjectExec",
                                                             names.index("SortExec"))
    rid_query = []
    orig = s.execute

    def spy(lp):
        out = orig(lp)
        rid_query.append(out)
        return out
    s.execute = spy
    passist.try_host_assisted_collect(
        s, s.create_dataframe(t, num_partitions=3).filter(pcol("v") > 0)
        .sort(pcol("k"), pcol("v"))._lp)
    (rids,) = rid_query
    r = ref()
    want_rids = r.execute(_ref_rid_plan(t, 3))
    assert rids.equals(want_rids)
    per = -(-t.num_rows // 3)
    rid = rids.column("__rid__").to_numpy()
    idx = (rid >> 33) * per + (rid & ((1 << 33) - 1))
    assert got.equals(t.take(idx))
    assert got.equals(r.create_dataframe(t, num_partitions=3).filter(
        rcol("v") > 0).sort(rcol("k"), rcol("v")).collect())


def _nodes(root):
    out = []
    root.foreach(out.append)
    return out


def _ref_rid_plan(t, parts):
    from spark_rapids_tpu.expr.predicates import GreaterThan
    from spark_rapids_tpu.plan import logical as RL
    A = rcore.AttributeReference
    rel = RL.LocalRelation(t, parts)
    lp = RL.Project([A("k"), A("v"),
                     rcore.Alias(rhash.MonotonicallyIncreasingID(),
                                 "__rid__")], rel)
    lp = RL.Filter(GreaterThan(A("v"), rcore.Literal(0)), lp)
    lp = RL.Sort([(A("k"), True, True), (A("v"), True, True)], True, lp)
    return RL.Project([A("__rid__")], lp)


# ---------------------------------------------------------------------------
# the host-assisted write
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wfact():
    return flat_table(20_000, 5, key_hi=100)


def _read_back(out):
    files = sorted(glob.glob(os.path.join(out, "*.parquet")))
    return pa.concat_tables([papq.read_table(f) for f in files])


def _mask_plan_ran(session) -> bool:
    return any("__keep__" in n for n in plan_names(session))


def test_filtered_write_matches_unassisted(wfact, tmp_path):
    outs = []
    for assisted in (True, False):
        s = port({WRITE: assisted})
        df = (s.create_dataframe(wfact).filter(pcol("v") > 0)
              .filter(pcol("f") < 0.9).select(pcol("k"), pcol("v")))
        out = str(tmp_path / f"out_{assisted}")
        df.write.mode("overwrite").parquet(out)
        assert _mask_plan_ran(s) == assisted
        outs.append(_read_back(out))
    assert outs[0].equals(outs[1])
    assert outs[0].num_rows > 0
    r = ref({WRITE: True})
    out = str(tmp_path / "out_ref")
    (r.create_dataframe(wfact).filter(rcol("v") > 0)
     .filter(rcol("f") < 0.9).select(rcol("k"), rcol("v"))
     .write.mode("overwrite").parquet(out))
    assert outs[0].equals(_read_back(out))


def test_null_conditions_drop_rows(wfact, tmp_path):
    """A null keep flag drops the row, as Spark's filter does."""
    s = port()
    df = s.create_dataframe(wfact).filter(pcol("b"))
    got = pwriter._host_assisted_table(df)
    assert got.equals(wfact.filter(pc.fill_null(wfact["b"], False)))
    assert got.equals(df.collect())


def test_projection_only_write(wfact, tmp_path):
    s = port({WRITE: True})
    out = str(tmp_path / "proj")
    s.create_dataframe(wfact).select(pcol("f"), pcol("k")) \
        .write.mode("overwrite").parquet(out)
    assert _read_back(out).equals(wfact.select(["f", "k"]))
    assert s.last_plan is None         # nothing ran on the device


def test_file_source_filtered_write(wfact, tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    os.makedirs(src)
    papq.write_table(wfact, os.path.join(src, "part-0.parquet"))
    emitted = []
    orig = pscan.FileScanExec._emit

    def spy(self, table, ctx, path=""):
        for b in orig(self, table, ctx, path):
            emitted.append((self.placement, bool(self.pushed_filters),
                            b.device.type))
            yield b
    monkeypatch.setattr(pscan.FileScanExec, "_emit", spy)
    outs = []
    for assisted in (True, False):
        pscan.clear_filescan_pin()
        emitted.clear()
        s = port({WRITE: assisted})
        df = s.read.parquet(src).filter(pcol("f") < 0.5)
        out = str(tmp_path / f"fout_{assisted}")
        df.write.mode("overwrite").parquet(out)
        outs.append(_read_back(out))
        if assisted:
            # the host copy: a CPU-placed scan with no pushed filter;
            # the mask plan's own scan is GPU-placed
            assert ("cpu", False, "cpu") in emitted
            assert ("gpu", False, "cpu") in emitted
            assert _mask_plan_ran(s)
    pscan.clear_filescan_pin()
    assert outs[0].equals(outs[1])
    keep = pc.fill_null(pc.less(wfact["f"], 0.5), False)
    assert outs[0].equals(wfact.filter(keep))
    rscan._FILESCAN_PIN.clear()
    r = ref({WRITE: True})
    out = str(tmp_path / "fout_ref")
    r.read.parquet(src).filter(rcol("f") < 0.5).write.mode(
        "overwrite").parquet(out)
    rscan._FILESCAN_PIN.clear()
    assert outs[0].equals(_read_back(out))


def test_compute_plans_fall_back(wfact, tmp_path):
    """A plan that computes values takes the collect, same result."""
    s = port()
    df = s.create_dataframe(wfact).select(
        (pcol("v") + pcol("k")).alias("s"))
    assert pwriter._host_assisted_table(df) is None
    r = ref()
    assert rwriter._host_assisted_table(r.create_dataframe(wfact).select(
        (rcol("v") + rcol("k")).alias("s"))) is None
    out = str(tmp_path / "computed")
    df.write.mode("overwrite").parquet(out)
    want = pa.table({"s": pc.add(wfact["v"], wfact["k"])})
    assert _read_back(out).equals(want)


def test_partitioned_write_host_assisted(wfact, tmp_path):
    s = port({WRITE: True})
    df = s.create_dataframe(wfact).filter(pcol("k") < 3)
    out = str(tmp_path / "parts")
    df.write.mode("overwrite").partition_by("k").parquet(out)
    assert _mask_plan_ran(s)
    assert sorted(os.listdir(out)) == ["k=0", "k=1", "k=2"]
    for k in range(3):
        got = _read_back(os.path.join(out, f"k={k}"))
        keep = pc.fill_null(pc.equal(wfact["k"], k), False)
        assert got.equals(wfact.filter(keep).drop_columns(["k"]))
