"""The port's file IO against the reference, on the CPU.

The same seeded numpy table (int, long, double and bool columns, each
with nulls) is written to ``tmp_path`` and read through the reference's
TpuSession (single-device exchange fusion forced on, as in the other
parity tests) and the port's GpuSession(device="cpu"); the two results
are compared with the reference's assert_tables_equal, integers exactly
and double sums to a relative 1e-9.  The flat cases of
tests/test_io.py and tests/test_io_scan.py: each reader type over 1, 3
and 5 files and AUTO, pushdown and pruning, the no-leak case, orc, csv
with and without a header and with a schema, parquet round trips, a
partitioned write with a null key, every write mode, and the device
pin (reuse, invalidation, off).  Also ``_expand`` and
``_pushdown_to_arrow`` against the reference's functions, the
NotImplementedError for a string column, the scan's CPU placement
under ``format.parquet.enabled=false``, and the io config keys' names,
defaults and accepted values.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import predicates as rpred
from spark_rapids_tpu.expr import arithmetic as rarith
from spark_rapids_tpu.io import reader as rreader
from spark_rapids_tpu.io import scan as rscan
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import arithmetic as parith
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import predicates as ppred
from spark_rapids_tpu_torch.io import reader as preader
from spark_rapids_tpu_torch.io import scan as pscan

FLOAT_RTOL = 1e-9
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on",
            "spark.rapids.sql.enabled": True}
READER = "spark.rapids.sql.format.parquet.reader.type"
PIN = "spark.rapids.sql.fileScan.pinDeviceBatches"


def flat_table(n=1000, seed=7):
    rng = np.random.default_rng(seed)

    def nulls(p=0.1):
        return rng.random(n) < p
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n).astype(np.int32),
                      mask=nulls()),
        "v": pa.array(rng.integers(-10**6, 10**6, n), mask=nulls()),
        "f": pa.array(rng.random(n), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


def write_parquet_files(directory, table, n_files):
    bounds = [round(i * table.num_rows / n_files)
              for i in range(n_files + 1)]
    paths = []
    for i in range(n_files):
        p = str(directory / f"f{i}.parquet")
        papq.write_table(table.slice(bounds[i], bounds[i + 1] - bounds[i]),
                         p)
        paths.append(p)
    return paths


def sessions(conf=None):
    conf = dict(conf or {})
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def both(query, conf=None, ignore_order=True):
    """``query(session, col, F)`` through each package; the collects are
    compared and returned with the sessions."""
    ref, port = sessions(conf)
    want = query(ref, rcol, RF).collect()
    got = query(port, pcol, PF).collect()
    assert_tables_equal(want, got, ignore_order=ignore_order,
                        approximate_float=FLOAT_RTOL)
    return want, got, ref, port


def scans(session):
    found = []
    session.last_plan.foreach(
        lambda e: found.append(e) if type(e).__name__ == "FileScanExec"
        else None)
    return found


@pytest.fixture(autouse=True)
def _empty_pins():
    pscan.clear_filescan_pin()
    rscan._FILESCAN_PIN.clear()
    yield
    pscan.clear_filescan_pin()
    rscan._FILESCAN_PIN.clear()


# ---------------------------------------------------------------------------
# the config keys, against the reference
# ---------------------------------------------------------------------------

IO_KEYS = ("PARQUET_ENABLED", "ORC_ENABLED", "CSV_ENABLED",
           "PARQUET_READER_TYPE", "PARQUET_MULTITHREAD_READ_NUM_THREADS",
           "MAX_READER_BATCH_SIZE_ROWS", "FILESCAN_PIN_DEVICE",
           "HOST_ASSISTED_COLLECT", "HOST_ASSISTED_WRITE")
PORT_DEFAULTS = {"HOST_ASSISTED_COLLECT": False, "HOST_ASSISTED_WRITE": False}


@pytest.mark.parametrize("name", IO_KEYS)
def test_config_keys_match_reference(name):
    from spark_rapids_tpu import config as rcfg
    from spark_rapids_tpu_torch import config as pcfg
    r, p = getattr(rcfg, name), getattr(pcfg, name)
    assert p.key == r.key
    if name in PORT_DEFAULTS:
        # the port's reasoned departure: the elisions lose on the H100
        assert (r.default, p.default) == (True, PORT_DEFAULTS[name])
    else:
        assert p.default == r.default
    for raw in ("true", "false", "0", "1", "7", "AUTO", "PERFILE",
                "COALESCING", "MULTITHREADED", "FASTEST"):
        try:
            want = r.get({r.key: raw})
        except ValueError:
            with pytest.raises(ValueError):
                p.get({p.key: raw})
            continue
        assert p.get({p.key: raw}) == want, raw


# ---------------------------------------------------------------------------
# path expansion and the pushed predicate, against the reference
# ---------------------------------------------------------------------------

def test_expand_matches_reference(tmp_path):
    t = flat_table(20)
    root = tmp_path / "root"
    for rel in ("a.parquet", "b.parquet", "k=1/c.parquet",
                "k=2/deep/d.parquet", "_temporary/e.parquet",
                "k=3/_tmp/f.parquet", ".hidden/g.parquet",
                "k=1/.h.parquet", "_SUCCESS"):
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        papq.write_table(t, str(p))
    other = tmp_path / "csvs"
    other.mkdir()
    for name in ("x.csv", "y.csv", "_z.csv"):
        pacsv.write_csv(t, str(other / name))
    cases = [str(root), [str(root)], str(root / "a.parquet"),
             str(root / "*.parquet"), str(root / "k=?" / "*.parquet"),
             [str(root / "b.parquet"), str(other)], str(other),
             str(tmp_path / "missing.parquet")]
    for case in cases:
        want = rreader._expand(case)
        assert preader._expand(case) == want, case
    got = preader._expand(str(root))
    assert [os.path.relpath(p, root) for p in got] == [
        "a.parquet", "b.parquet", "k=1/c.parquet", "k=2/deep/d.parquet"]
    for rel in ("_x/a", "a/.b", "a/b", "_SUCCESS", "k=1/part"):
        path = str(root / rel)
        assert preader._hidden_component(str(root), path) == \
            rreader._hidden_component(str(root), path)


def _predicates(core, pred, arith):
    A, L = core.AttributeReference, core.Literal
    return {
        "gt": [pred.GreaterThan(A("k"), L(25))],
        "eq": [pred.EqualTo(A("v"), L(3))],
        "lt_double": [pred.LessThan(A("f"), L(0.5))],
        "le_ge": [pred.LessThanOrEqual(A("k"), L(9)),
                  pred.GreaterThanOrEqual(A("v"), L(-4))],
        "and": [pred.And(pred.GreaterThan(A("k"), L(1)),
                         pred.LessThan(A("f"), L(0.25)))],
        "or": [pred.Or(pred.EqualTo(A("k"), L(1)),
                       pred.IsNotNull(A("v")))],
        "is_not_null": [pred.IsNotNull(A("f"))],
        "literal_left": [pred.GreaterThan(L(3), A("k"))],
        "computed": [pred.GreaterThan(arith.Add(A("k"), L(1)), L(3))],
        "or_half_computed": [pred.Or(
            pred.EqualTo(A("k"), L(1)),
            pred.GreaterThan(arith.Add(A("k"), L(1)), L(3)))],
        "mixed": [pred.GreaterThan(arith.Add(A("k"), L(1)), L(3)),
                  pred.LessThan(A("v"), L(10))],
        "none": [],
    }


@pytest.mark.parametrize("case", sorted(_predicates(pcore, ppred, parith)))
def test_pushdown_to_arrow_matches_reference(case, tmp_path):
    want = rscan._pushdown_to_arrow(
        _predicates(rcore, rpred, rarith)[case], ["k", "v", "f"])
    got = pscan._pushdown_to_arrow(
        _predicates(pcore, ppred, parith)[case], ["k", "v", "f"])
    if want is None:
        assert got is None
        return
    assert got is not None and got.equals(want), (got, want)
    # and the rows the two select from a file agree
    p = str(tmp_path / "t.parquet")
    papq.write_table(flat_table(200), p)
    import pyarrow.dataset as pads
    ds = pads.dataset(p, format="parquet")
    assert ds.to_table(filter=got).equals(ds.to_table(filter=want))


# ---------------------------------------------------------------------------
# reading: the reader types, pushdown and pruning, orc, csv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_files", [1, 3, 5])
@pytest.mark.parametrize("reader_type",
                         ["PERFILE", "COALESCING", "MULTITHREADED", "AUTO"])
def test_parquet_read_strategies(tmp_path, reader_type, n_files):
    t = flat_table()
    paths = write_parquet_files(tmp_path, t, n_files)

    def q(spark, col, F):
        return spark.read.parquet(*paths).group_by(col("k")).agg(
            F.sum(col("v")).alias("sv"), F.sum(col("f")).alias("sf"),
            F.count("*").alias("c"))
    _, got, ref, port = both(q, {READER: reader_type})
    (rs,), (ps,) = scans(ref), scans(port)
    assert ps.reader_type == rs.reader_type
    assert ps.num_partitions == rs.num_partitions
    want_type = reader_type if reader_type != "AUTO" else \
        {1: "PERFILE", 3: "COALESCING", 5: "MULTITHREADED"}[n_files]
    assert ps.reader_type == want_type
    assert ps.placement == "gpu" and "!" not in port.last_explain
    assert ps._pool is None          # MULTITHREADED shut its pool down
    assert got.num_rows == len(set(t.column("k").to_pylist()))


def test_parquet_scan_rows_match_reference(tmp_path):
    """The scan alone, row for row, in file order over 3 files."""
    t = flat_table()
    paths = write_parquet_files(tmp_path, t, 3)
    for reader_type in ("PERFILE", "COALESCING", "MULTITHREADED"):
        want, got, _, _ = both(
            lambda s, col, F: s.read.parquet(*paths).select("k", "v", "f",
                                                            "b"),
            {READER: reader_type}, ignore_order=False)
        assert got.equals(t)


def test_parquet_pushdown_and_pruning(tmp_path):
    t = flat_table()
    paths = write_parquet_files(tmp_path, t, 3)

    def q(spark, col, F):
        return spark.read.parquet(*paths).filter(col("k") > 25) \
            .select("k", "v")
    want, got, ref, port = both(q)
    assert got.schema.names == ["k", "v"]
    keep = pc.fill_null(pc.greater(t["k"], 25), False)
    assert got.num_rows == pc.sum(keep).as_py()
    (ps,) = scans(port)
    assert [f.sql() for f in ps.pushed_filters] == ["(k > 25)"]
    assert ps.output_names == ["k", "v", "f", "b"]   # filter above prunes no
    # an attribute-only projection directly over the relation prunes
    _, _, _, port = both(lambda s, col, F: s.read.parquet(*paths).select(
        "f", "k"))
    (ps,) = scans(port)
    assert ps.required_columns == ["f", "k"]
    assert ps.output_names == ["f", "k"] and not ps.pushed_filters


def test_filter_pushdown_does_not_leak_across_queries(tmp_path):
    """Planning a filtered query must not change the shared relation."""
    p = str(tmp_path / "t.parquet")
    for session in sessions():
        session.create_dataframe(pa.table(
            {"k": pa.array(range(100)), "v": pa.array(range(100))})) \
            .write.mode("overwrite").parquet(p)
        base = session.read.parquet(p)
        assert base.filter(
            (rcol if isinstance(session, TpuSession) else pcol)("k") > 90
        ).collect().num_rows == 9
        assert base.select("k", "v").collect().num_rows == 100
        assert base.collect().num_rows == 100


def test_orc_read(tmp_path):
    t = flat_table()
    src = str(tmp_path / "a.orc")
    paorc.write_table(t, src)

    def q(spark, col, F):
        return spark.read.orc(src).group_by(col("k")).agg(
            F.count("*").alias("c"), F.sum(col("v")).alias("sv"))
    both(q)
    _, got, _, port = both(lambda s, col, F: s.read.orc(src).select(
        "k", "b"), ignore_order=False)
    assert got.equals(t.select(["k", "b"]))
    assert scans(port)[0].required_columns == ["k", "b"]
    # pruned out of file order: ORC reads in file order, and the
    # reference's cast to the pruned schema then raises; the port selects
    ref, port = sessions()
    with pytest.raises(ValueError):
        ref.read.orc(src).select("b", "k").collect()
    assert port.read.orc(src).select("b", "k").collect().equals(
        t.select(["b", "k"]))


CSV_TEXT = "a,b,c\n1,2.5,true\n2,3.5,false\n3,,true\n-7,0.25,\n"


@pytest.mark.parametrize("header", [True, False])
def test_csv_read(tmp_path, header):
    p = str(tmp_path / "data.csv")
    with open(p, "w") as f:
        f.write(CSV_TEXT if header else CSV_TEXT.split("\n", 1)[1])
    a, b = ("a", "b") if header else ("f0", "f1")

    def q(spark, col, F):
        return spark.read.csv(p, header=header).select(
            (col(a) * 2).alias("a2"), col(b))
    _, got, _, _ = both(q, ignore_order=False)
    assert got.column("a2").to_pylist() == [2, 4, 6, -14]
    assert got.column(b).to_pylist() == [2.5, 3.5, None, 0.25]


def test_csv_read_with_schema(tmp_path):
    p = str(tmp_path / "data.csv")
    with open(p, "w") as f:
        f.write(CSV_TEXT)
    from spark_rapids_tpu import types as rt
    ref, port = sessions()
    want = ref.read.schema([("a", rt.INT), ("b", rt.DOUBLE),
                            ("c", rt.BOOLEAN)]).csv(p).collect()
    got = port.read.schema([("a", pt.INT), ("b", pt.DOUBLE),
                            ("c", pt.BOOLEAN)]).csv(p).collect()
    assert_tables_equal(want, got, ignore_order=False)
    assert got.schema.field("a").type == pa.int32()
    assert got.column("c").to_pylist() == [True, False, True, None]


def test_unported_column_type_raises_at_read(tmp_path):
    p = str(tmp_path / "s.parquet")
    # a time of day: no SQL type in the port (nor in the reference)
    papq.write_table(pa.table({"k": pa.array([1, 2]),
                               "name": pa.array([1, 2], pa.time32("s"))}),
                     p)
    with pytest.raises(NotImplementedError, match="'name'"):
        GpuSession(device="cpu").read.parquet(p)
    q = str(tmp_path / "s.csv")
    with open(q, "w") as f:
        f.write("k,name\n1,12:34:56\n")
    with pytest.raises(NotImplementedError, match="'name'"):
        GpuSession(device="cpu").read.csv(q)


def test_missing_files_and_unknown_format(tmp_path):
    s = GpuSession(device="cpu")
    with pytest.raises(FileNotFoundError):
        s.read.parquet(str(tmp_path / "*.parquet"))
    p = str(tmp_path / "t.parquet")
    papq.write_table(flat_table(10), p)
    from spark_rapids_tpu_torch.config import RapidsConf
    scan = pscan.FileScanExec("hivetext", [p], ["k"], [pt.INT], {},
                              RapidsConf())
    with pytest.raises(ValueError):
        scan._read_file(p)


def test_empty_file_gives_one_empty_batch(tmp_path):
    t = flat_table(10).slice(0, 0)
    p = str(tmp_path / "empty.parquet")
    papq.write_table(t, p)
    _, got, _, port = both(lambda s, col, F: s.read.parquet(p).select(
        "k", "v"))
    assert got.num_rows == 0 and got.schema.names == ["k", "v"]
    from spark_rapids_tpu_torch.exec.base import ExecContext
    (scan,) = scans(port)
    batches = list(scan.execute_partition(0, ExecContext("cpu",
                                                         port.conf)))
    assert len(batches) == 1 and batches[0].num_rows == 0


def test_batch_size_rows_cuts_batches(tmp_path):
    t = flat_table(100)
    p = str(tmp_path / "t.parquet")
    papq.write_table(t, p)
    conf = {"spark.rapids.sql.reader.batchSizeRows": 30, PIN: False}
    _, got, _, port = both(lambda s, col, F: s.read.parquet(p).select(
        "k", "v", "f", "b"), conf, ignore_order=False)
    assert got.equals(t)
    from spark_rapids_tpu_torch.exec.base import ExecContext
    (scan,) = scans(port)
    rows = [b.num_rows for b in scan.execute_partition(
        0, ExecContext("cpu", port.conf))]
    assert rows == [30, 30, 30, 10]


def test_scan_disabled_stays_on_cpu(tmp_path):
    t = flat_table()
    paths = write_parquet_files(tmp_path, t, 3)
    conf = {"spark.rapids.sql.format.parquet.enabled": False}

    def q(spark, col, F):
        return spark.read.parquet(*paths).filter(col("f") < 0.5) \
            .group_by(col("k")).agg(F.sum(col("v")).alias("sv"))
    _, _, ref, port = both(q, conf)
    (rs,), (ps,) = scans(ref), scans(port)
    assert rs.placement == "cpu" and ps.placement == "cpu"
    assert "parquet scan disabled by config" in port.last_explain
    placed = []
    port.last_plan.foreach(lambda e: placed.append(
        (type(e).__name__, e.placement)))
    assert ("HostToDeviceExec", "gpu") in placed
    assert all(p == "gpu" for n, p in placed
               if n not in ("FileScanExec", "DeviceToHostExec"))
    # the other formats' keys
    src = str(tmp_path / "a.orc")
    paorc.write_table(t, src)
    _, _, _, port = both(lambda s, col, F: s.read.orc(src).filter(
        col("k") > 3), {"spark.rapids.sql.format.orc.enabled": False})
    assert scans(port)[0].placement == "cpu"
    assert "orc scan disabled by config" in port.last_explain


# ---------------------------------------------------------------------------
# writing: round trips, partitioning, modes, options
# ---------------------------------------------------------------------------

def _read_dir(path, fmt="parquet"):
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(path)
                   for f in fs if f.endswith("." + fmt))
    read = {"parquet": papq.read_table,
            "orc": lambda f: paorc.ORCFile(f).read(),
            "csv": pacsv.read_csv}[fmt]
    return pa.concat_tables([read(f) for f in files]), files


def test_parquet_roundtrip_write(tmp_path):
    t = flat_table()
    src = str(tmp_path / "src.parquet")
    papq.write_table(t, src)
    for name, session in zip(("ref", "port"), sessions()):
        out = str(tmp_path / f"out_{name}")
        session.read.parquet(src).write.mode("overwrite").parquet(out)
        back = session.read.parquet(out).collect()
        assert back.equals(t), name
    assert _read_dir(str(tmp_path / "out_port"))[0].equals(
        _read_dir(str(tmp_path / "out_ref"))[0])


@pytest.mark.parametrize("fmt", ["orc", "csv"])
def test_other_format_roundtrip_write(tmp_path, fmt):
    t = flat_table(200)
    s = GpuSession(device="cpu")
    out = str(tmp_path / "out")
    getattr(s.create_dataframe(t).filter(pcol("v") > 0).write, fmt)(out)
    back, files = _read_dir(out, fmt)
    want = t.filter(pc.greater(t["v"], 0))
    assert len(files) == 1 and back.num_rows == want.num_rows
    if fmt == "orc":
        assert back.equals(want)
        assert s.read.orc(out).collect().equals(want)
    else:
        assert back.column("v").to_pylist() == want.column("v").to_pylist()


def test_partitioned_write_with_null_key(tmp_path):
    t = flat_table(300)
    listings = {}
    for name, session in zip(("ref", "port"), sessions()):
        out = str(tmp_path / f"p_{name}")
        w = session.create_dataframe(t).write.mode("overwrite")
        w.partition_by("b").parquet(out)
        listings[name] = sorted(os.listdir(out))
        if name == "port":
            assert sorted(w.stats.partitions) == sorted(
                os.path.join(out, d) for d in listings[name])
            assert w.stats.num_rows == t.num_rows
            assert w.stats.num_files == 3 and w.stats.num_bytes > 0
    assert listings["port"] == listings["ref"] == [
        "b=False", "b=True", "b=__HIVE_DEFAULT_PARTITION__"]
    back, _ = _read_dir(str(tmp_path / "p_port" /
                            "b=__HIVE_DEFAULT_PARTITION__"))
    nulls = t.filter(pc.is_null(t["b"]))
    assert back.equals(nulls.drop_columns(["b"]))


def test_partitioned_write_read_roundtrip(tmp_path):
    """The reader finds the files under k=<v>/ (recursive); the key
    column itself is not in the files."""
    t = flat_table(300)
    out = str(tmp_path / "part_out")
    s = GpuSession(device="cpu")
    s.create_dataframe(t).write.partition_by("k").parquet(out)
    back = s.read.parquet(out).collect()
    assert back.num_rows == t.num_rows
    assert back.schema.names == ["v", "f", "b"]
    assert len(os.listdir(out)) == len(set(t.column("k").to_pylist()))


def test_write_modes_match_reference(tmp_path):
    t = flat_table(50)
    results = {}
    for name, session in zip(("ref", "port"), sessions()):
        out = str(tmp_path / f"m_{name}")
        df = session.create_dataframe(t)
        df.write.parquet(out)                         # default: error
        for mode in ("error", "errorifexists"):
            with pytest.raises(FileExistsError):
                df.write.mode(mode).parquet(out)
        df.write.mode("append").parquet(out)
        after_append = _read_dir(out)
        df.write.mode("ignore").parquet(out)
        after_ignore = _read_dir(out)
        assert after_ignore[1] == after_append[1]
        small = session.create_dataframe(t.slice(0, 5))
        small.write.mode("overwrite").parquet(out)
        results[name] = (after_append[0].num_rows, len(after_append[1]),
                         _read_dir(out)[0])
    assert results["port"][:2] == results["ref"][:2] == (100, 2)
    assert results["port"][2].equals(results["ref"][2])
    assert results["port"][2].equals(t.slice(0, 5))
    with pytest.raises(ValueError):
        GpuSession(device="cpu").create_dataframe(t).write.mode("upsert")


@pytest.mark.parametrize("codec", [None, "zstd", "none"])
def test_write_compression_option(tmp_path, codec):
    t = flat_table(50)
    out = str(tmp_path / "c")
    w = GpuSession(device="cpu").create_dataframe(t).write
    if codec is not None:
        w = w.option("compression", codec)
    w.parquet(out)
    back, (f,) = _read_dir(out)
    assert back.equals(t)
    want = {None: "SNAPPY", "zstd": "ZSTD", "none": "UNCOMPRESSED"}[codec]
    assert papq.ParquetFile(f).metadata.row_group(0).column(0) \
        .compression == want


# ---------------------------------------------------------------------------
# the device pin
# ---------------------------------------------------------------------------

def _pin_query(s, p):
    return (s.read.parquet(p).group_by(pcol("k"))
            .agg(PF.sum(pcol("v")).alias("sv")).collect().sort_by("k"))


def _spy_reads(monkeypatch):
    calls = []
    orig = pscan.FileScanExec._read_file

    def spy(self, path):
        calls.append(path)
        return orig(self, path)
    monkeypatch.setattr(pscan.FileScanExec, "_read_file", spy)
    return calls


def test_filescan_device_pin_reuses_and_invalidates(tmp_path, monkeypatch):
    """Repeated queries reuse the pinned batches; a rewritten file (new
    size or mtime) changes the key and is read again."""
    p = str(tmp_path / "pin.parquet")
    tb = pa.table({"k": pa.array(np.arange(100, dtype=np.int64) % 7),
                   "v": pa.array(np.arange(100, dtype=np.int64))})
    papq.write_table(tb, p)
    s = GpuSession(device="cpu")
    out1 = _pin_query(s, p)
    assert len(pscan._FILESCAN_PIN) == 1
    (key,) = pscan._FILESCAN_PIN
    assert key[-1] == "cpu" and key[1][0][0] == p
    calls = _spy_reads(monkeypatch)
    out2 = _pin_query(s, p)
    assert calls == [], "a pinned scan must not read the file again"
    assert out1.equals(out2)
    tb2 = pa.table({"k": pa.array(np.arange(50, dtype=np.int64) % 7),
                    "v": pa.array(np.arange(50, dtype=np.int64))})
    papq.write_table(tb2, p)
    out3 = _pin_query(s, p)
    assert calls == [p], "a changed file must be read again"
    assert sum(out3.column("sv").to_pylist()) == sum(range(50))
    # the reference over the same rewritten file agrees
    ref, _ = sessions()
    want = (ref.read.parquet(p).group_by(rcol("k"))
            .agg(RF.sum(rcol("v")).alias("sv")).collect().sort_by("k"))
    assert want.equals(out3)


def test_filescan_pin_off_and_cpu_scan_read_every_time(tmp_path,
                                                       monkeypatch):
    p = str(tmp_path / "pin.parquet")
    papq.write_table(flat_table(100), p)
    calls = _spy_reads(monkeypatch)
    for conf in ({PIN: False},
                 {"spark.rapids.sql.format.parquet.enabled": False},
                 {"spark.rapids.sql.enabled": False}):
        calls.clear()
        s = GpuSession(device="cpu", conf=conf)
        _pin_query(s, p)
        _pin_query(s, p)
        assert calls == [p, p], conf
        assert not pscan._FILESCAN_PIN


def test_filescan_pin_keys_on_shape(tmp_path, monkeypatch):
    """Other columns, filters or reader shapes are other keys; the
    pinned batches replay their input file."""
    t = flat_table(100)
    paths = write_parquet_files(tmp_path, t, 2)
    s = GpuSession(device="cpu")
    s.read.parquet(*paths).collect()
    s.read.parquet(*paths).select("k").collect()
    s.read.parquet(*paths).filter(pcol("k") > 3).collect()
    GpuSession(device="cpu", conf={READER: "PERFILE"}).read.parquet(
        *paths).collect()
    assert len(pscan._FILESCAN_PIN) == 1 + 1 + 1 + 2
    calls = _spy_reads(monkeypatch)
    got = s.read.parquet(*paths).filter(pcol("k") > 3).collect()
    assert calls == []
    keep = pc.fill_null(pc.greater(t["k"], 3), False)
    assert got.equals(t.filter(keep))
    # a pinned partition replays its input file
    from spark_rapids_tpu_torch.exec.base import ExecContext
    (scan,) = scans(s)
    pscan.set_current_input_file("")
    list(scan.execute_partition(0, ExecContext("cpu", s.conf)))
    assert calls == []
    assert pscan.current_input_file() == ",".join(paths)


def test_filescan_pin_holds_its_byte_budget(tmp_path, monkeypatch):
    """The pin drops its least recently used keys to stay under its
    budget, and does not pin a partition larger than the budget."""
    t = flat_table(100)
    paths = write_parquet_files(tmp_path, t, 3)
    s = GpuSession(device="cpu", conf={READER: "PERFILE"})
    s.read.parquet(paths[0]).collect()
    (key0,) = pscan._FILESCAN_PIN
    one = pscan._PIN_BYTES[key0]
    monkeypatch.setattr(pscan, "_PIN_BUDGET_BYTES", 2 * one)
    s.read.parquet(paths[1]).collect()
    s.read.parquet(paths[0]).collect()      # a hit: key0 is newest now
    calls = _spy_reads(monkeypatch)
    s.read.parquet(paths[2]).collect()      # drops paths[1]'s key
    assert calls == [paths[2]]
    assert len(pscan._FILESCAN_PIN) == 2 and key0 in pscan._FILESCAN_PIN
    assert sum(pscan._PIN_BYTES.values()) <= 2 * one
    got = s.read.parquet(paths[0]).collect()
    assert calls == [paths[2]]
    assert got.equals(papq.read_table(paths[0]))
    s.read.parquet(paths[1]).collect()
    assert calls == [paths[2], paths[1]]
    monkeypatch.setattr(pscan, "_PIN_BUDGET_BYTES", one - 1)
    pscan.clear_filescan_pin()
    s.read.parquet(paths[0]).collect()
    assert not pscan._FILESCAN_PIN and not pscan._PIN_BYTES
