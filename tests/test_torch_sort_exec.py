"""The port's global sort, TopN and projection against the reference, on
the CPU.

Queries run through the reference's TpuSession and the port's
GpuSession(device="cpu") on the same tables (the reference's data
generators, or numpy draws from a seed), and the two results are
compared with the reference's assert_tables_equal with the row order
kept: a sort must agree row for row, ties in arrival order.  The
reference's single-device exchange fusion is forced on
(spark.rapids.tpu.singleChipFuse=on; its tests see 8 CPU devices), as
the port's is whenever it drives one device.  Below the sessions: the
port's sort key words against the reference's ``key_words_for_column``
words, K8's plain version against ``index_select``, range partitioning
against the reference's numpy branch, and the sort and limit operators'
determinism declarations.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.exec import basic as rbasic
from spark_rapids_tpu.exec import sort as rsort
from spark_rapids_tpu.expr.core import AttributeReference as RA
from spark_rapids_tpu.expr.core import EvalContext as REval
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu.shuffle import partitioning as rpart
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (DoubleGen, IntegerGen,
                                               LongGen, gen_table)
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.exec import basic as pbasic
from spark_rapids_tpu_torch.exec import sort as psort
from spark_rapids_tpu_torch.expr.core import AttributeReference as PA
from spark_rapids_tpu_torch.expr.core import EvalContext as PEval
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import gather as pgather
from spark_rapids_tpu_torch.ops import segmented as pseg
from spark_rapids_tpu_torch.shuffle import partitioning as ppart

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


def sessions(conf=None):
    conf = dict(conf or {})
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def both(table, query, partitions=1, conf=None):
    """Each package's collect of ``query(df, col)``, compared in order;
    returns the two sessions."""
    ref, port = sessions(conf)
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 rcol).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                pcol).collect()
    assert_tables_equal(want, got, ignore_order=False)
    return ref, port


def shape(session):
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return nodes


# ---------------------------------------------------------------------------
# tests/test_sort.py's flat-type cases, through both sessions
# ---------------------------------------------------------------------------

def test_sort_int_asc():
    t = gen_table([("a", IntegerGen()), ("b", LongGen())], 512, 0)
    both(t, lambda df, col: df.order_by(col("a"), col("b")))


def test_sort_desc_and_nulls():
    t = gen_table([("a", IntegerGen(null_prob=0.3)), ("b", LongGen())],
                  512, 0)
    both(t, lambda df, col: df.order_by(col("a").desc(), col("b").asc()))


def test_sort_doubles_with_nan():
    t = gen_table([("d", DoubleGen()), ("x", IntegerGen())], 512, 0)
    both(t, lambda df, col: df.order_by(col("d"), col("x")))


def test_sort_multi_partition_global():
    t = gen_table([("a", IntegerGen()), ("b", LongGen())], 1024, 0)
    ref, port = both(t, lambda df, col: df.order_by(col("a"), col("b")),
                     partitions=4)
    assert shape(port) == shape(ref) == [
        ("DeviceToHostExec", "cpu"), ("CoalesceBatchesExec", "gpu"),
        ("SortExec", "gpu"), ("GatherPartitionsExec", "gpu"),
        ("LocalScanExec", "gpu")]


def test_sort_strings_are_not_ported():
    """Strings have been ported since this test was written: a sort by a
    string column now runs on the GPU path and equals the reference's
    row for row (tests/test_torch_strings.py holds the full parity)."""
    t = pa.table({"s": pa.array(["b", "a", None, "ab", ""]),
                  "x": pa.array([1, 2, 3, 4, 5], type=pa.int32())})
    ref, port = both(t, lambda df, col: df.order_by(col("s"), col("x")))
    assert shape(port) == shape(ref)


# ---------------------------------------------------------------------------
# orders, nulls and special doubles, one partition and four, both engines
# ---------------------------------------------------------------------------

def special_table(seed, n=700):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n)
    pick = rng.random(n)
    d = np.where(pick < 0.05, np.nan, d)
    d = np.where((pick >= 0.05) & (pick < 0.1), -0.0, d)
    d = np.where((pick >= 0.1) & (pick < 0.15), 0.0, d)
    d = np.where((pick >= 0.15) & (pick < 0.2), np.inf, d)
    d = np.where((pick >= 0.2) & (pick < 0.25), -np.inf, d)
    i = rng.integers(-20, 20, n).astype(np.int32)
    l = rng.choice(np.array([-2**63, 2**63 - 1, -1, 0, 1, 5],
                            dtype=np.int64), n)
    return pa.table({
        "i": pa.array(i, mask=rng.random(n) < 0.15),
        "d": pa.array(d, mask=rng.random(n) < 0.1),
        "l": pa.array(l, mask=rng.random(n) < 0.05),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })


ORDERS = {
    "asc": lambda c: [c("i"), c("d")],
    "desc": lambda c: [c("i").desc(), c("d").desc()],
    "asc_nulls_last": lambda c: [c("d").asc_nulls_last(), c("i")],
    "desc_nulls_first": lambda c: [c("d").desc_nulls_first(),
                                   c("i").desc_nulls_first()],
    "long_extremes": lambda c: [c("l").desc(), c("b").asc_nulls_last()],
    "boolean": lambda c: [c("b").desc(), c("l")],
}


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_sort_orders_and_nulls(order, partitions):
    both(special_table(3), lambda df, col: df.order_by(*ORDERS[order](col)),
         partitions=partitions)


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("order", ["desc", "asc_nulls_last"])
def test_sort_cpu_engine(order, partitions):
    """Every operator CPU-placed: the range exchange runs on the host."""
    ref, port = both(special_table(4),
                     lambda df, col: df.order_by(*ORDERS[order](col)),
                     partitions=partitions,
                     conf={"spark.rapids.sql.enabled": False})
    assert all(p == "cpu" for _, p in shape(port))
    if partitions > 1:
        assert ("ShuffleExchangeExec", "cpu") in shape(port)


@pytest.mark.parametrize("ascending", [True, False, [True, False]])
def test_order_by_ascending_argument(ascending):
    both(special_table(5),
         lambda df, col: df.order_by("i", "d", ascending=ascending))


@pytest.mark.parametrize("partitions", [1, 3])
def test_sort_within_partitions(partitions):
    both(special_table(6),
         lambda df, col: df.sort_within_partitions(col("d"), col("i"),
                                                   ascending=False),
         partitions=partitions)


# ---------------------------------------------------------------------------
# TopN, limit, select and with_column
# ---------------------------------------------------------------------------

TOPN = [
    (1, 10), (4, 10), (4, 0), (4, 2000), (1, 1),
]


@pytest.mark.parametrize("partitions,n", TOPN)
def test_topn(partitions, n):
    ref, port = both(special_table(7),
                     lambda df, col: df.sort(col("d").desc(),
                                             col("row")).limit(n),
                     partitions=partitions)
    assert shape(port) == shape(ref)
    names = [name for name, _ in shape(port)]
    assert names[2:5] == ["GlobalLimitExec", "SortExec",
                          "GatherPartitionsExec" if partitions > 1
                          else "LocalLimitExec"]


@pytest.mark.parametrize("partitions", [1, 4])
def test_limit_without_sort(partitions):
    ref, port = both(special_table(8),
                     lambda df, col: df.limit(25), partitions=partitions)
    assert shape(port) == shape(ref)


SELECTS = {
    "columns": lambda df, col: df.select(col("row"), col("d")),
    "star": lambda df, col: df.select("*"),
    "predicate": lambda df, col: df.select(
        col("row"), (col("i") > 0).alias("pos")),
    "with_column_new": lambda df, col: df.with_column("big", col("l") > 1),
    "with_column_replace": lambda df, col: df.with_column(
        "i", col("row") <= 100),
    "select_then_sort": lambda df, col: df.select(
        col("d"), col("row")).order_by(col("d").desc()).limit(50),
}


@pytest.mark.parametrize("query", sorted(SELECTS))
def test_select_and_with_column(query):
    ref, port = both(special_table(9), SELECTS[query])
    assert shape(port) == shape(ref)


def test_unported_expression_raises():
    """Arithmetic and casts to string are ported now; a cast to binary
    is not."""
    df = GpuSession(device="cpu").create_dataframe(special_table(1))
    with pytest.raises(NotImplementedError):
        df.select(pcol("i").cast("binary")).collect()


# ---------------------------------------------------------------------------
# plans and explain lines against the reference's
# ---------------------------------------------------------------------------

PLANS = {
    "sort": (1, lambda df, col: df.order_by(col("i"))),
    "sort_4": (4, lambda df, col: df.order_by(col("i").desc())),
    "topn_4": (4, lambda df, col: df.order_by(col("d")).limit(3)),
    "limit_4": (4, lambda df, col: df.limit(3)),
    "select_sort": (1, lambda df, col: df.select(col("i")).order_by(
        col("i"))),
}


CONFS = {"gpu": {}, "cpu_engine": {"spark.rapids.sql.enabled": False},
         "sort_disabled": {"spark.rapids.sql.exec.SortExec": False}}
# a disabled sort over the range exchange: test_sort_disabled_over_exchange
PLAN_CASES = [(name, conf) for name in sorted(PLANS) for conf in CONFS
              if (name, conf) != ("sort_4", "sort_disabled")]


@pytest.mark.parametrize("name,conf", PLAN_CASES)
def test_plans_and_explain_match_reference(name, conf):
    partitions, query = PLANS[name]
    ref, port = both(special_table(2), query, partitions=partitions,
                     conf=CONFS[conf])
    assert shape(port) == shape(ref)
    assert port.last_explain == ref.last_explain.replace("TPU", "GPU")


def test_sort_disabled_over_exchange():
    """A CPU sort over the range exchange: the reference places the
    exchange on its device and reads it through its AQE reader (not
    ported), which hands equal keys over in another order than they
    arrived; the port's exchange runs on the host and keeps arrival
    order, so its result is the reference CPU engine's, row for row."""
    t = special_table(2)
    _, port = sessions({"spark.rapids.sql.exec.SortExec": False})
    cpu, _ = sessions({"spark.rapids.sql.enabled": False})
    want = cpu.create_dataframe(t, num_partitions=4).order_by(
        rcol("i").desc()).collect()
    got = port.create_dataframe(t, num_partitions=4).order_by(
        pcol("i").desc()).collect()
    assert_tables_equal(want, got, ignore_order=False)
    assert shape(port) == [("SortExec", "cpu"), ("ShuffleExchangeExec", "cpu"),
                           ("DeviceToHostExec", "cpu"),
                           ("LocalScanExec", "gpu")]
    assert port.last_explain.splitlines() == [
        "!Exec <SortExec> cannot run on GPU because SortExec has been "
        "disabled by config",
        "  !Exec <ShuffleExchangeExec> cannot run on GPU because the "
        "shuffle exchange runs on the host only (its consumer SortExec "
        "stays on the CPU)",
        "    *Exec <LocalScanExec> will run on GPU"]


def test_sort_with_fusion_off_stays_on_the_cpu():
    """With spark.rapids.tpu.singleChipFuse=off the range exchange stays,
    and it runs on the host only: its consumer stays on the CPU."""
    conf = {"spark.rapids.tpu.singleChipFuse": "off"}
    port = GpuSession(device="cpu", conf=conf)
    t = special_table(2)
    want = TpuSession.builder().get_or_create().create_dataframe(
        t, num_partitions=4).order_by(rcol("i")).collect()
    got = port.create_dataframe(t, num_partitions=4).order_by(
        pcol("i")).collect()
    assert_tables_equal(want, got, ignore_order=False)
    assert ("SortExec", "cpu") in shape(port)
    assert ("ShuffleExchangeExec", "cpu") in shape(port)
    assert "singleChipFuse=off" in port.last_explain


# ---------------------------------------------------------------------------
# sort key words against the reference's
# ---------------------------------------------------------------------------

WORD_DATA = {
    "long": pa.array(np.array([-2**63, 2**63 - 1, -2**63 + 1, 2**63 - 2,
                               -1, 0, 1, 7, 0, -5], dtype=np.int64),
                     mask=np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 0], bool)),
    "int": pa.array(np.array([-2**31, 2**31 - 1, -1, 0, 1, 3, 0, -7],
                             dtype=np.int32),
                    mask=np.array([0, 0, 0, 0, 0, 0, 1, 0], bool)),
    "double": pa.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.5,
                        None, 5e-324, -1e308]),
    "boolean": pa.array([True, False, None, True, False]),
}


def _words(name):
    rb = pa.RecordBatch.from_arrays([WORD_DATA[name]], names=["x"])
    return (rdev.batch_to_device(rb, xp=np), pdev.batch_to_device(rb, "cpu"))


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("name", sorted(WORD_DATA))
def test_sort_key_words_match_reference(name, ascending, nulls_first):
    """The null word is the reference's exactly; a 64-bit value word is
    the reference's XOR 2^63 (so ``~`` of it is the reference's ``~``);
    a narrow value word differs from the reference's by one constant,
    so it orders the rows the same."""
    rb_, pb = _words(name)
    rcol_, pcol_ = rb_.columns[0], pb.columns[0]
    live = np.arange(rb_.capacity) < rb_.num_rows
    ref = rseg.key_words_for_column(np, rcol_, live, for_grouping=False,
                                    nulls_first=nulls_first,
                                    ascending=ascending)
    port = pseg.sort_key_words(pcol_, ascending, nulls_first)
    assert len(ref) == len(port) == 2
    assert np.array_equal(ref[0].astype(np.int64), port[0].numpy())
    r, p = ref[1], port[1].numpy()
    if r.dtype == np.uint64:
        assert np.array_equal((r ^ np.uint64(2**63)).view(np.int64), p)
    else:
        diff = p - r.astype(np.int64)
        assert np.all(diff == diff[0])
    # the two word lists give the same stable order
    order_ref = np.lexsort(tuple(reversed(ref)))
    order_port = pcarry.sort_order_plain(port).numpy()
    assert np.array_equal(order_ref, order_port)


@pytest.mark.parametrize("name", sorted(WORD_DATA))
def test_grouping_words_are_ascending_nulls_first(name):
    _, pb = _words(name)
    c = pb.columns[0]
    assert all(torch.equal(a, b) for a, b in zip(
        pseg.key_words_for_column(c), pseg.sort_key_words(c, True, True)))


def test_sort_key_words_of_unported_type_raise():
    c = pdev.DeviceColumn(pdev.t.NULL, torch.zeros(4, dtype=torch.int8),
                          torch.zeros(4, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        pseg.sort_key_words(c, False, False)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_sort_exec_order_matches_reference(seed):
    """SortExec's batch (padding word included) against the reference's
    numpy branch, on a batch with padding rows."""
    t = special_table(seed, n=900)
    rb = t.combine_chunks().to_batches()[0]
    orders_r = [(RA("d"), False, True), (RA("i"), True, False)]
    orders_p = [(PA("d"), False, True), (PA("i"), True, False)]
    rs = rsort.SortExec(orders_r, rbasic.LocalScanExec(t))
    ps = psort.SortExec(orders_p, pbasic.LocalScanExec(t))
    want = rdev.batch_to_arrow(rs._sort_batch(
        np, rdev.batch_to_device(rb, xp=np)))
    got = pdev.batch_to_arrow(ps.sort_batch(pdev.batch_to_device(rb, "cpu")))
    assert_tables_equal(pa.Table.from_batches([want]),
                        pa.Table.from_batches([got]), ignore_order=False)


# ---------------------------------------------------------------------------
# K8's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int32,
                                   torch.int64, torch.float64])
@pytest.mark.parametrize("n", [0, 1, 17, 1000])
def test_gather_rows_plain_matches_index_select(dtype, n):
    rng = np.random.default_rng(n)
    m = max(n, 1) * 2
    lanes = [torch.from_numpy(rng.integers(-100, 100, m)).to(dtype)
             for _ in range(3)]
    order = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    for got, lane in zip(pgather.gather_rows(order, lanes), lanes):
        assert torch.equal(got, lane.index_select(0, order.long()))


def test_gather_rows_many_lanes_and_identity_and_reverse():
    lanes = [torch.arange(40, dtype=torch.int64) * k for k in range(20)]
    ident = torch.arange(40, dtype=torch.int32)
    rev = torch.flip(ident, [0])
    assert all(torch.equal(a, b) for a, b in zip(
        pgather.gather_rows(ident, lanes), lanes))
    assert all(torch.equal(a, torch.flip(b, [0])) for a, b in zip(
        pgather.gather_rows(rev, lanes), lanes))


def test_gather_rows_takes_an_int32_order():
    with pytest.raises(TypeError):
        pgather.gather_rows(torch.arange(3), [torch.arange(3)])


def test_sort_rows_gathers_columns_and_extras():
    words = [torch.tensor([3, 1, 2, 1], dtype=torch.int64)]
    col = pdev.DeviceColumn(pdev.t.LONG, torch.tensor([30, 10, 20, 11]),
                            torch.tensor([True, True, False, True]))
    order, cols, extras = pcarry.sort_rows(
        words, [col], [torch.tensor([0, 1, 2, 3], dtype=torch.int32)])
    assert order.tolist() == [1, 3, 2, 0]
    assert cols[0].data.tolist() == [10, 11, 20, 30]
    assert cols[0].validity.tolist() == [True, True, False, True]
    assert extras[0].tolist() == [1, 3, 2, 0]


# ---------------------------------------------------------------------------
# range partitioning against the reference's numpy branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4, 7])
@pytest.mark.parametrize("order", ["asc", "desc_nulls_first", "two_keys"])
def test_range_partitioning_matches_reference(order, parts):
    cols = {"asc": [("i", True, True)],
            "desc_nulls_first": [("d", False, True)],
            "two_keys": [("i", False, False), ("d", True, True)]}[order]
    t = special_table(parts)
    names = t.column_names
    rp = rpart.RangePartitioning([(RA(c), a, nf) for c, a, nf in cols],
                                 parts)
    pp = ppart.RangePartitioning([(PA(c), a, nf) for c, a, nf in cols],
                                 parts)
    rp = rp.bind(names, [rdev.batch_to_device(
        t.slice(0, 1).combine_chunks().to_batches()[0], xp=np).columns[j]
        .dtype for j in range(len(names))])
    pp = pp.bind(names, pbasic.LocalScanExec(t).output_types)
    # the bounds come from the first batch; later batches only route
    for start, length in ((0, 400), (400, 300)):
        rb = t.slice(start, length).combine_chunks().to_batches()[0]
        rbatch = rdev.batch_to_device(rb, xp=np)
        pbatch = pdev.batch_to_device(rb, "cpu")
        want = rp.partition_ids(np, REval(np, rbatch), rbatch)
        got = pp.partition_ids(PEval(pbatch), pbatch)
        live = rb.num_rows
        assert np.array_equal(np.asarray(want)[:live], got.numpy()[:live])


# ---------------------------------------------------------------------------
# determinism declarations
# ---------------------------------------------------------------------------

FLAGS = ("cls", "order_sensitive_selection", "establishes_order",
         "partition_scoped", "canonicalizable")


def _decl(e):
    d = e.determinism()
    return None if d is None else tuple(getattr(d, f) for f in FLAGS)


@pytest.mark.parametrize("which", ["sort_global", "sort_local",
                                   "local_limit", "global_limit"])
def test_determinism_matches_reference(which):
    t = special_table(0, n=20)

    def build(basic, sort, A):
        scan = basic.LocalScanExec(t)
        return {
            "sort_global": lambda: sort.SortExec([(A("i"), True, True)],
                                                 scan),
            "sort_local": lambda: sort.SortExec([(A("i"), False, False)],
                                                scan, is_global=False),
            "local_limit": lambda: basic.LocalLimitExec(5, scan),
            "global_limit": lambda: basic.GlobalLimitExec(5, scan),
        }[which]()
    assert _decl(build(pbasic, psort, PA)) == _decl(build(rbasic, rsort, RA))
