"""Decimals in the port against the reference, on the CPU.

Every test of tests/test_decimal.py runs through the reference's
TpuSession and the port's GpuSession(device="cpu") on the same table
(made from a seed with numpy); the two results are compared exactly with
the reference's ``assert_tables_equal`` and the two plans' placements
are compared operator for operator ("Tpu" read as "Gpu").  Beside them:
the plain ``segment_sum128`` and ``segment_extreme128`` against the
reference's numpy branch on values near +-2^63 and +-10^37 with carries
across the low word, K3's plain version on 128-bit sums, mins and maxes
with ties, the int128 helpers against Python ints, TPC-H Q1 over real
dates and decimals at a small size (q1d as the reference keeps it on its
device, and the Q1 text with the reference's placements), and the two
decimal behaviours the port pins: a join of DECIMAL128 keys that differ
only in their high words, and a sum past 38 digits.
"""

import datetime
import decimal
import random

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import arithmetic as rar
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.expr import arithmetic as par
from spark_rapids_tpu_torch.ops import int128 as i128
from spark_rapids_tpu_torch.ops import segmented as pseg

D = decimal.Decimal
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
REF = (RF, rcol, rlit, rt)
PORT = (PF, pcol, plit, pt)


def _sessions(enabled=True):
    b = TpuSession.builder().config("spark.rapids.sql.enabled", enabled)
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(
        device="cpu", conf={"spark.rapids.sql.enabled": enabled})


def shape(session):
    """(operator, placement) top-down, the reference's names read as the
    port's."""
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return [n for n in nodes
            if n[0] not in ("AQEShuffleReadExec", "_SkewAwareRead")]


def host_exchanges(nodes):
    """The reference's plan as the port places it: a shuffle exchange
    under a CPU consumer runs on the host, below the download."""
    nodes = list(nodes)
    for i in range(len(nodes) - 1):
        if nodes[i:i + 3] == [("DeviceToHostExec", "cpu"),
                              ("ShuffleExchangeExec", "gpu"),
                              ("HostToDeviceExec", "gpu")]:
            # over a CPU child the exchange needs no transition at all
            nodes[i:i + 3] = [("ShuffleExchangeExec", "cpu")]
        elif nodes[i:i + 2] == [("DeviceToHostExec", "cpu"),
                                ("ShuffleExchangeExec", "gpu")]:
            nodes[i:i + 2] = [("ShuffleExchangeExec", "cpu"),
                              ("DeviceToHostExec", "cpu")]
    return nodes


def run_both(table, query, partitions=1, enabled=True, order=False):
    """Both packages' results of ``query(df, F, col, lit, types)``,
    compared exactly, and both plans' placements; returns the port's
    result and session."""
    ref, port = _sessions(enabled)
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 *REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                *PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=not order)
    assert shape(port) == host_exchanges(shape(ref))
    return got, port


def _dec_table(n=400, precision=12, scale=2, seed=0, null_every=7):
    rng = np.random.default_rng(seed)
    lim = 10 ** (precision - scale) - 1
    vals = [None if i % null_every == 0 else
            D(int(rng.integers(-lim, lim))).scaleb(-scale) +
            D(int(rng.integers(0, 10 ** scale))).scaleb(-scale)
            for i in range(n)]
    return pa.table({
        "k": pa.array((rng.integers(0, 20, n)).astype(np.int64)),
        "d": pa.array(vals, type=pa.decimal128(precision, scale)),
    })


# ---------------------------------------------------------------------------
# the 13 tests of tests/test_decimal.py
# ---------------------------------------------------------------------------

def test_decimal_project_filter_roundtrip():
    tb = _dec_table()

    def q(df, F, col, lit, T):
        return df.select(col("k"), (col("d") + col("d")).alias("dd"),
                         (col("d") * lit(2)).alias("d2")) \
            .filter(col("k") >= 0)
    got, port = run_both(tb, q, order=True)
    want = [None if v is None else v * 2 for v in
            tb.column("d").to_pylist()]
    assert got.column("dd").to_pylist() == want
    assert any(p == "gpu" for _, p in shape(port))


def test_decimal_sum_exact_beyond_64_bits():
    n = 3000
    tb = pa.table({"k": pa.array([1] * n),
                   "d": pa.array([D("9999999999999999.99")] * n,
                                 type=pa.decimal128(18, 2))})
    got, port = run_both(tb, lambda df, F, col, lit, T: df.group_by(
        col("k")).agg(F.sum(col("d")).alias("sd")))
    assert got.column("sd").to_pylist() == [D("9999999999999999.99") * n]
    assert ("GpuHashAggregateExec", "gpu") in shape(port)


def test_decimal_group_agg_differential():
    tb = _dec_table(600)
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.group_by(
        col("k")).agg(F.sum(col("d")).alias("sd"),
                      F.min(col("d")).alias("mn"),
                      F.max(col("d")).alias("mx"),
                      F.count(col("d")).alias("c")))
    want = pa.TableGroupBy(tb, ["k"], use_threads=False).aggregate(
        [("d", "sum"), ("d", "min"), ("d", "max"), ("d", "count")]
    ).sort_by("k")
    got = got.sort_by("k")
    assert got.column("sd").to_pylist() == want.column("d_sum").to_pylist()
    assert got.column("mn").to_pylist() == want.column("d_min").to_pylist()
    assert got.column("mx").to_pylist() == want.column("d_max").to_pylist()


def test_decimal_sort():
    tb = _dec_table(300, null_every=11)
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.sort(col("d"),
                                                              col("k")),
                      order=True)
    vals = [v for v in got.column("d").to_pylist() if v is not None]
    assert vals == sorted(vals)


def test_decimal_group_keys_and_shuffle():
    vals = [D("1.50"), D("-2.25"), D("1.50"), None, D("-2.25"), D("1.50")]
    tb = pa.table({"d": pa.array(vals * 50, type=pa.decimal128(10, 2)),
                   "v": pa.array(list(range(300)), type=pa.int64())})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.group_by(
        col("d")).agg(F.count("*").alias("c")), partitions=4)
    assert dict(zip(got.column("d").to_pylist(),
                    got.column("c").to_pylist())) == {
        D("1.50"): 150, D("-2.25"): 100, None: 50}


def test_decimal128_expressions_fall_back_to_cpu():
    tb = pa.table({"d": pa.array([D("123456789012345678901.23")],
                                 type=pa.decimal128(30, 2))})
    got, port = run_both(tb, lambda df, F, col, lit, T: df.select(
        (col("d") + col("d")).alias("dd")))
    assert got.column("dd").to_pylist() == [D("246913578024691357802.46")]
    assert ("ProjectExec", "cpu") in shape(port)


def test_decimal128_min_max_on_gpu():
    big = [D("123456789012345678901.23"), D("-99999999999999999999.99"),
           None, D("5.00")]
    tb = pa.table({"k": pa.array([1, 1, 1, 1]),
                   "d": pa.array(big, type=pa.decimal128(30, 2))})
    got, port = run_both(tb, lambda df, F, col, lit, T: df.group_by(
        col("k")).agg(F.min(col("d")).alias("mn"),
                      F.max(col("d")).alias("mx")))
    assert got.column("mn").to_pylist() == [D("-99999999999999999999.99")]
    assert got.column("mx").to_pylist() == [D("123456789012345678901.23")]
    assert ("GpuHashAggregateExec", "gpu") in shape(port)


def test_decimal_cast_to_double_and_string():
    """The casts to double and to string run in both, on the device."""
    tb = pa.table({"d": pa.array([D("12.34"), None, D("-0.05")],
                                 type=pa.decimal128(10, 2))})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        col("d").cast("double").alias("f")), order=True)
    assert got.column("f").to_pylist() == [12.34, None, -0.05]
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        col("d").cast("string").alias("s")), order=True)
    assert got.column("s").to_pylist() == ["12.34", None, "-0.05"]


def test_decimal_cast_scale_up_to_128_exact():
    tb = pa.table({"d": pa.array([D("999999999999999999"), None],
                                 type=pa.decimal128(18, 0))})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        col("d").cast(pa.decimal128(38, 5)).alias("x"),
        col("d").cast(pa.decimal128(38, 20)).alias("y")), order=True)
    assert got.column("x").to_pylist() == [D("999999999999999999.00000"),
                                           None]
    assert got.column("y").to_pylist() == [D("999999999999999999"), None]


def test_decimal128_literal_exact_on_cpu_fallback():
    big = D("12345678901234567890123.45")
    got, port = run_both(pa.table({"x": pa.array([1])}),
                         lambda df, F, col, lit, T: df.select(
                             lit(big).alias("L")))
    assert got.column("L").to_pylist() == [big]
    assert ("ProjectExec", "cpu") in shape(port)


def test_decimal_mul_into_128_exact():
    tb = pa.table({"a": pa.array([D("123456789012.34")],
                                 type=pa.decimal128(14, 2)),
                   "b": pa.array([D("987654321098.76")],
                                 type=pa.decimal128(14, 2))})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        (col("a") * col("b")).alias("p")))
    assert got.column("p").to_pylist() == [
        D("123456789012.34") * D("987654321098.76")]


def test_decimal_cast_scale_down_half_up():
    vals = [D("1.2345"), D("-1.2345"), D("0.0050"), D("-0.0050"),
            D("99.9949"), D("99.9951"), None, D("0.0000")]
    tb = pa.table({"d": pa.array(vals, type=pa.decimal128(10, 4))})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        col("d").cast(T.DecimalType(10, 2)).alias("c")), order=True)
    half_up = D("0.01")
    assert got.column("c").to_pylist() == [
        None if v is None else
        v.quantize(half_up, rounding=decimal.ROUND_HALF_UP) for v in vals]


@pytest.mark.parametrize("enabled", [True, False])
def test_decimal_cast_scale_down_differential(enabled):
    tb = _dec_table(300, precision=12, scale=4, seed=5)
    run_both(tb, lambda df, F, col, lit, T: df.select(
        col("k"), col("d").cast(T.DecimalType(12, 1)).alias("c")),
        enabled=enabled, order=True)


# ---------------------------------------------------------------------------
# decimal division against the reference and exact Python ints
# ---------------------------------------------------------------------------

def _half_up(n: int, d: int) -> int:
    q, r = divmod(abs(n), abs(d))
    q += 2 * r >= abs(d)
    return q if (n < 0) == (d < 0) else -q


def _div_inputs(case):
    """((p1, s1), (p2, s2), numerators, divisors) of a divide case, as
    unscaled ints (None a null), made from a seed; a (p1, s1) of None is
    a LONG numerator."""
    rng = random.Random(case)
    n = 240
    if case == "d1_0_by_d15_0":
        # DECIMAL(17,16) on the device path: divisors below and above 2^46
        a = [rng.randint(-9, 9) for _ in range(n)]
        b = [None if rng.random() < 0.05 else
             rng.choice([0, rng.randint(1, 2**46 - 1),
                         rng.randint(2**46, 10**15 - 1)])
             * rng.choice([1, -1]) for _ in range(n)]
        return (1, 0), (15, 0), a, b
    if case == "d7_2_by_d5_3":
        a = [rng.randint(-10**7 + 1, 10**7 - 1) for _ in range(n)]
        b = [rng.choice([0, rng.randint(-10**5 + 1, 10**5 - 1), None])
             for _ in range(n)]
        return (7, 2), (5, 3), a, b
    if case == "ties_d3_0_by_d3_0":
        # 1/128 = 0.0078125: a tie at the quotient's 6 digits
        a = [rng.choice([1, 3, 5, 7, 9, 11, 127]) * rng.choice([1, -1])
             for _ in range(n)]
        b = [rng.choice([128, 64, 32, 256, 512, 0]) * rng.choice([1, -1])
             for _ in range(n)]
        return (3, 0), (3, 0), a, b
    if case == "d20_2_by_d20_3":
        # DECIMAL(38,23) on the CPU engine: numerators and divisors past
        # 2^64, divisors below 2^46, ties (10^24 / 2^25) and zeros
        a, b = [], []
        for _ in range(n):
            kind = rng.random()
            if kind < 0.1:
                a.append(rng.choice([1, -1, 3, -7]))
                b.append(rng.choice([2**25, -2**25]))
                continue
            if kind < 0.4:
                y = rng.randint(1, 2**46 - 1)
            elif kind < 0.7:
                y = rng.randint(2**46, 2**64)
            else:
                y = rng.randint(2**64, 10**20 - 1)
            # |quotient| = |a| 10^24 / |y| below 10^37
            x = rng.randint(0, min(10**20 - 1, y * 10**13 - 1))
            a.append(x * rng.choice([1, -1]))
            b.append(0 if rng.random() < 0.05 else y * rng.choice([1, -1]))
        return (20, 2), (20, 3), a, b
    # LONG / DECIMAL(12,2): the long as DECIMAL(20,0), DECIMAL(35,15)
    a = [rng.choice([rng.randint(-2**63, 2**63 - 1), rng.randint(-99, 99)])
         for _ in range(n)]
    b = [rng.choice([0, rng.randint(-10**12 + 1, 10**12 - 1)])
         for _ in range(n)]
    return None, (12, 2), a, b


DIV_CASES = ["d1_0_by_d15_0", "d7_2_by_d5_3", "ties_d3_0_by_d3_0",
             "d20_2_by_d20_3", "long_by_d12_2"]


@pytest.mark.parametrize("case", DIV_CASES)
def test_decimal_divide_matches_reference(case):
    """l / r through both packages at mixed scales: the placements equal,
    the port equals the exact HALF_UP quotient (a zero divisor gives
    null), and the reference equals it wherever its download is exact.
    The reference builds a decimal for Arrow with Python's default
    context (``Decimal(v).scaleb(-scale)``, 28 significant digits), so
    past 28 digits it returns the quotient rounded half to even at the
    28th digit; the test records that too (ROADMAP Queue 3)."""
    left, (p2, s2), a, b = _div_inputs(case)
    cols = {"b": pa.array([None if y is None else D(y).scaleb(-s2)
                           for y in b], pa.decimal128(p2, s2))}
    if left is None:
        p1, s1 = 20, 0
        cols["a"] = pa.array(a, pa.int64())
    else:
        p1, s1 = left
        cols["a"] = pa.array([D(x).scaleb(-s1) for x in a],
                             pa.decimal128(p1, s1))
    tb = pa.table(cols)
    ref, port = _sessions()

    def q(df, F, col, lit, T):
        return df.select((col("a") / col("b")).alias("q"))
    want = q(ref.create_dataframe(tb), *REF).collect()
    got = q(port.create_dataframe(tb), *PORT).collect()
    assert got.schema == want.schema
    assert shape(port) == host_exchanges(shape(ref))
    out = got.schema.field("q").type
    assert (out.precision > 18) == (case in ("d20_2_by_d20_3",
                                             "long_by_d12_2"))
    shift = out.scale - s1 + s2
    ctx28 = decimal.Context(prec=28)
    with decimal.localcontext(decimal.Context(prec=100)):
        exact = [None if y in (None, 0) else
                 D(_half_up(x * 10 ** shift, y)).scaleb(-out.scale)
                 for x, y in zip(a, b)]
    assert got.column("q").to_pylist() == exact
    assert want.column("q").to_pylist() == [
        None if e is None else e if len(e.as_tuple().digits) <= 28 else
        ctx28.plus(e) for e in exact]


@pytest.mark.parametrize("a_bound,mult,d_bound", [
    (10, 10**16, 10**15),              # int64: DECIMAL(1,0) / (15,0)
    (10**7, 10**9, 10**5),             # int64: DECIMAL(7,2) / (5,3)
    (10**20, 10**24, 10**20),          # bit by bit: DECIMAL(20,2) / (20,3)
    (2**127, 10**4, 2**63),            # an average: any sum by a count
    (10**38, 10**38, 2**127),          # the widest product, 256 bits
])
def test_int128_div_half_up_matches_python_ints(a_bound, mult, d_bound):
    rng = random.Random(a_bound % 1000 + mult % 997)
    a_vals = [rng.randint(-a_bound + 1, a_bound - 1) for _ in range(300)]
    d_vals = [rng.choice([rng.randint(1, min(d_bound - 1, 2**46)),
                          rng.randint(1, d_bound - 1)])
              * rng.choice([1, -1]) for _ in a_vals]
    # ties: x * mult / d = k + 1/2
    a_vals += [1, -1, 3, -3, a_bound - 1, -(a_bound - 1)]
    d_vals += [2 * mult, 2 * mult, 2 * mult, -2 * mult, 1, -1]
    d_vals = [d if abs(d) < d_bound else (d_bound - 1) * (1 if d > 0 else
                                                           -1)
              for d in d_vals]

    def wrap(x):
        return ((x + 2**127) % 2**128) - 2**127
    got = i128.div_half_up(i128.from_ints(a_vals, "cpu"), mult,
                           i128.from_ints(d_vals, "cpu"), a_bound, d_bound)
    assert i128.to_ints(got) == [wrap(_half_up(x * mult, d))
                                 for x, d in zip(a_vals, d_vals)]


# ---------------------------------------------------------------------------
# the 128-bit reductions against the reference's numpy branch
# ---------------------------------------------------------------------------

def _edge_values(rng, n):
    """Unscaled values near +-2^63, +-2^64 and +-10^37, small ones, and
    runs of maxima whose low words carry."""
    pool = [2**63 - 1, 2**63, -(2**63), -(2**63) - 1, 2**64 - 1, -(2**64),
            10**37, -(10**37), 10**38 - 1, -(10**38 - 1), 0, 1, -1]
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.3:
            out.append(pool[i % len(pool)])
        elif r < 0.6:
            out.append(int(rng.integers(-2**62, 2**62)) * 4 + 3)
        else:
            out.append(int(rng.integers(-10**9, 10**9)) * 10**28
                       + int(rng.integers(0, 2**62)))
    return out


def _words(vals):
    lo = np.array([v & (2**64 - 1) for v in vals], dtype=np.uint64)
    hi = np.array([v >> 64 for v in vals], dtype=np.int64)
    return lo.astype(np.int64), hi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum128_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, g = 2000, 13
    vals = [v // 16 for v in _edge_values(rng, n)]   # sums stay in range
    lo, hi = _words(vals)
    seg_ids = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    rlo, rhi, rcnt = rseg.segment_sum128(np, lo, hi, seg_ids, g, valid)
    plo, phi, pcnt = pseg.segment_sum128(
        torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(seg_ids), g, torch.from_numpy(valid))
    assert plo.numpy().tolist() == rlo.tolist()
    assert phi.numpy().tolist() == rhi.tolist()
    assert pcnt.numpy().tolist() == rcnt.tolist()
    exact = [sum(v for v, s, ok in zip(vals, seg_ids, valid)
                 if ok and s == k) for k in range(g)]
    assert i128.to_ints((plo, phi)) == exact


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_extreme128_with_ties(op):
    rng = np.random.default_rng(7)
    n, g = 1500, 9
    vals = _edge_values(rng, n)
    vals[::5] = [vals[0]] * len(vals[::5])           # ties across groups
    lo, hi = _words(vals)
    seg_ids = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    plo, phi, cnt = pseg.segment_extreme128(
        op, torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(seg_ids), g, torch.from_numpy(valid))
    pick = min if op == "min" else max
    want = [pick([v for v, s, ok in zip(vals, seg_ids, valid)
                  if ok and s == k] or [0]) for k in range(g)]
    assert i128.to_ints((plo, phi)) == want


@pytest.mark.parametrize("ordered", [False, True])
def test_k3_plain_128bit_ops(ordered):
    """K3's plain version over (lo, hi) pairs: the sum, min and max of
    each group in key order, with ties, through an order or not."""
    rng = np.random.default_rng(3)
    n = 3000
    vals = [v // 64 for v in _edge_values(rng, n)]
    vals[::7] = [vals[1]] * len(vals[::7])
    lo, hi = (torch.from_numpy(x) for x in _words(vals))
    key = torch.from_numpy(rng.integers(0, 40, n))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    words = [key]
    order = pseg.lexsort(words) if ordered else None
    if not ordered:
        srt = torch.argsort(key, stable=True)
        key, lo, hi, valid = key[srt], lo[srt], hi[srt], valid[srt]
        vals = [vals[i] for i in srt.tolist()]
        words = [key]
    first, sums, counts, groups = pagg.segment_reduce_sorted(
        words, None, [lo, lo, lo, None], [valid] * 4, False, order,
        ["sum", "min", "max", "sum"], values_hi=[hi, hi, hi, None])
    keys = sorted(set(key.tolist()))
    assert groups == len(keys)
    for g, k in enumerate(keys):
        mine = [v for v, kk, ok in zip(vals, key.tolist(), valid.tolist())
                if kk == k and ok]
        assert i128.to_ints(sums[0])[g] == sum(mine)
        assert i128.to_ints(sums[1])[g] == min(mine)
        assert i128.to_ints(sums[2])[g] == max(mine)
        assert counts[3][g] == len(mine)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_k3_plain_sum_of_decimal64_through_its_signs(ordered, seed):
    """A 128-bit sum of a DECIMAL64 lane read without a lane of signs
    (``values_hi = SIGN``), beside a DECIMAL128 sum in the same call,
    through K3's plain version: each group's (lo, hi) pair equals the
    reference's ``segment_sum128`` (numpy branch) over the lane and its
    materialised signs, and Python's exact sums."""
    rng = np.random.default_rng(40 + seed)
    n, g = 2500, 11
    small = rng.integers(-10**15, 10**15, n)       # DECIMAL(17, s) range
    small[::9] = rng.choice([-(2**63), 2**63 - 1, -1], len(small[::9]))
    big = [v // 64 for v in _edge_values(rng, n)]
    blo, bhi = (torch.from_numpy(x) for x in _words(big))
    key = rng.integers(0, g, n)
    valid = rng.random(n) > 0.15
    lo = torch.from_numpy(small.astype(np.int64))
    keyt, validt = torch.from_numpy(key), torch.from_numpy(valid)
    order = pseg.lexsort([keyt]) if ordered else None
    words = [keyt]
    if not ordered:
        srt = torch.argsort(keyt, stable=True)
        keyt, lo, blo, bhi, validt = (x[srt] for x in
                                      (keyt, lo, blo, bhi, validt))
        words = [keyt]
    first, sums, counts, groups = pagg.segment_reduce_sorted(
        words, None, [lo, blo], [validt, validt], False, order,
        ["sum", "sum"], values_hi=[pagg.SIGN, bhi])
    assert groups == g
    seg_ids = np.searchsorted(np.unique(key), key).astype(np.int32)
    rlo, rhi, rcnt = rseg.segment_sum128(
        np, small.astype(np.int64), small.astype(np.int64) >> 63, seg_ids,
        g, valid)
    assert sums[0][0].tolist() == rlo.tolist()
    assert sums[0][1].tolist() == rhi.tolist()
    assert counts[0].tolist() == rcnt.tolist()
    exact = [sum(int(v) for v, s, ok in zip(small, seg_ids, valid)
                 if ok and s == k) for k in range(g)]
    assert i128.to_ints(sums[0]) == exact
    exact_big = [sum(v for v, s, ok in zip(big, seg_ids, valid)
                     if ok and s == k) for k in range(g)]
    assert i128.to_ints(sums[1]) == exact_big


def test_q1d_sums_read_the_decimal64_lanes():
    """q1d's three DECIMAL(15,2) sums reach K3 as the columns' own int64
    lanes with SIGN as their high lane (no cast pair and no lane of
    signs is built), a min and a max of one column read one lane, and
    the result equals the reference's."""
    tb = lineitem()
    _, port = _sessions()
    seen = []
    orig = pagg.segment_reduce_sorted

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return orig(*args, **kwargs)
    pagg.segment_reduce_sorted = spy
    try:
        got = q1d(port.create_dataframe(tb), *PORT).collect()
    finally:
        pagg.segment_reduce_sorted = orig
    (args, kwargs), = seen
    values, ops, his = args[2], args[6], kwargs["values_hi"]
    assert [h is pagg.SIGN for h in his] == [op == "sum" and v is not None
                                             for v, op in zip(values, ops)]
    lanes = {(v.data_ptr(), v.dtype) for v in values if v is not None}
    assert len(lanes) == 4            # qty, price, discount, ship date
    assert all(v.dtype == torch.int64 for v in values if v is not None)
    want = q1_oracle(tb, text=False)
    assert got.schema.field("sum_base_price").type == pa.decimal128(25, 2)
    for name in want[0]:
        assert got.column(name).to_pylist() == [r[name] for r in want]


def test_int128_helpers_match_python_ints():
    random.seed(11)
    a_vals = [random.randint(-10**38, 10**38) for _ in range(500)] + \
        [0, 1, -1, 2**63, -(2**63), 2**64 - 1, 10**38 - 1, -(10**38 - 1)]
    b_vals = [random.randint(-10**18, 10**18) or 1 for _ in a_vals]
    a, b = i128.from_ints(a_vals, "cpu"), i128.from_ints(b_vals, "cpu")

    def wrap(x):
        return ((x + 2**127) % 2**128) - 2**127

    assert i128.to_ints(i128.add(a, b)) == [wrap(x + y) for x, y in
                                            zip(a_vals, b_vals)]
    assert i128.to_ints(i128.mul(a, b)) == [wrap(x * y) for x, y in
                                            zip(a_vals, b_vals)]
    for k in (1, 2, 14, 20, 38):
        def half_up(x):
            q, r = divmod(abs(x), 10**k)
            q += 2 * r >= 10**k
            return q if x >= 0 else -q
        assert i128.to_ints(i128.round_half_up_pow10(a, k)) == \
            [half_up(x) for x in a_vals]
    assert i128.lt(a, b).tolist() == [x < y for x, y in zip(a_vals, b_vals)]


# ---------------------------------------------------------------------------
# TPC-H Q1 over real dates and decimals, at a small size
# ---------------------------------------------------------------------------

def lineitem(n=3000, seed=42):
    """A TPC-H lineitem of n rows: DECIMAL(15,2) quantity, extended
    price, discount and tax, the two flags and the ship date, in
    TPC-H's value ranges."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n)
    price = rng.integers(90000, 10494951, n)       # cents, <= 104,949.50
    disc = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    day0 = (datetime.date(1992, 1, 2) - datetime.date(1970, 1, 1)).days
    day1 = (datetime.date(1998, 12, 1) - datetime.date(1970, 1, 1)).days
    ship = rng.integers(day0, day1 + 1, n).astype(np.int32)
    flags = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    status = np.array(["F", "O"])[rng.integers(0, 2, n)]

    def dec(unscaled):
        return pa.Array.from_buffers(
            pa.decimal128(15, 2), n,
            [None, pa.py_buffer(np.stack(
                [unscaled.astype(np.int64),
                 np.zeros(n, np.int64)], 1).tobytes())])
    return pa.table({
        "l_quantity": dec(qty * 100), "l_extendedprice": dec(price),
        "l_discount": dec(disc), "l_tax": dec(tax),
        "l_returnflag": pa.array(flags), "l_linestatus": pa.array(status),
        "l_shipdate": pa.array(ship, pa.date32())})


CUTOFF = datetime.date(1998, 9, 2)


def q1d(df, F, col, lit, T):
    """Q1 as the reference keeps it on its device: sums, min/max and the
    count, no average or product."""
    return (df.filter(col("l_shipdate") <= lit(CUTOFF))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(col("l_discount")).alias("sum_disc"),
                 F.min(col("l_extendedprice")).alias("min_price"),
                 F.max(col("l_extendedprice")).alias("max_price"),
                 F.min(col("l_shipdate")).alias("min_ship"),
                 F.max(col("l_shipdate")).alias("max_ship"),
                 F.count("*").alias("count_order"))
            .sort(col("l_returnflag"), col("l_linestatus")))


def q1(df, F, col, lit, T):
    """The TPC-H Q1 text: the two products projected, then the
    aggregate."""
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1) - disc)
    return (df.filter(col("l_shipdate") <= lit(CUTOFF))
            .select(col("l_returnflag"), col("l_linestatus"),
                    col("l_quantity"), price, disc,
                    disc_price.alias("disc_price"),
                    (disc_price * (lit(1) + col("l_tax"))).alias("charge"))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(price).alias("sum_base_price"),
                 F.sum(col("disc_price")).alias("sum_disc_price"),
                 F.sum(col("charge")).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(price).alias("avg_price"),
                 F.avg(disc).alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .sort(col("l_returnflag"), col("l_linestatus")))


# the reference's placements of the Q1 text (probed on the CPU)
Q1_PLACEMENTS = [
    ("DeviceToHostExec", "cpu"), ("CoalesceBatchesExec", "gpu"),
    ("SortExec", "gpu"), ("HostToDeviceExec", "gpu"),
    ("CpuHashAggregateExec", "cpu"), ("ProjectExec", "cpu"),
    ("DeviceToHostExec", "cpu"), ("FilterExec", "gpu"),
    ("LocalScanExec", "gpu")]


def q1_oracle(tb, text: bool):
    """Q1's rows from Python decimals: exact sums, averages as the
    reference's CPU engine rounds them (HALF_UP at the input's scale)."""
    rows = {}
    for r in tb.to_pylist():
        if r["l_shipdate"] > CUTOFF:
            continue
        rows.setdefault((r["l_returnflag"], r["l_linestatus"]), []).append(r)
    out = []
    for k in sorted(rows):
        g = rows[k]
        p = [r["l_extendedprice"] for r in g]
        row = {"sum_qty": sum(r["l_quantity"] for r in g),
               "sum_base_price": sum(p)}
        if text:
            dp = [r["l_extendedprice"] * (1 - r["l_discount"]) for r in g]
            row["sum_disc_price"] = sum(dp)
            row["sum_charge"] = sum(x * (1 + r["l_tax"])
                                    for x, r in zip(dp, g))
            for name, c in (("avg_qty", "l_quantity"),
                            ("avg_price", "l_extendedprice"),
                            ("avg_disc", "l_discount")):
                s = sum(r[c] for r in g) / len(g)
                row[name] = s.quantize(D("0.01"),
                                       rounding=decimal.ROUND_HALF_UP)
        else:
            row["sum_disc"] = sum(r["l_discount"] for r in g)
            row["min_price"], row["max_price"] = min(p), max(p)
            row["min_ship"] = min(r["l_shipdate"] for r in g)
            row["max_ship"] = max(r["l_shipdate"] for r in g)
        row["count_order"] = len(g)
        out.append(row)
    return out


@pytest.mark.parametrize("partitions", [1, 4])
def test_q1d_over_real_types(partitions):
    tb = lineitem()
    got, port = run_both(tb, q1d, partitions=partitions, order=True)
    assert all(p == "gpu" for n, p in shape(port)
               if n not in ("DeviceToHostExec",))
    assert ("GpuHashAggregateExec", "gpu") in shape(port)
    assert got.schema.field("sum_qty").type == pa.decimal128(25, 2)
    want = q1_oracle(tb, text=False)
    for name in want[0]:
        assert got.column(name).to_pylist() == [r[name] for r in want]


@pytest.mark.parametrize("partitions", [1, 4])
def test_q1_text_placements_and_result(partitions):
    tb = lineitem()
    got, port = run_both(tb, q1, partitions=partitions, order=True)
    if partitions == 1:
        assert shape(port) == Q1_PLACEMENTS
    want = q1_oracle(tb, text=True)
    for name in want[0]:
        assert [D(x) if x is not None else x for x in
                got.column(name).to_pylist()] == [r[name] for r in want]


# ---------------------------------------------------------------------------
# what the port pins
# ---------------------------------------------------------------------------

def test_decimal128_join_keys_differing_only_in_high_words():
    """The reference's join word reads a DECIMAL128 key's low word alone,
    so keys that differ only in their high words match there; the port
    folds the high word in (Spark's answer: no match), and keys that fit
    64 bits keep the reference's word (ROADMAP Queue 3)."""
    a = D(2**64 + 5)
    b = D(5)
    left = pa.table({"k": pa.array([a, D(7)], pa.decimal128(30, 0)),
                     "v": pa.array([1, 2])})
    right = pa.table({"k2": pa.array([b, D(7)], pa.decimal128(30, 0)),
                      "w": pa.array([10, 20])})
    ref, port = _sessions()

    def q(s, col):
        return s.create_dataframe(left).join(
            s.create_dataframe(right), col("k") == col("k2"),
            "inner").select(col("v"), col("w"))
    want = q(ref, rcol).collect()
    got = q(port, pcol).collect()
    assert sorted(want.column("v").to_pylist()) == [1, 2]   # the reference
    assert got.column("v").to_pylist() == [2]
    assert got.column("w").to_pylist() == [20]


def test_decimal_sum_past_38_digits_wraps_as_the_reference():
    """A DECIMAL(38) sum past 38 digits: Spark gives null; both packages'
    device paths add modulo 2^128 and keep the row valid, and their
    results are the same value (pinned here, ROADMAP Queue 3)."""
    v = D("9" * 36 + ".00")
    tb = pa.table({"k": pa.array([1] * 40),
                   "d": pa.array([v] * 40, pa.decimal128(38, 2))})
    lo, hi = _words([int(v.scaleb(2))] * 40)
    s_lo, s_hi, _ = pseg.segment_sum128(
        torch.from_numpy(lo), torch.from_numpy(hi),
        torch.zeros(40, dtype=torch.int32), 1, torch.ones(40,
                                                          dtype=torch.bool))
    r_lo, r_hi, _ = rseg.segment_sum128(np, lo, hi, np.zeros(40, np.int32),
                                        1, np.ones(40, bool))
    assert (s_lo.tolist(), s_hi.tolist()) == (r_lo.tolist(), r_hi.tolist())
    total = int(v.scaleb(2)) * 40
    assert i128.to_ints((s_lo, s_hi))[0] == \
        ((total + 2**127) % 2**128) - 2**127
    _, port = _sessions()
    df = port.create_dataframe(tb).group_by(pcol("k")).agg(
        PF.max(pcol("d")).alias("m"))
    assert df.collect().column("m").to_pylist() == [v]


# ---------------------------------------------------------------------------
# div, % and pmod, greatest and least over decimals
# ---------------------------------------------------------------------------

DIVISION_TYPES = [(10, 2), (18, 4), (30, 2)]
DIVISION_OPS = ["mod", "pmod", "div", "greatest", "least"]


def _division_table(p, s, seed, n=240):
    """a and b DECIMAL(p, s), multiples of 0.25 below 2^36 (so the
    reference's div through doubles is exact), with negatives, nulls and
    zero divisors; returned with the unscaled ints."""
    rng = random.Random(seed)
    unit = 25 * 10 ** (s - 2)
    lim = min(2**38, (10 ** p - 1) // unit)

    def one(zero_p):
        if rng.random() < 0.06:
            return None
        if rng.random() < zero_p:
            return 0
        return rng.choice([rng.randint(-lim, lim), rng.randint(-40, 40)]) \
            * unit
    a = [one(0.02) for _ in range(n)]
    b = [one(0.06) for _ in range(n)]
    cols = {k: pa.array([None if x is None else D(x).scaleb(-s) for x in v],
                        pa.decimal128(p, s)) for k, v in (("a", a), ("b", b))}
    return pa.table(cols), a, b


def _trunc_div(x: int, y: int) -> int:
    q = abs(x) // abs(y)
    return q if (x < 0) == (y < 0) else -q


def _spark_division(op, a, b, s):
    """Spark's div, % and pmod, greatest and least of unscaled ints at one
    scale: % takes the dividend's sign, pmod is (r + n) % n for r < 0,
    div truncates and keeps the low 64 bits (Java's toLong), a zero
    divisor gives null; greatest and least skip nulls."""
    out = []
    for x, y in zip(a, b):
        if op in ("greatest", "least"):
            vals = [v for v in (x, y) if v is not None]
            pick = (max if op == "greatest" else min)(vals) if vals else None
            out.append(None if pick is None else D(pick).scaleb(-s))
            continue
        if x is None or y is None or y == 0:
            out.append(None)
            continue
        q = _trunc_div(x, y)
        if op == "div":
            out.append((q + 2**63) % 2**64 - 2**63)
            continue
        r = x - q * y
        if op == "pmod" and r < 0:
            r = (r + y) - _trunc_div(r + y, y) * y
        out.append(D(r).scaleb(-s))
    return out


def _division_query(op):
    def q(df, F, col, lit, T):
        a, b = col("a"), col("b")
        if op in ("greatest", "least"):
            return df.select(getattr(F, op)(a, b).alias("r"))
        if op == "mod":
            return df.select((a % b).alias("r"))
        ar = rar if F is RF else par
        cls = ar.Pmod if op == "pmod" else ar.IntegralDivide
        return df.select(type(a)(cls(a.expr, b.expr)).alias("r"))
    return q


@pytest.mark.parametrize("op", DIVISION_OPS)
@pytest.mark.parametrize("precision,scale", DIVISION_TYPES)
def test_decimal_division_family_matches_reference(precision, scale, op):
    """div, %, pmod, greatest and least over DECIMAL(10,2), (18,4) and
    (30,2) with negative operands, nulls and zero divisors: the port
    equals Spark's answer (exact Python ints) and the reference's, and
    both plans place the same operators (the DECIMAL(30,2) results of %,
    pmod, greatest and least on the CPU engine, as the reference places
    them).  pmod's divisors are positive here; a negative one is
    test_decimal_pmod_of_a_negative_divisor's."""
    tb, a, b = _division_table(precision, scale, seed=precision + len(op))
    if op == "pmod":
        b = [None if y is None else abs(y) for y in b]
        tb = tb.set_column(1, "b", pc.abs(tb.column("b")))
    ref, port = _sessions()
    q = _division_query(op)
    want = q(ref.create_dataframe(tb), *REF).collect()
    got = q(port.create_dataframe(tb), *PORT).collect()
    assert got.schema == want.schema
    assert shape(port) == host_exchanges(shape(ref))
    assert got.column("r").to_pylist() == _spark_division(op, a, b, scale)
    assert want.column("r").to_pylist() == got.column("r").to_pylist()


@pytest.mark.parametrize("precision,scale", DIVISION_TYPES)
def test_decimal_pmod_of_a_negative_divisor(precision, scale):
    """pmod(a, n) with n < 0 and a negative remainder r: Spark's (r + n) %
    n, which is r, in the port; the reference's r + n (ROADMAP Queue
    3)."""
    t = pa.decimal128(precision, scale)
    tb = pa.table({"a": pa.array([D("-7.25"), D("7.25"), D("-7.00")], t),
                   "b": pa.array([D("-2.00"), D("-2.00"), D("-2.00")], t)})
    ref, port = _sessions()
    q = _division_query("pmod")
    got = q(port.create_dataframe(tb), *PORT).collect()
    want = q(ref.create_dataframe(tb), *REF).collect()
    assert [str(x) for x in got.column("r").to_pylist()] == \
        [str(D(v).quantize(D(1).scaleb(-scale))) for v in
         ("-1.25", "1.25", "-1")]
    assert [str(x) for x in want.column("r").to_pylist()] == \
        [str(D(v).quantize(D(1).scaleb(-scale))) for v in
         ("-3.25", "1.25", "-3")]


def test_decimal_mod_pmod_div_small_table():
    """DECIMAL(10,2) a = [10.50, -7.25, null, 3.00] over b = [3.00, 2.00,
    1.00, 0.00] in both packages."""
    tb = pa.table({
        "a": pa.array([D("10.50"), D("-7.25"), None, D("3.00")],
                      pa.decimal128(10, 2)),
        "b": pa.array([D("3.00"), D("2.00"), D("1.00"), D("0.00")],
                      pa.decimal128(10, 2))})
    want = {"mod": [D("1.50"), D("-1.25"), None, None],
            "pmod": [D("1.50"), D("0.75"), None, None],
            "div": [3, -3, None, None]}
    for op, values in want.items():
        got, port = run_both(tb, _division_query(op), order=True)
        assert got.column("r").to_pylist() == values
        nodes = shape(port)
        assert all(p == "gpu" for _, p in nodes[1:]), nodes


def test_decimal_div_past_doubles():
    """div of quotients a double does not hold exactly: the port
    truncates the exact quotient (Spark's answer; past 2^63 its low 64
    bits, Java's toLong); the reference divides doubles, so 0.30 div
    0.10 is 2 there and 99999999.99 div 0.03 is 3333333332, and over a
    DECIMAL(30,2) past 2^64 its CPU engine raises (ROADMAP Queue 3)."""
    big = -123456789012345678901234
    cases = [((10, 2), ["0.30", "-0.70", "99999999.99"],
              ["0.10", "0.10", "0.03"], [3, -7, 3333333333],
              [2, -7, 3333333332]),
             ((30, 2), [str(D(big).scaleb(-2)), "5", "10.50"],
              ["7.10", "-0.03", "3"],
              [(_trunc_div(big, 710) + 2**63) % 2**64 - 2**63, -166, 3],
              None)]
    q = _division_query("div")
    for (p, s), a, b, spark, ref_values in cases:
        tb = pa.table({k: pa.array([D(x) for x in v], pa.decimal128(p, s))
                       for k, v in (("a", a), ("b", b))})
        ref, port = _sessions()
        got = q(port.create_dataframe(tb), *PORT).collect()
        assert got.column("r").to_pylist() == spark
        if ref_values is not None:
            want = q(ref.create_dataframe(tb), *REF).collect()
            assert want.column("r").to_pylist() == ref_values
            continue
        ref_cpu, _ = _sessions(enabled=False)
        with pytest.raises(OverflowError):
            q(ref_cpu.create_dataframe(tb), *REF).collect()


def test_window_over_decimal128():
    """A window partitioned by a DECIMAL128 key tells apart keys that
    differ only in their high words; a window function over such a
    value waits for its slice (the reference raises IndexError on both
    queries; the port raises NotImplementedError naming ROADMAP Queue 1
    item 3 for the second rather than drop the high words)."""
    from spark_rapids_tpu_torch.expr.window import Window
    tb = pa.table({"x": pa.array([D(2**64 + 5), D(5), D(5), D(2**64 + 5)],
                                 pa.decimal128(30, 0)),
                   "o": pa.array([1, 2, 3, 4])})
    s = GpuSession(device="cpu")
    w = Window.partition_by(pcol("x")).order_by(pcol("o"))
    got = s.create_dataframe(tb).select(
        pcol("o"), PF.row_number().over(w).alias("rn")).collect()
    assert dict(zip(got.column("o").to_pylist(),
                    got.column("rn").to_pylist())) == {1: 1, 2: 1, 3: 2,
                                                       4: 2}
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        s.create_dataframe(tb).select(PF.sum(pcol("x")).over(
            Window.partition_by(pcol("o")).order_by(pcol("o")))).collect()


# ---------------------------------------------------------------------------
# round, bround, floor and ceil over decimals; sums and averages past 38
# digits on the CPU engine; the cases where the port gives Spark's answer
# ---------------------------------------------------------------------------

_ROUND_VALUES = [D("1.25"), D("-3.75"), D("0.05"), D("-0.05"), D("12.50"),
                 D("-12.55"), D("0.00"), None, D("99999.99"),
                 D("-99999.95")]


@pytest.mark.parametrize("precision", [10, 30])
@pytest.mark.parametrize("scale", [-1, 0, 1, 3])
def test_decimal_round_floor_ceil_match_reference(precision, scale):
    """Values and result types equal the reference's: round and bround
    give DECIMAL at the target scale (a negative scale rounds at 0),
    floor and ceil DECIMAL(p - s + 1, 0), computed on the unscaled words
    (past 18 digits the high word is kept)."""
    vals = list(_ROUND_VALUES)
    if precision == 30:
        vals += [D("1111111111111111111111111.55"),
                 D("-1111111111111111111111111.45"),
                 D("999999999999999999999.99"), D(2**64) + D("0.5")]
    tb = pa.table({"d": pa.array(vals, pa.decimal128(precision, 2))})
    got, _ = run_both(tb, lambda df, F, col, lit, T: df.select(
        F.round(col("d"), scale).alias("r"),
        F.bround(col("d"), scale).alias("b"),
        F.floor(col("d")).alias("f"), F.ceil(col("d")).alias("c")),
        order=True)
    k = 2 - min(max(scale, 0), 2)
    assert got.schema.field("f").type == pa.decimal128(precision - 1, 0)
    assert got.schema.field("r").type.scale == 2 - k
    with decimal.localcontext(decimal.Context(prec=60)):
        exact = [None if v is None else v.quantize(
            D(1).scaleb(k - 2), rounding=decimal.ROUND_HALF_UP)
            for v in vals]
        floors = [None if v is None else D(int(v.to_integral_value(
            rounding=decimal.ROUND_FLOOR))) for v in vals]
    assert got.column("r").to_pylist() == exact
    assert got.column("f").to_pylist() == floors
    if precision == 30:
        assert got.column("f").to_pylist()[10] == \
            D("1111111111111111111111111")


@pytest.mark.parametrize("partitions", [1, 3])
def test_cpu_engine_decimal_sum_and_avg_past_38_digits_are_null(partitions):
    """The CPU engine's SUM and AVG of DECIMAL(38,10) past 38 digits give
    null (Spark's answer), and the table validates; the reference's
    collect raises ArrowInvalid on the sum and its AVG raises too."""
    v = D("9999999999999999999999999999.9999999999")
    tb = pa.table({"g": pa.array([1, 1, 2, 2, 3]),
                   "x": pa.array([v, v, D(1), D("2.5"), None],
                                 pa.decimal128(38, 10))})
    ref, port = _sessions()
    for q in (lambda df, F, col: df.group_by(col("g")).agg(
                  F.sum(col("x")).alias("s"), F.avg(col("x")).alias("a")),
              lambda df, F, col: df.agg(F.sum(col("x")).alias("s"),
                                        F.avg(col("x")).alias("a"))):
        got = q(port.create_dataframe(tb, num_partitions=partitions), PF,
                pcol).collect()
        got.validate(full=True)
        rows = sorted(zip(*[got.column(c).to_pylist()
                            for c in got.column_names]), key=str)
        assert ("CpuHashAggregateExec", "cpu") in shape(port)
        if "g" in got.column_names:
            assert rows == [(1, None, None),
                            (2, D("3.5000000000"), D("1.75000000000000")),
                            (3, None, None)]
        else:
            assert rows == [(None, None)]
        with pytest.raises(pa.ArrowInvalid):
            q(ref.create_dataframe(tb, num_partitions=partitions), RF,
              rcol).collect()


def test_round_narrow_types_at_negative_scale_past_range():
    """round(127 as BYTE, -1) wraps as Spark does (-126) and SHORT alike;
    the reference raises ArrowInvalid (ROADMAP Queue 3)."""
    tb = pa.table({"b": pa.array([127, -128, 14], pa.int8()),
                   "s": pa.array([32767, -32768, 14], pa.int16())})
    ref, port = _sessions()
    got = port.create_dataframe(tb).select(
        PF.round(pcol("b"), -1).alias("b"),
        PF.round(pcol("s"), -1).alias("s")).collect()
    assert got.column("b").to_pylist() == [-126, 126, 10]
    assert got.column("s").to_pylist() == [-32766, 32766, 10]
    with pytest.raises(pa.ArrowInvalid):
        ref.create_dataframe(tb).select(RF.round(rcol("b"), -1)).collect()


def test_round_float_max_keeps_its_value():
    """round(f, 1) of FLOAT 3.4e38 is 3.4e38 in the port (Spark's); the
    reference's float arithmetic overflows to inf (ROADMAP Queue 3)."""
    tb = pa.table({"f": pa.array([3.4e38, 1.25], pa.float32())})
    ref, port = _sessions()
    got = port.create_dataframe(tb).select(
        PF.round(pcol("f"), 1).alias("r")).collect()
    want = ref.create_dataframe(tb).select(
        RF.round(rcol("f"), 1).alias("r")).collect()
    assert got.column("r").to_pylist()[0] == pytest.approx(3.4e38, rel=1e-6)
    assert want.column("r").to_pylist()[0] == float("inf")


def test_decimal128_beyond_2_63_cast_to_long_wraps():
    """A DECIMAL(30,2) beyond 2^63 cast to LONG gives the low 64 bits, as
    Spark's longValue does; the reference raises OverflowError (ROADMAP
    Queue 3)."""
    tb = pa.table({"d": pa.array([D("1111111111111111111111111.55")],
                                 pa.decimal128(30, 2))})
    ref, port = _sessions()
    got = port.create_dataframe(tb).select(
        pcol("d").cast("long").alias("l")).collect()
    assert got.column("l").to_pylist() == [8375319363688624583]
    with pytest.raises(OverflowError):
        ref.create_dataframe(tb).select(rcol("d").cast("long")).collect()
