"""The port's flat expression surface against the reference, on the CPU.

The flat cases of tests/test_basic_ops.py (arithmetic, division,
comparisons, conditionals, math, casts, three-valued logic, NaN
comparisons) and a catalogue of every ported expression run through the
reference's TpuSession and the port's GpuSession(device="cpu") on the
same table (the reference's data generators, from a seed); the two
results are compared row for row with the reference's
``assert_tables_equal``: integers and booleans exactly, doubles to a
relative 1e-12 (the same operation in numpy/jnp and in torch rounds the
same way; transcendental functions may differ in the last bit, so the
math cases use the reference's own 1e-9).  Where the reference's
integer arithmetic departs from Spark (an operand at its type's minimum
value, whose ``abs`` wraps; pmod with a negative divisor), its answer
is recorded and the port is held to Spark's, computed with Python
integers.  Edge values: INT64_MIN / -1 and % -1 (no crash), zero
divisors, IN with a null, round at .5, and the saturating double ->
LONG cast.
"""

import math

import pyarrow as pa
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import Column as RColumn
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import arithmetic as rar
from spark_rapids_tpu.expr import conditional as rcond
from spark_rapids_tpu.expr import mathexpr as rmx
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (BooleanGen, DoubleGen,
                                               IntegerGen, LongGen,
                                               gen_table)
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import Column as PColumn
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import arithmetic as par
from spark_rapids_tpu_torch.expr import conditional as pcond
from spark_rapids_tpu_torch.expr import mathexpr as pmx
from spark_rapids_tpu_torch.plan.overrides import EXPR_RULES

EXACT_RTOL = 1e-12      # one IEEE operation, rounded alike in both
MATH_RTOL = 1e-9        # libm functions may differ in the last bit
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
INT64_MIN, INT64_MAX = -2**63, 2**63 - 1
INT32_MIN = -2**31


class NS:
    """One package's API: functions, col, lit, Column and the expression
    modules a case builds nodes from."""

    def __init__(self, F, col, lit, Column, ar, mx, cond):
        self.F, self.col, self.lit, self.Column = F, col, lit, Column
        self.ar, self.mx, self.cond = ar, mx, cond

    def node(self, cls, *args):
        return self.Column(cls(*[a.expr for a in args]))


REF = NS(RF, rcol, rlit, RColumn, rar, rmx, rcond)
PORT = NS(PF, pcol, plit, PColumn, par, pmx, pcond)


@pytest.fixture(scope="module")
def sessions():
    b = TpuSession.builder()
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu")


def run_both(sessions, table, query, partitions=1):
    """(reference result, port result, port session) of
    ``query(df, ns)``."""
    ref, port = sessions
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                PORT).collect()
    return want, got, port


def on_gpu(port) -> bool:
    return "!" not in port.last_explain


# ---------------------------------------------------------------------------
# the flat cases of tests/test_basic_ops.py
# ---------------------------------------------------------------------------

def test_project_arithmetic(sessions):
    t = gen_table([("a", LongGen()), ("b", IntegerGen())], length=512)

    def q(df, X):
        c = X.col
        return df.select((c("a") + c("b")).alias("add"),
                         (c("a") - c("b")).alias("sub"),
                         (c("a") * c("b")).alias("mul"),
                         (-c("a")).alias("neg"),
                         X.F.abs(c("b")).alias("abs"))
    want, got, port = run_both(sessions, t, q)
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False)
    assert on_gpu(port)


def _spark_div_mod(a, b):
    """Spark's (a div b, a % b) for int64 a and b: truncated toward zero,
    wrapping, null (None) for a zero divisor."""
    if a is None or b is None or b == 0:
        return None, None
    q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
    return par.wrap_int(q, par.t.LONG), a - q * b


def test_division_semantics(sessions):
    """``/`` and ``%``: the reference's rows where no operand is its
    type's minimum, and every row against Spark's answer."""
    t = gen_table([("a", LongGen()), ("b", IntegerGen(lo=-3, hi=3))],
                  length=512)

    def q(df, X):
        c = X.col
        return df.select((c("a") / c("b")).alias("div"),
                         (c("a") % c("b")).alias("mod"))
    want, got, port = run_both(sessions, t, q)
    a, b = t["a"].to_pylist(), t["b"].to_pylist()
    plain = [i for i in range(len(a))
             if a[i] != INT64_MIN and b[i] != INT32_MIN]
    assert len(plain) < len(a)            # the generator draws the minimum
    assert_tables_equal(want.take(plain), got.take(plain),
                        ignore_order=False, approximate_float=EXACT_RTOL)
    mods = got["mod"].to_pylist()
    divs = got["div"].to_pylist()
    for i in range(len(a)):
        assert mods[i] == _spark_div_mod(a[i], b[i])[1], i
        if a[i] is None or b[i] is None or b[i] == 0:
            assert divs[i] is None
        else:
            assert divs[i] == float(a[i]) / float(b[i])
    assert on_gpu(port)


def test_filter_comparisons(sessions):
    t = gen_table([("a", IntegerGen()), ("b", IntegerGen())], length=1024)

    def q(df, X):
        c = X.col
        return df.filter((c("a") > c("b")) | c("a").is_null())
    want, got, port = run_both(sessions, t, q)
    assert_tables_equal(want, got, ignore_order=False)
    assert on_gpu(port)


@pytest.mark.parametrize("partitions", [1, 3])
def test_conditional_exprs(sessions, partitions):
    t = gen_table([("a", IntegerGen()), ("b", IntegerGen())], length=512)

    def q(df, X):
        c, F = X.col, X.F
        return df.select(
            F.when(c("a") > 0, c("a")).when(c("b") > 0, c("b"))
             .otherwise(X.lit(0)).alias("cw"),
            F.coalesce(c("a"), c("b"), X.lit(-1)).alias("co"))
    want, got, port = run_both(sessions, t, q, partitions)
    assert_tables_equal(want, got, ignore_order=partitions > 1)
    assert on_gpu(port)


def test_math_functions(sessions):
    t = gen_table([("d", DoubleGen(no_nans=True))], length=512)

    def q(df, X):
        c, F = X.col, X.F
        return df.select(F.sqrt(F.abs(c("d"))).alias("sq"),
                         F.floor(c("d")).alias("fl"),
                         F.ceil(c("d")).alias("ce"),
                         F.log(F.abs(c("d"))).alias("lg"),
                         F.signum(c("d")).alias("sg"))
    want, got, port = run_both(sessions, t, q)
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=MATH_RTOL)
    assert on_gpu(port)


def test_casts(sessions):
    """The flat columns of test_basic_ops.py::test_casts (the string casts
    wait for Queue 1 item 3)."""
    t = gen_table([("i", IntegerGen()), ("l", LongGen()), ("d", DoubleGen()),
                   ("b", BooleanGen())], length=512)

    def q(df, X):
        c = X.col
        return df.select(c("i").cast("long").alias("i2l"),
                         c("l").cast("int").alias("l2i"),
                         c("d").cast("int").alias("d2i"),
                         c("i").cast("double").alias("i2d"),
                         c("b").cast("int").alias("b2i"))
    want, got, port = run_both(sessions, t, q)
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False)
    assert on_gpu(port)


def test_three_valued_logic_vs_oracle(sessions):
    t = pa.table({
        "a": pa.array([True, True, True, False, False, False, None, None,
                       None]),
        "b": pa.array([True, False, None, True, False, None, True, False,
                       None])})

    def q(df, X):
        c = X.col
        return df.select((c("a") & c("b")).alias("and_"),
                         (c("a") | c("b")).alias("or_"),
                         c("a").eq_null_safe(c("b")).alias("ns"))
    want, got, _ = run_both(sessions, t, q)
    assert_tables_equal(want, got, ignore_order=False)
    assert got["and_"].to_pylist() == [
        True, False, None, False, False, False, None, False, None]
    assert got["or_"].to_pylist() == [
        True, True, True, True, False, None, True, None, None]
    assert got["ns"].to_pylist() == [
        True, False, False, False, True, False, False, False, True]


def test_nan_comparison_semantics(sessions):
    t = pa.table({"a": pa.array([float("nan"), 1.0, float("inf")]),
                  "b": pa.array([float("nan"), float("nan"), 1.0])})

    def q(df, X):
        c = X.col
        return df.select((c("a") == c("b")).alias("eq"),
                         (c("a") > c("b")).alias("gt"),
                         (c("a") < c("b")).alias("lt"),
                         c("a").eq_null_safe(c("b")).alias("ns"),
                         X.F.isnan(c("a")).alias("nan"))
    want, got, _ = run_both(sessions, t, q)
    assert_tables_equal(want, got, ignore_order=False)
    assert got["eq"].to_pylist() == [True, False, False]
    assert got["gt"].to_pylist() == [False, False, True]
    assert got["lt"].to_pylist() == [False, True, False]


# ---------------------------------------------------------------------------
# every ported expression against the reference
# ---------------------------------------------------------------------------

def _catalogue_table():
    """The generators' draws with each integral column's minimum moved up
    by one: an operand at the minimum is test_port_follows_spark's."""
    t = gen_table([("a", LongGen()), ("b", IntegerGen(lo=-3, hi=3)),
                   ("i", IntegerGen(lo=-10**6, hi=10**6)),
                   ("d", DoubleGen()), ("e", DoubleGen()),
                   ("p", DoubleGen(no_nans=True)), ("x", BooleanGen())],
                  length=600, seed=7)
    for name, lo in (("a", INT64_MIN), ("b", INT32_MIN), ("i", INT32_MIN)):
        c = t[name]
        t = t.set_column(t.column_names.index(name), name, pc.if_else(
            pc.equal(c, pa.scalar(lo, c.type)), pa.scalar(lo + 1, c.type),
            c))
    return t


# name -> (query over X, tolerance); operands at an integral type's
# minimum are left to test_port_follows_spark
CATALOGUE = {
    "add_int_long": (lambda X: X.col("i") + X.col("a"), 0.0),
    "sub_literal_first": (lambda X: 7 - X.col("i"), 0.0),
    "mul_wraps": (lambda X: X.col("a") * X.lit(3), 0.0),
    "add_double": (lambda X: X.col("d") + X.col("e"), EXACT_RTOL),
    "mul_double_int": (lambda X: X.col("d") * X.col("i"), EXACT_RTOL),
    "divide_doubles": (lambda X: X.col("d") / X.col("e"), EXACT_RTOL),
    "divide_by_zero_literal": (lambda X: X.col("d") / X.lit(0), 0.0),
    "divide_ints": (lambda X: X.col("i") / X.col("b"), EXACT_RTOL),
    "integral_divide": (lambda X: X.node(X.ar.IntegralDivide, X.col("i"),
                                         X.col("b")), 0.0),
    "remainder_ints": (lambda X: X.col("i") % X.col("b"), 0.0),
    "remainder_doubles": (lambda X: X.col("d") % X.col("e"), EXACT_RTOL),
    "pmod_positive_divisor": (lambda X: X.node(X.ar.Pmod, X.col("i"),
                                               X.lit(3)), 0.0),
    "unary_minus_double": (lambda X: -X.col("d"), 0.0),
    "unary_positive": (lambda X: X.node(X.ar.UnaryPositive, X.col("i")),
                       0.0),
    "abs_double": (lambda X: X.F.abs(X.col("d")), 0.0),
    "greatest_ints": (lambda X: X.F.greatest(X.col("i"), X.col("b"),
                                             X.lit(5)), 0.0),
    "least_doubles": (lambda X: X.F.least(X.col("p"), X.lit(0.5)), 0.0),
    "eq_null_safe": (lambda X: X.col("b").eq_null_safe(X.col("i")), 0.0),
    "is_null": (lambda X: X.col("d").is_null(), 0.0),
    "is_not_null": (lambda X: X.col("x").is_not_null(), 0.0),
    "isnan": (lambda X: X.F.isnan(X.col("d")), 0.0),
    "isnull": (lambda X: X.F.isnull(X.col("a")), 0.0),
    "in_ints": (lambda X: X.col("b").isin(1, 2, 5), 0.0),
    "in_with_null": (lambda X: X.col("b").isin([1, None]), 0.0),
    "in_doubles": (lambda X: X.col("p").isin(0.0, 1.0), 0.0),
    "if": (lambda X: X.node(X.cond.If, X.col("x"), X.col("i"), X.col("b")),
           0.0),
    "case_when_no_else": (lambda X: X.F.when(X.col("b") > 0, X.lit(1.5))
                          .when(X.col("b") < 0, X.col("d")), 0.0),
    "case_when_null_branch": (lambda X: X.F.when(X.col("x"), X.lit(None))
                              .otherwise(X.col("a")), 0.0),
    "coalesce_doubles": (lambda X: X.F.coalesce(X.col("d"), X.col("e"),
                                                X.lit(0.0)), 0.0),
    "nullif": (lambda X: X.node(X.cond.NullIf, X.col("b"), X.lit(1)), 0.0),
    "exp": (lambda X: X.F.exp(X.col("p")), MATH_RTOL),
    "expm1": (lambda X: X.node(X.mx.Expm1, X.col("p")), MATH_RTOL),
    "sin": (lambda X: X.node(X.mx.Sin, X.col("p")), MATH_RTOL),
    "cos": (lambda X: X.node(X.mx.Cos, X.col("p")), MATH_RTOL),
    "tan": (lambda X: X.node(X.mx.Tan, X.col("p")), MATH_RTOL),
    "cot": (lambda X: X.node(X.mx.Cot, X.col("p")), MATH_RTOL),
    "asin": (lambda X: X.node(X.mx.Asin, X.col("p") / X.lit(1e300)),
             MATH_RTOL),
    "acos": (lambda X: X.node(X.mx.Acos, X.col("p") / X.lit(1e300)),
             MATH_RTOL),
    "atan": (lambda X: X.node(X.mx.Atan, X.col("p")), MATH_RTOL),
    "sinh": (lambda X: X.node(X.mx.Sinh, X.col("b")), MATH_RTOL),
    "cosh": (lambda X: X.node(X.mx.Cosh, X.col("b")), MATH_RTOL),
    "tanh": (lambda X: X.node(X.mx.Tanh, X.col("p")), MATH_RTOL),
    "asinh": (lambda X: X.node(X.mx.Asinh, X.col("p")), MATH_RTOL),
    "acosh": (lambda X: X.node(X.mx.Acosh, X.F.abs(X.col("p"))),
              MATH_RTOL),
    "atanh": (lambda X: X.node(X.mx.Atanh, X.col("b") / X.lit(4)),
              MATH_RTOL),
    "cbrt": (lambda X: X.node(X.mx.Cbrt, X.col("i")), MATH_RTOL),
    "rint": (lambda X: X.node(X.mx.Rint, X.col("b") / X.lit(2)), 0.0),
    "degrees": (lambda X: X.node(X.mx.ToDegrees, X.col("p")), MATH_RTOL),
    "radians": (lambda X: X.node(X.mx.ToRadians, X.col("p")), MATH_RTOL),
    "log2": (lambda X: X.node(X.mx.Log2, X.col("d")), MATH_RTOL),
    "log10": (lambda X: X.node(X.mx.Log10, X.col("i")), MATH_RTOL),
    "log1p": (lambda X: X.node(X.mx.Log1p, X.col("b")), MATH_RTOL),
    "logarithm": (lambda X: X.node(X.mx.Logarithm, X.col("b"), X.col("d")),
                  MATH_RTOL),
    "pow": (lambda X: X.F.pow(X.col("b"), X.col("b")), MATH_RTOL),
    "atan2": (lambda X: X.node(X.mx.Atan2, X.col("d"), X.col("e")),
              MATH_RTOL),
    "floor_long": (lambda X: X.F.floor(X.col("a")), 0.0),
    "ceil_double": (lambda X: X.F.ceil(X.col("d")), 0.0),
    "signum_with_nan": (lambda X: X.F.signum(X.col("d")), 0.0),
    "round_double": (lambda X: X.F.round(X.col("p"), 2), MATH_RTOL),
    "round_long_negative_scale": (lambda X: X.F.round(X.col("i"), -2), 0.0),
    "bround_double": (lambda X: X.F.bround(X.col("p"), 1), MATH_RTOL),
    "cast_double_to_long": (lambda X: (X.col("p") / X.lit(1e290))
                            .cast("long"), 0.0),
    "cast_long_to_int": (lambda X: X.col("a").cast("int"), 0.0),
    "cast_double_to_boolean": (lambda X: X.col("d").cast("boolean"), 0.0),
    "cast_boolean_to_double": (lambda X: X.col("x").cast("double"), 0.0),
    "cast_long_to_double": (lambda X: X.col("a").cast("double"), 0.0),
    "cast_null_to_int": (lambda X: X.lit(None).cast("int"), 0.0),
}


@pytest.mark.parametrize("case", sorted(CATALOGUE))
def test_expression_catalogue(sessions, case):
    fn, rtol = CATALOGUE[case]

    def q(df, X):
        return df.select(X.col("i"), fn(X).alias("r"))
    want, got, port = run_both(sessions, _catalogue_table(), q)
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=rtol)
    assert on_gpu(port), port.last_explain


def test_nvl_is_coalesce_of_two(sessions):
    """nvl(a, b) is coalesce(a, b).  The reference registers Nvl but has
    no evaluator for it (its evaluators are looked up by exact class), so
    the port is held to the reference's coalesce."""
    def q(df, X):
        c = X.col
        if X is PORT:
            return df.select(X.node(X.cond.Nvl, c("i"), c("b")).alias("r"))
        return df.select(X.F.coalesce(c("i"), c("b")).alias("r"))
    want, got, port = run_both(sessions, _catalogue_table(), q)
    assert_tables_equal(want, got, ignore_order=False)
    assert on_gpu(port)


def test_catalogue_covers_every_ported_rule():
    """Each expression class the reference registers for these modules
    has a port rule."""
    names = {c.__name__ for c in EXPR_RULES}
    for name in ("Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
                 "Remainder", "Pmod", "UnaryMinus", "UnaryPositive", "Abs",
                 "Greatest", "Least", "EqualNullSafe", "IsNull", "IsNotNull",
                 "IsNaN", "In", "If", "CaseWhen", "Coalesce", "NullIf",
                 "Nvl", "Sqrt", "Exp", "Expm1", "Sin", "Cos", "Tan", "Asin",
                 "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Cbrt", "Rint",
                 "ToDegrees", "ToRadians", "Log", "Log2", "Log10", "Log1p",
                 "Pow", "Atan2", "Signum", "Round", "BRound", "Floor",
                 "Ceil", "Asinh", "Acosh", "Atanh", "Cot", "Logarithm",
                 "Cast", "Min", "Max"):
        assert name in names, name


# ---------------------------------------------------------------------------
# edge values
# ---------------------------------------------------------------------------

def _edge_table():
    return pa.table({
        "a": pa.array([INT64_MIN, INT64_MIN, 7, -7, 7, None, INT64_MAX, 0],
                      type=pa.int64()),
        "b": pa.array([-1, 1, 0, 2, -2, 3, -1, 0], type=pa.int64()),
        "i": pa.array([INT32_MIN, 5, -5, 0, 1, 2, 3, None], type=pa.int32()),
        "d": pa.array([2.5, -2.5, 0.5, -0.5, 1.5, 0.0, -0.0, float("nan")]),
    })


def test_int64_min_by_minus_one_does_not_crash(sessions):
    """INT64_MIN div -1 and % -1 (integer division traps on the CPU):
    the wrapping negation and 0, equal to the reference; INT32_MIN % -1
    too."""
    def q(df, X):
        c = X.col
        return df.select(X.node(X.ar.IntegralDivide, c("a"), c("b"))
                         .alias("div"), (c("a") % c("b")).alias("mod"),
                         (c("i") % X.lit(-1)).alias("imod"),
                         X.node(X.ar.Pmod, c("a"), c("b")).alias("pmod"))
    want, got, _ = run_both(sessions, _edge_table().slice(0, 2), q)
    assert_tables_equal(want, got, ignore_order=False)
    assert got["div"].to_pylist() == [INT64_MIN, INT64_MIN]
    assert got["mod"].to_pylist() == [0, 0]
    assert got["imod"].to_pylist() == [0, 0]


def test_zero_divisors_are_null(sessions):
    def q(df, X):
        c = X.col
        return df.select((c("a") / c("b")).alias("div"),
                         (c("a") % c("b")).alias("mod"),
                         X.node(X.ar.IntegralDivide, c("a"), c("b"))
                         .alias("idiv"),
                         X.node(X.ar.Pmod, c("a"), c("b")).alias("pmod"),
                         (c("d") % X.lit(0.0)).alias("dmod"),
                         (c("d") / X.lit(0)).alias("ddiv"))
    t = _edge_table().slice(2, 6)
    want, got, _ = run_both(sessions, t, q)
    assert_tables_equal(want, got, ignore_order=False)
    zero = [b == 0 for b in t["b"].to_pylist()]
    for name in ("div", "mod", "idiv", "pmod"):
        vals = got[name].to_pylist()
        assert all(v is None for v, z in zip(vals, zero) if z)
    assert got["dmod"].null_count == got["ddiv"].null_count == t.num_rows


def test_in_with_a_null_is_three_valued(sessions):
    def q(df, X):
        c = X.col
        return df.select(c("b").isin(2, None).alias("with_null"),
                         c("b").isin(2).alias("without"))
    want, got, _ = run_both(sessions, _edge_table(), q)
    assert_tables_equal(want, got, ignore_order=False)
    # b = -1, 1, 0, 2, -2, 3, -1, 0: a match is true, else null with the
    # null in the list and false without it
    assert got["with_null"].to_pylist() == [None, None, None, True, None,
                                            None, None, None]
    assert got["without"].to_pylist() == [False, False, False, True, False,
                                          False, False, False]


def test_round_at_half(sessions):
    """round is HALF_UP (away from zero), bround HALF_EVEN, at .5."""
    def q(df, X):
        c, F = X.col, X.F
        return df.select(F.round(c("d")).alias("r"),
                         F.bround(c("d")).alias("br"),
                         F.round(c("d") * X.lit(10), -1).alias("r10"))
    want, got, _ = run_both(sessions, _edge_table(), q)
    assert_tables_equal(want, got, ignore_order=False)
    r = got["r"].to_pylist()
    assert r[:5] == [3.0, -3.0, 1.0, -1.0, 2.0] and math.isnan(r[7])
    assert got["br"].to_pylist()[:5] == [2.0, -2.0, 0.0, -0.0, 2.0]
    assert got["r10"].to_pylist()[:2] == [30.0, -30.0]


SATURATION = [(1e19, INT64_MAX), (-1e19, INT64_MIN), (9.3e18, INT64_MAX),
              (-9.3e18, INT64_MIN), (2.0**63, INT64_MAX),
              (-2.0**63, INT64_MIN), (float("nan"), 0),
              (float("inf"), INT64_MAX), (float("-inf"), INT64_MIN),
              (-1.9, -1), (1.9, 1), (9.2e18, 9200000000000000000)]


def test_double_to_long_cast_saturates(sessions):
    """Spark's non-ANSI cast (Java's d.toLong) on the port's CPU path,
    equal to the reference's device path (XLA's convert saturates).  The
    reference's CPU engine clamps to float(2**63 - 1), which is 2^63,
    then converts with numpy: it gives INT64_MIN for 1e19, 9.3e18 and
    +inf (recorded here, ROADMAP.md Queue 3)."""
    t = pa.table({"d": pa.array([d for d, _ in SATURATION])})

    def q(df, X):
        return df.select(X.col("d").cast("long").alias("l"),
                         X.col("d").cast("int").alias("i"))
    want, got, port = run_both(sessions, t, q)
    assert got["l"].to_pylist() == [w for _, w in SATURATION]
    assert got["i"].to_pylist() == [
        max(min(w, 2**31 - 1), INT32_MIN) for _, w in SATURATION]
    assert_tables_equal(want, got, ignore_order=False)
    assert on_gpu(port)
    ref_cpu = TpuSession.builder().config(
        "spark.rapids.sql.enabled", False).get_or_create()
    cpu = q(ref_cpu.create_dataframe(t), REF).collect()["l"].to_pylist()
    assert cpu[0] == cpu[2] == cpu[7] == INT64_MIN


# ---------------------------------------------------------------------------
# where the port follows Spark and the reference does not
# ---------------------------------------------------------------------------

FOLLOWS_SPARK = {
    # INT64_MIN % 3: abs(INT64_MIN) wraps in the reference
    "int64_min_mod_3": (pa.table({"a": pa.array([INT64_MIN]),
                                  "b": pa.array([3])}),
                        lambda X: X.col("a") % X.col("b"), -2),
    "int64_min_div_2": (pa.table({"a": pa.array([INT64_MIN]),
                                  "b": pa.array([2])}),
                        lambda X: X.node(X.ar.IntegralDivide, X.col("a"),
                                         X.col("b")), -2**62),
    "int_mod_int32_min": (pa.table({"a": pa.array([-781112516],
                                                  type=pa.int32()),
                                    "b": pa.array([INT32_MIN],
                                                  type=pa.int32())}),
                          lambda X: X.col("a") % X.col("b"), -781112516),
    # Spark: r = a % n; r < 0 ? (r + n) % n : r
    "pmod_negative_divisor": (pa.table({"a": pa.array([-7]),
                                        "b": pa.array([-3])}),
                              lambda X: X.node(X.ar.Pmod, X.col("a"),
                                               X.col("b")), -1),
    # Spark orders NaN above every double
    "greatest_with_nan": (pa.table({"a": pa.array([1.0]),
                                    "b": pa.array([float("nan")])}),
                          lambda X: X.F.greatest(X.col("a"), X.col("b")),
                          "nan"),
    "least_with_nan_first": (pa.table({"a": pa.array([float("nan")]),
                                       "b": pa.array([1.0])}),
                             lambda X: X.F.least(X.col("a"), X.col("b")),
                             1.0),
    # Spark's IN equates NaN with NaN, as = does
    "nan_in_nan": (pa.table({"a": pa.array([float("nan")])}),
                   lambda X: X.col("a").isin(float("nan"), 1.0), True),
}


@pytest.mark.parametrize("case", sorted(FOLLOWS_SPARK))
def test_port_follows_spark(sessions, case):
    """The port gives Spark's answer; the reference's differs (recorded
    in ROADMAP.md Queue 3, "differs on purpose")."""
    table, fn, spark = FOLLOWS_SPARK[case]

    def q(df, X):
        return df.select(fn(X).alias("r"))
    want, got, _ = run_both(sessions, table, q)
    mine, ref = got["r"].to_pylist()[0], want["r"].to_pylist()[0]
    if spark == "nan":
        assert math.isnan(mine) and not math.isnan(ref)
    else:
        assert mine == spark and ref != spark, (mine, ref)


def test_unported_types_raise_with_their_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        pcol("a").cast("date")
    # string is a type of the port now; a cast to it waits for the
    # string functions
    df = GpuSession(device="cpu").create_dataframe(pa.table({"a": [1]}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        df.select(pcol("a").cast("string")).collect()


def test_literal_operands_and_scalar_edges():
    """A literal on either side or both, unary ops on literals at the
    type's edge, and the both-literal case materialise as columns."""
    port = GpuSession(device="cpu")
    t = pa.table({"a": pa.array([1, 2, 3])})
    got = port.create_dataframe(t).select(
        (plit(2) + plit(3)).alias("s"), (-plit(INT64_MIN)).alias("n"),
        PF.abs(plit(INT64_MIN)).alias("ab"),
        (plit(10) % pcol("a")).alias("m"),
        (plit(1.0) / pcol("a")).alias("q")).collect()
    assert got["s"].to_pylist() == [5] * 3
    assert got["n"].to_pylist() == [INT64_MIN] * 3
    assert got["ab"].to_pylist() == [INT64_MIN] * 3
    assert got["m"].to_pylist() == [0, 0, 1]
    assert got["q"].to_pylist() == [1.0, 0.5, 1.0 / 3.0]


def test_string_names_are_columns_in_functions():
    """As in pyspark, F.sum("v") sums the column v."""
    port = GpuSession(device="cpu")
    t = pa.table({"k": pa.array([1, 1, 2]), "v": pa.array([1, 2, 3])})
    got = port.create_dataframe(t).group_by("k").agg(
        PF.sum("v").alias("s"), PF.min("v").alias("m")).sort("k").collect()
    assert got["s"].to_pylist() == [3, 3]
    assert got["m"].to_pylist() == [1, 3]


def test_round_int_at_negative_scale_on_int32_min(sessions):
    """F.round of an INT column at scale -2 on -2^31: the port returns
    Spark's HALF_UP answer, -2147483600, as an INT.  The reference's
    integral branch gives -2147483700, which does not fit an INT, so its
    collect raises ArrowInvalid (recorded in ROADMAP.md Queue 3)."""
    table = pa.table({"i": pa.array([INT32_MIN, 149, -150, 2**31 - 1],
                                    type=pa.int32())})
    ref, port = sessions
    got = port.create_dataframe(table).select(
        PF.round(pcol("i"), -2).alias("r")).collect()
    assert got.schema.field("r").type == pa.int32()
    assert got["r"].to_pylist() == [-2147483600, 100, -200, 2147483600]
    assert on_gpu(port)
    with pytest.raises(pa.ArrowInvalid):
        ref.create_dataframe(table).select(
            RF.round(rcol("i"), -2).alias("r")).collect()
