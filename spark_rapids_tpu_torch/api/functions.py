"""pyspark.sql.functions-style surface of the port.

Counterpart of spark_rapids_tpu/api/functions.py over the port's flat
types: col, lit; the aggregates sum, avg (mean), count, min, max,
first, last, stddev (stddev_samp), stddev_pop, variance (var_samp),
var_pop, collect_list, collect_set, approx_percentile
(percentile_approx) and pivot_first; the
scalar functions abs, sqrt, exp, expm1, log (ln, or log(base, x)),
log2, log10, log1p, pow, atan2, the trigonometric and hyperbolic
functions, cbrt, rint, degrees, radians, floor, ceil, round, bround,
signum, greatest, least, when(...).when(...).otherwise(...), coalesce,
isnull, isnan, expr_if, monotonically_increasing_id, spark_partition_id,
input_file_name, rand and scalar_subquery; year, month, dayofmonth and
window (a tumbling time window); bitwise_and, bitwise_or, bitwise_xor,
bitwise_not, shiftleft, shiftright and shiftrightunsigned; and the
window functions row_number, rank, dense_rank, lead, lag, ntile,
percent_rank and cume_dist.  As in pyspark, a string argument names a
column (the reference reads it as a string literal, which no flat
function takes).
"""

from __future__ import annotations

from ..expr import aggregates as agg
from ..expr import arithmetic as ar
from ..expr import bitwise as bw
from ..expr import conditional as cond
from ..expr import datetime_expr as dte
from ..expr import hashfns as hf
from ..expr import mathexpr as mx
from ..expr import predicates as pred
from ..expr import window as win
from ..expr.core import AttributeReference, Expression
from .column import Column, _expr, col, lit  # noqa: F401  (re-export)


def _arg(c) -> Expression:
    """A function's argument: a column name, a Column, an Expression or
    a literal value."""
    return AttributeReference(c) if isinstance(c, str) else _expr(c)


def _c(e: Expression) -> Column:
    return Column(e)


# -- aggregates --------------------------------------------------------------

def sum(c) -> Column:  # noqa: A001
    return _c(agg.AggregateExpression(agg.Sum(_arg(c))))


def count(c="*") -> Column:
    child = None if (isinstance(c, str) and c == "*") else _arg(c)
    return _c(agg.AggregateExpression(agg.Count(child)))


def avg(c) -> Column:
    return _c(agg.AggregateExpression(agg.Average(_arg(c))))


mean = avg


def min(c) -> Column:  # noqa: A001
    return _c(agg.AggregateExpression(agg.Min(_arg(c))))


def max(c) -> Column:  # noqa: A001
    return _c(agg.AggregateExpression(agg.Max(_arg(c))))


def first(c, ignorenulls: bool = False) -> Column:
    return _c(agg.AggregateExpression(agg.First(_arg(c), ignorenulls)))


def last(c, ignorenulls: bool = False) -> Column:
    return _c(agg.AggregateExpression(agg.Last(_arg(c), ignorenulls)))


def stddev(c) -> Column:
    return _c(agg.AggregateExpression(agg.StddevSamp(_arg(c))))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return _c(agg.AggregateExpression(agg.StddevPop(_arg(c))))


def variance(c) -> Column:
    return _c(agg.AggregateExpression(agg.VarianceSamp(_arg(c))))


var_samp = variance


def var_pop(c) -> Column:
    return _c(agg.AggregateExpression(agg.VariancePop(_arg(c))))


def collect_list(c) -> Column:
    return _c(agg.AggregateExpression(agg.CollectList(_arg(c))))


def collect_set(c) -> Column:
    return _c(agg.AggregateExpression(agg.CollectSet(_arg(c))))


def approx_percentile(c, percentage: float, accuracy: int = 10000
                      ) -> Column:
    """The exact inverted-CDF percentile of each group (``accuracy`` is
    accepted and not needed)."""
    return _c(agg.AggregateExpression(
        agg.ApproximatePercentile(_arg(c), percentage, accuracy)))


percentile_approx = approx_percentile


def pivot_first(pivot_col, value_col, pivot_value) -> Column:
    """The first non-null value_col of the rows whose pivot_col is
    pivot_value: the unit a pivot lowers to."""
    return _c(agg.AggregateExpression(
        agg.PivotFirst(_arg(pivot_col), _arg(value_col), pivot_value)))


# -- scalar ------------------------------------------------------------------

def abs(c) -> Column:  # noqa: A001
    return _c(ar.Abs(_arg(c)))


def _unary(cls):
    def fn(c) -> Column:
        return _c(cls(_arg(c)))
    fn.__name__ = cls.__name__.lower()
    return fn


sqrt = _unary(mx.Sqrt)
exp = _unary(mx.Exp)
expm1 = _unary(mx.Expm1)
sin = _unary(mx.Sin)
cos = _unary(mx.Cos)
tan = _unary(mx.Tan)
cot = _unary(mx.Cot)
asin = _unary(mx.Asin)
acos = _unary(mx.Acos)
atan = _unary(mx.Atan)
sinh = _unary(mx.Sinh)
cosh = _unary(mx.Cosh)
tanh = _unary(mx.Tanh)
asinh = _unary(mx.Asinh)
acosh = _unary(mx.Acosh)
atanh = _unary(mx.Atanh)
cbrt = _unary(mx.Cbrt)
rint = _unary(mx.Rint)
degrees = _unary(mx.ToDegrees)
radians = _unary(mx.ToRadians)
log2 = _unary(mx.Log2)
log10 = _unary(mx.Log10)
log1p = _unary(mx.Log1p)
floor = _unary(mx.Floor)
ceil = _unary(mx.Ceil)
signum = _unary(mx.Signum)


def log(a, b=None) -> Column:
    """ln(a), or the logarithm of b to base a (pyspark's order)."""
    if b is None:
        return _c(mx.Log(_arg(a)))
    return _c(mx.Logarithm(_arg(a), _arg(b)))


def pow(l, r) -> Column:  # noqa: A001
    return _c(mx.Pow(_arg(l), _arg(r)))


def atan2(l, r) -> Column:
    return _c(mx.Atan2(_arg(l), _arg(r)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return _c(mx.Round(_arg(c), scale))


def bround(c, scale: int = 0) -> Column:
    return _c(mx.BRound(_arg(c), scale))


def greatest(*cols) -> Column:
    return _c(ar.Greatest(*[_arg(c) for c in cols]))


def least(*cols) -> Column:
    return _c(ar.Least(*[_arg(c) for c in cols]))


def when(condition, value) -> "CaseBuilder":
    return CaseBuilder([(_expr(condition), _expr(value))])


class CaseBuilder(Column):
    def __init__(self, branches):
        self._branches = branches
        super().__init__(cond.CaseWhen(branches))

    def when(self, condition, value) -> "CaseBuilder":
        return CaseBuilder(self._branches + [(_expr(condition),
                                              _expr(value))])

    def otherwise(self, value) -> Column:
        return Column(cond.CaseWhen(self._branches, _expr(value)))


def coalesce(*cols) -> Column:
    return _c(cond.Coalesce(*[_arg(c) for c in cols]))


def isnull(c) -> Column:
    return _c(pred.IsNull(_arg(c)))


def isnan(c) -> Column:
    return _c(pred.IsNaN(_arg(c)))


def expr_if(c, a, b) -> Column:
    return _c(cond.If(_expr(c), _expr(a), _expr(b)))


def hash(*cols) -> Column:  # noqa: A001
    """Spark's hash(): Murmur3 with seed 42 over the columns, an INT."""
    from ..expr.hashfns import Murmur3Hash
    return _c(Murmur3Hash([_arg(c) for c in cols]))


def element_at(c, index) -> Column:
    """element_at(array, i): 1-based, negative from the end; null out of
    range."""
    from ..expr.complextype import ElementAt
    return _c(ElementAt(_arg(c), _expr(index)))


def array(*cols) -> Column:
    from ..expr.complextype import CreateArray
    return _c(CreateArray([_arg(c) for c in cols]))


def struct(*cols) -> Column:
    """A struct of the columns, each field named as the column is."""
    from ..expr.complextype import CreateNamedStruct
    from ..expr.core import output_name
    exprs = [_arg(c) for c in cols]
    return _c(CreateNamedStruct([output_name(e) for e in exprs], exprs))


def monotonically_increasing_id() -> Column:
    return _c(hf.MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    return _c(hf.SparkPartitionID())


def input_file_name() -> Column:
    return _c(hf.InputFileName())


def rand(seed: int = 0) -> Column:
    """Uniform in [0, 1), determined by (seed, partition, row position):
    the reference's values, not Spark's XORShift stream."""
    return _c(hf.Rand(seed))


def scalar_subquery(df) -> Column:
    """A one-row, one-column DataFrame as a value: it runs first and its
    value enters the query as a literal."""
    from ..expr.subquery import ScalarSubquery
    return _c(ScalarSubquery(df._lp))


# -- dates and times ---------------------------------------------------------

def year(c) -> Column:
    return _c(dte.Year(_arg(c)))


def month(c) -> Column:
    return _c(dte.Month(_arg(c)))


def dayofmonth(c) -> Column:
    return _c(dte.DayOfMonth(_arg(c)))


def window(time_col, window_duration: str, slide_duration: str = None,
           start_time: str = "0 seconds") -> Column:
    """window(ts, '10 minutes'): the struct<start, end> of the row's
    tumbling window, a grouping key.  A slide other than the window
    duration (a sliding window) is not ported (ROADMAP Queue 1 item
    4d)."""
    w = dte.parse_duration_micros(window_duration)
    s = dte.parse_duration_micros(slide_duration) if slide_duration \
        else None
    st = dte.parse_duration_micros(start_time, allow_nonpositive=True) \
        if start_time else 0
    return _c(dte.TimeWindow(_arg(time_col), w, s, st))


# -- bitwise -----------------------------------------------------------------

def bitwise_and(a, b) -> Column:
    return _c(bw.BitwiseAnd(_arg(a), _arg(b)))


def bitwise_or(a, b) -> Column:
    return _c(bw.BitwiseOr(_arg(a), _arg(b)))


def bitwise_xor(a, b) -> Column:
    return _c(bw.BitwiseXor(_arg(a), _arg(b)))


def bitwise_not(c) -> Column:
    return _c(bw.BitwiseNot(_arg(c)))


def shiftleft(c, n) -> Column:
    return _c(bw.ShiftLeft(_arg(c), _expr(n)))


def shiftright(c, n) -> Column:
    return _c(bw.ShiftRight(_arg(c), _expr(n)))


def shiftrightunsigned(c, n) -> Column:
    return _c(bw.ShiftRightUnsigned(_arg(c), _expr(n)))


# -- window ------------------------------------------------------------------

def row_number() -> Column:
    return Column(win.RowNumber())


def rank() -> Column:
    return Column(win.Rank())


def dense_rank() -> Column:
    return Column(win.DenseRank())


def lead(c, offset: int = 1) -> Column:
    return Column(win.Lead(_expr(c), offset))


def lag(c, offset: int = 1) -> Column:
    return Column(win.Lag(_expr(c), offset))


def ntile(n: int) -> Column:
    return Column(win.NTile(n))


def percent_rank() -> Column:
    return Column(win.PercentRank())


def cume_dist() -> Column:
    return Column(win.CumeDist())


# -- strings -----------------------------------------------------------------

def upper(c) -> Column:
    from ..expr.strings import Upper
    return _c(Upper(_arg(c)))


def lower(c) -> Column:
    from ..expr.strings import Lower
    return _c(Lower(_arg(c)))


def length(c) -> Column:
    from ..expr.strings import Length
    return _c(Length(_arg(c)))


def substring(c, pos, length) -> Column:
    from ..expr.core import Literal
    from ..expr.strings import Substring
    return _c(Substring(_arg(c), Literal(pos), Literal(length)))


def concat(*cols) -> Column:
    from ..expr.strings import Concat
    return _c(Concat(*[_arg(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Column:
    """concat_ws(sep, c1, c2, ...): the inputs that are not null joined
    by sep."""
    from ..expr.core import Literal
    from ..expr.strings import ConcatWs
    return _c(ConcatWs(Literal(sep), *[_arg(c) for c in cols]))


def md5(c) -> Column:
    from ..expr.hashfns import Md5
    return _c(Md5(_arg(c)))


def ascii(c) -> Column:  # noqa: A001
    from ..expr.strings import Ascii
    return _c(Ascii(_arg(c)))
