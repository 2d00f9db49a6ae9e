"""DataFrame and GroupedData of the slice.

Counterpart of spark_rapids_tpu/api/dataframe.py: columns, dtypes,
select (window expressions go through a Window node),
select_expr_window, with_column, filter / where, group_by / groupBy,
agg, join, union / unionAll, distinct, drop, with_column_renamed,
repartition, sample, order_by / orderBy / sort, sort_within_partitions,
limit, cache / persist, unpersist, is_cached, collect, to_pandas, count,
show, explain and write; GroupedData's agg, pivot, count, sum, avg,
min and max.  ``cache()`` registers the DataFrame's plan with the process-wide
CacheManager (io/cached_batch.py) until ``unpersist()``: the next query
over it materializes parquet blobs, later ones scan them; under a Spark
3.0.x dialect (``spark.rapids.tpu.sparkVersion``) it does nothing.
"""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from ..exec.join import JOIN_TYPES
from ..expr.aggregates import AggregateExpression
from ..expr.core import Alias, AttributeReference, Expression, Literal
from ..expr.window import WindowExpression
from ..io.cached_batch import CacheManager, cached_batch_supported
from ..io.writer import DataFrameWriter
from ..plan import logical as L
from . import functions as F
from .column import Column, col, lit


def _to_expr(c) -> Expression:
    if isinstance(c, Column):
        return c.expr
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return AttributeReference(c)
    return Literal(c)


class DataFrame:
    def __init__(self, lp: L.LogicalPlan, session):
        self._lp = lp
        self.session = session

    @property
    def columns(self) -> List[str]:
        return self._lp.schema()[0]

    @property
    def dtypes(self):
        """[(column name, SQL type name)]."""
        names, types = self._lp.schema()
        return list(zip(names, [dt.name for dt in types]))

    def select(self, *cols) -> "DataFrame":
        exprs = []
        for c in cols:
            if isinstance(c, str) and c == "*":
                exprs += [AttributeReference(n) for n in self.columns]
            else:
                e = _to_expr(c)
                if isinstance(e, Alias) and isinstance(e.child,
                                                       WindowExpression):
                    e.child.name = e.name
                    e = e.child
                if isinstance(c, Column) and c._alias and \
                        isinstance(e, WindowExpression):
                    e.name = c._alias
                exprs.append(e)
        # window expressions go through a Window node, then a projection
        windows = [e for e in exprs if isinstance(e, WindowExpression)]
        if windows:
            base = L.Window(windows, self._lp)
            proj = [AttributeReference(e.name)
                    if isinstance(e, WindowExpression) else e
                    for e in exprs]
            return DataFrame(L.Project(proj, base), self.session)
        return DataFrame(L.Project(exprs, self._lp), self.session)

    def select_expr_window(self, *window_exprs) -> "DataFrame":
        """Every column, then each window expression as its own column."""
        return DataFrame(L.Window(list(window_exprs), self._lp),
                         self.session)

    def with_column(self, name: str, c) -> "DataFrame":
        """Every other column, then ``c`` as ``name`` (last, as in the
        reference)."""
        cols = [col(n) for n in self.columns if n != name]
        cc = c if isinstance(c, Column) else Column(_to_expr(c))
        return self.select(*cols, cc.alias(name))

    withColumn = with_column

    def filter(self, condition) -> "DataFrame":
        return DataFrame(L.Filter(_to_expr(condition), self._lp),
                         self.session)

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData([_to_expr(c) for c in cols], self)

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return self.group_by().agg(*aggs)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join with ``other``: ``on`` is a column name or a list of names
        (USING: one key column in the output) or a condition; ``how`` one
        of inner, left, right, full, left_semi, left_anti, cross, or a
        Spark alias of one."""
        how = {"leftsemi": "left_semi", "semi": "left_semi",
               "leftanti": "left_anti", "anti": "left_anti",
               "outer": "full", "fullouter": "full",
               "leftouter": "left", "rightouter": "right"}.get(
                   how.lower().replace("_", ""), how.lower())
        if how not in JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}; expected one of "
                             f"{', '.join(JOIN_TYPES)} or a Spark alias")
        cond = None
        using = None
        if on is not None:
            if isinstance(on, str):
                using = [on]
            elif isinstance(on, (list, tuple)) and on and \
                    isinstance(on[0], str):
                using = list(on)
            else:
                cond = _to_expr(on)
        return DataFrame(L.Join(self._lp, other._lp, how, cond, using),
                         self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """The rows of both, by position (Spark's UNION ALL)."""
        return DataFrame(L.Union([self._lp, other._lp]), self.session)

    unionAll = union

    def distinct(self) -> "DataFrame":
        return DataFrame(L.Distinct(self._lp), self.session)

    def drop(self, *names) -> "DataFrame":
        keep = [AttributeReference(n) for n in self.columns
                if n not in names]
        return DataFrame(L.Project(keep, self._lp), self.session)

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(AttributeReference(n), new) if n == old
                 else AttributeReference(n) for n in self.columns]
        return DataFrame(L.Project(exprs, self._lp), self.session)

    withColumnRenamed = with_column_renamed

    def repartition(self, num_partitions: int, *cols) -> "DataFrame":
        """``num_partitions`` partitions, by the hash of ``cols`` or round
        robin without them."""
        keys = [_to_expr(c) for c in cols] or None
        return DataFrame(L.Repartition(num_partitions, keys, self._lp),
                         self.session)

    def sample(self, fraction: float, seed: Optional[int] = None
               ) -> "DataFrame":
        """Each row with probability ``fraction``, decided by a hash of
        (seed, partition, the row's index in its partition)."""
        return DataFrame(L.Sample(fraction, 42 if seed is None else seed,
                                  self._lp), self.session)

    def order_by(self, *cols, ascending=True) -> "DataFrame":
        """A global sort.  A column's own order (``asc``, ``desc``,
        ``asc_nulls_last``, ``desc_nulls_first``) wins; otherwise
        ``ascending`` (one bool, or a list of one bool a column) applies, with nulls
        first exactly when the order is ascending."""
        orders = []
        for i, c in enumerate(cols):
            if isinstance(c, Column) and c._sort_order is not None:
                asc, nf = c._sort_order
                orders.append((c.expr, asc, nf))
            else:
                asc = ascending if isinstance(ascending, bool) \
                    else ascending[i]
                orders.append((_to_expr(c), asc, asc))
        return DataFrame(L.Sort(orders, True, self._lp), self.session)

    orderBy = order_by
    sort = order_by

    def sort_within_partitions(self, *cols, ascending=True) -> "DataFrame":
        orders = [(_to_expr(c), ascending, ascending) for c in cols]
        return DataFrame(L.Sort(orders, False, self._lp), self.session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._lp), self.session)

    def cache(self) -> "DataFrame":
        """Keep this DataFrame's rows as parquet blobs from its next
        query on; a no-op under a Spark 3.0.x dialect."""
        if cached_batch_supported(self.session.conf):
            CacheManager.cache(self._lp)
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        CacheManager.uncache(self._lp)
        return self

    @property
    def is_cached(self) -> bool:
        return CacheManager.lookup(self._lp) is not None

    def collect(self) -> pa.Table:
        return self.session.execute(self._lp)

    def to_pandas(self):
        return self.collect().to_pandas()

    toPandas = to_pandas

    def count(self) -> int:
        res = self.agg(F.count(lit(1)).alias("count")).collect()
        return res.column("count").to_pylist()[0]

    def show(self, n: int = 20):
        print(self.limit(n).collect().to_pandas().to_string())

    def explain(self) -> str:
        s = self.session.explain(self._lp)
        print(s)
        return s

    @property
    def write(self) -> DataFrameWriter:
        return DataFrameWriter(self)


class GroupedData:
    def __init__(self, grouping: List[Expression], df: DataFrame):
        self.grouping = grouping
        self.df = df
        self._pivot = None

    def agg(self, *aggs) -> DataFrame:
        out = []
        for a in aggs:
            e = a.expr if isinstance(a, Column) else a
            name = a._alias if isinstance(a, Column) else None
            if isinstance(e, Alias) and isinstance(e.child,
                                                   AggregateExpression):
                name, e = e.name, e.child
            if not isinstance(e, AggregateExpression):
                raise TypeError(f"not an aggregate: {e}")
            out.append(AggregateExpression(e.func, name or e.name))
        if self._pivot is not None:
            out = self._expand_pivot_aggs(out)
        return DataFrame(L.Aggregate(self.grouping, out, self.df._lp),
                         self.df.session)

    def pivot(self, pivot_col, values=None) -> "GroupedData":
        """``group_by(k).pivot(p, [v1, v2]).agg(...)``: one output column
        per (pivot value, aggregate), each aggregate over IF(p <=> v, x,
        NULL), so the pivot is one grouped pass; a first becomes
        PivotFirst.  With ``values`` omitted they are the distinct values
        of ``p``, collected first and sorted by (is null, str)."""
        p = pivot_col.expr if isinstance(pivot_col, Column) else \
            col(pivot_col).expr if isinstance(pivot_col, str) else pivot_col
        if values is None:
            vt = self.df.select(Column(p)).distinct().collect()
            values = sorted(vt.column(0).to_pylist(),
                            key=lambda v: (v is None, str(v)))
        g = GroupedData(self.grouping, self.df)
        g._pivot = (p, list(values))
        return g

    def _expand_pivot_aggs(self, aggs):
        from .. import types as t
        from ..expr.aggregates import First, PivotFirst
        from ..expr.conditional import If
        from ..expr.predicates import EqualNullSafe
        p, values = self._pivot
        out = []
        for v in values:
            for ae in aggs:
                fn = ae.func
                if not fn.children:
                    raise TypeError(
                        "pivot aggregates need an input column "
                        "(count(*) unsupported, use count(col))")
                name = str(v) if len(aggs) == 1 else f"{v}_{ae.name}"
                if type(fn) is First:
                    out.append(AggregateExpression(
                        PivotFirst(p, fn.child, v), name))
                    continue
                masked = fn.with_children(
                    [If(EqualNullSafe(p, Literal(v)), fn.child,
                        Literal(None, t.NULL))] + list(fn.children[1:]))
                out.append(AggregateExpression(masked, name))
        return out

    def count(self) -> DataFrame:
        return self.agg(F.count(lit(1)).alias("count"))

    def _simple(self, fn: str, cols) -> DataFrame:
        """``fn`` of each named column, or of every numeric column (the
        reference's type names) when none is named."""
        names = cols or [n for n, tn in self.df.dtypes
                         if tn in ("tinyint", "smallint", "int", "bigint",
                                   "float", "double") or
                         tn.startswith("decimal")]
        return self.agg(*[getattr(F, fn)(col(n)).alias(f"{fn}({n})")
                          for n in names])

    def sum(self, *cols) -> DataFrame:
        return self._simple("sum", list(cols))

    def avg(self, *cols) -> DataFrame:
        return self._simple("avg", list(cols))

    def min(self, *cols) -> DataFrame:
        return self._simple("min", list(cols))

    def max(self, *cols) -> DataFrame:
        return self._simple("max", list(cols))
