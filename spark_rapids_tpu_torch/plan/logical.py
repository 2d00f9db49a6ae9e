"""Logical plan nodes of the slice: LocalRelation, Range, FileRelation,
Project, Filter, Aggregate, Join, Sort, Limit, Union, Window, Distinct,
Sample and Repartition.

Counterpart of spark_rapids_tpu/plan/logical.py; each node resolves its
output schema.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import pyarrow as pa

from .. import types as t
from ..columnar.interop import from_arrow_type
from ..expr.aggregates import AggregateExpression, bind_aggregate
from ..expr.core import Expression, bind_expression, output_name


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def schema(self) -> Tuple[List[str], List[t.DataType]]:
        raise NotImplementedError


class LocalRelation(LogicalPlan):
    def __init__(self, table: pa.Table, num_partitions: int = 1):
        self.table = table
        self.num_partitions = num_partitions
        # device batches shared by every scan planned from this node;
        # they live as long as the user's DataFrame
        self.device_cache: dict = {}

    def schema(self):
        return (list(self.table.schema.names),
                [from_arrow_type(f.type) for f in self.table.schema])


class Range(LogicalPlan):
    """``range(start, end, step)`` as one LONG column ``id``."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions

    def schema(self):
        return ["id"], [t.LONG]


class FileRelation(LogicalPlan):
    """Scan of parquet, orc or csv files (resolved by the io layer).  A
    filter pushed into the scan lives in that query's scan exec
    (plan/planner.py), never on this node, which every query over the
    DataFrame shares."""

    def __init__(self, fmt: str, paths: List[str], schema_names,
                 schema_types, options=None):
        self.fmt = fmt
        self.paths = list(paths)
        self._names = list(schema_names)
        self._types = list(schema_types)
        self.options = dict(options or {})

    def schema(self):
        return list(self._names), list(self._types)


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = (child,)

    def schema(self):
        cn, ct = self.children[0].schema()
        return ([output_name(e) for e in self.exprs],
                [bind_expression(e, cn, ct).data_type() for e in self.exprs])


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()


class Aggregate(LogicalPlan):
    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[AggregateExpression],
                 child: LogicalPlan):
        self.grouping = list(grouping)
        self.aggregates = list(aggregates)
        self.children = (child,)

    def schema(self):
        cn, ct = self.children[0].schema()
        names = [output_name(g) for g in self.grouping]
        dtypes = [bind_expression(g, cn, ct).data_type()
                  for g in self.grouping]
        for a in self.aggregates:
            names.append(a.name)
            dtypes.append(bind_aggregate(a, cn, ct).data_type())
        return names, dtypes


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, how: str,
                 condition: Optional[Expression] = None,
                 using: Optional[List[str]] = None):
        self.children = (left, right)
        self.how = how  # inner, left, right, full, left_semi, left_anti, cross
        self.condition = condition
        self.using = using

    def schema(self):
        ln, lt = self.children[0].schema()
        rn, rt = self.children[1].schema()
        if self.how in ("left_semi", "left_anti"):
            return ln, lt
        if self.using:
            # USING (as plan_join projects it): the key columns first, then
            # each side's other columns
            names, types = [], []
            for k in self.using:
                names.append(k)
                types.append(rt[rn.index(k)] if self.how == "right"
                             else lt[ln.index(k)])
            for n, t_ in zip(ln, lt):
                if n not in self.using:
                    names.append(n)
                    types.append(t_)
            for n, t_ in zip(rn, rt):
                if n not in self.using:
                    names.append(n)
                    types.append(t_)
            return names, types
        return ln + rn, lt + rt


class Sort(LogicalPlan):
    def __init__(self, orders, is_global: bool, child: LogicalPlan):
        # orders: [(expr, ascending, nulls_first)]
        self.orders = list(orders)
        self.is_global = is_global
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()


class Union(LogicalPlan):
    """The children's rows, end to end; the first child names the
    columns."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = tuple(children)

    def schema(self):
        return self.children[0].schema()


class Window(LogicalPlan):
    """Window function application; window_exprs are WindowExpressions,
    each a new column after the child's."""

    def __init__(self, window_exprs, child: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.children = (child,)

    def schema(self):
        cn, ct = self.children[0].schema()
        names, dtypes = list(cn), list(ct)
        for we in self.window_exprs:
            names.append(we.name)
            dtypes.append(we.resolved_type(cn, ct))
        return names, dtypes


class Distinct(LogicalPlan):
    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()


class Sample(LogicalPlan):
    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        self.fraction = fraction
        self.seed = seed
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()


class Repartition(LogicalPlan):
    """``num_partitions`` partitions: by the hash of ``keys``, or round
    robin when there are none."""

    def __init__(self, num_partitions: int,
                 keys: Optional[List[Expression]], child: LogicalPlan):
        self.num_partitions = num_partitions
        self.keys = keys
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()
