"""Logical plan nodes of the slice: LocalRelation, Filter, Aggregate.

Counterpart of spark_rapids_tpu/plan/logical.py; each node resolves its
output schema.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
