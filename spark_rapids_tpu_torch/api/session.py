"""The port's session: the DataFrame entry point.

Counterpart of spark_rapids_tpu/api/session.py (TpuSession).  A session
runs its queries on one device, ``cuda`` unless the caller passes
another; asking for CUDA where there is none raises.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ..columnar.device import resolve_device
from ..exec.base import Exec, ExecContext
from ..plan import logical as L
from ..plan.planner import plan
from .dataframe import DataFrame


class GpuSession:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.last_plan: Optional[Exec] = None

    def create_dataframe(self, data, num_partitions: int = 1) -> DataFrame:
        if isinstance(data, pa.RecordBatch):
            data = pa.Table.from_batches([data])
        elif isinstance(data, dict):
            data = pa.table(data)
        elif not isinstance(data, pa.Table):
            raise TypeError(f"cannot create a DataFrame from {type(data)}")
        relation = L.LocalRelation(data, num_partitions)
        relation.schema()             # an unported column type raises here
        return DataFrame(relation, self)

    def execute(self, lp: L.LogicalPlan) -> pa.Table:
        root = plan(lp)
        self.last_plan = root
        return root.execute_collect(ExecContext(self.device))
