"""The port's session: the DataFrame entry point.

Counterpart of spark_rapids_tpu/api/session.py (TpuSession).  A session
holds its configuration and runs its queries on one device, ``cuda``
unless the caller passes another; asking for CUDA where there is none
raises.  A query's scalar subqueries run first and become literals
(expr/subquery.py); it is then planned to a CPU-placed physical plan,
rewritten onto the GPU by plan/overrides.py, and executed; ``last_plan`` and
``last_explain`` keep the final plan and the rewrite's explain lines.
A global sort of an in-memory table is first offered to the
host-assisted collect (plan/host_assist.py), which runs its own row-id
query; ``last_plan`` is then that query's plan.  ``read`` returns a
DataFrameReader (io/reader.py); ``range`` a DataFrame of one LONG
column ``id``.
With ``spark.rapids.sql.enabled=false`` every operator stays on the CPU
engine, the oracle the reference's differential tests toggle.
"""

from __future__ import annotations

from typing import Dict, Optional

import pyarrow as pa

from ..columnar.device import resolve_device
from ..config import RapidsConf
from ..exec.base import Exec, ExecContext
from ..expr.subquery import resolve_scalar_subqueries
from ..io.reader import DataFrameReader
from ..plan import logical as L
from ..plan.host_assist import try_host_assisted_collect
from ..plan.overrides import GpuOverrides
from ..plan.planner import plan as plan_physical
from .dataframe import DataFrame


class GpuSession:
    def __init__(self, device=None, conf: Optional[Dict] = None):
        self.device = resolve_device(device)
        self._conf_map = dict(conf or {})
        self.last_plan: Optional[Exec] = None
        self.last_explain = ""

    @property
    def conf(self) -> RapidsConf:
        return RapidsConf(self._conf_map)

    @classmethod
    def builder(cls) -> "_Builder":
        return _Builder()

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

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

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> DataFrame:
        """One LONG column ``id``: start, start + step, ... below ``end``
        (above it for a negative step); ``range(n)`` is 0 .. n - 1."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.Range(start, end, step, num_partitions), self)

    def prepare_plan(self, lp: L.LogicalPlan,
                     run_subqueries: bool = True) -> Exec:
        """Logical plan -> final physical plan: the scalar subqueries (run
        first, or with ``run_subqueries=False`` replaced by typed nulls so
        that nothing runs), planning, then the rewrite onto the GPU."""
        lp = resolve_scalar_subqueries(lp, self, run_subqueries)
        conf = self.conf
        overrides = GpuOverrides(conf)
        final_plan = overrides.apply(plan_physical(lp, conf))
        self.last_plan = final_plan
        self.last_explain = overrides.last_explain
        return final_plan

    def execute(self, lp: L.LogicalPlan) -> pa.Table:
        assisted = try_host_assisted_collect(self, lp)
        if assisted is not None:
            return assisted
        root = self.prepare_plan(lp)
        return root.execute_collect(ExecContext(self.device, self.conf))

    def explain(self, lp: L.LogicalPlan) -> str:
        """The final plan (``*`` marks a GPU-placed operator) and the
        rewrite's explain lines, without running the query."""
        final_plan = self.prepare_plan(lp, run_subqueries=False)
        return final_plan.tree_string() + "\n--\n" + self.last_explain


class _Builder:
    def __init__(self):
        self._conf: Dict = {}

    def config(self, key, value) -> "_Builder":
        self._conf[key] = value
        return self

    def get_or_create(self, device=None) -> GpuSession:
        return GpuSession(device=device, conf=self._conf)
