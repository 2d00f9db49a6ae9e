"""Logical plan -> device execs.

Counterpart of spark_rapids_tpu/plan/planner.py together with the
aggregate and join conversions of plan/overrides.py (_convert_aggregate,
_convert_join): with one partition, an aggregate plans as a single
COMPLETE-mode GpuHashAggregateExec, and a join through
exec/join.py:plan_join.  The reference's tagging, cost model and CPU
fallback are not ported yet, so a node or a multi-partition aggregate
outside the slice raises NotImplementedError.
"""

from __future__ import annotations

from . import logical as L
from ..exec.aggregate import GpuHashAggregateExec
from ..exec.base import Exec
from ..exec.basic import FilterExec, LocalScanExec
from ..exec.join import plan_join
from ..expr.aggregates import COMPLETE


def plan(lp: L.LogicalPlan) -> Exec:
    if isinstance(lp, L.LocalRelation):
        return LocalScanExec(lp.table, lp.num_partitions,
                             pin_cache=lp.device_cache)
    if isinstance(lp, L.Filter):
        return FilterExec(lp.condition, plan(lp.children[0]))
    if isinstance(lp, L.Aggregate):
        child = plan(lp.children[0])
        if child.num_partitions > 1:
            raise NotImplementedError(
                "an aggregate over more than one partition needs the "
                "shuffle exchange, which is not ported yet")
        return GpuHashAggregateExec(lp.grouping, lp.aggregates, COMPLETE,
                                    child)
    if isinstance(lp, L.Join):
        return plan_join(lp, plan(lp.children[0]), plan(lp.children[1]))
    raise NotImplementedError(
        f"logical plan node {type(lp).__name__} is not ported yet")
