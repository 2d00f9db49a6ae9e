"""Logical plan -> CPU-placed physical plan.

Counterpart of spark_rapids_tpu/plan/planner.py: the planner produces
the plan Spark's query planner would hand the plugin, every operator
placed on the CPU, and plan/overrides.py then rewrites it onto the GPU (tagging
the pieces that stay on the CPU).  A file relation becomes a
FileScanExec: an attribute-only projection directly over it prunes the
scan's columns, and a filter directly over it pushes its condition into
that query's scan (the exact filter stays above; the shared relation is
never changed).  An aggregate over more than one
partition gets a hash exchange on its grouping keys (a partition
gather for a global aggregate); a join is planned by
exec/join.py:plan_join.  Distinct is the aggregate that groups by every
column with no aggregates, so over more than one partition it gets the
same hash exchange and duplicates across partitions meet; repartition is
a shuffle exchange, hash partitioned by its keys or round robin.  A node
whose DataFrame was cached (io/cached_batch.py) is planned as a
CachedScanExec once its entry is materialized, and under a
CacheWriteExec until then.  A logical node the port's API cannot build yet
raises NotImplementedError, and so do monotonically_increasing_id(),
spark_partition_id() and rand() anywhere but a projection or a filter,
the two operators that carry their running row base.
"""

from __future__ import annotations

from . import logical as L
from ..exec.aggregate import CpuHashAggregateExec
from ..exec.base import CPU, Exec
from ..exec.basic import (FilterExec, GlobalLimitExec, LocalLimitExec,
                          LocalScanExec, ProjectExec, RangeExec, SampleExec,
                          UnionExec)
from ..exec.gatherpart import GatherPartitionsExec
from ..exec.join import plan_join
from ..exec.sort import SortExec
from ..exec.window import WindowExec
from ..expr.core import AttributeReference, Expression
from ..expr.hashfns import POSITIONAL, InputFileName
from ..io.cached_batch import CacheManager, CachedScanExec, CacheWriteExec
from ..io.scan import FileScanExec, make_scan_exec
from ..shuffle.exchange import ShuffleExchangeExec
from ..shuffle.partitioning import (HashPartitioning, RangePartitioning,
                                    RoundRobinPartitioning)


def plan(lp: L.LogicalPlan, conf) -> Exec:
    root = _plan(lp, conf)
    root.foreach(lambda e: setattr(e, "placement", CPU))
    _force_perfile_if_input_file(root)
    return root


def _force_perfile_if_input_file(root: Exec) -> None:
    """A plan that evaluates input_file_name() reads one file a partition
    (PERFILE), so that every batch comes from one file (the reference's
    ``force_perfile_if_input_file``)."""
    found = []

    def check(v):
        if isinstance(v, Expression):
            found.extend(v.collect(lambda x: isinstance(x, InputFileName)))
        elif isinstance(v, (list, tuple)):
            for x in v:
                check(x)

    root.foreach(lambda node: check(getattr(node, "_bound", None)))
    if found:
        root.foreach(lambda n: isinstance(n, FileScanExec) and
                     setattr(n, "reader_type", "PERFILE"))


def _row_id_exprs(lp: L.LogicalPlan):
    """The expressions of an operator that carries no row base."""
    if isinstance(lp, L.Aggregate):
        return lp.grouping + lp.aggregates
    if isinstance(lp, L.Join):
        return [lp.condition] if lp.condition is not None else []
    if isinstance(lp, L.Sort):
        return [e for e, _, _ in lp.orders]
    if isinstance(lp, L.Repartition):
        return list(lp.keys or [])
    if isinstance(lp, L.Window):
        return [x for w in lp.window_exprs
                for x in [w, *w.spec.partition_by,
                          *(e for e, _, _ in w.spec.order_by)]]
    return []


def _plan(lp: L.LogicalPlan, conf) -> Exec:
    entry = CacheManager.lookup(lp)
    if entry is None:
        return _plan_uncached(lp, conf)
    if entry.materialized:
        names, dtypes = lp.schema()
        return CachedScanExec(entry, names, dtypes)
    return CacheWriteExec(entry, _plan_uncached(lp, conf))


def _plan_uncached(lp: L.LogicalPlan, conf) -> Exec:
    for e in _row_id_exprs(lp):
        found = e.collect(lambda x: isinstance(x, POSITIONAL))
        if found:
            raise NotImplementedError(
                f"{found[0].sql()} in a {type(lp).__name__} is not "
                "supported: project it into a column first")
    if isinstance(lp, L.LocalRelation):
        return LocalScanExec(lp.table, lp.num_partitions,
                             pin_cache=lp.device_cache)
    if isinstance(lp, L.Range):
        return RangeExec(lp.start, lp.end, lp.step, lp.num_partitions)
    if isinstance(lp, L.FileRelation):
        return make_scan_exec(lp, conf)
    if isinstance(lp, L.Project):
        child_lp = lp.children[0]
        if isinstance(child_lp, L.FileRelation) and all(
                isinstance(e, AttributeReference) for e in lp.exprs):
            scan = make_scan_exec(child_lp, conf)
            scan.required_columns = [e.name for e in lp.exprs]
            return scan
        return ProjectExec(lp.exprs, _plan(child_lp, conf))
    if isinstance(lp, L.Filter):
        child_lp = lp.children[0]
        if isinstance(child_lp, L.FileRelation):
            return FilterExec(lp.condition, make_scan_exec(
                child_lp, conf, extra_filters=[lp.condition]))
        return FilterExec(lp.condition, _plan(child_lp, conf))
    if isinstance(lp, L.Aggregate):
        child = _plan(lp.children[0], conf)
        if child.num_partitions > 1:
            # co-locate groups: a hash exchange on the grouping keys
            if lp.grouping:
                child = ShuffleExchangeExec(
                    HashPartitioning(lp.grouping, child.num_partitions),
                    child)
            else:
                child = GatherPartitionsExec(child)
        return CpuHashAggregateExec(lp.grouping, lp.aggregates, child)
    if isinstance(lp, L.Join):
        return plan_join(lp, _plan(lp.children[0], conf),
                         _plan(lp.children[1], conf), conf)
    if isinstance(lp, L.Sort):
        child = _plan(lp.children[0], conf)
        if lp.is_global and child.num_partitions > 1:
            # a total order: range-partition, then sort within partitions
            child = ShuffleExchangeExec(
                RangePartitioning(lp.orders, child.num_partitions), child)
        return SortExec(lp.orders, child, is_global=lp.is_global)
    if isinstance(lp, L.Limit):
        child_lp = lp.children[0]
        if isinstance(child_lp, L.Sort) and child_lp.is_global:
            # TopN: a sort and a limit per partition, then one sort and
            # the limit, with no range exchange
            inner = _plan(child_lp.children[0], conf)
            local = LocalLimitExec(
                lp.n, SortExec(child_lp.orders, inner, is_global=False))
            merged = GatherPartitionsExec(local) \
                if inner.num_partitions > 1 else local
            return GlobalLimitExec(
                lp.n, SortExec(child_lp.orders, merged, is_global=False))
        child = _plan(child_lp, conf)
        if child.num_partitions > 1:
            child = GatherPartitionsExec(LocalLimitExec(lp.n, child))
        return GlobalLimitExec(lp.n, child)
    if isinstance(lp, L.Window):
        child = _plan(lp.children[0], conf)
        if child.num_partitions > 1:
            specs = [w.spec for w in lp.window_exprs]
            pkeys = specs[0].partition_by if specs else []
            same_keys = all([k.sql() for k in s.partition_by] ==
                            [k.sql() for k in pkeys] for s in specs)
            if pkeys and same_keys:
                child = ShuffleExchangeExec(
                    HashPartitioning(list(pkeys), child.num_partitions),
                    child)
            else:
                child = GatherPartitionsExec(child)
        return WindowExec(lp.window_exprs, child)
    if isinstance(lp, L.Union):
        return UnionExec([_plan(c, conf) for c in lp.children])
    if isinstance(lp, L.Distinct):
        grouping = [AttributeReference(n) for n in lp.schema()[0]]
        return _plan_uncached(L.Aggregate(grouping, [], lp.children[0]),
                              conf)
    if isinstance(lp, L.Sample):
        return SampleExec(lp.fraction, lp.seed, _plan(lp.children[0], conf))
    if isinstance(lp, L.Repartition):
        part = HashPartitioning(lp.keys, lp.num_partitions) if lp.keys \
            else RoundRobinPartitioning(lp.num_partitions)
        return ShuffleExchangeExec(part, _plan(lp.children[0], conf))
    raise NotImplementedError(
        f"logical plan node {type(lp).__name__} is not ported yet")
