"""Cost-based optimizer: the optional second pass that can move subtrees
back to the CPU when acceleration would not pay for its transitions.

Counterpart of spark_rapids_tpu/plan/cost.py with its static row model
only (the reference's feedback blend from obs/estimator.py is not
ported).  An exact two-state dynamic program over the meta tree:

  best_gpu(n) = gpu_cost(n) + sum_c min(best_gpu(c), best_cpu(c) + h2d(c))
  best_cpu(n) = cpu_cost(n) + sum_c min(best_cpu(c), best_gpu(c) + d2h(c))

(best_gpu = inf where tagging already rejected the node).  Backtracking
marks every CPU-chosen node "removed by cost-based optimizer".  Per-row
operator costs are overridden by
``spark.rapids.sql.optimizer.{cpu,gpu}.exec.<ExecName>``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

from .. import config as cfg
from ..exec import base as eb

# default per-row operator costs (arbitrary units; only ratios matter)
DEFAULT_CPU_OP_COST = 1.0
DEFAULT_GPU_OP_COST = 0.25
# host<->device transition per-row costs
DEFAULT_H2D_COST = 0.4
DEFAULT_D2H_COST = 0.4
# rows assumed when no statistics are available
DEFAULT_ROW_COUNT = 1_000_000

_CARDINALITY = {
    # output rows as a factor of input rows (first child)
    "FilterExec": 0.5,
    "CpuHashAggregateExec": 0.2,
    "GpuHashAggregateExec": 0.2,
    "SampleExec": 0.1,
}

_JOINS = ("HashJoinExec", "CpuJoinExec", "BroadcastHashJoinExec",
          "NestedLoopJoinExec", "BroadcastNestedLoopJoinExec")


def estimate_rows(node: eb.Exec, child_rows: List[float]) -> float:
    """Output-row estimate for one operator from its children's."""
    return _static_rows(node, child_rows)


def _static_rows(node: eb.Exec, child_rows: List[float]) -> float:
    from ..exec.basic import (GlobalLimitExec, LocalLimitExec, LocalScanExec,
                              RangeExec, UnionExec)
    from ..io.scan import FileScanExec
    if isinstance(node, LocalScanExec):
        return float(node.table.num_rows)
    if isinstance(node, RangeExec):
        return max(1.0, abs(node.end - node.start) / abs(node.step))
    if isinstance(node, FileScanExec):
        try:
            size = sum(os.path.getsize(p) for p in node.paths)
        except OSError:
            return float(DEFAULT_ROW_COUNT)
        return max(size / 100.0, 1.0)      # ~100 compressed bytes a row
    if isinstance(node, (LocalLimitExec, GlobalLimitExec)):
        n = float(node.limit)
        return min(n, child_rows[0]) if child_rows else n
    if not child_rows:
        return float(DEFAULT_ROW_COUNT)
    if isinstance(node, UnionExec):
        return sum(child_rows)
    name = type(node).__name__
    if name in _JOINS:
        return max(child_rows)
    return child_rows[0] * _CARDINALITY.get(name, 1.0)


class CostBasedOptimizer:
    def __init__(self, conf: cfg.RapidsConf):
        self.conf = conf
        self.explain_lines: List[str] = []

    def _op_cost(self, side: str, name: str, default: float) -> float:
        raw = self.conf.raw(f"spark.rapids.sql.optimizer.{side}.exec.{name}")
        return float(raw) if raw is not None else default

    def optimize(self, meta) -> int:
        """Tags CPU-cheaper nodes on the meta tree; returns #nodes moved."""
        plans: Dict[int, Tuple] = {}

        def walk(m) -> Tuple[float, float, float]:
            """(rows, best_cpu, best_gpu) of the subtree."""
            child_states = [walk(c) for c in m.children]
            rows = estimate_rows(m.exec, [s[0] for s in child_states])
            name = type(m.exec).__name__
            cpu_total = self._op_cost("cpu", name, DEFAULT_CPU_OP_COST) * rows
            gpu_total = self._op_cost("gpu", name, DEFAULT_GPU_OP_COST) * rows
            choice_cpu, choice_gpu = [], []
            for crows, ccpu, cgpu in child_states:
                h2d = DEFAULT_H2D_COST * crows
                d2h = DEFAULT_D2H_COST * crows
                if ccpu <= cgpu + d2h:          # parent on the CPU
                    cpu_total += ccpu
                    choice_cpu.append("cpu")
                else:
                    cpu_total += cgpu + d2h
                    choice_cpu.append("gpu")
                if cgpu <= ccpu + h2d:          # parent on the GPU
                    gpu_total += cgpu
                    choice_gpu.append("gpu")
                else:
                    gpu_total += ccpu + h2d
                    choice_gpu.append("cpu")
            if not m.can_replace:
                gpu_total = math.inf
            plans[id(m)] = (choice_cpu, choice_gpu)
            return rows, cpu_total, gpu_total

        def mark(m, placement: str):
            if placement == "cpu" and m.can_replace:
                m.will_not_work("removed by cost-based optimizer")
                self.explain_lines.append(
                    f"CBO: {type(m.exec).__name__} -> CPU")
            choices = plans[id(m)][0 if placement == "cpu" else 1]
            for c, choice in zip(m.children, choices):
                mark(c, choice)

        rows, best_cpu, best_gpu = walk(meta)
        # the plan root hands rows back to the host either way
        root_gpu = best_gpu + DEFAULT_D2H_COST * rows
        root = "cpu" if best_cpu <= root_gpu else "gpu"
        before = _count_replaceable(meta)
        mark(meta, root)
        moved = before - _count_replaceable(meta)
        if self.conf.get(cfg.OPTIMIZER_EXPLAIN) == "ALL" and \
                self.explain_lines:
            print("\n".join(self.explain_lines))
        return moved


def _count_replaceable(meta) -> int:
    n = 1 if meta.can_replace else 0
    return n + sum(_count_replaceable(c) for c in meta.children)
