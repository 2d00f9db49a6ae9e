"""Placement: where each operator's tensors live, and the guards on it.

An operator built by hand runs on the context's device unless its class
runs on the host only; a GPU-placed operator given CPU tensors raises,
and a plan whose placement changes with no transition is refused before
it runs.  A CUDA context is stood in for by a CPU context whose device
is set to ``cuda``: the guards raise before any tensor reaches CUDA.
Also here: a right or full join whose probe side yields no batch at all
(a multi-partition side filtered to nothing, which the probe side's
coalesce drops) still emits every build row, null-extended, as pyarrow's
join does.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api.column import col
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec.aggregate import (CpuHashAggregateExec,
                                                   GpuHashAggregateExec)
from spark_rapids_tpu_torch.exec.base import (CPU, GPU, DeviceToHostExec,
                                              ExecContext, HostToDeviceExec)
from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
from spark_rapids_tpu_torch.exec.join import CpuJoinExec, HashJoinExec
from spark_rapids_tpu_torch.expr.aggregates import (COMPLETE,
                                                    AggregateExpression,
                                                    Count)
from spark_rapids_tpu_torch.expr.core import AttributeReference as A
from spark_rapids_tpu_torch.plan.overrides import insert_transitions
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning


def tables(seed=3, n_fact=500, n_dim=60):
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": pa.array(rng.integers(0, 40, n_fact),
                      mask=rng.random(n_fact) < 0.05),
        "v": pa.array(rng.integers(-50, 50, n_fact)),
    })
    dim = pa.table({
        "k2": pa.array(rng.integers(0, 40, n_dim),
                       mask=rng.random(n_dim) < 0.1),
        "w": pa.array(rng.random(n_dim)),
    })
    return fact, dim


def cuda_context():
    ctx = ExecContext("cpu")
    ctx.device = torch.device("cuda")
    return ctx


COUNT = AggregateExpression(Count(None), "c")


def positive_v():
    return (col("v") > 0).expr


def count_by_k(child):
    return GpuHashAggregateExec([A("k")], [COUNT], COMPLETE, child)


def test_hand_built_operators_default_to_their_class_placement():
    fact, dim = tables()
    scan, dscan = LocalScanExec(fact), LocalScanExec(dim)
    assert scan.placement == FilterExec(positive_v(), scan).placement == GPU
    assert HashJoinExec([A("k")], [A("k2")], "inner", None, scan,
                        dscan).placement == GPU
    assert count_by_k(scan).placement == GPU
    assert CpuJoinExec([A("k")], [A("k2")], "inner", None, scan,
                       dscan).placement == CPU
    assert CpuHashAggregateExec([A("k")], [COUNT], scan).placement == CPU
    assert ShuffleExchangeExec(HashPartitioning([A("k")], 2),
                               scan).placement == CPU
    assert HostToDeviceExec(scan).placement == GPU
    assert DeviceToHostExec(scan).placement == CPU


def cpu_placed(node):
    node.foreach(lambda e: setattr(e, "placement", CPU))
    return node


def test_gpu_aggregate_over_cpu_placed_children_raises():
    """Under a CUDA context a GPU-placed aggregate over a CPU-placed
    filter and scan would get CPU tensors: the collect refuses the plan,
    and the operator itself raises on the first batch."""
    fact, _ = tables()
    agg = count_by_k(cpu_placed(FilterExec(positive_v(),
                                           LocalScanExec(fact))))
    with pytest.raises(ValueError, match="with no transition"):
        agg.execute_collect(cuda_context())
    with pytest.raises(RuntimeError, match="expected cuda tensors"):
        next(agg.execute_partition(0, cuda_context()))


def test_cpu_engine_over_device_operators_needs_a_transition():
    """A CPU join over GPU-placed scans is refused as built, and runs
    once insert_transitions has put the downloads in."""
    fact, dim = tables()
    join = CpuJoinExec([A("k")], [A("k2")], "inner", None,
                       LocalScanExec(fact), LocalScanExec(dim))
    with pytest.raises(ValueError, match="with no transition"):
        join.execute_collect(ExecContext("cpu"))
    placed = insert_transitions(join)
    assert [type(c).__name__ for c in placed.children] == \
        ["DeviceToHostExec"] * 2
    got = placed.execute_collect(ExecContext("cpu"))
    want = fact.filter(pa.compute.is_valid(fact["k"])).join(
        dim, keys="k", right_keys="k2", join_type="inner",
        coalesce_keys=False)
    assert_tables_equal(want.select(got.schema.names), got)


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("how", ["full", "right"])
def test_outer_join_with_no_probe_rows_keeps_every_build_row(how, parts,
                                                             enabled):
    fact, dim = tables()
    s = GpuSession(device="cpu",
                   conf={"spark.rapids.sql.enabled": enabled})
    got = (s.create_dataframe(fact, num_partitions=parts)
           .filter(col("v") > 1000)
           .join(s.create_dataframe(dim), on=col("k") == col("k2"), how=how)
           .collect())
    empty = fact.slice(0, 0)
    want = empty.join(dim, keys="k", right_keys="k2",
                      join_type=f"{how} outer", coalesce_keys=False)
    assert got.num_rows == dim.num_rows
    assert_tables_equal(want.select(got.schema.names).cast(got.schema), got)
