"""The port's operators declare the reference's replay classes.

The same plan is built in both packages on the CPU (scan, filter,
project, the file scan, range, union, sample, the round-robin exchange,
the cache write and the cached scan, the grouped aggregate in each mode
with integer and float buffers and with the canonical keyed merge on and
off, the hash join of every type and the nested-loop join), and
``determinism()`` of each
operator must agree: None where the reference returns None, else the
same class and the same flags.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import config as rconfig
from spark_rapids_tpu.exec import aggregate as ragg
from spark_rapids_tpu.exec import base as rbase
from spark_rapids_tpu.exec import basic as rbasic
from spark_rapids_tpu.exec import broadcast as rbroadcast
from spark_rapids_tpu.exec import gatherpart as rgather
from spark_rapids_tpu.exec import join as rjoin
from spark_rapids_tpu.expr import aggregates as raggs
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import predicates as rpred
from spark_rapids_tpu.io import cached_batch as rcached
from spark_rapids_tpu.io import scan as rscan
from spark_rapids_tpu.shuffle import exchange as rexchange
from spark_rapids_tpu.shuffle import partitioning as rpartitioning
from spark_rapids_tpu_torch import config as pconfig
from spark_rapids_tpu_torch.analysis import determinism as pdet
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec import base as pbase
from spark_rapids_tpu_torch.exec import basic as pbasic
from spark_rapids_tpu_torch.exec import broadcast as pbroadcast
from spark_rapids_tpu_torch.exec import gatherpart as pgather
from spark_rapids_tpu_torch.exec import join as pjoin
from spark_rapids_tpu_torch.expr import aggregates as paggs
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import predicates as ppred
from spark_rapids_tpu_torch.io import cached_batch as pcached
from spark_rapids_tpu_torch.io import scan as pscan
from spark_rapids_tpu_torch.shuffle import exchange as pexchange
from spark_rapids_tpu_torch.shuffle import partitioning as ppartitioning

REF = dict(basic=rbasic, agg=ragg, join=rjoin, aggs=raggs,
           core=rcore, pred=rpred, Agg=ragg.TpuHashAggregateExec,
           base=rbase, broadcast=rbroadcast, gather=rgather,
           exchange=rexchange, partitioning=rpartitioning, scan=rscan,
           conf=rconfig, cached=rcached)
PORT = dict(basic=pbasic, agg=pagg, join=pjoin, aggs=paggs,
            core=pcore, pred=ppred, Agg=pagg.GpuHashAggregateExec,
            base=pbase, broadcast=pbroadcast, gather=pgather,
            exchange=pexchange, partitioning=ppartitioning, scan=pscan,
            conf=pconfig, cached=pcached)
FLAGS = ("cls", "order_sensitive_selection", "establishes_order",
         "partition_scoped", "canonicalizable")


def table():
    rng = np.random.default_rng(0)
    return pa.table({"k": pa.array(rng.integers(0, 5, 20)),
                     "v": pa.array(rng.integers(0, 9, 20)),
                     "f": pa.array(rng.random(20))})


def scan(lib):
    return lib["basic"].LocalScanExec(table())


def attr(lib, name):
    return lib["core"].AttributeReference(name)


def filt(lib):
    return lib["basic"].FilterExec(lib["pred"].GreaterThan(
        attr(lib, "v"), lib["core"].Literal(3)), scan(lib))


def file_scan(lib):
    """A parquet scan of three files with a pushed filter; nothing is
    read to build it or to ask its declaration."""
    types = lib["basic"].LocalScanExec(table())._types
    return lib["scan"].FileScanExec(
        "parquet", [f"part-{i}.parquet" for i in range(3)], ["k", "v", "f"],
        types, {}, lib["conf"].RapidsConf(),
        pushed_filters=[lib["pred"].GreaterThan(attr(lib, "v"),
                                                lib["core"].Literal(3))])


def project(lib):
    return lib["basic"].ProjectExec(
        [lib["core"].Alias(attr(lib, "v"), "w"), attr(lib, "f")],
        scan(lib))


AGG_FUNCS = {
    "int": lambda lib: [lib["aggs"].AggregateExpression(
        lib["aggs"].Sum(attr(lib, "v")), "s"),
        lib["aggs"].AggregateExpression(lib["aggs"].Count(None), "c")],
    "float": lambda lib: [lib["aggs"].AggregateExpression(
        lib["aggs"].Average(attr(lib, "f")), "a")],
    # a DECIMAL(20,2) sum buffer and a FLOAT max
    "decimal": lambda lib: [lib["aggs"].AggregateExpression(
        lib["aggs"].Sum(lib["aggs"].Cast(
            attr(lib, "v"), lib["aggs"].t.DecimalType(10, 2))), "s"),
        lib["aggs"].AggregateExpression(lib["aggs"].Max(lib["aggs"].Cast(
            attr(lib, "f"), lib["aggs"].t.FLOAT)), "m")],
}


def aggregate(lib, mode, buffers, stable_merge):
    node = lib["Agg"]([attr(lib, "k")], AGG_FUNCS[buffers](lib), mode,
                      filt(lib))
    node.stable_merge = stable_merge
    return node


def hash_join(lib, how):
    return lib["join"].HashJoinExec([attr(lib, "k")], [attr(lib, "k")], how,
                                    None, scan(lib), scan(lib))


def nested_loop_join(lib, how):
    return lib["join"].NestedLoopJoinExec(how, None, scan(lib), scan(lib))


PLANS = {
    "scan": scan,
    "filter": filt,
    "project": project,
    "file_scan": file_scan,
    **{f"aggregate_{mode}_{buffers}_stable_{stable}":
       (lambda lib, m=mode, b=buffers, s=stable: aggregate(lib, m, b, s))
       for mode in ("Partial", "Complete") for buffers in AGG_FUNCS
       for stable in (True, False)},
    **{f"hash_join_{how}": (lambda lib, h=how: hash_join(lib, h))
       for how in pjoin.JOIN_TYPES},
    "nested_loop_join_cross": lambda lib: nested_loop_join(lib, "cross"),
    "nested_loop_join_inner": lambda lib: nested_loop_join(lib, "inner"),
    # the plan rewrite's operators: the host engines, the exchanges, the
    # gather, the coalesce and the transitions
    **{f"cpu_aggregate_{buffers}": (
        lambda lib, b=buffers: lib["agg"].CpuHashAggregateExec(
            [attr(lib, "k")], AGG_FUNCS[b](lib), filt(lib)))
       for buffers in AGG_FUNCS},
    "cpu_join_inner": lambda lib: lib["join"].CpuJoinExec(
        [attr(lib, "k")], [attr(lib, "k")], "inner", None, scan(lib),
        scan(lib)),
    "broadcast_hash_join_left": lambda lib: (
        lib["broadcast"].BroadcastHashJoinExec(
            [attr(lib, "k")], [attr(lib, "k")], "left", None, scan(lib),
            lib["broadcast"].BroadcastExchangeExec(scan(lib)))),
    "broadcast_nested_loop_join": lambda lib: (
        lib["broadcast"].BroadcastNestedLoopJoinExec(
            "cross", None, scan(lib),
            lib["broadcast"].BroadcastExchangeExec(scan(lib)))),
    "shuffle_exchange": lambda lib: lib["exchange"].ShuffleExchangeExec(
        lib["partitioning"].HashPartitioning([attr(lib, "k")], 3),
        filt(lib)),
    "gather_partitions": lambda lib: lib["gather"].GatherPartitionsExec(
        scan(lib)),
    "coalesce_batches": lambda lib: lib["basic"].CoalesceBatchesExec(
        filt(lib)),
    "transitions": lambda lib: lib["base"].DeviceToHostExec(
        lib["base"].HostToDeviceExec(scan(lib))),
    # the DataFrame surface: range, union, sample, round robin and the
    # parquet cached batch
    "range": lambda lib: lib["basic"].RangeExec(0, 100, 3, 2),
    "union": lambda lib: lib["basic"].UnionExec([scan(lib), filt(lib)]),
    "sample": lambda lib: lib["basic"].SampleExec(0.3, 7, filt(lib)),
    "round_robin_exchange": lambda lib: lib["exchange"].ShuffleExchangeExec(
        lib["partitioning"].RoundRobinPartitioning(4), scan(lib)),
    "cache_write": lambda lib: lib["cached"].CacheWriteExec(
        lib["cached"].CacheEntry(None), filt(lib)),
    "cached_scan": lambda lib: lib["cached"].CachedScanExec(
        lib["cached"].CacheEntry(None), ["k", "v", "f"],
        lib["basic"].LocalScanExec(table())._types),
}


def declared(plan):
    """Each operator's declaration, top-down, as a tuple of flags."""
    out = []

    def visit(node):
        d = node.determinism()
        out.append((type(node).__name__, None if d is None else
                    tuple(getattr(d, f) for f in FLAGS)))
    plan.foreach(visit)
    return out


@pytest.mark.parametrize("case", sorted(PLANS))
def test_determinism_matches_reference(case):
    want = declared(PLANS[case](REF))
    got = declared(PLANS[case](PORT))
    assert [d for _, d in got] == [d for _, d in want], (want, got)
    assert len(got) == len(want)


def test_aggregate_classes():
    """The classes the comparison above covers, stated once: the keyed
    merge makes float buffers order-stable; without it they depend on
    arrival order, and only PARTIAL is scoped to its partition."""
    stable = aggregate(PORT, "Complete", "float", True).determinism()
    loose = aggregate(PORT, "Partial", "float", False).determinism()
    assert stable.cls == pdet.ORDER_STABLE and not stable.partition_scoped
    assert loose.cls == pdet.ORDER_DEPENDENT and loose.canonicalizable
    assert loose.partition_scoped
    assert aggregate(PORT, "Partial", "int", False).determinism().cls == \
        pdet.ORDER_STABLE


def test_unknown_class_raises():
    with pytest.raises(ValueError):
        pdet.Determinism("sometimes")
