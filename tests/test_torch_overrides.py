"""The port's plan rewrite against the reference's: tag -> cost -> convert
-> transitions, with CPU fallback.

Every query runs through the reference's TpuSession and the port's
GpuSession(device="cpu") on the same tables, made from a numpy seed.
The reference's tests see 8 CPU devices (tests/conftest.py), so its
single-device exchange fusion is forced on
(spark.rapids.tpu.singleChipFuse=on), as the port's is whenever it
drives one device.  Checked per query: the
result (assert_tables_equal, floats to a relative 1e-9: the two engines
add a group's doubles in different orders), every operator of the final
plan with its placement ("tpu" read as "gpu"), and the explain lines
with every fallback reason ("TPU" read as "GPU").  One difference is
planned: the port's shuffle exchange runs on the host only, so an
exchange that survives the rewrite (its consumer stays on the CPU) is
CPU-placed with its reason where the reference places it on the device
(``host_exchanges``).
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol, lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol, lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec.base import CPU

FLOAT_RTOL = 1e-9
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
REF = (RF, rcol, rlit)
PORT = (PF, pcol, plit)


def tables(seed=0, n_fact=600, n_dim=80):
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": pa.array(rng.integers(0, 100, n_fact),
                      mask=rng.random(n_fact) < 0.05),
        "v": pa.array(rng.integers(-50, 50, n_fact)),
        "f": pa.array(rng.random(n_fact)),
    })
    dim = pa.table({
        "k2": pa.array(rng.integers(0, 100, n_dim),
                       mask=rng.random(n_dim) < 0.05),
        "w": pa.array(rng.random(n_dim)),
        "j": pa.array(rng.integers(0, 5, n_dim).astype(np.int32)),
    })
    return fact, dim


def sessions(conf=None, ref_conf=None):
    conf = dict(conf or {})
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf, **(ref_conf or {})}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def shape(session):
    """(operator, placement) top-down.  The reference reads a surviving
    shuffle through an AQE reader, which is not ported; the reader adds a
    node and changes no placement."""
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return [n for n in nodes
            if n[0] not in ("AQEShuffleReadExec", "_SkewAwareRead")]


def host_exchanges(ref_shape, ref_explain):
    """The reference's plan and explain as the port gives them: a shuffle
    exchange under a CPU consumer runs on the host, below the download,
    and its explain line says why."""
    nodes = list(ref_shape)
    for i in range(len(nodes) - 1):
        if nodes[i:i + 2] == [("DeviceToHostExec", "cpu"),
                              ("ShuffleExchangeExec", "gpu")]:
            nodes[i:i + 2] = [("ShuffleExchangeExec", "cpu"),
                              ("DeviceToHostExec", "cpu")]
    lines = ref_explain.replace("TPU", "GPU").splitlines()
    for i, line in enumerate(lines):
        body = line.lstrip()
        if body != "*Exec <ShuffleExchangeExec> will run on GPU":
            continue
        pad = line[:len(line) - len(body)]
        parent = next(p for p in reversed(lines[:i])
                      if len(p) - len(p.lstrip()) < len(pad))
        if parent.lstrip().startswith("!"):
            consumer = parent.split("<")[1].split(">")[0]
            lines[i] = (f"{pad}!Exec <ShuffleExchangeExec> cannot run on GPU "
                        f"because the shuffle exchange runs on the host only "
                        f"(its consumer {consumer} stays on the CPU)")
    return nodes, "\n".join(lines)


def same_plans(ref, port):
    want_shape, want_explain = host_exchanges(shape(ref), ref.last_explain)
    assert shape(port) == want_shape
    assert port.last_explain == want_explain
    assert_cpu_nodes_explained(port)


def assert_cpu_nodes_explained(session):
    """Every CPU-placed operator other than a transition has its reason in
    the explain: no placement comes from anywhere but tagging."""
    for name, placement in shape(session):
        if placement == CPU and name != "DeviceToHostExec":
            assert f"!Exec <{name}> cannot run on GPU because" in \
                session.last_explain or \
                session.last_explain == "(GPU acceleration disabled)"


def run(query, conf=None, ref_conf=None, seed=0, **sizes):
    """(reference result, port result) and the two sessions."""
    fact, dim = tables(seed, **sizes)
    ref, port = sessions(conf, ref_conf)
    want = query(ref, *REF, fact, dim).collect()
    got = query(port, *PORT, fact, dim).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    same_plans(ref, port)
    return want, got, ref, port


def agg_q(parts):
    return lambda s, F, col, lit, fact, dim: (
        s.create_dataframe(fact, num_partitions=parts)
        .filter(col("v") > -40).group_by(col("k"))
        .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
             F.count("*").alias("c")))


def join_q(how, fparts=1, dparts=1, cond=None):
    def q(s, F, col, lit, fact, dim):
        on = col("k") == col("k2")
        if cond is not None:
            on = on & cond(col)
        return s.create_dataframe(fact, num_partitions=fparts).join(
            s.create_dataframe(dim, num_partitions=dparts), on=on, how=how)
    return q


def joined_agg_q(fparts, dparts):
    return lambda s, F, col, lit, fact, dim: (
        s.create_dataframe(fact, num_partitions=fparts)
        .join(s.create_dataframe(dim.rename_columns(["k", "w", "j"]),
                                 num_partitions=dparts), on="k")
        .group_by(col("k")).agg(F.sum(col("w")).alias("sw")))


NO_BROADCAST = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1}

PARITY = {
    "aggregate_4_partitions": (agg_q(4), {}),
    "global_aggregate_3_partitions": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(
            fact, num_partitions=3).agg(F.sum(col("v")).alias("sv"),
                                        F.count("*").alias("c")), {}),
    **{f"broadcast_join_{how}": (join_q(how, 4, 2), {})
       for how in ("inner", "left", "left_semi", "left_anti")},
    **{f"shuffled_join_{how}": (join_q(how, 3, 2), NO_BROADCAST)
       for how in ("inner", "left", "right", "full", "left_semi",
                   "left_anti")},
    "shuffled_conditional_left": (
        join_q("left", 2, 2, lambda col: col("v") > 0), NO_BROADCAST),
    "broadcast_nested_loop": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(
            fact, num_partitions=2).join(s.create_dataframe(dim),
                                         on=col("v") < col("j")),
        dict(n_fact=120, n_dim=20)),
    "q6_shape": (joined_agg_q(4, 2), {}),
    "conditional_right_flips_to_left": (
        join_q("right", cond=lambda col: col("v") < col("j")), {}),
    "null_literal_filter": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(fact).filter(
            (col("v") > lit(None)) | (col("v") > 10)), {}),
    "null_literal_and": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(fact).filter(
            (col("v") > 0) & (col("k") == lit(None))), {}),
    "range_aggregate_2_partitions": (
        lambda s, F, col, lit, fact, dim: s.range(
            -300, 900, 7, num_partitions=2).group_by(
            (col("id") % 10).alias("m")).agg(F.sum(col("id")).alias("s"),
                                             F.count("*").alias("c")), {}),
    "union_1_and_4_partitions": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(fact).union(
            s.create_dataframe(fact, num_partitions=4).filter(
                col("v") > 0)), {}),
    "distinct_4_partitions": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(
            fact, num_partitions=4).select(col("k"), col("v") % 7).distinct(),
        {}),
    "sample_filter": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(fact).sample(
            0.3, seed=7).filter(col("v") > -20), {}),
    # the flat types: a decimal sum on a 128-bit buffer, a date filter and
    # a sort on narrow types
    "decimal_sum_2_partitions": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(
            fact, num_partitions=2).group_by(col("k")).agg(
            F.sum(col("v").cast("decimal(12,2)")).alias("s"),
            F.max(col("v").cast("decimal(12,2)")).alias("m")), {}),
    "date_filter": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(fact).filter(
            col("v").cast("timestamp").cast("date")
            <= lit(__import__("datetime").date(1970, 1, 1))), {}),
    "narrow_type_sort_2_partitions": (
        lambda s, F, col, lit, fact, dim: s.create_dataframe(
            fact, num_partitions=2).select(
            col("k"), col("v").cast("smallint").alias("s"),
            col("f").cast("float").alias("ff")).sort(
            col("s").desc(), col("ff"), col("k")), {}),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_plan_and_result_match_reference(case):
    query, extra = PARITY[case]
    conf = {k: v for k, v in extra.items() if k.startswith("spark.")}
    sizes = {k: v for k, v in extra.items() if not k.startswith("spark.")}
    _, got, _, port = run(query, conf, **sizes)
    assert got.num_rows > 0 or case == "null_literal_and"
    if case != "broadcast_nested_loop":
        # everything runs on the device; only the result crosses to host
        assert [p for _, p in shape(port)][1:] == \
            ["gpu"] * (len(shape(port)) - 1)


def test_conditional_right_join_stays_on_the_device():
    *_, port = run(join_q("right", cond=lambda col: col("v") < col("j")))
    names = [n for n, _ in shape(port)]
    assert "HashJoinExec" in names and "CpuJoinExec" not in names


DISABLED = {
    "exec_filter": ({"spark.rapids.sql.exec.FilterExec": False}, agg_q(1)),
    "exec_aggregate": ({"spark.rapids.sql.exec.CpuHashAggregateExec": False},
                       agg_q(2)),
    "exec_cpu_join": ({"spark.rapids.sql.exec.CpuJoinExec": False},
                      joined_agg_q(1, 1)),
    "exec_broadcast": ({"spark.rapids.sql.exec.BroadcastExchangeExec": False},
                       joined_agg_q(3, 2)),
    "expression_greater_than": (
        {"spark.rapids.sql.expression.GreaterThan": False}, agg_q(1)),
    "expression_sum": ({"spark.rapids.sql.expression.Sum": False}, agg_q(1)),
    "sql_disabled": ({"spark.rapids.sql.enabled": False}, joined_agg_q(4, 2)),
}


@pytest.mark.parametrize("case", sorted(DISABLED))
def test_disable_keys_match_reference(case):
    """A per-exec or per-expression key, or spark.rapids.sql.enabled,
    moves operators to the CPU engine with the reference's reasons and
    transitions, and the result does not change."""
    conf, query = DISABLED[case]
    want, got, _, port = run(query, conf)
    assert any(p == CPU and n not in ("DeviceToHostExec",)
               for n, p in shape(port))
    _, enabled, _, _ = run(query)
    assert_tables_equal(enabled, got, approximate_float=FLOAT_RTOL)


def test_sql_disabled_places_every_operator_on_the_cpu():
    _, _, _, port = run(joined_agg_q(4, 2),
                        {"spark.rapids.sql.enabled": False})
    assert {p for _, p in shape(port)} == {CPU}
    assert port.last_explain == "(GPU acceleration disabled)"


RAISES = {
    f"conditional_{how}": join_q(how, cond=lambda col: col("w") > 0.5)
    for how in ("full", "left_semi", "left_anti")
}
# the fallback between device operators: a filter below, an aggregate above
RAISES["conditional_full_between_device_operators"] = (
    lambda s, F, col, lit, fact, dim: s.create_dataframe(fact)
    .filter(col("v") > 0)
    .join(s.create_dataframe(dim), on=(col("k") == col("k2")) &
          (col("w") > 0.5), how="full")
    .group_by(col("k")).agg(F.count("*").alias("c")))


@pytest.mark.parametrize("case", sorted(RAISES))
def test_cpu_fallback_matches_reference(case):
    """A conditional full, left_semi or left_anti join stays on the CPU
    engine with the reference's reason; executing it raises there, in
    both packages, with the same words."""
    fact, dim = tables(1)
    ref, port = sessions()
    outcomes = []
    for s, lib in ((ref, REF), (port, PORT)):
        df = RAISES[case](s, *lib, fact, dim)
        s.explain(df._lp)
        with pytest.raises(NotImplementedError) as err:
            df.collect()
        outcomes.append(str(err.value))
    assert outcomes[0] == outcomes[1]
    same_plans(ref, port)
    how = case.split("_")[1] if "between" not in case else "full"
    if how == "left":
        how = "_".join(case.split("_")[1:3])
    assert (f"!Exec <CpuJoinExec> cannot run on GPU because conditional "
            f"{how} join is not supported on GPU") in \
        [ln.strip() for ln in port.last_explain.splitlines()]
    if "between" in case:
        assert shape(port) == [
            ("DeviceToHostExec", "cpu"), ("CoalesceBatchesExec", "gpu"),
            ("GpuHashAggregateExec", "gpu"), ("HostToDeviceExec", "gpu"),
            ("CpuJoinExec", "cpu"), ("DeviceToHostExec", "cpu"),
            ("FilterExec", "gpu"), ("LocalScanExec", "gpu"),
            ("DeviceToHostExec", "cpu"), ("LocalScanExec", "gpu")]


def test_sum_of_null_literal_plans_like_reference():
    """sum(lit(None)) is tagged off the GPU with the reference's reason."""
    fact, dim = tables(2)
    ref, port = sessions()
    for s, (F, col, lit) in ((ref, REF), (port, PORT)):
        df = s.create_dataframe(fact).group_by(col("k")).agg(
            F.sum(lit(None)).alias("s"))
        s.explain(df._lp)
    same_plans(ref, port)
    assert "Sum over unsupported input: null is not supported" in \
        port.last_explain


def test_explain_prints_the_plan_and_the_reasons(capsys):
    fact, dim = tables(3)
    _, port = sessions({"spark.rapids.sql.exec.FilterExec": False})
    text = agg_q(1)(port, *PORT, fact, dim).explain()
    out = capsys.readouterr().out
    assert text in out
    plan, explain = text.split("\n--\n")
    assert " DeviceToHostExec" in plan.splitlines()[0]
    assert "*GpuHashAggregate(mode=Complete" in plan
    assert "  !Exec <FilterExec> cannot run on GPU because FilterExec has " \
        "been disabled by config" in explain.splitlines()


def test_explain_modes_print_what_they_name(capsys):
    fact, dim = tables(4)
    conf = {"spark.rapids.sql.exec.FilterExec": False}
    for mode, printed in (("NONE", []), ("NOT_ON_GPU", ["!"]),
                          ("ALL", ["!", "*"])):
        port = GpuSession(device="cpu", conf={
            **conf, "spark.rapids.sql.explain": mode})
        agg_q(1)(port, *PORT, fact, dim).collect()
        lines = capsys.readouterr().out.splitlines()
        assert sorted({ln.strip()[0] for ln in lines}) == printed


def test_builder_and_conf_checks():
    s = GpuSession.builder().config("spark.rapids.sql.enabled",
                                    "false").get_or_create(device="cpu")
    assert s.conf.sql_enabled is False and s.device.type == "cpu"
    bad = GpuSession(device="cpu", conf={
        "spark.rapids.tpu.singleChipFuse": "sometimes"})
    with pytest.raises(ValueError, match="singleChipFuse"):
        agg_q(2)(bad, *PORT, *tables()).collect()
