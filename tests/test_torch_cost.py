"""The port's cost-based optimizer against the reference's.

Mirrors tests/test_optimizer.py: the same query (filter, group-by, count
or sum) through the reference's TpuSession and the port's
GpuSession(device="cpu") with the optimizer off, on with default costs,
and on with every device cost inflated; placements ("tpu" read as
"gpu"), the explain and the results must agree.  The port's per-exec
cost keys name the GPU side (spark.rapids.sql.optimizer.gpu.exec.<Exec>)
where the reference's name the TPU side.  Float sums to a relative 1e-9.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.exec.basic import LocalScanExec
from spark_rapids_tpu_torch.plan import cost

FLOAT_RTOL = 1e-9
INFLATED = ("LocalScanExec", "FilterExec", "ProjectExec",
            "CpuHashAggregateExec")


def _table(n=1000):
    rng = np.random.default_rng(0)
    return pa.table({
        "k": pa.array(rng.integers(0, 10, n).astype(np.int64)),
        "v": pa.array(rng.random(n)),
    })


def _conf(mode):
    conf = {"spark.rapids.sql.enabled": True}
    if mode != "off":
        conf["spark.rapids.sql.optimizer.enabled"] = True
    return conf


def _sessions(mode):
    conf = _conf(mode)
    ref_conf, port_conf = dict(conf), dict(conf)
    if mode == "inflated":
        for name in INFLATED:
            ref_conf[f"spark.rapids.sql.optimizer.tpu.exec.{name}"] = 1e9
            port_conf[f"spark.rapids.sql.optimizer.gpu.exec.{name}"] = 1e9
    b = TpuSession.builder()
    for k, v in ref_conf.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=port_conf)


def _placements(session):
    out = []
    session.last_plan.foreach(
        lambda e: out.append((type(e).__name__.replace("Tpu", "Gpu"),
                              e.placement.replace("tpu", "gpu"))))
    return out


def _count_query(s, F, col, n=1000):
    return (s.create_dataframe(_table(n)).filter(col("v") > 0.5)
            .group_by(col("k")).agg(F.count("*").alias("c")))


@pytest.mark.parametrize("mode", ["off", "default_costs", "inflated"])
def test_cbo_placement_matches_reference(mode):
    ref, port = _sessions(mode)
    want = _count_query(ref, RF, rcol).collect()
    got = _count_query(port, PF, pcol).collect()
    assert got.num_rows == want.num_rows == 10
    assert_tables_equal(want, got)
    assert _placements(port) == _placements(ref)
    assert port.last_explain == ref.last_explain.replace("TPU", "GPU")
    placements = {p for _, p in _placements(port)}
    if mode == "inflated":
        # every device op absurdly expensive: the whole plan on the CPU
        assert placements == {"cpu"}
        assert "removed by cost-based optimizer" in port.last_explain
    else:
        # default costs (GPU 4x cheaper a row) keep acceleration on
        assert "gpu" in placements


def test_cbo_results_identical_either_way():
    base = None
    for mode in ("off", "default_costs"):
        _, port = _sessions(mode)
        got = (port.create_dataframe(_table(500))
               .filter(pcol("v") > 0.25).group_by(pcol("k"))
               .agg(PF.sum(pcol("v")).alias("sv"))
               .collect().sort_by("k"))
        if base is None:
            base = got
        else:
            assert got.column("k").to_pylist() == \
                base.column("k").to_pylist()
            np.testing.assert_allclose(np.array(got.column("sv")),
                                       np.array(base.column("sv")),
                                       rtol=FLOAT_RTOL)


def test_static_row_model():
    scan = LocalScanExec(_table(400))
    assert cost.estimate_rows(scan, []) == 400.0
    assert cost.DEFAULT_ROW_COUNT == 1_000_000
