"""The port's packed fetch (columnar/fetch.py) against the reference's, on
the CPU.

On the same Arrow batch, the port's plain K9 (lane stats) and transfer
plan must equal the reference's ``_lane_stats`` and ``_build_plan``,
and every kept lane's slice of the port's plain K10 buffer must hold
the reference's wire values for the live rows.  A seeded fuzz over
BOOLEAN, INT, LONG and DOUBLE (nulls, all null, empty batches, values
at +-2^63, spans at the narrowing boundaries, row counts that are not a
multiple of 8) must come back through ``fetch_batch`` exactly, as
``batch_to_arrow(move_batch(...))`` brings it.  The routing of
``DeviceToHostExec`` is checked by monkeypatching; no kernel runs here.
Last, no module of the port and not ``chip_smoke.py`` imports jax or
the JAX package.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.columnar import fetch as rfetch
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.columnar import fetch as pfetch
from spark_rapids_tpu_torch.exec import base as pbase

REPO = pathlib.Path(__file__).resolve().parents[1]
SPANS = [0, 2**8 - 1, 2**8, 2**16 - 1, 2**16, 2**32 - 1, 2**32]


def rand_array(rng, n, kind):
    null_frac = float(rng.choice([0.0, 0.0, 0.1, 1.0]))
    mask = (rng.random(n) < null_frac) if null_frac else None
    if kind == "boolean":
        vals = rng.random(n) < float(rng.choice([0.5, 1.0]))
    elif kind == "int":
        vals = rng.integers(-2**31, 2**31, n).astype(np.int32) \
            if rng.random() < 0.3 else \
            rng.integers(-300, 300, n).astype(np.int32)
    elif kind == "long_small":
        vals = rng.integers(10**15, 10**15 + 300, n)
    elif kind == "long_wide":
        vals = rng.integers(-2**62, 2**62, n)
    elif kind == "long_extremes":
        vals = rng.choice(np.array([-2**63, 2**63 - 1, 0, -1],
                                   dtype=np.int64), n)
    elif kind == "long_span":
        base = int(rng.integers(-2**40, 2**40))
        span = int(rng.choice(SPANS))
        vals = base + rng.integers(0, span + 1, n, dtype=np.int64)
        if n >= 2:
            vals[:2] = [base, base + span]
    else:
        vals = rng.normal(size=n)
        vals[rng.random(n) < 0.1] = np.nan
    return pa.array(vals, mask=mask)


KINDS = ["boolean", "int", "long_small", "long_wide", "long_extremes",
         "long_span", "double"]


def rand_batch(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([0, 1, 7, 8, 9, int(rng.integers(2, 3000))]))
    kinds = [str(rng.choice(KINDS)) for _ in range(int(rng.integers(1, 6)))]
    cols = {f"c{i}_{k}": rand_array(rng, n, k) for i, k in enumerate(kinds)}
    return pa.RecordBatch.from_pydict(cols)


def rows(batch):
    """The batch's rows, NaN as a string (NaN equals nothing)."""
    return [{k: "NaN" if isinstance(v, float) and v != v else v
             for k, v in r.items()} for r in batch.to_pylist()]


def ref_stats(rbatch):
    n = jnp.asarray(rbatch.num_rows)
    return np.asarray(jnp.stack([s for c in rbatch.columns
                                 for s in rfetch._lane_stats(c, n)]))


@pytest.mark.parametrize("seed", range(16))
def test_stats_and_plan_match_reference(seed):
    rb = rand_batch(seed)
    rbatch = rdev.batch_to_device(rb, xp=jnp)
    pbatch = pdev.batch_to_device(rb, "cpu")
    want = ref_stats(rbatch)
    lanes = pfetch.batch_lanes(pbatch)
    got = pfetch.lane_stats(lanes, pbatch.num_rows)
    assert got.tolist() == want.tolist()
    plan, mins = pfetch.build_plan(lanes, got.tolist())
    rplan, rmins = rfetch._build_plan(rbatch, want)
    assert plan == rplan
    assert mins == [int(m) for m in rmins]


@pytest.mark.parametrize("seed", range(16, 28))
def test_packed_slices_hold_reference_wire_values(seed):
    """Each kept lane's slice holds the live rows of the reference's wire
    group for that lane (the reference ships whole capacity buckets,
    grouped by wire dtype; the port ships the live rows, in one buffer,
    each slice 8-byte aligned and zero to the boundary)."""
    rb = rand_batch(seed)
    n = rb.num_rows
    rbatch = rdev.batch_to_device(rb, xp=jnp)
    pbatch = pdev.batch_to_device(rb, "cpu")
    lanes = pfetch.batch_lanes(pbatch)
    stats = pfetch.lane_stats(lanes, n).tolist()
    plan, mins = pfetch.build_plan(lanes, stats)
    packed = pfetch.pack_lanes(lanes, plan, mins, n).numpy()
    slices, total = pfetch.layout(lanes, plan, n)
    assert packed.shape == (total,) and total % 8 == 0
    out_cap = rdev.bucket_for(n, rdev.DEFAULT_ROW_BUCKETS)
    bufs = rfetch._make_shrink_pack_fn(out_cap, (), plan)(rbatch)
    rlanes = [l for c in rbatch.columns for _, l in rfetch._walk_lanes(c)]
    order = []
    for lane, step in zip(rlanes, plan):
        wd = rfetch._transferred_dtype(rfetch._np_dtype_of(lane), step)
        if wd is not None and wd not in order:
            order.append(wd)
    groups = {wd: np.asarray(b) for wd, b in zip(order, bufs)}
    at = {wd: 0 for wd in order}
    covered = np.zeros(total, dtype=bool)
    for lane, step, (off, size) in zip(rlanes, plan, slices):
        wd = rfetch._transferred_dtype(rfetch._np_dtype_of(lane), step)
        if wd is None:
            continue
        count = out_cap // 8 if step[0] == "bit" else out_cap
        ref = groups[wd][at[wd]:at[wd] + count]
        at[wd] += count
        mine = packed[off:off + size]
        if step[0] == "bit":
            assert np.array_equal(mine, ref[:size])
        else:
            assert np.array_equal(
                mine, np.ascontiguousarray(ref[:n]).view(np.uint8))
        covered[off:off + size] = True
    assert not packed[~covered].any()


@pytest.mark.parametrize("seed", range(40))
def test_round_trip_fuzz(seed):
    rb = rand_batch(seed)
    batch = pdev.batch_to_device(rb, "cpu")
    got = pdev.batch_to_arrow(pfetch.fetch_batch(batch))
    want = pdev.batch_to_arrow(pdev.move_batch(batch, torch.device("cpu"),
                                               live_only=True))
    assert got.num_rows == rb.num_rows
    assert rows(got) == rows(want) == rows(rb)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("low", [-2**63, -5, 2**63 - 2**32 - 1])
def test_span_boundaries(span, low):
    n = 37
    vals = np.full(n, low, dtype=np.int64)
    top = min(low + span, 2**63 - 1)
    vals[1::3] = top
    rb = pa.RecordBatch.from_pydict({"x": pa.array(vals)})
    batch = pdev.batch_to_device(rb, "cpu")
    lanes = pfetch.batch_lanes(batch)
    stats = pfetch.lane_stats(lanes, n).tolist()
    plan, mins = pfetch.build_plan(lanes, stats)
    width = {0: 1, 2**8 - 1: 1, 2**8: 2, 2**16 - 1: 2, 2**16: 4,
             2**32 - 1: 4}.get(top - low)
    assert plan[0] == (("narrow", width) if width else ("none",))
    assert mins[0] == low
    back = pdev.batch_to_arrow(pfetch.fetch_batch(batch))
    assert back.column(0).to_pylist() == vals.tolist()


@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 1000])
def test_bit_order_is_arrows_and_spare_bits_are_zero(n):
    rng = np.random.default_rng(n)
    bits = rng.random(n) < 0.5
    packed = pfetch.pack_bits_plain(torch.from_numpy(bits)).numpy()
    assert np.array_equal(packed, np.packbits(bits, bitorder="little"))
    arr = pa.array(np.arange(n), mask=~bits)
    assert np.array_equal(np.frombuffer(arr.buffers()[0], np.uint8)[
        :len(packed)] & packed, packed)
    if n % 8:
        assert packed[-1] >> (n % 8) == 0
    assert torch.equal(pdev.unpack_bits(torch.from_numpy(packed), n),
                       torch.from_numpy(bits))


def test_layout_aligns_every_slice():
    lanes = [torch.zeros(16, dtype=dt) for dt in (
        torch.int64, torch.bool, torch.int32, torch.bool, torch.float64)]
    plan = (("narrow", 1), ("bit",), ("narrow", 2), ("skip",), ("none",))
    slices, total = pfetch.layout(lanes, plan, 11)
    assert slices == [(0, 11), (16, 2), (24, 22), (0, 0), (48, 88)]
    assert total == 136


def test_empty_batch_stats_never_narrow():
    rb = pa.RecordBatch.from_pydict({"x": pa.array([], pa.int64()),
                                     "y": pa.array([], pa.int32()),
                                     "b": pa.array([], pa.bool_())})
    batch = pdev.batch_to_device(rb, "cpu")
    lanes = pfetch.batch_lanes(batch)
    stats = pfetch.lane_stats(lanes, 0).tolist()
    assert stats == [2**63 - 1, -2**63, 1, 0, 2**31 - 1, -2**31, 1, 0,
                     1, 0, 1, 0]
    plan, _ = pfetch.build_plan(lanes, stats)
    assert plan[0] == plan[2] == ("none",)
    assert pdev.batch_to_arrow(pfetch.fetch_batch(batch)).num_rows == 0


def test_host_column_bitmap_and_lazy_validity():
    rb = pa.RecordBatch.from_pydict({
        "x": pa.array([1, None, 3, 4, None, 6, 7, 8, 9], pa.int64()),
        "y": pa.array([1.0] * 9)})
    out = pfetch.fetch_batch(pdev.batch_to_device(rb, "cpu"))
    x, y = out.columns
    assert isinstance(x, pdev.HostColumn) and y.bitmap is None
    assert x.validity.tolist() == [True, False, True, True, False, True,
                                   True, True, True]
    assert y.validity.tolist() == [True] * 9
    assert pdev.batch_to_arrow(out).to_pylist() == rb.to_pylist()


# ---------------------------------------------------------------------------
# the download's routing
# ---------------------------------------------------------------------------

class _FakeBatch:
    """Stands in for a batch on the card: only its device is read."""
    columns = (object(),)
    num_rows = 3
    device = torch.device("cuda")


class _Child(pbase.Exec):
    def __init__(self, batch):
        super().__init__([])
        self.batch = batch

    @property
    def output_names(self):
        return ["x"]

    @property
    def output_types(self):
        return []

    def execute_partition(self, pid, ctx):
        yield self.batch


def test_device_to_host_fetches_cuda_batches(monkeypatch):
    seen = []
    monkeypatch.setattr(pbase, "fetch_batch",
                        lambda b: seen.append(b) or "fetched")
    monkeypatch.setattr(pbase, "move_batch", lambda *a, **k: "moved")
    ctx = pbase.ExecContext("cpu")
    ctx.device = torch.device("cuda")       # the card, as the guard sees it
    batch = _FakeBatch()
    out = list(pbase.DeviceToHostExec(_Child(batch)).execute_partition(0,
                                                                       ctx))
    assert out == ["fetched"] and seen == [batch]


def test_device_to_host_moves_cpu_batches(monkeypatch):
    def no_fetch(b):
        raise AssertionError("a CPU batch went through fetch_batch")
    monkeypatch.setattr(pbase, "fetch_batch", no_fetch)
    rb = pa.RecordBatch.from_pydict({"x": pa.array([1, 2, 3])})
    ctx = pbase.ExecContext("cpu")
    batch = pdev.batch_to_device(rb, "cpu")
    out = list(pbase.DeviceToHostExec(_Child(batch)).execute_partition(0,
                                                                       ctx))
    assert pdev.batch_to_arrow(out[0]).to_pylist() == rb.to_pylist()


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


PORT_FILES = sorted((REPO / "spark_rapids_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "spark_rapids_tpu"), \
            f"{path.relative_to(REPO)} imports {name}"
