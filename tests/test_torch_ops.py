"""Parity of the PyTorch port's kernel modules with the JAX reference.

The same inputs, made from a numpy seed, go through the reference
(``spark_rapids_tpu``, jnp on the CPU, or its numpy branch where that is
what states the semantics) and through the port on ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.  Integers
must match exactly.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.exec import filter_common as rfilter
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import predicates as rpred
from spark_rapids_tpu.ops import carry as rcarry
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.exec import filter_common as pfilter
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import predicates as ppred
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import segmented as pseg

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECIAL_DOUBLES = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-310, -1e-310, 1.5,
     -1.5, np.finfo(np.float64).max, -np.finfo(np.float64).max] +
    [np.frombuffer(np.uint64(b).tobytes(), np.float64)[0]
     for b in (0x7FF0000000000001, 0xFFF8000000000123)])
EXTREME_LONGS = np.array([0, -1, 1, 2**62, -2**62, 2**63 - 1, -2**63,
                          12345, -12345], dtype=np.int64)


def port_batch(rb_batch, device="cpu"):
    """The port's batch from the numpy lanes of a reference batch."""
    return pdev.batch_from_numpy_lanes(
        [np.asarray(c.data) for c in rb_batch.columns],
        [np.asarray(c.validity) for c in rb_batch.columns],
        int(rb_batch.num_rows), rb_batch.names,
        [c.dtype.name for c in rb_batch.columns], device)


def arrow_table(rng, n, null_frac=0.2):
    def nulls():
        return rng.random(n) < null_frac

    f = rng.choice(SPECIAL_DOUBLES, n)
    return pa.table({
        "k": pa.array(rng.integers(-3, 4, n), mask=nulls()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=nulls()),
        "v": pa.array(rng.choice(EXTREME_LONGS, n), mask=nulls()),
        "f": pa.array(f, mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


def ref_batch(table, xp=jnp):
    return rdev.batch_to_device(table.to_batches()[0], xp=xp)


# ---------------------------------------------------------------------------
# columnar/device.py
# ---------------------------------------------------------------------------

def test_batch_round_trip_matches_reference():
    rng = np.random.default_rng(1)
    table = arrow_table(rng, 700)
    ref = ref_batch(table, np)
    mine = pdev.batch_to_device(table.to_batches()[0], "cpu")
    assert mine.capacity == ref.capacity == 1024
    for rc, pc_ in zip(ref.columns, mine.columns):
        np.testing.assert_array_equal(np.asarray(rc.validity),
                                      pc_.validity.numpy())
        np.testing.assert_array_equal(
            np.asarray(rc.data).view(np.uint8),
            pc_.data.numpy().view(np.uint8))
    want = pa.Table.from_batches([rdev.batch_to_arrow(ref)])
    for batch in (mine, port_batch(ref)):
        got = pa.Table.from_batches([pdev.batch_to_arrow(batch)])
        assert got.schema == want.schema
        assert_tables_equal(want, got, ignore_order=False)


def test_bucket_for_matches_reference():
    for n in (0, 1, 1024, 1025, 4194304, 4194305, 1 << 25):
        assert pdev.bucket_for(n) == rdev.bucket_for(
            n, rdev.DEFAULT_ROW_BUCKETS)


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        GpuSession()
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        GpuSession(device="cuda")
    table = pa.table({"k": pa.array([1, 2], type=pa.int64())})
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        pdev.batch_to_device(table.to_batches()[0], "cuda")


def test_unported_type_raises():
    # a time of day has no SQL type in the port (nor in the reference)
    table = pa.table({"s": pa.array([1, 2], pa.time32("s"))})
    with pytest.raises(NotImplementedError, match="time32"):
        GpuSession(device="cpu").create_dataframe(table)


# ---------------------------------------------------------------------------
# ops/segmented.py: key words
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["k", "i", "v", "f", "b"])
def test_key_words_match_reference(name):
    rng = np.random.default_rng(2)
    table = arrow_table(rng, 900).select([name])
    ref = ref_batch(table, np)
    mine = port_batch(ref)
    live = np.arange(ref.capacity) < ref.num_rows
    ref_words = rseg.key_words_for_column(np, ref.columns[0], live)
    my_words = pseg.key_words_for_column(mine.columns[0])
    assert len(ref_words) == len(my_words) == 2
    for rw, mw in zip(ref_words, my_words):
        rw = np.asarray(rw)
        mw = mw.numpy()
        if rw.dtype == np.uint64:
            # carried as int64 holding (word XOR 2^63)
            np.testing.assert_array_equal(
                (rw ^ np.uint64(1 << 63)).view(np.int64), mw)
        else:
            # narrow words keep their order as plain int64 values
            bias = (1 << 31) if rw.dtype == np.uint32 else 0
            np.testing.assert_array_equal(rw.astype(np.int64) - bias, mw)


def test_float_words_total_order():
    col = pdev.DeviceColumn(pt.DOUBLE, torch.tensor(SPECIAL_DOUBLES),
                            torch.ones(len(SPECIAL_DOUBLES), dtype=torch.bool))
    w = pseg.key_words_for_column(col)[1]
    vals = SPECIAL_DOUBLES
    zero = (vals == 0.0)
    assert len(set(w[torch.from_numpy(zero)].tolist())) == 1   # -0.0 == 0.0
    nan = np.isnan(vals)
    assert len(set(w[torch.from_numpy(nan)].tolist())) == 1    # one NaN
    assert int(w[torch.from_numpy(nan)][0]) > int(w[torch.from_numpy(~nan)]
                                                  .max())      # NaN last
    finite = ~nan
    order = np.argsort(w.numpy()[finite], kind="stable")
    assert np.all(np.diff(vals[finite][order]) >= 0)


def test_segment_boundaries_and_ids_match_reference():
    rng = np.random.default_rng(3)
    n = 600
    words = [np.sort(rng.integers(0, 2, n)).astype(np.uint8),
             rng.integers(0, 3, n).astype(np.uint64)]
    words[1] = words[1][np.lexsort((words[1], words[0]))]
    live = np.arange(n) < 550
    ref_ng = rseg.segment_boundaries(np, words, live)
    mine_ng = pseg.segment_boundaries(
        [torch.from_numpy(w.astype(np.int64)) for w in words],
        torch.from_numpy(live))
    np.testing.assert_array_equal(ref_ng, mine_ng.numpy())
    np.testing.assert_array_equal(rseg.segment_ids(np, ref_ng),
                                  pseg.segment_ids(mine_ng).numpy())


# ---------------------------------------------------------------------------
# ops/carry.py: K2 (sort) and K1 (compaction), plain versions on the CPU
# ---------------------------------------------------------------------------

def _ref_and_port_words(rng, n, kind):
    """(reference words, port words) for keys of one kind."""
    if kind == "ties":
        data = rng.integers(-2, 3, n).astype(np.int64)
    elif kind == "extreme":
        data = rng.choice(EXTREME_LONGS, n)       # words >= 2^63 included
    else:
        data = rng.choice(SPECIAL_DOUBLES, n)
    valid = rng.random(n) < 0.85
    dtype = rt.DOUBLE if kind == "doubles" else rt.LONG
    data = np.where(valid, data, np.zeros_like(data))
    ref_col = rdev.DeviceColumn(dtype, data=data, validity=valid)
    my_col = pdev.DeviceColumn(pt.from_name(dtype.name),
                               torch.from_numpy(data.copy()),
                               torch.from_numpy(valid.copy()))
    live = np.ones(n, dtype=bool)
    ref_words = rseg.key_words_for_column(np, ref_col, live)
    return ref_words, pseg.key_words_for_column(my_col)


@pytest.mark.parametrize("kind", ["ties", "extreme", "doubles"])
def test_sort_rows_matches_reference(kind):
    rng = np.random.default_rng(4)
    n = 777
    ref_words, my_words = _ref_and_port_words(rng, n, kind)
    ref_order, _, _ = rcarry.sort_rows(
        jnp, [jnp.asarray(w) for w in ref_words], [], n)
    payload = pdev.DeviceColumn(pt.LONG, torch.arange(n, dtype=torch.int64),
                                torch.ones(n, dtype=torch.bool))
    my_order, (moved,), (moved_word,) = pcarry.sort_rows(
        my_words, [payload], extras=[my_words[1]])
    assert my_order.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref_order), my_order.numpy())
    np.testing.assert_array_equal(moved.data.numpy(), np.asarray(ref_order))
    assert torch.equal(moved_word, my_words[1][my_order.long()])
    assert pcarry.sort_order.launches == 0       # CPU tensors: plain version


def test_sort_is_stable_on_equal_keys():
    n = 300
    words = [torch.zeros(n, dtype=torch.int64),
             torch.tensor([5, 5, 3] * 100, dtype=torch.int64)]
    order = pcarry.sort_order(words).tolist()
    threes = [i for i in range(n) if i % 3 == 2]
    fives = [i for i in range(n) if i % 3 != 2]
    assert order == threes + fives


@pytest.mark.parametrize("keep_frac", [0.0, 0.4, 1.0])
def test_compact_rows_matches_reference(keep_frac):
    rng = np.random.default_rng(5)
    table = arrow_table(rng, 800)
    ref = ref_batch(table)
    keep = (rng.random(ref.capacity) < keep_frac) & \
        (np.arange(ref.capacity) < ref.num_rows)
    ref_out = rfilter.compact(jnp, ref, jnp.asarray(keep), ref.names)
    mine = pfilter.compact(port_batch(ref), torch.from_numpy(keep),
                           ref.names)
    assert mine.num_rows == int(ref_out.num_rows) == int(keep.sum())
    for rc, mc in zip(ref_out.columns, mine.columns):
        np.testing.assert_array_equal(np.asarray(rc.validity),
                                      mc.validity.numpy())
        np.testing.assert_array_equal(np.asarray(rc.data).view(np.uint8),
                                      mc.data.numpy().view(np.uint8))


def test_compact_plain_version_is_a_stable_partition():
    keep = torch.tensor([False, True, True, False, True])
    data = torch.arange(5, dtype=torch.int64)
    valid = torch.ones(5, dtype=torch.bool)
    (d, v), n = pcarry.compact_lanes(keep, [data, valid], [False, True])
    assert n == 3
    assert d.tolist() == [1, 2, 4, 0, 3]
    assert v.tolist() == [True, True, True, False, False]
    assert pcarry.compact_lanes.launches == 0


# ---------------------------------------------------------------------------
# expr/predicates.py: comparisons and three-valued logic
# ---------------------------------------------------------------------------

def _bound(table, build):
    names = table.schema.names
    rtypes = [rdev.from_arrow_type(f.type) for f in table.schema]
    ptypes = [pt.from_name(x.name) for x in rtypes]
    return (rcore.bind_expression(build(rpred, rcore), names, rtypes),
            pcore.bind_expression(build(ppred, pcore), names, ptypes))


PREDICATES = {
    "gt_long": lambda P, C: P.GreaterThan(C.AttributeReference("v"),
                                          C.Literal(-5)),
    "le_double_nan": lambda P, C: P.LessThanOrEqual(
        C.AttributeReference("f"), C.Literal(1.5)),
    "eq_nan": lambda P, C: P.EqualTo(C.AttributeReference("f"),
                                     C.AttributeReference("f")),
    "lt_int_long": lambda P, C: P.LessThan(C.AttributeReference("i"),
                                           C.AttributeReference("v")),
    "and_or_not": lambda P, C: P.Or(
        P.And(C.AttributeReference("b"),
              P.GreaterThanOrEqual(C.AttributeReference("k"),
                                   C.Literal(0))),
        P.Not(P.EqualTo(C.AttributeReference("k"), C.Literal(1)))),
    "literal_vs_column": lambda P, C: P.GreaterThan(
        C.Literal(0.5), C.AttributeReference("f")),
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicates_match_reference(name):
    rng = np.random.default_rng(6)
    table = arrow_table(rng, 500)
    ref = ref_batch(table, np)
    r_expr, p_expr = _bound(table, PREDICATES[name])
    rv = r_expr.eval(rcore.EvalContext(np, ref)).col
    pv = p_expr.eval(pcore.EvalContext(port_batch(ref))).col
    np.testing.assert_array_equal(np.asarray(rv.validity),
                                  pv.validity.numpy())
    np.testing.assert_array_equal(np.asarray(rv.data), pv.data.numpy())


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_rapids_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_project_matches_reference():
    from spark_rapids_tpu.exec.base import ExecContext as RExecContext
    from spark_rapids_tpu.exec.basic import LocalScanExec as RScan
    from spark_rapids_tpu.exec.basic import ProjectExec as RProject
    from spark_rapids_tpu_torch.exec.base import ExecContext as PExecContext
    from spark_rapids_tpu_torch.exec.basic import LocalScanExec as PScan
    from spark_rapids_tpu_torch.exec.basic import ProjectExec as PProject
    table = arrow_table(np.random.default_rng(7), 300)

    def exprs(P, C):
        return [C.AttributeReference("k"),
                C.Alias(P.GreaterThan(C.AttributeReference("f"),
                                      C.Literal(0.0)), "pos"),
                C.Alias(C.Literal(7), "seven")]

    want = RProject(exprs(rpred, rcore), RScan(table)).execute_collect(
        RExecContext())
    got = PProject(exprs(ppred, pcore), PScan(table)).execute_collect(
        PExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False)
