"""Parity of the PyTorch port's grouped aggregate with the JAX reference.

The reference's ``_group_reduce`` and ``TpuHashAggregateExec`` run
through jnp on the CPU; the port's ``_group_reduce`` and
``GpuHashAggregateExec`` on ``device="cpu"``, where kernels K2 and K3
run their plain PyTorch versions.  Integer sums and counts must match
exactly; float sums to a relative 1e-9, because the reference adds a
group's values by a segmented prefix scan and the port in another
order (row order in the plain version, tiles and a fixed tree in K3).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.exec import aggregate as ragg
from spark_rapids_tpu.exec.base import TPU
from spark_rapids_tpu.exec.base import ExecContext as RExecContext
from spark_rapids_tpu.exec.basic import FilterExec as RFilterExec
from spark_rapids_tpu.exec.basic import LocalScanExec as RLocalScanExec
from spark_rapids_tpu.expr import aggregates as raggs
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import predicates as rpred
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec import concat as pconcat
from spark_rapids_tpu_torch.exec.base import ExecContext as PExecContext
from spark_rapids_tpu_torch.exec.basic import FilterExec as PFilterExec
from spark_rapids_tpu_torch.exec.basic import LocalScanExec as PLocalScanExec
from spark_rapids_tpu_torch.expr import aggregates as paggs
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import predicates as ppred
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import gather as pgather
from spark_rapids_tpu_torch.ops import segmented as pseg

FLOAT_RTOL = 1e-9


def q1_table(rng, n, nulls=True, specials=True):
    def mask(frac):
        return (rng.random(n) < frac) if nulls else None

    f = rng.random(n)
    if specials:
        pick = rng.random(n)
        f = np.where(pick < 0.01, np.inf, f)
        f = np.where((pick >= 0.01) & (pick < 0.02), -np.inf, f)
        f = np.where((pick >= 0.02) & (pick < 0.025), np.nan, f)
        f = np.where((pick >= 0.025) & (pick < 0.03), -0.0, f)
    big = rng.integers(2**61, 2**62, n)     # sums wrap mod 2^64
    v = np.where(rng.random(n) < 0.1, big, rng.integers(-10**6, 10**6, n))
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=mask(0.05)),
        "v": pa.array(v.astype(np.int64), mask=mask(0.1)),
        "f": pa.array(f, mask=mask(0.1)),
    })


def _columns(table, n_rows):
    """Reference (jnp) and port (cpu) columns of the same batch."""
    ref = rdev.batch_to_device(table.to_batches()[0])
    mine = pdev.batch_from_numpy_lanes(
        [np.asarray(c.data) for c in ref.columns],
        [np.asarray(c.validity) for c in ref.columns], ref.num_rows,
        ref.names, [c.dtype.name for c in ref.columns], "cpu")
    assert n_rows == int(ref.num_rows)
    return ref, mine


def _compare_column(rc, pc_, n, exact=True):
    rv = np.asarray(rc.validity)[:n]
    np.testing.assert_array_equal(rv, pc_.validity[:n].numpy())
    rd = np.asarray(rc.data)[:n]
    pd = pc_.data[:n].numpy()
    if exact:
        np.testing.assert_array_equal(rd, pd)
    else:
        np.testing.assert_allclose(pd, rd, rtol=FLOAT_RTOL, atol=0.0,
                                   equal_nan=True)


def _check_group_reduce(table, global_agg):
    """The port's _group_reduce equals the reference's on ``table``:
    sum(v) wraps; sum(f) with +-inf, nan, -0.0; two counts.  Returns the
    group count."""
    n = table.num_rows
    ref, mine = _columns(table, n)
    r_keys = [] if global_agg else [ref.columns[0]]
    p_keys = [] if global_agg else [mine.columns[0]]
    ops = ["sum", "sum", "countvalid", "countvalid"]
    r_vals = [ref.columns[1], ref.columns[2], ref.columns[2], ref.columns[0]]
    p_vals = [mine.columns[1], mine.columns[2], mine.columns[2],
              mine.columns[0]]
    live = jnp.arange(ref.capacity) < ref.num_rows
    rk, rv, rn = ragg._group_reduce(jnp, r_keys, r_vals, ops, ref.capacity,
                                    live, global_agg)
    pk, pv, pn = pagg._group_reduce(p_keys, p_vals, ops, n, global_agg)
    groups = int(rn)
    assert pn == groups
    for rc, pc_ in zip(rk, pk):
        _compare_column(rc, pc_, groups)
    for rc, pc_ in zip(rv, pv):
        _compare_column(rc, pc_, groups,
                        exact=pc_.data.dtype != torch.float64)
    assert pagg.segment_reduce_sorted.launches == 0   # plain version
    return groups


@pytest.mark.parametrize("global_agg", [False, True])
def test_group_reduce_matches_reference(global_agg):
    table = q1_table(np.random.default_rng(11), 900)
    groups = _check_group_reduce(table, global_agg)
    assert groups == (1 if global_agg else 41)        # 40 keys and null


def test_group_reduce_hot_key_matches_reference():
    """40 % of the rows under one key, nulls in k and v, +-inf and NaN in
    f: the input on which one thread folding a whole group was slowest."""
    rng = np.random.default_rng(16)
    n = 3000
    table = q1_table(rng, n)
    k = np.where(rng.random(n) < 0.4, 7, rng.integers(0, 40, n))
    table = table.set_column(0, "k", pa.array(k.astype(np.int64),
                                              mask=rng.random(n) < 0.05))
    assert _check_group_reduce(table, False) == 41


@pytest.mark.parametrize("sizes", [[4095], [4096], [4097], [8193],
                                   [4000, 4191, 100]],
                         ids=["4095", "4096", "4097", "8193",
                              "rows_4000_to_8190"])
def test_group_reduce_at_tile_edges_matches_reference(sizes):
    """Groups that end at, before and after K3's 4096-row tile edge, in
    key order; the rows are shuffled, so K3 reads them through K2's
    order.  The last layout has one group over sorted rows 4000-8190."""
    rng = np.random.default_rng(17)
    n = sum(sizes)
    k = np.repeat(np.arange(len(sizes), dtype=np.int64) * 5 - 3, sizes)
    table = q1_table(rng, n).set_column(0, "k",
                                        pa.array(rng.permutation(k)))
    assert _check_group_reduce(table, False) == len(sizes)


def test_group_reduce_of_no_rows():
    table = q1_table(np.random.default_rng(12), 0)
    mine = pdev.batch_to_device(pa.RecordBatch.from_arrays(
        [c.combine_chunks() for c in table.columns],
        names=table.column_names), "cpu")
    keys, vals, groups = pagg._group_reduce(
        [mine.columns[0]], [mine.columns[1]], ["sum"], 0, False)
    assert groups == 0 and keys[0].capacity == 1024
    keys, vals, groups = pagg._group_reduce(
        [], [mine.columns[1], mine.columns[2]], ["sum", "countvalid"], 0,
        True)
    assert groups == 1
    assert vals[0].validity[0].item() is False       # sum of nothing: null
    assert vals[1].data[0].item() == 0               # count of nothing: 0


def test_segment_reduce_plain_folds_in_row_order():
    words = [torch.tensor([1, 1, 2, 2, 2, 5], dtype=torch.int64)]
    live = torch.tensor([True] * 5 + [False])
    vals = torch.tensor([1.0, float("inf"), 2.0, float("-inf"),
                         float("inf"), 7.0], dtype=torch.float64)
    ints = torch.tensor([2**63 - 1, 1, 3, 4, 5, 6], dtype=torch.int64)
    first, sums, counts, groups = pagg.segment_reduce_sorted(
        words, live, [vals, ints, None], [live, live, live], False)
    assert groups == 2 and first.tolist() == [0, 2]
    assert sums[0].tolist()[0] == float("inf")
    assert np.isnan(sums[0].tolist()[1])              # +inf and -inf
    assert sums[1].tolist() == [-2**63, 12]           # wraps mod 2^64
    assert counts[2].tolist() == [2, 3]


def _same_bits(a, b):
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


@pytest.mark.parametrize("global_agg", [False, True])
def test_segment_reduce_through_order_equals_sorted_lanes(global_agg):
    """K3's interface: lanes in input order read through ``order`` give
    what the same lanes gathered into key order first give, with
    ``first_row`` naming input rows."""
    rng = np.random.default_rng(15)
    n = 3000
    words = [torch.from_numpy((rng.random(n) < 0.95).astype(np.int64)),
             torch.from_numpy(rng.integers(-30, 30, n))]
    order = pcarry.sort_order(words)
    f = rng.random(n)
    pick = rng.random(n)
    f = np.where(pick < 0.01, np.inf, np.where(pick > 0.995, np.nan, f))
    vals = [torch.from_numpy(rng.integers(2**61, 2**62, n)),
            torch.from_numpy(f), None]
    live = torch.from_numpy(rng.random(n) < 0.9)
    contribs = [live & torch.from_numpy(rng.random(n) < 0.8)
                for _ in vals]
    idx = order.long()
    old = pagg.segment_reduce_sorted(
        [w[idx] for w in words], live[idx],
        [None if v is None else v[idx] for v in vals],
        [c[idx] for c in contribs], global_agg)
    new = pagg.segment_reduce_sorted(words, live, vals, contribs,
                                     global_agg, order)
    assert new[3] == old[3] and (new[3] == 1) == global_agg
    assert torch.equal(new[0], order[old[0].long()])
    for a, b in zip(new[1] + new[2], old[1] + old[2]):
        assert (a is None and b is None) or _same_bits(a, b)
    assert pagg.segment_reduce_sorted.launches == 0   # plain version


# ---------------------------------------------------------------------------
# exec level: many batches, every mode
# ---------------------------------------------------------------------------

def _q1_aggs(lib_aggs, lib_core):
    A = lib_core.AttributeReference
    return [lib_aggs.AggregateExpression(lib_aggs.Sum(A("v")), "sv"),
            lib_aggs.AggregateExpression(lib_aggs.Average(A("f")), "af"),
            lib_aggs.AggregateExpression(lib_aggs.Count(None), "c")]


def _ref_plan(table, batch_rows, modes):
    scan = RLocalScanExec(table, batch_rows=batch_rows)
    filt = RFilterExec(rpred.GreaterThan(rcore.AttributeReference("v"),
                                         rcore.Literal(-500000)), scan)
    scan.placement = filt.placement = TPU
    keys = [rcore.AttributeReference("k")]
    node = ragg.TpuHashAggregateExec(keys, _q1_aggs(raggs, rcore), modes[0],
                                     filt)
    if len(modes) > 1:
        node = ragg.TpuHashAggregateExec(keys, node.aggregates, modes[1],
                                         node)
    return node


def _port_plan(table, batch_rows, modes):
    scan = PLocalScanExec(table, batch_rows=batch_rows)
    filt = PFilterExec(ppred.GreaterThan(pcore.AttributeReference("v"),
                                         pcore.Literal(-500000)), scan)
    keys = [pcore.AttributeReference("k")]
    node = pagg.GpuHashAggregateExec(keys, _q1_aggs(paggs, pcore), modes[0],
                                     filt)
    if len(modes) > 1:
        node = pagg.GpuHashAggregateExec(keys, node.aggregates, modes[1],
                                         node)
    return node


@pytest.mark.parametrize("modes", [("Complete",), ("Partial",),
                                   ("Partial", "Final")])
def test_many_batches_match_reference(modes):
    table = q1_table(np.random.default_rng(13), 2000)
    want = _ref_plan(table, 300, modes).execute_collect(RExecContext())
    got = _port_plan(table, 300, modes).execute_collect(PExecContext("cpu"))
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)


def test_stable_merge_ignores_batch_arrival_order():
    """The canonical keyed merge makes float sums a function of content:
    the same batches in another order give the same bits."""
    rng = np.random.default_rng(14)
    table = q1_table(rng, 2400, specials=False)
    pieces = [table.slice(i * 300, 300) for i in range(8)]
    outs = []
    for perm in (range(8), rng.permutation(8)):
        t = pa.concat_tables([pieces[i] for i in perm])
        out = _port_plan(t, 300, ("Complete",)).execute_collect(
            PExecContext("cpu")).sort_by("k")
        outs.append(out)
    assert outs[0].equals(outs[1])


def test_merge_reads_through_canonical_order():
    """The merge hands the canonical keyed order straight to the grouped
    reduce; the old route gathered the batch by that order and sorted it
    by key again.  Both give the same bits."""
    table = q1_table(np.random.default_rng(18), 2400, specials=False)
    node = _port_plan(table, 300, ("Complete",))
    ctx = PExecContext("cpu")
    partials = [node._update_batch(b)
                for b in node.children[0].execute_partition(0, ctx)]
    assert len(partials) == 8
    names = node._group_names + node._buffer_names
    merged_in = pconcat.concat_batches(
        partials, names, node._key_types() + node._buffer_types)
    got = node._merge_batch(merged_in)

    n = merged_in.num_rows
    live = pdev.DeviceBatch([pagg._prefix(c, n) for c in merged_in.columns],
                            n, names)
    words = [w for c in live.columns for w in pseg.key_words_for_column(c)]
    canon = pgather.gather_batch(live, pseg.lexsort(words), None, n)
    ok, ov, groups = pagg._group_reduce(
        list(canon.columns[:1]), list(canon.columns[1:]), node._merge_ops,
        n, False)
    assert got.num_rows == groups
    for a, b in zip(got.columns, ok + ov):
        assert _same_bits(a.data, b.data)
        assert torch.equal(a.validity, b.validity)
