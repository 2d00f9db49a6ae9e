"""K3 (``exec/aggregate.py:segment_reduce_sorted``) on the CPU: its plan
and its results against the reference.

The plan (``k3_plan``) decides from sizes alone between the record path
(each input row's distinct lanes packed into a record of 16 to 128
bytes, then one record read a row through the order) and the direct
path (each distinct input read through the order), cuts the ops into
launch sets, lays out each set's record and sizes the scratch.  On the
CPU ``segment_reduce_sorted`` runs its plain version whatever path is
asked for and launches nothing.  Its results on q1-like and q1x-like
ops are held against the reference's ``exec/aggregate.py:_group_reduce``
(sums, counts, min and max through its jax branch) on the same numpy
inputs: keys, counts, integer sums, min and max exactly (min and max by
their bits), float sums to a relative 1e-9 (they add in another order).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec import aggregate as ragg
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import segmented as pseg

FLOAT_RTOL = 1e-9
Q1_ROWS = 25_163_115           # q1's rows after its filter
Q1X_ROWS = 32_880_000          # about q1x's rows after its filter

# q1: sum(v), avg(f) (its sum; its count folds with it), count(*)
Q1_VALUES = ["v", "f", None]
Q1_MASKS = ["v.valid", "f.valid", "one.valid"]
# q1x: sum(v), sum(disc), sum(charge), avg(v) (over v as double), avg(f),
# count(*), min/max(disc), min/max(v): 10 ops over 5 value lanes
Q1X_VALUES = ["v", "disc", "charge", "dv", "f", None, "disc", "disc", "v",
              "v"]
Q1X_MASKS = ["v.valid", "disc.valid", "charge.valid", "v.valid",
             "f.valid", "one.valid", "disc.valid", "disc.valid", "v.valid",
             "v.valid"]


def _scratch(n, rows_per_thread, ops, record):
    tiles = -(-n // (256 * rows_per_thread))

    def up(x):
        return (x + 15) // 16 * 16
    return (up((1 + tiles) * 8) + up(tiles * 512) + 2 * up(tiles * 4)
            + 2 * up(tiles * ops * 32) + up(n * record))


@pytest.mark.parametrize("shape,n,nkeys,record,rows,lanes,keys,mask_at", [
    # q1: v, f and k's varying word, three masks in the mask word
    ("q1", Q1_ROWS, 1, 32, 8, [0, 8], [16], 24),
    # q1x: five value lanes and two varying words (rf, ls): 60 bytes
    ("q1x", Q1X_ROWS, 2, 64, 4, [0, 8, 16, 24, 32], [40, 48], 56),
    # q1x grouped by a key whose four words all vary: 76 bytes
    ("q1x", Q1X_ROWS, 4, 128, 2, [0, 8, 16, 24, 32], [40, 48, 56, 64], 72),
])
def test_k3_plan_records(shape, n, nkeys, record, rows, lanes, keys,
                         mask_at):
    """q1's and q1x's shapes take the record path: each distinct value
    lane once, at 8-byte offsets, then the varying key words, then the
    mask word; a tile of 64 KB of records sets the rows a thread."""
    values, masks = ((Q1_VALUES, Q1_MASKS) if shape == "q1"
                     else (Q1X_VALUES, Q1X_MASKS))
    plan = pagg.k3_plan(n, values, masks, nkeys, ordered=True)
    assert plan.packed and plan.rows_per_thread == rows
    assert len(plan.sets) == 1
    s = plan.sets[0]
    assert s.ops == list(range(len(values)))
    assert (s.record_bytes, s.lane_offsets, s.key_offsets,
            s.mask_offset) == (record, lanes, keys, mask_at)
    assert plan.scratch_bytes == _scratch(n, rows, len(values), record)
    assert plan.packed_bytes < plan.direct_bytes


@pytest.mark.parametrize("runs,packed", [
    (None, True), (1, False), (6, False), (64, False), (65, True),
    (100_000, True)])
def test_k3_plan_few_runs_stay_direct(runs, packed):
    """An order of at most 64 increasing runs of input rows (K2's stable
    order over at most 64 groups: q1x's and qs1's 6) keeps the direct
    path, whose reads then stream; more runs (q1's 100,000 groups), or
    runs not counted, keep the byte rule; forcing still packs."""
    plan = pagg.k3_plan(Q1X_ROWS, Q1X_VALUES, Q1X_MASKS, 2, True,
                        runs=runs)
    assert plan.packed == packed
    forced = pagg.k3_plan(Q1X_ROWS, Q1X_VALUES, Q1X_MASKS, 2, True,
                          packed=True, runs=runs)
    assert forced.packed and forced.sets[0].record_bytes == 64


def test_k3_plan_distinct_inputs_at_q1x():
    """q1x's 10 ops read 5 distinct value lanes and 5 distinct masks: v
    by sum, min and max, disc by sum, min and max; each op's lane and
    mask bit name them."""
    s = pagg.k3_plan(Q1X_ROWS, Q1X_VALUES, Q1X_MASKS, 2, True).sets[0]
    assert [Q1X_VALUES[k] for k in s.lanes] == ["v", "disc", "charge", "dv",
                                                "f"]
    assert [Q1X_MASKS[k] for k in s.masks] == [
        "v.valid", "disc.valid", "charge.valid", "f.valid", "one.valid"]
    assert s.op_lane == [0, 1, 2, 3, 4, -1, 1, 1, 0, 0]
    assert s.op_mask == [0, 1, 2, 0, 3, 4, 1, 1, 0, 0]


def test_k3_plan_q1_bytes():
    """q1 through its order: the direct path reads one sector a row for
    each of 2 lanes, 3 masks and the key word (196 B a row with the
    order); the record path packs 27 B into 32 and reads one record a row
    (95 B)."""
    plan = pagg.k3_plan(Q1_ROWS, Q1_VALUES, Q1_MASKS, 1, True)
    assert plan.direct_bytes == Q1_ROWS * (4 + 32 * 6)
    assert plan.packed_bytes == Q1_ROWS * (27 + 32 + 4 + 32)


@pytest.mark.parametrize("case", ["unordered", "count_only", "in_l2",
                                  "small"])
def test_k3_plan_direct(case):
    """The direct path: rows already in key order (no order), a
    count-only op (the ordered pick of a string min or max), inputs that
    fit in the L2 cache, and a batch of a few rows."""
    values, masks, n, ordered = Q1_VALUES, Q1_MASKS, Q1_ROWS, True
    if case == "unordered":
        ordered = False
    elif case == "count_only":
        values, masks = [None], ["s.valid"]
    elif case == "in_l2":
        n = (96 << 20) // 19           # q1's 19 bytes of inputs a row
    else:
        n = 1000
    plan = pagg.k3_plan(n, values, masks, 1, ordered)
    assert not plan.packed and plan.rows_per_thread == 8
    assert all(s.record_bytes == 0 for s in plan.sets)
    assert plan.scratch_bytes == _scratch(n, 8, len(values), 0)
    assert pagg.k3_plan(n + 1 if case == "in_l2" else n, values, masks, 1,
                        ordered).packed == (case == "in_l2")


@pytest.mark.parametrize("packed,sizes,records", [
    (False, [16, 1], [0, 0]),
    # 15 lanes, the mask word and no key words fill 124 of 128 bytes
    (True, [15, 2], [128, 32]),
])
def test_k3_plan_two_sets(packed, sizes, records):
    """17 ops (the wide group-by's 17 sums): two launch sets; on the
    record path a set ends where its record would pass 128 bytes."""
    values = [f"v{j}" for j in range(17)]
    masks = [f"m{j}" for j in range(17)]
    plan = pagg.k3_plan(1 << 22, values, masks, 0, True, packed=packed)
    assert plan.packed == packed
    assert [len(s.ops) for s in plan.sets] == sizes
    assert [s.record_bytes for s in plan.sets] == records
    assert sum((s.ops for s in plan.sets), []) == list(range(17))
    rows = 2 if packed else 8
    assert plan.scratch_bytes == _scratch(1 << 22, rows, max(sizes),
                                          max(records))


def test_k3_plan_keys_in_the_first_set_only():
    """The first set's record carries the varying key words; the later
    sets fold with the start bits the first one kept."""
    values = [f"v{j}" for j in range(20)]
    plan = pagg.k3_plan(1 << 22, values, values, 6, True, packed=True)
    assert [len(s.key_offsets) for s in plan.sets] == [6, 0]
    assert [len(s.ops) for s in plan.sets] == [9, 11]
    assert plan.sets[0].record_bytes == 128


@pytest.mark.parametrize("nkeys,record,carried", [
    (7, 128, 7), (8, 16, 0), (18, 16, 0)])
def test_k3_plan_many_key_words(nkeys, record, carried):
    """Up to 7 varying key words ride in the first set's record; more
    (the wide group-by's 18) stay out of it and the fold reads each
    through the order, one sector a row, so the record path takes any
    key."""
    plan = pagg.k3_plan(1 << 22, ["v"], ["m"], nkeys, True, packed=True)
    s = plan.sets[0]
    assert (s.record_bytes, len(s.key_offsets)) == (record, carried)
    far = nkeys - carried
    assert plan.packed_bytes == (1 << 22) * (
        8 + 8 * carried + 1 + record + 4 + max(record, 32) + 32 * far)


def _table(rng, n, groups):
    """Keys with nulls and an all-null value group; v with the int64
    edges, f with NaN, -0.0 and the infinities, each 10 % null."""
    k = rng.integers(0, groups, n)
    v = rng.integers(-2**40, 2**40, n)
    v[rng.random(n) < 0.02] = -2**63
    v[rng.random(n) < 0.02] = 2**63 - 1
    f = rng.normal(size=n)
    pick = rng.random(n)
    f[pick < 0.02] = np.nan
    f[(pick > 0.02) & (pick < 0.04)] = -0.0
    f[(pick > 0.04) & (pick < 0.05)] = np.inf
    f[(pick > 0.05) & (pick < 0.06)] = -np.inf
    null_v = (rng.random(n) < 0.1) | (k == 3)     # group 3: every v null
    return pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=null_v),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "d": pa.array(f * 3.0 - 1.0, mask=rng.random(n) < 0.1)})


SHAPES = {
    # column index (into v, f, d) and op of each aggregate input
    "q1": [(0, "sum"), (1, "sum"), (1, "countvalid"), (2, "countvalid")],
    "q1x": [(0, "sum"), (2, "sum"), (1, "sum"), (1, "countvalid"),
            (2, "min"), (2, "max"), (0, "min"), (0, "max"), (1, "min"),
            (1, "max"), (0, "countvalid")],
}


@pytest.mark.parametrize("packed", [None, False, True])
@pytest.mark.parametrize("global_agg", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k3_matches_reference_group_reduce(shape, global_agg, packed):
    """K3 through its wrapper, with either path asked for, against the
    reference's ``_group_reduce`` on the same rows: keys at the groups'
    first rows, counts, integer sums (wrapping at the int64 edges), min
    and max (by bits: -0.0, NaN greatest) exactly, float sums to
    FLOAT_RTOL; the all-null group's v results are null."""
    from test_torch_aggregate import _columns
    rng = np.random.default_rng(31)
    n = 4000
    table = _table(rng, n, 12)
    ref, mine = _columns(table, n)
    spec = SHAPES[shape]
    ops = [op for _, op in spec]
    r_vals = [ref.columns[1 + c] for c, _ in spec]
    p_vals = [pagg._prefix(mine.columns[1 + c], n) for c, _ in spec]
    live = jnp.arange(ref.capacity) < ref.num_rows
    rk, rv, rn = ragg._group_reduce(
        jnp, [] if global_agg else [ref.columns[0]], r_vals, ops,
        ref.capacity, live, global_agg)
    key = pagg._prefix(mine.columns[0], n)
    words = [] if global_agg else pseg.key_words_for_column(key)
    order = pcarry.sort_order(words) if words else None
    k3_vals, k3_contribs, k3_names, take = pagg.k3_ops(p_vals, ops)
    first_row, sums, counts, groups = pagg.segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order, k3_names,
        packed=packed)
    assert groups == int(rn) == (1 if global_agg else 13)
    if not global_agg:
        rkey = np.asarray(rk[0].data)[:groups]
        rkey_ok = np.asarray(rk[0].validity)[:groups]
        idx = first_row.numpy()
        assert rkey_ok.tolist() == key.validity.numpy()[idx].tolist()
        assert np.array_equal(rkey[rkey_ok], key.data.numpy()[idx][rkey_ok])
    for (c, op), rc, t in zip(spec, rv, take):
        ok = np.asarray(rc.validity)[:groups]
        want = np.asarray(rc.data)[:groups]
        cnt = counts[t].numpy()
        if op == "countvalid":
            assert np.array_equal(cnt, want)
            continue
        assert (cnt > 0).tolist() == ok.tolist()
        got = sums[t].numpy()
        if op in ("min", "max"):
            got = got.astype(want.dtype)
            if want.dtype == np.float64:
                got, want = got.view(np.int64), want.view(np.int64)
            assert np.array_equal(got[ok], want[ok])
        elif want.dtype == np.float64:
            np.testing.assert_allclose(got[ok], want[ok], rtol=FLOAT_RTOL,
                                       atol=0.0, equal_nan=True)
        else:
            assert np.array_equal(got[ok], want[ok])
    if not global_agg:
        null_group = int(np.flatnonzero(
            np.asarray(rk[0].data)[:groups] == 3)[0])
        v_ops = [t for (c, op), t in zip(spec, take) if c == 0]
        assert all(int(counts[t][null_group]) == 0 for t in v_ops)
    assert pagg.segment_reduce_sorted.launches == 0
