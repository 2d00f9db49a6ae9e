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
            + 2 * up(tiles * ops * 32) + up(n * record)
            + up(-(-tiles // 64) * ops * 32))


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
                          path="record", runs=runs)
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
    plan = pagg.k3_plan(1 << 22, values, masks, 0, True,
                        path="record" if packed else "direct")
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
    plan = pagg.k3_plan(1 << 22, values, values, 6, True, path="record")
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
    plan = pagg.k3_plan(1 << 22, ["v"], ["m"], nkeys, True, path="record")
    s = plan.sets[0]
    assert (s.record_bytes, len(s.key_offsets)) == (record, carried)
    far = nkeys - carried
    assert plan.packed_bytes == (1 << 22) * (
        8 + 8 * carried + 1 + record + 4 + max(record, 32) + 32 * far)


# q1d: sum(qty), sum(price), sum(disc) (DECIMAL64 columns read through
# their signs), min/max(price), min/max(ship date), count(*)
Q1D_ROWS = 32_357_834          # q1d's rows after its filter
Q1D_VALUES = ["qty", "price", "disc", "price", "price", "ship", "ship", None]
Q1D_HIS = [pagg.SIGN] * 3 + [None] * 5
Q1D_MASKS = ["qty.valid", "price.valid", "disc.valid", "price.valid",
             "price.valid", "ship.valid", "ship.valid", "one.valid"]


@pytest.mark.parametrize("runs,packed,run_path", [
    (1, False, True), (6, False, True), (64, False, True),
    (65, True, False), (None, True, False), (100_000, True, False)])
def test_k3_plan_few_runs_128bit_take_the_run_path(runs, packed, run_path):
    """q1d's 128-bit set over an order of at most 64 runs keeps the
    direct path and takes the run path (tiles of input rows split by the
    runs); more runs (or runs not counted) take the byte rule; forcing
    the records or turning the run path off keeps tiles of sorted rows.
    The three sums read their DECIMAL64 lanes with SIGN (-2) as the high
    lane, so the set reads 4 distinct lanes; the run path's traffic counts
    each input once and the order twice, and its scratch holds the
    pieces (runs x tiles) and the fixup's block heads."""
    plan = pagg.k3_plan(Q1D_ROWS, Q1D_VALUES, Q1D_MASKS, 4, True, runs=runs,
                        his=Q1D_HIS)
    assert (plan.packed, plan.run_path) == (packed, run_path)
    s = plan.sets[0]
    assert [Q1D_VALUES[k] for k in s.lanes] == ["qty", "price", "disc",
                                                "ship"]
    assert s.op_lane == [0, 1, 2, 1, 1, 3, 3, -1]
    assert s.op_lane_hi == [-2, -2, -2, -1, -1, -1, -1, -1]
    if run_path:
        # order twice, 4 key words, 4 lanes, 5 masks of a byte
        assert plan.direct_bytes == Q1D_ROWS * (8 + 32 + 32 + 5)
        assert plan.direct_bytes < plan.packed_bytes
        tiles = -(-Q1D_ROWS // 2048)
        parts = runs * tiles

        def up(x):
            return (x + 15) // 16 * 16
        assert plan.scratch_bytes == (
            up((1 + tiles) * 8) + up(tiles * 512) + 2 * up(parts * 4)
            + 2 * up(parts * 8 * 32) + up(runs * (tiles + 1) * 4)
            + up(-(-parts // 64) * 8 * 32))
    for path in ("direct", "record"):
        assert not pagg.k3_plan(Q1D_ROWS, Q1D_VALUES, Q1D_MASKS, 4, True,
                                path=path, runs=runs, his=Q1D_HIS).run_path


def test_k3_plan_sign_lane_in_a_record():
    """On the record path a sum through SIGN packs only its low lane: the
    record holds the 4 distinct lanes, the key words and the mask word,
    and the plan's scratch is the layout's."""
    plan = pagg.k3_plan(Q1D_ROWS, Q1D_VALUES, Q1D_MASKS, 4, True,
                        path="record", his=Q1D_HIS)
    s = plan.sets[0]
    assert (s.record_bytes, s.lane_offsets, s.key_offsets,
            s.mask_offset) == (128, [0, 8, 16, 24], [32, 40, 48, 56], 64)
    assert s.op_lane_hi == [-2, -2, -2, -1, -1, -1, -1, -1]
    assert plan.scratch_bytes == _scratch(Q1D_ROWS, 2, 8, 128)


@pytest.mark.parametrize("path", pagg.K3_PATHS)
@pytest.mark.parametrize("g", [1, 6, 65])
def test_k3_sign_sums_match_reference_segment_sum128(path, g):
    """q1d-shaped ops through ``segment_reduce_sorted`` (on the CPU its
    plain version, whatever path is asked for) over g groups, so g runs
    of K2's order, against the reference: the SIGN sums as the reference's
    ``segment_sum128`` (numpy branch) over the lane and its materialised
    signs, min and max as its ``segment_reduce``, the count exactly."""
    from spark_rapids_tpu.ops import segmented as rseg
    rng = np.random.default_rng(17)
    n = 6000
    key = rng.integers(0, g, n)
    qty = rng.integers(1, 51, n) * 100
    price = rng.integers(-10**13, 10**13, n)
    ship = rng.integers(8036, 10562, n)
    valid = rng.random(n) > 0.1
    t = [torch.from_numpy(x) for x in (key, qty, price, ship, valid)]
    order = pcarry.sort_order([t[0]])
    lanes = {"qty": t[1], "price": t[2], "disc": t[1], "ship": t[3]}
    values = [None if v is None else lanes[v] for v in Q1D_VALUES]
    ops = ["sum", "sum", "sum", "min", "max", "min", "max", "sum"]
    first, sums, counts, groups = pagg.segment_reduce_sorted(
        [t[0]], None, values, [t[4]] * 8, False, order, ops, path=path,
        values_hi=Q1D_HIS)
    assert groups == g
    assert key[first.numpy()].tolist() == list(range(g))
    seg_ids = key.astype(np.int32)
    for k in range(3):
        x = values[k].numpy()
        rlo, rhi, rcnt = rseg.segment_sum128(np, x, x >> 63, seg_ids, g,
                                             valid)
        assert sums[k][0].tolist() == rlo.tolist()
        assert sums[k][1].tolist() == rhi.tolist()
        assert counts[k].tolist() == rcnt.tolist()
    for k in range(3, 7):
        want, _ = rseg.segment_reduce(np, ops[k], values[k].numpy(),
                                      seg_ids, g, valid)
        assert sums[k].tolist() == np.asarray(want).tolist()
    assert counts[7].tolist() == np.bincount(key[valid], minlength=g
                                             ).tolist()


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
    k3_vals, k3_contribs, k3_names, take, _ = pagg.k3_ops(p_vals, ops)
    first_row, sums, counts, groups = pagg.segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order, k3_names,
        path=None if packed is None else "record" if packed else "direct")
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


# ---------------------------------------------------------------------------
# the positional kinds, first and last
# ---------------------------------------------------------------------------

# qg2's update: first(date) counting nulls and count(*) over every row (no
# mask: K3 reads them from the groups' bounds), last(price) over its
# validity and the collects' counts over theirs: five ops, no value lane
QG2_ROWS = 7_500_000
QG2_VALUES = [None, None, None, None, None]
QG2_MASKS = [None, "price.valid", "keys.valid", "prio.valid", None]


def test_k3_plan_positional_reads_masks_alone():
    """A first or last reads no value lane, only its contributor mask, and
    an op over every row reads none: qg2's set holds three masks, 22.5 MB
    that stay in the L2 cache, so it keeps the direct path (the order, and
    a sector a row for the key word and each mask, as the model counts
    them) over the 16-byte records of the key word and the mask word."""
    plan = pagg.k3_plan(QG2_ROWS, QG2_VALUES, QG2_MASKS, 1, True)
    s = plan.sets[0]
    assert not plan.packed and not plan.run_path and s.lanes == []
    assert plan.bounds and s.op_lane == [-1] * 5
    assert [QG2_MASKS[k] for k in s.masks] == ["price.valid", "keys.valid",
                                               "prio.valid"]
    assert s.op_mask == [-1, 0, 1, 2, -1]
    assert plan.direct_bytes == QG2_ROWS * (4 + 32 * 4)
    assert plan.packed_bytes == QG2_ROWS * (8 + 3 + 16 + 4 + 32)
    # and the groups' first sorted positions
    assert plan.scratch_bytes == _scratch(QG2_ROWS, 8, 5, 0) + 4 * QG2_ROWS
    assert not pagg.k3_may_pack(QG2_ROWS, QG2_VALUES, QG2_MASKS, True)


@pytest.mark.parametrize("path,packed,record", [
    (None, False, 0), ("direct", False, 0), ("record", True, 16),
    ("run", False, 0)])
def test_k3_plan_masks_alone_direct_or_records_at_qg2(path, packed, record):
    """Each layout of qg2's set a path asks for: the masks read through
    the order, or the 16-byte record of the key word and a word of the
    three mask bits; the planned one is the direct path's, and an order
    whose runs are not counted gives no run path."""
    plan = pagg.k3_plan(QG2_ROWS, QG2_VALUES, QG2_MASKS, 1, True, path=path)
    s = plan.sets[0]
    assert plan.packed == packed and s.record_bytes == record
    if record:
        assert (s.key_offsets, s.mask_offset) == ([0], 8)
        assert plan.rows_per_thread == 16
    assert plan.bounds and not plan.run_path


@pytest.mark.parametrize("n,masks,packed", [
    (1 << 23, 3, False),                    # 24 MiB of masks
    ((32 << 20) // 3, 3, False),            # at the edge
    ((32 << 20) // 3 + 1, 3, True),
    (1 << 25, 3, True),                     # 96 MiB: records
    (1 << 25, 1, False)])                   # 32 MiB
def test_k3_plan_masks_alone_records_past_l2(n, masks, packed):
    """A set of masks and no value lane keeps the direct path while its
    masks fit ``_K3_MASKS_CACHED`` (the L2 cache's share) and takes the
    records past it, over a random order (runs not counted)."""
    ms = [f"m{q}" for q in range(masks)]
    plan = pagg.k3_plan(n, [None] * (masks + 1), ms + [None], 1, True)
    assert plan.packed == packed
    assert pagg.k3_may_pack(n, [None] * masks, ms, True) == packed
    assert not pagg.k3_plan(n, [None] * masks, ms, 1, False).packed


def test_k3_may_pack_masks_alone_by_the_l2_edge():
    """The masks' L2 edge is for sets of masks alone: with a value lane
    the inputs keep the 96-MiB rule, so nine masks of 4 Mi rows (36 MiB)
    beside a lane stay direct, and alone take records; masks of every row
    (None) count nothing."""
    n, ms = 1 << 22, [f"m{q}" for q in range(9)]
    assert not pagg.k3_may_pack(n, ["v"] + [None] * 9, ["v.valid"] + ms,
                                True)
    assert pagg.k3_may_pack(n, [None] * 9, ms, True)
    assert not pagg.k3_may_pack(1 << 25, [None] * 3, [None] * 3, True)
    assert not pagg.k3_may_pack(n, [None] * 9, ms, False)


def test_k3_plan_every_row_ops_read_no_mask():
    """Ops over every row (mask None) add no mask to their set, not even
    on the record path, and need the starts in the scratch; a set of
    counts over every row alone reads nothing but the order and keys."""
    plan = pagg.k3_plan(1 << 20, [None, None, None], [None, None, None], 1,
                        True)
    s = plan.sets[0]
    assert s.masks == [] and s.op_mask == [-1, -1, -1] and plan.bounds
    assert plan.direct_bytes == (1 << 20) * (4 + 32)
    assert plan.scratch_bytes == _scratch(1 << 20, 8, 3, 0) + 4 * (1 << 20)
    rec = pagg.k3_plan(1 << 20, [None, None], [None, "m"], 1, True,
                       path="record")
    assert rec.sets[0].masks == [1] and rec.sets[0].op_mask == [-1, 0]
    assert not pagg.k3_plan(1 << 20, [None], ["m"], 1, True).bounds


@pytest.mark.parametrize("shared,masks", [(True, 1), (False, 2)])
def test_k3_plan_first_and_last_share_a_mask(shared, masks):
    """A first and a last of one column read its mask once; on the record
    path it is one bit of the mask word, beside the key word."""
    ms = ["x.valid", "x.valid" if shared else "y.valid"]
    plan = pagg.k3_plan(1 << 22, [None, None], ms, 1, True, path="record")
    s = plan.sets[0]
    assert len(s.masks) == masks and s.op_mask == [0, 0 if shared else 1]
    assert (s.record_bytes, s.key_offsets, s.mask_offset) == (16, [0], 8)
    # the pack reads the key word and the masks and writes 16-byte records;
    # the fold reads the order and one record sector a row
    assert plan.packed_bytes == (1 << 22) * (8 + masks + 16 + 4 + 32)


def test_k3_positional_kinds_beside_other_ops():
    """segment_reduce_sorted with first and last beside a sum and a min
    over an order: each positional result is the input row of the
    group's least / greatest sorted contributing position; the plain
    version launches nothing."""
    rng = np.random.default_rng(24)
    n = 5000
    keys = torch.from_numpy(rng.integers(0, 40, n))
    flag = torch.from_numpy(rng.integers(0, 2, n))
    # a group over two runs: the order sorts by (key, flag)
    order = pcarry.sort_order_plain([keys, flag])
    v = torch.from_numpy(rng.integers(-50, 50, n))
    m = torch.from_numpy(rng.random(n) < 0.3)
    first_row, sums, counts, g = pagg.segment_reduce_sorted(
        [keys], None, [None, None, v, v], [m, m, m, m], False, order,
        ["first", "last", "sum", "min"])
    rows = order.numpy()
    ks = keys.numpy()[rows]
    for gi, k in enumerate(np.unique(ks)):
        sel = np.flatnonzero((ks == k) & m.numpy()[rows])
        assert int(counts[0][gi]) == len(sel)
        if len(sel):
            assert int(sums[0][gi]) == rows[sel[0]]
            assert int(sums[1][gi]) == rows[sel[-1]]
        assert int(first_row[gi]) == rows[np.flatnonzero(ks == k)[0]]
    assert sums[0].dtype == torch.int32
    assert pagg.segment_reduce_sorted.launches == 0


# ---------------------------------------------------------------------------
# ops over every row, from the groups' bounds, against the reference
# ---------------------------------------------------------------------------

EVERY_OPS = ["first", "last", "sum", "first", "last", "sum"]


@pytest.mark.parametrize("shape", ["span_runs", "one_row_groups",
                                   "live_head", "global", "rows_in_order"])
def test_k3_every_row_picks_match_reference_segment_reduce(shape):
    """first, last and a count over every row (no mask: K3 reads them
    from the groups' bounds) beside first, last and a count over a mask,
    through the wrapper, against the reference's ``ops/segmented.py:
    segment_reduce(np, "first" | "last")`` of the rows' input rows and its
    counts, per group: groups over two of the order's runs (the order
    sorts by key then a flag), one-row groups, rows before the first
    start (the first sorted rows not live), the ungrouped aggregate, and
    rows already in key order."""
    from spark_rapids_tpu.ops import segmented as rseg
    rng = np.random.default_rng(25)
    n = 6000
    ngroups = {"one_row_groups": n}.get(shape, 37)
    keys = rng.integers(0, ngroups, n)
    flag = rng.integers(0, 2, n)
    if shape == "one_row_groups":
        keys = rng.permutation(n)
    if shape == "rows_in_order":
        keys = np.sort(keys)
    mask = rng.random(n) < 0.3
    glob = shape == "global"
    order = None if shape == "rows_in_order" else np.lexsort((flag, keys))
    live = np.ones(n, bool)
    if shape == "live_head":
        live[order[:7]] = False
    rows = np.arange(n) if order is None else order
    ks, live_s = keys[rows], live[rows]
    if glob:
        ids, g = np.zeros(n, np.int64), 1
    else:
        new = live_s & np.r_[True, ks[1:] != ks[:-1]]
        ids, g = np.cumsum(new) - 1, int(new.sum())
    grouped = ids >= 0
    t = torch.from_numpy
    got = pagg.segment_reduce_sorted(
        [] if glob else [t(keys)], None if shape != "live_head" else
        t(live), [None] * 6, [None, None, None] + [t(mask)] * 3, glob,
        None if order is None else t(order.astype(np.int32)), EVERY_OPS)
    assert got[3] == g
    for k, (op, valid) in enumerate(zip(EVERY_OPS, [grouped] * 3 + [
            grouped & mask[rows]] * 3)):
        out, cnt = rseg.segment_reduce(
            np, "first" if op == "sum" else op, rows.astype(np.int64),
            np.maximum(ids, 0), g, valid)
        assert np.array_equal(got[2][k].numpy(), cnt), (shape, k)
        if op != "sum":
            ok = cnt > 0
            assert np.array_equal(got[1][k].numpy()[ok], out[ok]), (shape, k)
            assert not got[1][k].numpy()[~ok].any()
    assert pagg.segment_reduce_sorted.launches == 0


@pytest.mark.parametrize("global_agg", [False, True])
def test_k3_every_row_ops_match_reference_group_reduce(global_agg):
    """The port's ``_group_reduce`` with first_any, last_any and a count
    of a column valid in every row (count(*)'s literal: no mask for K3)
    beside first, last, countvalid and a sum over nullable columns, against
    the reference's ``_group_reduce`` on the same rows; the K3 call it
    makes hands every-row ops no mask."""
    from test_torch_aggregate import _columns
    rng = np.random.default_rng(32)
    n = 4000
    table = _table(rng, n, 12).append_column(
        "one", pa.array(np.ones(n, dtype=np.int64)))
    ref, mine = _columns(table, n)
    spec = [(1, "first_any"), (1, "last_any"), (2, "first"), (2, "last"),
            (4, "countvalid"), (1, "countvalid"), (3, "sum")]
    ops = [op for _, op in spec]
    every = [c == 4 for c, _ in spec]
    live = jnp.arange(ref.capacity) < ref.num_rows
    rk, rv, rn = ragg._group_reduce(
        jnp, [] if global_agg else [ref.columns[0]],
        [ref.columns[c] for c, _ in spec], ops, ref.capacity, live,
        global_agg)
    seen = []
    orig = pagg.segment_reduce_sorted

    def spy(*args, **kw):
        seen.append(args[3])
        return orig(*args, **kw)
    pagg.segment_reduce_sorted = spy
    try:
        pk, pv, pn = pagg._group_reduce(
            [] if global_agg else [mine.columns[0]],
            [mine.columns[c] for c, _ in spec], ops, n, global_agg,
            every=every)
    finally:
        pagg.segment_reduce_sorted = orig
    assert pn == int(rn)
    masks = seen[0]
    if global_agg:
        # no key word: every-row ops take one shared mask of every row
        assert masks[0] is masks[1] is masks[4]
    else:
        assert masks[0] is None and masks[1] is None and masks[4] is None
    assert masks[2] is not None and masks[5] is not None
    for k, (c, op) in enumerate(spec):
        rd = np.asarray(rv[k].data)[:pn]
        ok = np.asarray(rv[k].validity)[:pn]
        assert np.array_equal(pv[k].validity[:pn].numpy(), ok), op
        pd = pv[k].data[:pn].numpy()
        if rd.dtype == np.float64:
            np.testing.assert_allclose(pd[ok], rd[ok], rtol=FLOAT_RTOL,
                                       atol=0.0, equal_nan=True)
        else:
            assert np.array_equal(pd[ok], rd[ok]), op
