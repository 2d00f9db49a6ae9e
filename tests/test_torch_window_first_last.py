"""First and last over window frames: the port against the reference and
Spark's answer, on the CPU.

The port computes every frame kind's bounds (a whole frame is the
partition, a running ROWS frame its start to the row, a running RANGE
frame its start to the end of the row's peer run, a bounded frame
``_frame_bounds``) and picks the row with K23 (``ops/scan.py:
frame_pick``, here its plain version).  Ignoring nulls, it is held
against the reference's TpuSession row for row with the reference's
``assert_tables_equal``.  With nulls counted the reference has no answer
Spark would give: on a whole frame it folds ``first_any`` as a sum, and
on any other frame it raises ("bounded frame op first_any"); both are
pinned, and the port is held to a Python oracle of Spark's semantics.
A DECIMAL128 column is picked whole (the reference fails with an
IndexError there, pinned), and K23's plain version is held against the
reference's formula over the valid-count prefix on every frame kind.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import window as rwexpr
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import window as pwexpr
from spark_rapids_tpu_torch.ops import scan as pscan

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
UNB = -(2**31)
UNF = 2**31

# (kind, start, end) of each frame: the reference's effective frames
FRAMES = {
    "range_running": None,                 # ORDER BY alone: Spark's default
    "whole": ("rows", UNB, UNF),
    "rows_running": ("rows", UNB, 0),
    "rows_bounded": ("rows", -3, 2),
    "rows_following": ("rows", 1, 4),
    "range_bounded": ("range", -20, 20),
}


def _ref_session():
    b = TpuSession.builder().config("spark.rapids.sql.enabled", True)
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create()


def _spec(W, col, frame):
    if frame is None:
        return W.Window.partition_by(col("k")).order_by(col("o"))
    kind, lo, hi = frame
    b = W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
    return b.rows_between(lo, hi) if kind == "rows" else \
        b.range_between(lo, hi)


def make_table(seed=3, n=300, column="x"):
    """k: 12 partitions and one (99) all null; o: a distinct order key
    with gaps (so RANGE frames differ from ROWS ones); the picked column
    with 40 % nulls."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n)
    k[:30] = 99
    o = rng.permutation(n) * 3
    null = rng.random(n) < 0.4
    null[:30] = True
    vals = {
        "x": [int(v) for v in rng.integers(-100, 100, n)],
        "s": [f"v{v}" for v in rng.integers(0, 50, n)],
        "d": [datetime.date(2000, 1, 1) + datetime.timedelta(days=int(v))
              for v in rng.integers(0, 5000, n)],
        "m": [decimal.Decimal(int(v)).scaleb(-2)
              for v in rng.integers(-10**8, 10**8, n)],
        "b": [bool(v) for v in rng.random(n) < 0.5],
        "f": [float(v) for v in np.round(rng.normal(0, 10, n), 2)],
    }[column]
    typ = {"x": pa.int64(), "s": pa.string(), "d": pa.date32(),
           "m": pa.decimal128(12, 2), "b": pa.bool_(), "f": pa.float64()}
    return pa.table({"k": pa.array(k, pa.int32()), "o": pa.array(o),
                     column: pa.array([None if z else v for v, z in
                                       zip(vals, null)], typ[column])})


def _query(df, F, col, W, fn, ignore, frame, column="x"):
    return df.select(col("k"), col("o"), getattr(F, fn)(
        col(column), ignore).over(_spec(W, col, frame)).alias("r"))


def _oracle(table, fn, ignore, frame, column="x"):
    """Spark's first/last over each row's frame, by Python."""
    k = table["k"].to_pylist()
    o = table["o"].to_pylist()
    v = table[column].to_pylist()
    parts = {}
    for i in range(len(k)):
        parts.setdefault(k[i], []).append(i)
    out = [None] * len(k)
    for rows in parts.values():
        rows.sort(key=lambda i: o[i])
        for p, i in enumerate(rows):
            if frame is None:
                span = rows[:p + 1]           # running RANGE, distinct o
            else:
                kind, lo, hi = frame
                if kind == "rows":
                    a = 0 if lo == UNB else max(p + lo, 0)
                    b = len(rows) - 1 if hi == UNF else min(p + hi,
                                                            len(rows) - 1)
                    span = rows[a:b + 1]
                else:
                    span = [j for j in rows if o[i] + lo <= o[j] <= o[i] + hi]
            vals = [v[j] for j in span]
            if ignore:
                vals = [x for x in vals if x is not None]
            if vals:
                out[i] = vals[0] if fn == "first" else vals[-1]
    return out


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("fn", ["first", "last"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_ignoring_nulls_matches_reference(frame, fn, partitions):
    t = make_table()
    ref = _ref_session()
    port = GpuSession(device="cpu")
    want = _query(ref.create_dataframe(t, num_partitions=partitions), RF,
                  rcol, rwexpr, fn, True, FRAMES[frame]).collect()
    got = _query(port.create_dataframe(t, num_partitions=partitions), PF,
                 pcol, pwexpr, fn, True, FRAMES[frame]).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got)
    assert "!" not in port.last_explain
    assert got.sort_by("o")["r"].to_pylist() == _oracle(
        t.sort_by("o"), fn, True, FRAMES[frame])


@pytest.mark.parametrize("fn", ["first", "last"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_counting_nulls_is_sparks_answer(frame, fn):
    """first(x) / last(x) with nulls counted: the frame's first or last
    row, null or not.  The reference folds a whole frame's first_any as a
    sum and raises on every other frame; both pinned."""
    t = make_table(4)
    port = GpuSession(device="cpu")
    got = _query(port.create_dataframe(t, num_partitions=2), PF, pcol,
                 pwexpr, fn, False, FRAMES[frame]).collect().sort_by("o")
    assert got["r"].to_pylist() == _oracle(t.sort_by("o"), fn, False,
                                           FRAMES[frame])
    assert "!" not in port.last_explain
    ref = _ref_session()
    q = _query(ref.create_dataframe(t, num_partitions=2), RF, rcol, rwexpr,
               fn, False, FRAMES[frame])
    if frame == "whole":
        want = q.collect().sort_by("o")
        sums = {}
        for k, x in zip(t["k"].to_pylist(), t["x"].to_pylist()):
            if x is not None:
                sums[k] = sums.get(k, 0) + x
        assert want["r"].to_pylist() == [sums.get(k) for k in
                                         want["k"].to_pylist()]
    else:
        with pytest.raises(NotImplementedError, match="bounded frame op"):
            q.collect()


@pytest.mark.parametrize("column", ["s", "d", "m", "b", "f"])
@pytest.mark.parametrize("frame", ["whole", "rows_bounded", "range_running"])
def test_every_type_ignoring_nulls(column, frame):
    """A string, DATE, DECIMAL64, BOOLEAN and DOUBLE column picked over a
    frame: the reference's rows and Spark's.  Over a string the
    reference fails (its span gather reads offsets its window result has
    not got: an AttributeError, pinned), and the port is held to Spark's
    answer alone.  Over a whole frame its error is a ValueError (a shape
    mismatch in the sum it folds)."""
    t = make_table(5, column=column)
    ref, port = _ref_session(), GpuSession(device="cpu")
    for fn in ("first", "last"):
        got = _query(port.create_dataframe(t, num_partitions=2), PF, pcol,
                     pwexpr, fn, True, FRAMES[frame], column).collect()
        assert "!" not in port.last_explain
        assert got.sort_by("o")["r"].to_pylist() == _oracle(
            t.sort_by("o"), fn, True, FRAMES[frame], column)
        q = _query(ref.create_dataframe(t, num_partitions=2), RF, rcol,
                   rwexpr, fn, True, FRAMES[frame], column)
        if column == "s":
            with pytest.raises(ValueError if frame == "whole"
                               else AttributeError):
                q.collect()
            continue
        want = q.collect()
        assert got.schema == want.schema
        assert_tables_equal(want, got)


@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("fn", ["first", "last"])
@pytest.mark.parametrize("frame", ["whole", "rows_running", "rows_bounded",
                                   "range_running", "range_bounded"])
def test_decimal128_is_picked_whole(frame, fn, ignore):
    """A DECIMAL(30, 4) column's first and last keep both words (Python
    decimals as the oracle); the reference fails there with an
    IndexError (pinned where it reaches the pick)."""
    D = decimal.Decimal
    rng = np.random.default_rng(6)
    n = 120
    vals = [None if rng.random() < 0.3 else
            D(int(rng.integers(-10**9, 10**9)) * 10**15
              + int(rng.integers(0, 10**6))).scaleb(-4) for _ in range(n)]
    t = pa.table({"k": pa.array(rng.integers(0, 5, n), pa.int32()),
                  "o": pa.array(rng.permutation(n) * 3),
                  "w": pa.array(vals, pa.decimal128(30, 4))})
    port = GpuSession(device="cpu")
    got = _query(port.create_dataframe(t), PF, pcol, pwexpr, fn, ignore,
                 FRAMES[frame], "w").collect().sort_by("o")
    assert got["r"].type == pa.decimal128(30, 4)
    assert got["r"].to_pylist() == _oracle(t.sort_by("o"), fn, ignore,
                                           FRAMES[frame], "w")
    if ignore:
        ref = _ref_session()
        with pytest.raises(IndexError):
            _query(ref.create_dataframe(t), RF, rcol, rwexpr, fn, ignore,
                   FRAMES[frame], "w").collect()


def test_decimal128_sum_still_raises_naming_item_3():
    t = pa.table({"k": [1, 1], "o": [1, 2],
                  "w": pa.array([decimal.Decimal("1.0000")] * 2,
                                pa.decimal128(30, 4))})
    port = GpuSession(device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        port.create_dataframe(t).select(PF.sum(pcol("w")).over(
            pwexpr.Window.partition_by(pcol("k")).order_by(pcol("o")))
            .alias("r")).collect()


# ---------------------------------------------------------------------------
# K23's plain version against the reference's formula
# ---------------------------------------------------------------------------

def _ref_pick(valid, lo, hi, last, ignore):
    """exec/window.py:338-355 of the reference, in numpy."""
    cap = len(valid)
    lo_c = np.clip(lo, 0, cap - 1)
    hi_c = np.clip(hi, -1, cap - 1)
    empty = hi_c < lo_c
    cpre = np.concatenate([[0], np.cumsum(valid.astype(np.int32))])
    if not last:
        idx = np.searchsorted(cpre, cpre[lo_c] + 1, side="left") - 1 \
            if ignore else lo_c
    else:
        idx = np.searchsorted(cpre, cpre[hi_c + 1], side="left") - 1 \
            if ignore else hi_c
    idx = np.clip(idx, 0, cap - 1)
    in_frame = (idx >= lo_c) & (idx <= hi_c) & ~empty
    return idx, in_frame & valid[idx]


def _frames(rng, n):
    """Bounds of every frame kind over random partitions of n sorted
    rows: whole, running, bounded ROWS, following, empty, one row,
    outside [0, n)."""
    pos = np.arange(n)
    starts = np.flatnonzero(np.r_[True, rng.random(n - 1) < 0.05])
    seg = starts[np.searchsorted(starts, pos, side="right") - 1]
    seg_end = np.r_[starts[1:] - 1, n - 1][
        np.searchsorted(starts, pos, side="right") - 1]
    return {
        "whole": (seg, seg_end),
        "running": (seg, pos),
        "bounded": (np.clip(pos - 3, seg, seg_end + 1),
                    np.clip(pos + 2, seg - 1, seg_end)),
        "following": (np.clip(pos + 1, seg, seg_end + 1),
                      np.clip(pos + 40, seg - 1, seg_end)),
        "empty": (pos + 1, pos),
        "one_row": (pos, pos),
        "outside": (pos - n - 5, pos + n + 5),
    }


@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.6, 1.0])
def test_frame_pick_plain_matches_reference_formula(density, last, ignore):
    rng = np.random.default_rng(int(density * 10) + 2 * last + ignore)
    n = 5000
    valid = rng.random(n) < density
    for name, (lo, hi) in _frames(rng, n).items():
        want_idx, want_flag = _ref_pick(valid, lo, hi, last, ignore)
        idx, flag = pscan.frame_pick_plain(
            torch.from_numpy(valid), torch.from_numpy(lo.astype(np.int32)),
            torch.from_numpy(hi.astype(np.int32)), last, ignore)
        assert np.array_equal(flag.numpy(), want_flag), name
        assert np.array_equal(idx.numpy()[want_flag], want_idx[want_flag])
    # a bound that is the row itself
    pos = np.arange(n, dtype=np.int32)
    for lo, hi in ((None, pos), (pos, None), (None, None)):
        want = _ref_pick(valid, pos if lo is None else lo,
                         pos if hi is None else hi, last, ignore)
        idx, flag = pscan.frame_pick(
            torch.from_numpy(valid),
            None if lo is None else torch.from_numpy(lo),
            None if hi is None else torch.from_numpy(hi), last, ignore)
        assert np.array_equal(flag.numpy(), want[1])
        assert np.array_equal(idx.numpy()[want[1]], want[0][want[1]])
    assert pscan.frame_pick.launches == 0


def test_frame_pick_rejects_bad_bounds():
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        pscan.frame_pick(valid, torch.zeros(4, dtype=torch.int64), None,
                         False, True)
    with pytest.raises(TypeError):
        pscan.frame_pick(valid.to(torch.int32), None, None, False, True)


# ---------------------------------------------------------------------------
# K23 with the live rows as a count, its launch plans
# ---------------------------------------------------------------------------

def _edge_frames(n):
    """Bounds on 32-row word edges and 8,192-row tile edges (one row
    either side), frames reaching across several tiles, and the row
    itself at one end."""
    pos = np.arange(n)
    word, tile = pos // 32 * 32, pos // 8192 * 8192
    odd = pos % 2
    return {
        "word_edges": (word - 1 + odd, word + 32 - odd),
        "tile_edges": (tile - 1 + odd, tile + 8192 - odd),
        "across_tiles": (pos - 20_000, pos + 20_000),
        "running": (np.maximum(pos - 9000, 0), pos),
        "following": (pos, np.minimum(pos + 9000, n - 1)),
    }


@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("valid_kind", ["tenth", "null_tiles",
                                        "word_edges", "none"])
def test_frame_pick_plain_with_live_count_matches_reference_formula(
        valid_kind, last, ignore):
    """K23's plain version over the column's validity and the live rows'
    count (the live rows are a prefix: the window's padding sorts last)
    equals the reference's formula over the validity ANDed with the live
    mask, on bounds at word and tile edges and across all-null stretches
    longer than a tile; with every row live, too."""
    rng = np.random.default_rng(7 + 2 * last + ignore)
    n = 3 * 8192 + 77
    pos = np.arange(n)
    valid = {"tenth": rng.random(n) < 0.1,
             "null_tiles": pos % 20_000 == 17,
             "word_edges": (pos % 32 == 0) | (pos % 32 == 31),
             "none": np.zeros(n, bool)}[valid_kind]
    for n_live in (None, n - 5000):
        live = pos < (n if n_live is None else n_live)
        for name, (lo, hi) in _edge_frames(n).items():
            want_idx, want_flag = _ref_pick(valid & live, lo, hi, last,
                                            ignore)
            idx, flag = pscan.frame_pick_plain(
                torch.from_numpy(valid), torch.from_numpy(lo.astype(np.int32)),
                torch.from_numpy(hi.astype(np.int32)), last, ignore, n_live)
            assert np.array_equal(flag.numpy(), want_flag), name
            assert np.array_equal(idx.numpy()[want_flag],
                                  want_idx[want_flag]), name


@pytest.mark.parametrize("last,ignore,lo,hi,plan", [
    (True, True, True, False, "fused"),       # the forward fill
    (True, True, False, False, "fused"),
    (False, True, False, True, "fused"),      # first with lo the row
    (False, True, True, True, "bitmap"),      # first over a RANGE frame
    (True, True, True, True, "bitmap"),       # last over the partition
    (True, False, True, True, "bound"),
    (False, False, True, False, "bound")])
def test_frame_pick_plan(last, ignore, lo, hi, plan):
    """The fused plan where the scan picks at the row itself, the bitmap
    plan where a bound may lie ahead of the scan, the bound where nulls
    count; the bitmap plan also serves the frames that fuse, and a plan
    that does not serve a frame is refused before any launch."""
    b = torch.zeros(4, dtype=torch.int32)
    lo_b, hi_b = (b if lo else None), (b if hi else None)
    assert pscan.frame_pick_plan(lo_b, hi_b, last, ignore) == plan
    serve = pscan._frame_pick_plans(lo_b, hi_b, last, ignore)
    assert serve == (("fused", "bitmap") if plan == "fused" else (plan,))
    for other in set(pscan.FRAME_PICK_PLANS) - set(serve):
        with pytest.raises(ValueError, match="does not serve"):
            pscan._frame_pick_launch(torch.ones(4, dtype=torch.bool), lo_b,
                                     hi_b, last, ignore, None, other)


def test_window_hands_k23_the_validity_and_the_live_count():
    """The window's first and last hand K23 the sorted column's validity
    and the live rows' count, which K23 ANDs itself (no combined lane is
    built first); the answers still equal Spark's with padding rows."""
    from spark_rapids_tpu_torch.exec import window as pwin
    table = make_table(seed=11, n=300)
    seen = []
    orig = pwin.frame_pick

    def spy(*args, **kw):
        seen.append(args)
        return orig(*args, **kw)
    pwin.frame_pick = spy
    try:
        got = _query(GpuSession(device="cpu").create_dataframe(table), PF,
                     pcol, pwexpr, "last", True,
                     FRAMES["rows_running"]).collect()
    finally:
        pwin.frame_pick = orig
    (valid, lo, hi, last, ignore, n_live), = seen
    assert n_live == table.num_rows and valid.shape[0] >= n_live
    assert last and ignore and hi is None
    assert pscan.frame_pick_plan(lo, hi, last, ignore) == "fused"
    want = _oracle(table, "last", True, FRAMES["rows_running"])
    order = {(k, o): i for i, (k, o) in enumerate(zip(
        table["k"].to_pylist(), table["o"].to_pylist()))}
    rows = got.to_pylist()
    assert len(rows) == table.num_rows
    for r in rows:
        assert r["r"] == want[order[(r["k"], r["o"])]]
