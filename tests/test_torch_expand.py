"""Parity of the port's join expansion, K7 (expand_ends) and K5
(expand_pairs), with the reference's expand_pairs.

The same counts, match ranges and columns, made from a numpy seed, go
through the reference's expand_pairs (numpy and jax.numpy branches on the
CPU) and through the port on CPU tensors, where K7 and K5 run their
plain PyTorch versions.  K7's running sums are the reference's offs,
read back from its output (probe row r's pairs end where its probe
indices do); the shapes are those K5's merge-path tiles must get right
on the card.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.columnar.device import DeviceColumn as RColumn
from spark_rapids_tpu.ops import gather as rgather
from spark_rapids_tpu.ops import join_kernels as rjk
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.columnar.device import DeviceColumn as PColumn
from spark_rapids_tpu_torch.ops import join_kernels as pjk

XPS = {"numpy": np, "jax.numpy": jnp}
HOWS = ["inner", "left", "full"]
K5_TILE = 2048                  # kTile in csrc/join_expand.cu: merge items


def reference_expand(xp, order, lo, counts, live, out_cap, how):
    """The reference's expand_pairs as numpy arrays."""
    args = [order, lo, counts, live]
    if xp is jnp:
        args = [jnp.asarray(a) for a in args]
    return [np.asarray(v) for v in rjk.expand_pairs(xp, *args, out_cap, how)]


def reference_ends(pidx, total, n):
    """The reference's running sums (its offs[1:]), from its output: pairs
    come grouped by probe row, so row r's pairs end where the probe
    indices up to r do."""
    return np.searchsorted(pidx[:total], np.arange(n), side="right")


# K7: (probe rows, match counts drawn from [0, hi), live fraction)
ENDS_CASES = {
    "dead_rows": (700, 4, 0.7),
    "all_misses": (700, 1, 0.9),
    "all_dead": (300, 4, 0.0),
    "not_a_tile_multiple": (4097, 5, 0.95),
    "several_tiles": (3 * 4096 + 5, 3, 0.9),
}


@pytest.mark.parametrize("xp", sorted(XPS))
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", sorted(ENDS_CASES))
def test_expand_ends_matches_reference(case, how, xp):
    n, hi, live_frac = ENDS_CASES[case]
    rng = np.random.default_rng(len(case) + 7 * len(how))
    counts = rng.integers(0, hi, n).astype(np.int64)
    live = rng.random(n) < live_frac
    counts = np.where(live, counts, 0)          # as K4 leaves dead rows
    order = rng.permutation(64).astype(np.int32)
    lo = rng.integers(0, 64 - hi, n).astype(np.int32)
    pidx, _, _, _, _, total = reference_expand(XPS[xp], order, lo, counts,
                                               live, n * hi + 1, how)
    total = int(total)
    for fn in (pjk.expand_ends, pjk.expand_ends_plain):
        ends, got_total = fn(torch.from_numpy(counts),
                             torch.from_numpy(live), how)
        assert ends.dtype == torch.int64 and got_total.shape == (1,)
        assert int(got_total) == total
        np.testing.assert_array_equal(ends.numpy(),
                                      reference_ends(pidx, total, n))
    if case == "all_misses" and how == "inner":
        assert total == 0


@pytest.mark.parametrize("how", HOWS)
def test_expand_ends_on_an_empty_probe_side(how):
    empty = np.zeros(0, np.int64)
    *_, total = reference_expand(np, np.arange(4, dtype=np.int32),
                                 np.zeros(0, np.int32), empty,
                                 np.zeros(0, bool), 0, how)
    for fn in (pjk.expand_ends, pjk.expand_ends_plain):
        ends, got_total = fn(torch.from_numpy(empty),
                             torch.zeros(0, dtype=torch.bool), how)
        assert ends.shape == (0,) and int(got_total) == int(total) == 0


# ---------------------------------------------------------------------------
# K5 on the shapes of its merge-path tiles
# ---------------------------------------------------------------------------

def columns(rng, n, k):
    """k columns of every lane width (LONG, INT, BOOLEAN, DOUBLE), some
    nulls: (reference, port)."""
    ref, port = [], []
    for i in range(k):
        kind = i % 4
        if kind == 0:
            rtype, ptype = rt.LONG, pt.LONG
            data = rng.integers(-2**62, 2**62, n).astype(np.int64)
        elif kind == 1:
            rtype, ptype = rt.INT, pt.INT
            data = rng.integers(-2**31, 2**31, n).astype(np.int32)
        elif kind == 2:
            rtype, ptype = rt.BOOLEAN, pt.BOOLEAN
            data = rng.random(n) < 0.5
        else:
            rtype, ptype = rt.DOUBLE, pt.DOUBLE
            data = rng.random(n)
        valid = rng.random(n) >= 0.1
        data = np.where(valid, data, np.zeros((), data.dtype))
        ref.append(RColumn(rtype, data=data, validity=valid))
        port.append(PColumn(ptype, torch.from_numpy(data.copy()),
                            torch.from_numpy(valid.copy())))
    return ref, port


def zero_run(rng):
    """Rows with no match for longer than a tile, before a hit."""
    counts = rng.integers(0, 3, 3 * K5_TILE)
    counts[100:100 + K5_TILE + 500] = 0
    return counts, 0, 4


def hot_row(rng):
    """One row with more pairs than a tile."""
    counts = rng.integers(0, 3, 1500)
    counts[777] = 2 * K5_TILE + 3
    return counts, 0, 4


def far_capacity(rng):
    """An output capacity far above the total: padding positions."""
    return rng.integers(0, 3, 1200), 20 * 1200, 4


def wide(rng):
    """More than 32 columns (the old design's launch took 32)."""
    return rng.integers(0, 4, 900), 50, 20


TILING_CASES = {"zero_run": zero_run, "hot_row": hot_row,
                "far_capacity": far_capacity, "wide": wide}


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_expand_pairs_tiling_matches_reference(case, how):
    rng = np.random.default_rng(len(case))
    counts, extra, ncols = TILING_CASES[case](rng)
    counts = counts.astype(np.int64)
    n = counts.shape[0]
    nb = int(counts.max()) + 3000
    live = rng.random(n) < 0.95
    counts = np.where(live, counts, 0)
    order = rng.permutation(nb).astype(np.int32)
    lo = rng.integers(0, nb - counts.max(), n).astype(np.int32)
    eff = np.where(live, np.maximum(counts, 1) if how == "left" else counts,
                   0)
    out_cap = int(eff.sum()) + extra
    pidx, bidx, _, pvalid, bvalid, total = reference_expand(
        np, order, lo, counts, live, out_cap, how)
    ref_p, port_p = columns(rng, n, ncols)
    ref_b, port_b = columns(rng, nb, ncols)
    ends, got_total = pjk.expand_ends(torch.from_numpy(counts),
                                      torch.from_numpy(live), how)
    assert int(got_total) == int(total)
    got = pjk.expand_pairs(ends, torch.from_numpy(lo),
                           torch.from_numpy(counts), torch.from_numpy(order),
                           int(total), out_cap, port_p, port_b)
    np.testing.assert_array_equal(got[0].numpy(), pidx)
    np.testing.assert_array_equal(got[1].numpy(), bidx)
    for refs, idx, valid, outs in ((ref_p, pidx, pvalid, got[2]),
                                   (ref_b, bidx, bvalid, got[3])):
        assert len(outs) == ncols
        for ref_col, out in zip(refs, outs):
            want = rgather.gather_column(np, ref_col, idx, valid)
            np.testing.assert_array_equal(out.validity.numpy(),
                                          want.validity)
            np.testing.assert_array_equal(out.data.numpy(), want.data)
    if case == "hot_row":
        assert np.bincount(pidx[:int(total)]).max() > K5_TILE
    if case == "far_capacity":
        assert out_cap > 10 * int(total)
