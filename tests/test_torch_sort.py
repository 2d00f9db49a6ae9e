"""K2's pass planner, its histogram step and its order, on the CPU.

The histogram and the plan are what the card's kernel computes before
its passes; here their plain versions are held against numpy, and the
order (the plain version on CPU tensors) against the reference's
``lexsort`` through the JAX package on the CPU, on the word list of the
aggregate's canonical merge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import segmented as pseg

EXTREME_LONGS = np.array([-2**63, 2**63 - 1, -2**63 + 1, 2**63 - 2, -1, 0,
                          1, 2**62], dtype=np.int64)


def _plan(words):
    n = int(words[0].shape[0])
    counts = pcarry.digit_histogram_plain(words)
    return pcarry.plan_passes(pcarry.varying_digits(counts, n))


# ---------------------------------------------------------------------------
# the pass planner
# ---------------------------------------------------------------------------

def test_plan_q1_key_takes_three_passes():
    # q1's key column (k in [0, 100,000), no nulls): a constant null word
    # and a value word varying in its low 17 bits
    rng = np.random.default_rng(0)
    k = rng.integers(0, 100_000, 5000).astype(np.int64)
    k[:2] = [0, 99_999]
    col = pdev.DeviceColumn(pt.LONG, torch.from_numpy(k),
                            torch.ones(5000, dtype=torch.bool))
    assert _plan(pseg.key_words_for_column(col)) == [(1, 0), (1, 8), (1, 16)]


def test_plan_word_varying_in_all_bits_takes_eight_passes():
    rng = np.random.default_rng(1)
    w = rng.integers(-2**63, 2**63 - 1, 4000, dtype=np.int64,
                     endpoint=True)
    assert _plan([torch.from_numpy(w)]) == [(0, s) for s in range(0, 64, 8)]


@pytest.mark.parametrize("value", [0, -2**63, 2**63 - 1, 12345])
def test_plan_constant_words_take_no_pass(value):
    words = [torch.full((300,), value, dtype=torch.int64),
             torch.ones(300, dtype=torch.int64)]
    assert _plan(words) == []
    order = pcarry.sort_order(words)
    assert order.dtype == torch.int32
    assert order.tolist() == list(range(300))


def test_plan_takes_the_less_significant_word_first():
    rng = np.random.default_rng(2)
    hi = torch.from_numpy(rng.integers(0, 3, 1000).astype(np.int64))
    lo = torch.from_numpy(rng.integers(0, 1 << 12, 1000).astype(np.int64)
                          << 20)
    assert _plan([hi, lo]) == [(1, 16), (1, 24), (0, 0)]
    assert pcarry.plan_passes([[True] + [False] * 7,
                               [False] * 7 + [True]]) == [(1, 56), (0, 0)]


# ---------------------------------------------------------------------------
# the histogram step
# ---------------------------------------------------------------------------

def _numpy_histogram(words):
    out = np.zeros((len(words), 8, 256), dtype=np.int64)
    for j, w in enumerate(words):
        u = w.view(np.uint64) ^ np.uint64(1 << 63)
        for d in range(8):
            digit = ((u >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64)
            out[j, d] = np.bincount(digit, minlength=256)
    return out


@pytest.mark.parametrize("kind", ["extreme", "random", "narrow"])
def test_digit_histogram_matches_numpy(kind):
    rng = np.random.default_rng(3)
    n = 2345
    if kind == "extreme":
        w = rng.choice(EXTREME_LONGS, n)
    elif kind == "random":
        w = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    else:
        w = rng.integers(-5, 5, n).astype(np.int64)
    words = [w, np.ones(n, dtype=np.int64)]
    got = pcarry.digit_histogram_plain([torch.from_numpy(x) for x in words])
    np.testing.assert_array_equal(got.numpy(), _numpy_histogram(words))
    assert int(got.sum()) == 2 * 8 * n


def test_varying_digits_at_the_sign_bit():
    # -2^63 and 2^63 - 1 differ in every bit; -2^63 and -2^63 + 1 only in
    # the lowest digit
    w = torch.tensor([-2**63, 2**63 - 1], dtype=torch.int64)
    assert pcarry.varying_digits(pcarry.digit_histogram_plain([w]), 2) == [
        [True] * 8]
    w = torch.tensor([-2**63, -2**63 + 1, -2**63], dtype=torch.int64)
    assert pcarry.varying_digits(pcarry.digit_histogram_plain([w]), 3) == [
        [True] + [False] * 7]


# ---------------------------------------------------------------------------
# the order, on the canonical merge's word list
# ---------------------------------------------------------------------------

def _merge_columns(rng, n):
    """(name, dtype, data, validity) of a merge input: the key, an int
    sum, a float sum with +-0.0, +-inf and NaN, and a count; ties in
    every column."""
    key = rng.integers(-3, 4, n).astype(np.int64)
    isum = rng.choice(np.array([0, 7, -7, 2**62, -2**63, 2**63 - 1]), n)
    fsum = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf,
                                np.nan, 1e-310]), n)
    cnt = rng.integers(0, 4, n).astype(np.int64)
    return [("k", rt.LONG, key, rng.random(n) < 0.9),
            ("sv", rt.LONG, isum, rng.random(n) < 0.8),
            ("sf", rt.DOUBLE, fsum, rng.random(n) < 0.8),
            ("cf", rt.LONG, cnt, np.ones(n, dtype=bool))]


@pytest.mark.parametrize("seed", [5, 6])
def test_sort_order_matches_reference_lexsort_on_merge_words(seed):
    rng = np.random.default_rng(seed)
    n = 1500
    live = np.ones(n, dtype=bool)
    ref_words, my_words = [], []
    for _, dtype, data, valid in _merge_columns(rng, n):
        data = np.where(valid, data, np.zeros_like(data))
        ref_col = rdev.DeviceColumn(dtype, data=data, validity=valid)
        my_col = pdev.DeviceColumn(pt.from_name(dtype.name),
                                   torch.from_numpy(data.copy()),
                                   torch.from_numpy(valid.copy()))
        ref_words += rseg.key_words_for_column(np, ref_col, live)
        my_words += pseg.key_words_for_column(my_col)
    assert len(my_words) == len(ref_words) == 8
    ref_order = rseg.lexsort(jnp, [jnp.asarray(w) for w in ref_words], n)
    my_order = pcarry.sort_order(my_words)
    assert my_order.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref_order), my_order.numpy())
    # the float word varies in its top digit (signs, inf, NaN) and the
    # null words in their lowest only
    plan = _plan(my_words)
    assert (5, 56) in plan and (4, 0) in plan
    assert [j for j, _ in plan] == sorted((j for j, _ in plan), reverse=True)
