"""K8 (``ops/gather.py:gather_rows``) on the CPU: its plan, its record
layout and chunks, and its results against the reference.

The plan (``gather_plan``) chooses between the single pass and the
record path (the source rows packed into records of whole sectors, one
random record read a row) from sizes alone; the chunks and records are
what the record path launches with.  On the
CPU ``gather_rows`` runs its plain version whatever path is asked for,
and launches nothing.  Its results through K2's order are held against
the reference's ``ops/carry.py:sort_rows`` payload (``extras``), and
through orders with repeats into longer lanes against the reference's
``ops/gather.py:gather_column``, on the same numpy inputs, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.columnar.device import DeviceColumn as RCol
from spark_rapids_tpu.ops import carry as rcarry
from spark_rapids_tpu.ops import gather as rgather
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.ops import gather as pgather

Q3 = [8, 1] * 3                  # q3's six lanes: k, v, f and validity
Q4 = [8, 1, 8, 1]                # q4's four: k and v with their validity


SINGLE_MAX = (96 << 20) // 27    # q3's lanes reach 96 MiB here


@pytest.mark.parametrize("n,m,widths,packed,scratch", [
    (0, 0, Q3, False, 0),
    (0, 1 << 25, Q3, False, 0),
    (1, 1, Q3, False, 0),
    (256, 256, Q3, False, 0),
    (257, 257, Q3, False, 0),
    (1 << 20, 1 << 20, Q3, False, 0),
    # up to 96 MiB of source lanes the single pass's reads mostly hit L2
    (SINGLE_MAX, SINGLE_MAX, Q3, False, 0),
    (SINGLE_MAX + 1, SINGLE_MAX + 1, Q3, True, (SINGLE_MAX + 1) * 32),
    (1 << 25, 1 << 25, Q3, True, (1 << 25) * 32),
    ((1 << 25) + 1, (1 << 25) + 1, Q3, True, ((1 << 25) + 1) * 32),
    # lanes longer than the order: packing the whole source costs more
    (1 << 20, 1 << 25, Q3, False, 0),
    (1 << 24, 1 << 25, Q3, True, (1 << 25) * 32),
    # more rows than the source (repeats): a source in L2 stays single
    (1 << 25, 1 << 20, Q3, False, 0),
    (1 << 25, 1 << 22, Q3, True, (1 << 22) * 32),
    (1 << 25, 1 << 21, Q3, False, 0),
    (1 << 25, 1 << 25, Q4, True, (1 << 25) * 32),
    # one lane: a record is no narrower than the lane's own sector
    (1 << 25, 1 << 25, [8], False, 0),
    (1 << 25, 1 << 25, [4], False, 0),
    (1 << 25, 1 << 25, [8, 1], True, (1 << 25) * 16),
    # 17 lanes of 8 bytes: records of 8, 8 and 1 lanes, 64 bytes widest
    (1 << 20, 1 << 20, [8] * 17, True, (1 << 20) * 64),
    (1 << 19, 1 << 19, [8] * 17, False, 0),
    (1, 1, [8] * 17, False, 0),
])
def test_gather_plan(n, m, widths, packed, scratch):
    """The record path where it moves fewer device-memory bytes than the
    single pass (a random read counted as its 32-byte sector) and the
    source lanes outgrow 96 MiB; its scratch is the widest record for
    each source row."""
    plan = pgather.gather_plan(n, m, widths)
    assert (plan.packed, plan.scratch_bytes) == (packed, scratch)
    assert plan.single_bytes == n * (36 * len(widths) + sum(widths))
    chunks = pgather.gather_chunks(widths, True)
    assert plan.packed_bytes == sum(
        m * (s + r) + n * (4 + r + s) for s, r in (
            (sum(widths[i] for i in c),
             pgather.record_layout([widths[i] for i in c])[0])
            for c in chunks))


def test_gather_plan_at_q3():
    """q3's 2^25 rows: 243 B a row on the single pass, 122 through the
    records, and 32 B a row of scratch."""
    n = 1 << 25
    assert pgather.gather_plan(n, n, Q3) == (True, 243 * n, 122 * n, 32 * n)


@pytest.mark.parametrize("widths,size,offsets", [
    ([8, 1, 8, 1, 8, 1], 32, [0, 24, 8, 25, 16, 26]),
    ([4, 8, 1], 16, [8, 0, 12]),
    ([4], 16, [0]),
    ([8], 16, [0]),
    ([1] * 16, 16, list(range(16))),
    ([8] * 8, 64, [0, 8, 16, 24, 32, 40, 48, 56]),
    ([8] * 9, 0, [0, 8, 16, 24, 32, 40, 48, 56, 64]),
    ([1, 4, 4, 8], 32, [16, 8, 12, 0]),
])
def test_record_layout(widths, size, offsets):
    """Each lane sits aligned to its width, the widest first, holes
    filled; 16, 32 or 64 bytes, 0 when the lanes need more."""
    assert pgather.record_layout(widths) == (size, offsets)


@pytest.mark.parametrize("widths,packed,sizes", [
    ([8] * 40, False, [16, 16, 8]),
    ([8] * 17, True, [8, 8, 1]),
    ([1] * 17, True, [16, 1]),
    (Q3, True, [6]),
    (Q3 * 3, True, [14, 4]),
])
def test_gather_chunks(widths, packed, sizes):
    chunks = pgather.gather_chunks(widths, packed)
    assert [len(c) for c in chunks] == sizes
    assert [j for c in chunks for j in c] == list(range(len(widths)))
    if packed:
        assert all(pgather.record_layout([widths[j] for j in c])[0]
                   for c in chunks)


def lanes_of(rng, m, widths):
    out = []
    for w in widths:
        if w == 8:
            out.append(rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64))
        elif w == 4:
            out.append(rng.integers(-2**31, 2**31 - 1, m, dtype=np.int32))
        else:
            out.append(rng.random(m) < 0.5)
    return out


@pytest.mark.parametrize("packed", [None, False, True])
def test_gather_rows_path_choice_is_the_plain_version_on_cpu(packed):
    rng = np.random.default_rng(5)
    n, m = 1000, 3000
    order = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    lanes = [torch.from_numpy(x) for x in lanes_of(rng, m, Q3 + [4])]
    before = pgather.gather_rows.launches
    got = pgather.gather_rows(order, lanes, packed=packed)
    assert pgather.gather_rows.launches == before
    assert all(torch.equal(g, w) for g, w in zip(
        got, pgather.gather_rows_plain(order, lanes)))


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_k8_through_k2_order_matches_reference_sort_rows(n, xp_name):
    """K2's order over key words with ties, then K8, against the
    reference's sort_rows carrying the same lanes as extras."""
    xp = np if xp_name == "numpy" else jnp
    rng = np.random.default_rng(n)
    ref_words = [rng.integers(0, 7, n).astype(np.uint64),
                 rng.integers(0, 2**64 - 1, n, dtype=np.uint64)]
    lanes = lanes_of(rng, n, Q3 + [4])
    _, _, want = rcarry.sort_rows(
        xp, [xp.asarray(w) for w in ref_words], [], n,
        [xp.asarray(x) for x in lanes])
    port_words = [torch.from_numpy((w ^ np.uint64(2**63)).view(np.int64))
                  for w in ref_words]
    order = pcarry.sort_order(port_words)
    got = pgather.gather_rows(order, [torch.from_numpy(x) for x in lanes])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("xp_name", ["numpy", "jnp"])
@pytest.mark.parametrize("n,m", [(1, 5), (300, 1000), (4096, 4096 * 3),
                                 (5000, 17)])
def test_k8_order_with_repeats_matches_reference_gather(n, m, xp_name):
    """An order that repeats rows and reads lanes longer (or shorter)
    than itself, against the reference's gather_column of each lane."""
    xp = np if xp_name == "numpy" else jnp
    rng = np.random.default_rng(n + m)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[: n // 3] = idx[0]                 # a run of one source row
    widths = Q3 + [4]
    lanes = lanes_of(rng, m, widths)
    got = pgather.gather_rows(torch.from_numpy(idx),
                              [torch.from_numpy(x) for x in lanes])
    ones = xp.ones((n,), dtype=bool)
    for g, x in zip(got, lanes):
        dtype = rt.BOOLEAN if x.dtype == bool else (
            rt.LONG if x.dtype == np.int64 else rt.INT)
        want = rgather.gather_column(
            xp, RCol(dtype, data=xp.asarray(x),
                     validity=xp.ones((m,), dtype=bool)),
            xp.asarray(idx), ones)
        assert np.array_equal(g.numpy(), np.asarray(want.data))
