"""The plain versions of the string kernels K14-K17 and the span concat,
held bit for bit against the reference's ops/strings.py and
expr/hashfns.py:hash_bytes, through both its numpy and its jax branch.

Every case builds one Arrow string array from a seed with numpy and
uploads it twice: through the reference's ``column_to_device`` (numpy
lanes) and the port's (CPU tensors).  The layouts must agree, and so
must every function of them:

* K14 ``string_hashes`` (h1, h2 and the join word h1 ^ (h2 * MIX)),
  against ``_rolling_hash``'s global prefix form;
* K15 ``hash_bytes`` (Spark's hashUnsafeBytes) from per-row seeds;
* K17 ``order_keys`` (4 prefix words and the length, XOR 2^63 here);
* K16 ``gather_strings`` over selections with invalid slots;
* ``concat_char_buffers`` and ``scalar_string_keys``.

The cases cover 0 rows, all-empty, all-null, a long string among short
ones, more than 32 bytes of shared prefix, multi-byte UTF-8 and counts
around K16's tile of 4,096 rows; a hypothesis case draws the rest.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.expr import hashfns as rhash
from spark_rapids_tpu.expr.predicates import scalar_string_keys as r_keys
from spark_rapids_tpu.ops import strings as rops
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.expr import hashfns as phash
from spark_rapids_tpu_torch.ops import strings as pops

SIGN = np.int64(-2**63)
ALPHABET = list("abcxyz") + ["é", "中", "\U0001F600", " "]


def random_strings(seed, n, max_len=12, null_p=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < null_p:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len + 1))
        out.append("".join(ALPHABET[i] for i in
                           rng.integers(0, len(ALPHABET), k)))
    return out


PREFIX = "p" * 40

CASES = {
    "zero_rows": [],
    "all_empty": [""] * 50,
    "all_null": [None] * 37,
    "random": random_strings(1, 300),
    "long_among_short": random_strings(2, 40) + ["L" * 70_000]
    + random_strings(3, 40),
    "shared_prefix": [PREFIX + s for s in ("b", "a", "", "ab", "a")]
    + ["p" * 32, "p" * 31 + "q", None],
    "multibyte": ["é中\U0001F600", "é", "\U0001F600" * 9,
                  "中é", ""],
    "tile_4095": random_strings(4, 4095, 5),
    "tile_4096": random_strings(5, 4096, 5),
    "tile_4097": random_strings(6, 4097, 5),
    "sliced": None,                   # built in ``arrow``
}


def arrow(case):
    if case == "sliced":
        return pa.array(random_strings(7, 120), pa.large_string()
                        ).slice(17, 60)
    return pa.array(CASES[case], pa.string())


def both_columns(arr):
    """(reference column on numpy, port column on CPU tensors, cap)."""
    n = len(arr)
    cap = pdev.bucket_for(n)
    ref = rdev.column_to_device(arr, rt.STRING, cap, xp=np)
    port = pdev.column_to_device(arr, pdev.t.STRING, cap,
                                 torch.device("cpu"))
    return ref, port, cap


def i64(x):
    return np.asarray(x).view(np.int64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_reference(case):
    ref, port, cap = both_columns(arrow(case))
    assert port.capacity == cap
    assert np.array_equal(np.asarray(ref.offsets), port.offsets.numpy())
    assert np.array_equal(np.asarray(ref.validity), port.validity.numpy())
    nbytes = int(port.offsets[-1])
    assert port.data.shape[0] == ref.data.shape[0]
    assert np.array_equal(np.asarray(ref.data)[:nbytes],
                          port.data.numpy()[:nbytes])
    assert not port.data[nbytes:].any()


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_string_hashes_match_reference(case, xp):
    ref, port, _ = both_columns(arrow(case))
    r1, r2 = rops.string_hashes(xp, xp.asarray(ref.offsets),
                                xp.asarray(ref.data))
    p1, p2, pw = pops.string_hashes(port.offsets, port.data,
                                    join_word=True)
    assert np.array_equal(i64(r1), p1.numpy())
    assert np.array_equal(i64(r2), p2.numpy())
    mix = np.uint64(0xBF58476D1CE4E5B9)
    word = np.asarray(r1) ^ (np.asarray(r2) * mix)
    assert np.array_equal(i64(word), pw.numpy())


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_order_keys_match_reference(case, xp):
    ref, port, _ = both_columns(arrow(case))
    want = rops.order_keys(xp, xp.asarray(ref.offsets),
                           xp.asarray(ref.data))
    got = pops.order_keys(port.offsets, port.data)
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        assert np.array_equal(i64(np.asarray(w).astype(np.uint64)) ^ SIGN,
                              g.numpy())


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_bytes_matches_reference(case, xp):
    ref, port, cap = both_columns(arrow(case))
    seeds = np.random.default_rng(3).integers(0, 2**32, cap,
                                              dtype=np.uint64)
    want = rhash.hash_bytes(xp, xp.asarray(ref.offsets),
                            xp.asarray(ref.data),
                            xp.asarray(seeds.astype(np.uint32)))
    got = phash.hash_bytes_plain(port.offsets, port.data,
                                 torch.from_numpy(seeds.astype(np.int64)))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    # the wrapper on CPU tensors is the plain version, nulls keep the seed
    keep = phash.hash_bytes(port.offsets, port.data,
                            torch.from_numpy(seeds.astype(np.int64)),
                            port.validity)
    v = port.validity.numpy()
    assert np.array_equal(keep.numpy()[v], got.numpy()[v])
    assert np.array_equal(keep.numpy()[~v], seeds.astype(np.int64)[~v])


def selection(seed, n_src, n_out):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n_src, 1), n_out).astype(np.int32)
    valid = rng.random(n_out) < 0.8
    if n_src == 0:
        valid[:] = False
    return idx, valid


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_strings_matches_reference(case, xp):
    arr = arrow(case)
    ref, port, cap = both_columns(arr)
    n_out = 4097 if case.startswith("tile") else 200
    idx, valid = selection(11, len(arr), n_out)
    out_char_cap = 1 << 18
    r_offs, r_chars = rops.gather_strings(
        xp, xp.asarray(ref.offsets), xp.asarray(ref.data), xp.asarray(idx),
        xp.asarray(valid), out_char_cap)
    offs, total, starts = pops.gather_offsets(
        port.offsets, torch.from_numpy(idx), torch.from_numpy(valid))
    total, = pops.read_totals([total])
    chars = pops.gather_chars(port.data, starts, offs, total, out_char_cap)
    assert np.array_equal(np.asarray(r_offs), offs.numpy())
    assert np.array_equal(np.asarray(r_chars), chars.numpy())
    # the one-call form sizes the chars at the bucket of the total
    o2, c2 = pops.gather_strings(port.offsets, port.data,
                                 torch.from_numpy(idx),
                                 torch.from_numpy(valid))
    assert np.array_equal(o2.numpy(), offs.numpy())
    assert c2.shape[0] == pdev.bucket_for(max(total, 1),
                                          pdev.DEFAULT_CHAR_BUCKETS)
    assert np.array_equal(c2.numpy()[:total], chars.numpy()[:total])


@pytest.mark.parametrize("total,stretches", [
    (0, 0), (1, 1), (4095, 1), (4096, 1), (4097, 2), (1 << 20, 256),
    ((1 << 20) + 1, 257), (2**31 - 1, 524288)])
def test_k16_stretch_count(total, stretches):
    """K16's copy takes one block a 4,096-byte stretch of selected bytes
    (blocks past them write the zero tail)."""
    assert pops.gather_stretches(total) == stretches


@pytest.mark.parametrize("case", ["random", "all_null", "long_among_short",
                                  "multibyte"])
def test_k16_copy_through_starts_matches_gather(case):
    """K16's copy reads each row's source start from its first launch;
    the plain copy through those starts equals the plain gather from the
    selection, zero tail included, and the starts are the clamped
    source offsets (0 for an invalid slot)."""
    arr = arrow(case)
    _, port, _ = both_columns(arr)
    idx, valid = selection(5, len(arr), 300)
    idx[:3] = [-2, len(arr) + 7, 0]          # clamped into the rows
    t_idx, t_valid = torch.from_numpy(idx), torch.from_numpy(valid)
    offs, total, starts = pops.gather_offsets(port.offsets, t_idx, t_valid)
    src = port.offsets.numpy()
    want = np.where(valid, src[np.clip(idx, 0, max(len(src) - 2, 0))], 0)
    assert np.array_equal(starts.numpy(), want.astype(np.int32))
    cap = int(total) + 4099
    got = pops.copy_spans_plain(port.data, starts, offs, cap)
    assert torch.equal(got, pops.gather_chars_plain(
        port.offsets, port.data, t_idx, offs, cap))
    assert torch.equal(got, pops.gather_chars(port.data, starts, offs,
                                              int(total), cap))
    assert not got[int(total):].any()


def test_gather_total_past_int32_raises():
    with pytest.raises(ValueError, match="2\\^31-1"):
        pops.read_totals([torch.tensor([2**31], dtype=torch.int64)])
    with pytest.raises(ValueError, match="2\\^31-1"):
        pops.gather_chars(torch.zeros(1, dtype=torch.uint8),
                          torch.zeros(1, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32), 2**31, 2**31)


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
def test_concat_char_buffers_matches_reference(xp):
    arrs = [arrow("random"), arrow("shared_prefix"), arrow("all_null"),
            arrow("multibyte")]
    cols = [both_columns(a) for a in arrs]
    # the reference concatenates whole columns: give it each column's
    # live rows and bytes, rebuilt at capacity = rows
    r_offs, r_chars = [], []
    for a, (ref, _, _) in zip(arrs, cols):
        n = len(a)
        nbytes = int(np.asarray(ref.offsets)[n])
        r_offs.append(xp.asarray(np.asarray(ref.offsets)[:n + 1]))
        r_chars.append(xp.asarray(np.asarray(ref.data)[:max(nbytes, 1)]))
    total = sum(int(np.asarray(o)[-1]) for o in r_offs)
    char_cap = pdev.bucket_for(max(total, 1), pdev.DEFAULT_CHAR_BUCKETS)
    want_offs, want_chars = rops.concat_char_buffers(xp, r_offs, r_chars,
                                                     char_cap)
    counts = [len(a) for a in arrs]
    nbytes = [int(p.offsets[n]) for (_, p, _), n in zip(cols, counts)]
    out_cap = pdev.bucket_for(sum(counts))
    offs, chars = pops.concat_char_buffers(
        [p.offsets for _, p, _ in cols], [p.data for _, p, _ in cols],
        counts, nbytes, out_cap, char_cap)
    rows = sum(counts)
    assert np.array_equal(np.asarray(want_offs), offs.numpy()[:rows + 1])
    assert (offs.numpy()[rows:] == total).all()
    assert np.array_equal(np.asarray(want_chars)[:total],
                          chars.numpy()[:total])
    assert not chars[total:].any()


@pytest.mark.parametrize("s", ["", "a", "m", "é中\U0001F600",
                               "x" * 31, "y" * 32, "z" * 33, PREFIX])
def test_scalar_string_keys_match_reference(s):
    b = s.encode("utf-8")
    r_words, r1, r2, r_len = r_keys(b)
    words, h1, h2, ln = pops.scalar_string_keys(b)
    assert [int(np.int64(np.uint64(w).view(np.int64)) ^ SIGN)
            for w in r_words] == words
    assert int(np.uint64(r1).view(np.int64)) == h1
    assert int(np.uint64(r2).view(np.int64)) == h2
    assert int(r_len) == ln
    # and a literal's keys are the column kernels' on a one-row column
    col = pdev.column_to_device(pa.array([s]), pdev.t.STRING, 1,
                                torch.device("cpu"))
    c1, c2 = pops.string_hashes(col.offsets, col.data)
    assert (int(c1[0]), int(c2[0])) == (h1, h2)
    ow = pops.order_keys(col.offsets, col.data)
    assert [int(w[0]) for w in ow] == words + [ln ^ -2**63]


def test_approximate_order_past_32_bytes():
    """The reference's documented corner, reproduced: two strings that
    share their first 32 bytes and their length have equal ordering
    words, so they tie (a stable sort keeps their input order) although
    their bytes differ; a shorter one orders first whatever its bytes."""
    vals = [PREFIX + "b", PREFIX + "a", PREFIX[:33]]
    col = pdev.column_to_device(pa.array(vals), pdev.t.STRING, 3,
                                torch.device("cpu"))
    w = pops.order_keys(col.offsets, col.data)
    assert all(int(x[0]) == int(x[1]) for x in w)
    assert int(w[-1][2]) < int(w[-1][0])
    h1, h2 = pops.string_hashes(col.offsets, col.data)
    assert int(h1[0]) != int(h1[1]) and int(h2[0]) != int(h2[1])


def test_wrappers_take_the_plain_version_on_cpu():
    col = pdev.column_to_device(arrow("random"), pdev.t.STRING, 512,
                                torch.device("cpu"))
    before = (pops.string_hashes.launches, pops.order_keys.launches,
              pops.gather_strings.launches, phash.hash_bytes.launches)
    pops.string_hashes(col.offsets, col.data)
    pops.order_keys(col.offsets, col.data)
    pops.gather_strings(col.offsets, col.data,
                        torch.zeros(3, dtype=torch.int32),
                        torch.ones(3, dtype=torch.bool))
    phash.hash_bytes(col.offsets, col.data,
                     torch.full((512,), 42, dtype=torch.int64))
    assert (pops.string_hashes.launches, pops.order_keys.launches,
            pops.gather_strings.launches,
            phash.hash_bytes.launches) == before


def test_row_lane_kernels_refuse_chars():
    """A span column's chars never reach a flat-lane kernel."""
    from spark_rapids_tpu_torch.columnar import fetch
    from spark_rapids_tpu_torch.ops import carry, gather
    chars = torch.zeros(4, dtype=torch.uint8)
    order = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="chars"):
        gather.gather_rows(order, [chars])
    with pytest.raises(TypeError, match="chars"):
        gather.scatter_rows(order, [chars])
    with pytest.raises(TypeError, match="chars"):
        carry.compact_lanes(torch.ones(4, dtype=torch.bool), [chars],
                            [False])
    with pytest.raises(TypeError, match="chars"):
        fetch.pack_lanes([chars], [("none",)], [0], 4)


_text = st.one_of(st.none(), st.text(max_size=12),
                  st.text(alphabet="pqé", min_size=30, max_size=45),
                  st.just(""))


@settings(max_examples=40, deadline=None)
@given(st.lists(_text, max_size=40), st.integers(0, 2**32 - 1))
def test_kernels_match_reference_hypothesis(vals, seed):
    arr = pa.array(vals, pa.string())
    ref, port, cap = both_columns(arr)
    r1, r2 = rops.string_hashes(np, np.asarray(ref.offsets),
                                np.asarray(ref.data))
    p1, p2 = pops.string_hashes(port.offsets, port.data)
    assert np.array_equal(i64(r1), p1.numpy())
    assert np.array_equal(i64(r2), p2.numpy())
    for w, g in zip(rops.order_keys(np, np.asarray(ref.offsets),
                                    np.asarray(ref.data)),
                    pops.order_keys(port.offsets, port.data)):
        assert np.array_equal(i64(w) ^ SIGN, g.numpy())
    seeds = np.full(cap, seed, np.uint64)
    want = rhash.hash_bytes(np, np.asarray(ref.offsets),
                            np.asarray(ref.data), seeds.astype(np.uint32))
    got = phash.hash_bytes_plain(port.offsets, port.data,
                                 torch.from_numpy(seeds.astype(np.int64)))
    assert np.array_equal(want.astype(np.int64), got.numpy())
    idx, valid = selection(seed % 1000, len(vals), 25)
    r_offs, r_chars = rops.gather_strings(
        np, np.asarray(ref.offsets), np.asarray(ref.data), idx, valid, 4096)
    offs, total, starts = pops.gather_offsets(
        port.offsets, torch.from_numpy(idx), torch.from_numpy(valid))
    chars = pops.gather_chars(port.data, starts, offs, int(total), 4096)
    assert np.array_equal(r_offs, offs.numpy())
    assert np.array_equal(r_chars, chars.numpy())
