"""Parity of the PyTorch port's equi-join with the JAX reference.

Kernel functions (ops/join_kernels.py) take the same inputs, made from a
numpy seed, through the reference under both numpy and jax.numpy on the
CPU and through the port on CPU tensors, where K2, K4 and K5 run their
plain PyTorch versions; hashes, ranges and pairs must match exactly.
Joins go through the reference's TpuSession and the port's
GpuSession(device="cpu") and are compared with the reference's
assert_tables_equal, floats to a relative 1e-9 (the group-by after q2's
join adds in another order than the reference's prefix-scan sums).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.device import DeviceColumn as RColumn
from spark_rapids_tpu.exec import join as rjoin
from spark_rapids_tpu.exec.base import ExecContext as RExecContext
from spark_rapids_tpu.exec.basic import LocalScanExec as RLocalScanExec
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.ops import gather as rgather
from spark_rapids_tpu.ops import join_kernels as rjk
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.device import DeviceColumn as PColumn
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.basic import LocalScanExec
from spark_rapids_tpu_torch.exec.join import HashJoinExec
from spark_rapids_tpu_torch.expr.core import AttributeReference
from spark_rapids_tpu_torch.ops import join_kernels as pjk

FLOAT_RTOL = 1e-9
XPS = {"numpy": np, "jax.numpy": jnp}
SPECIAL_DOUBLES = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.5, -1.5,
                   1e-310, np.finfo(np.float64).max]
EXTREME_LONGS = [-2**63, 2**63 - 1, -1, 0, 1, 2**62]

# ---------------------------------------------------------------------------
# key hashing
# ---------------------------------------------------------------------------

# (reference type, port type, numpy dtype, values to draw from).  The port
# carries no BYTE, SHORT or FLOAT column yet; its hash reads the lane's
# values, so those lanes go in under INT and DOUBLE.
KEY_KINDS = {
    "int8": (rt.BYTE, pt.INT, np.int8, [-128, 127, 0, -1, 5]),
    "int16": (rt.SHORT, pt.INT, np.int16, [-2**15, 2**15 - 1, 0, 7, -7]),
    "int32": (rt.INT, pt.INT, np.int32, [-2**31, 2**31 - 1, 0, 3, -3]),
    "int64": (rt.LONG, pt.LONG, np.int64, EXTREME_LONGS),
    "bool": (rt.BOOLEAN, pt.BOOLEAN, np.bool_, [True, False]),
    "float32": (rt.FLOAT, pt.DOUBLE, np.float32, SPECIAL_DOUBLES[:9]),
    "float64": (rt.DOUBLE, pt.DOUBLE, np.float64, SPECIAL_DOUBLES),
}


def key_columns(rng, kinds, cap, null_frac, subnormals=True):
    """The same key columns for both packages: (reference, port)."""
    ref, port = [], []
    for kind in kinds:
        rtype, ptype, npdt, values = KEY_KINDS[kind]
        if not subnormals:
            values = [x for x in values if not 0 < abs(x) < 1e-300]
        data = np.array(rng.choice(np.array(values, dtype=object), cap)
                        .tolist(), dtype=npdt)
        valid = rng.random(cap) >= null_frac
        data = np.where(valid, data, np.zeros((), npdt))
        ref.append(RColumn(rtype, data=data, validity=valid))
        port.append(PColumn(ptype, torch.from_numpy(data.copy()),
                            torch.from_numpy(valid.copy())))
    return ref, port


def as_int64(x):
    return np.asarray(x).view(np.int64)


HASH_CASES = {
    **{kind: ([kind], 0.0) for kind in KEY_KINDS},
    **{f"{kind}_nulls": ([kind], 0.2) for kind in ("int64", "float64",
                                                   "bool")},
    "two_keys": (["int64", "float64"], 0.1),
    "three_keys": (["int32", "bool", "float32"], 0.1),
}


@pytest.mark.parametrize("xp", sorted(XPS))
@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_combined_key_hash_matches_reference(case, xp):
    kinds, null_frac = HASH_CASES[case]
    rng = np.random.default_rng(len(case))
    cap = 600
    # XLA on the CPU flushes subnormal doubles to zero, so the reference's
    # jax.numpy branch hashes them as 0.0; its numpy branch, which states
    # the semantics, keeps them, and so does the port
    ref_cols, port_cols = key_columns(rng, kinds, cap, null_frac,
                                      subnormals=xp == "numpy")
    if xp == "jax.numpy":
        ref_cols = [RColumn(c.dtype, data=jnp.asarray(c.data),
                            validity=jnp.asarray(c.validity))
                    for c in ref_cols]
    for side in ("build", "probe"):
        for null_matches in (False, True):
            want = rjk.combined_key_hash(XPS[xp], ref_cols, cap,
                                         null_matches=null_matches,
                                         side=side)
            for fn in (pjk.combined_key_hash, pjk.combined_key_hash_plain):
                got = fn(port_cols, cap, null_matches=null_matches,
                         side=side)
                np.testing.assert_array_equal(as_int64(want), got.numpy())


def test_equal_keys_hash_alike_across_widths_and_zero_signs():
    """INT and LONG lanes of equal values hash alike (the reference
    widens both to one int64 word); -0.0 and 0.0, and every NaN, too."""
    ints = torch.tensor([-2**31, -1, 0, 7], dtype=torch.int32)
    yes = torch.ones(4, dtype=torch.bool)
    a = pjk.combined_key_hash([PColumn(pt.INT, ints, yes)], 4)
    b = pjk.combined_key_hash([PColumn(pt.LONG, ints.long(), yes)], 4)
    assert torch.equal(a, b)
    d = torch.tensor([0.0, float("nan")], dtype=torch.float64)
    e = torch.tensor([-0.0, -float("nan")], dtype=torch.float64)
    yes = torch.ones(2, dtype=torch.bool)
    assert torch.equal(pjk.combined_key_hash([PColumn(pt.DOUBLE, d, yes)], 2),
                       pjk.combined_key_hash([PColumn(pt.DOUBLE, e, yes)], 2))


# ---------------------------------------------------------------------------
# count_matches (K6 + K2 + K4), expand_pairs (K5), build_matched_flags
# ---------------------------------------------------------------------------

def join_inputs(seed, cap_b=300, cap_p=500, n_b=260, n_p=450,
                kinds=("int64",), null_matches=False):
    """Build and probe keys over duplicated, null and dead rows: (the
    reference's hashes and live flags, as it makes them; the port's key
    columns and live row counts)."""
    rng = np.random.default_rng(seed)
    ref_b, port_b = key_columns(rng, kinds, cap_b, 0.05)
    ref_p, port_p = key_columns(rng, kinds, cap_p, 0.05)
    if list(kinds) == ["int64"]:
        # many-to-many: build keys repeat, a third of the probe keys miss
        bkeys = rng.integers(0, 120, cap_b)
        pkeys = rng.integers(0, 180, cap_p)
        for ref, port, keys in ((ref_b, port_b, bkeys),
                                (ref_p, port_p, pkeys)):
            ref[0].data = keys.astype(np.int64)
            port[0].data = torch.from_numpy(keys.astype(np.int64))
    bh = rjk.combined_key_hash(np, ref_b, cap_b, null_matches=null_matches,
                               side="build")
    ph = rjk.combined_key_hash(np, ref_p, cap_p, null_matches=null_matches,
                               side="probe")
    blive = np.arange(cap_b) < n_b
    plive = np.arange(cap_p) < n_p
    return (bh, blive, ph, plive), (port_b, n_b, port_p, n_p)


def ref_arrays(xp, arrays):
    return [jnp.asarray(a) for a in arrays] if xp is jnp else list(arrays)


@pytest.mark.parametrize("xp", sorted(XPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_count_matches_matches_reference(seed, xp):
    """K6, K2 and K4 (their plain versions here) from the key columns
    equal the reference's count_matches on the reference's hashes."""
    ref_in, mine = join_inputs(seed)
    want = [np.asarray(x) for x in rjk.count_matches(
        XPS[xp], *ref_arrays(XPS[xp], ref_in))]
    for fn in (pjk.count_matches, pjk.count_matches_plain):
        got = [x.numpy() for x in fn(*mine)]
        for w, g, name in zip(want, got, ("order", "lo", "counts")):
            np.testing.assert_array_equal(w, g, err_msg=name)
        assert got[0].dtype == np.int32 and got[1].dtype == np.int32
        assert got[2].dtype == np.int64
    assert want[2].sum() > want[2].astype(bool).sum()   # many-to-many


PROBE_CASES = {
    "long": (("int64",), False),
    "three_keys": (("int32", "float64", "bool"), False),
    "three_keys_null_matches": (("int32", "float64", "bool"), True),
    "two_keys_null_matches": (("int64", "float64"), True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_join_probe_from_keys_matches_reference(case, seed):
    """K4's plain version (the probe keys hashed, then the two searches)
    gives the reference's lo and counts on the reference's hashes, also
    on keys of several columns with -0.0, NaN and nulls that match."""
    kinds, null_matches = PROBE_CASES[case]
    ref_in, (bcols, n_b, pcols, n_p) = join_inputs(
        seed, kinds=kinds, null_matches=null_matches)
    _, want_lo, want_counts = rjk.count_matches(np, *ref_in)
    bh = pjk.combined_key_hash_plain(bcols, 300, null_matches, "build")
    build = pjk.sort_build_plain(bh, torch.arange(300) < n_b)
    for lo, counts in (
            pjk.join_probe_keys_plain(build.sorted_hash, pcols, n_p,
                                      null_matches),
            pjk.join_probe(build, pcols, n_p, null_matches)):
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert want_counts.sum() > 0


def test_count_matches_on_an_empty_build_side():
    ref_in, (bcols, _, pcols, n_p) = join_inputs(2)
    bh, blive, ph, plive = ref_in
    _, want_lo, want_counts = rjk.count_matches(np, bh, np.zeros_like(blive),
                                                ph, plive)
    for fn in (pjk.count_matches, pjk.count_matches_plain):
        order, lo, counts = fn(bcols, 0, pcols, n_p)
        assert not counts.any() and torch.equal(lo, torch.zeros_like(lo))
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(counts.numpy(), want_counts)


def ref_column(rng, cap, null_frac=0.1):
    data = rng.integers(-10**6, 10**6, cap).astype(np.int64)
    valid = rng.random(cap) >= null_frac
    data = np.where(valid, data, 0)
    return (RColumn(rt.LONG, data=data, validity=valid),
            PColumn(pt.LONG, torch.from_numpy(data.copy()),
                    torch.from_numpy(valid.copy())))


@pytest.mark.parametrize("xp", sorted(XPS))
@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_expand_pairs_matches_reference(how, xp):
    ref_in, _ = join_inputs(3)
    order, lo, counts = rjk.count_matches(np, *ref_in)
    plive = ref_in[3]
    eff = np.where(plive, np.maximum(counts, 1) if how != "inner" else counts,
                   0)
    total = int(eff.sum())
    out_cap = total + 300                # capacity above the total
    x = XPS[xp]
    (pidx, bidx, pair_valid, pvalid, bvalid, rtotal) = [
        np.asarray(v) for v in rjk.expand_pairs(
            x, *ref_arrays(x, [order, lo, counts, plive]), out_cap, how)]
    assert int(rtotal) == total
    rng = np.random.default_rng(4)
    ref_p, port_p = ref_column(rng, plive.shape[0])
    ref_b, port_b = ref_column(rng, order.shape[0])
    ends = torch.cumsum(pjk.effective_counts(
        torch.from_numpy(counts), torch.from_numpy(plive), how), 0)
    assert int(ends[-1]) == total
    got = pjk.expand_pairs(ends, torch.from_numpy(lo),
                           torch.from_numpy(counts), torch.from_numpy(order),
                           total, out_cap, [port_p], [port_b])
    # past the total, the jax.numpy branch's running-max fill leaves other
    # indices than the numpy branch's clamped search; both are padding
    n = out_cap if xp == "numpy" else total
    np.testing.assert_array_equal(got[0].numpy()[:n], pidx[:n])
    np.testing.assert_array_equal(got[1].numpy()[:n], bidx[:n])
    for ref_col, idx, valid, (out,) in ((ref_p, pidx, pvalid, got[2]),
                                        (ref_b, bidx, bvalid, got[3])):
        want = rgather.gather_column(np, ref_col, idx, valid)
        np.testing.assert_array_equal(out.validity.numpy(), want.validity)
        np.testing.assert_array_equal(out.data.numpy(), want.data)
    # all-valid sources: the output validity is the pair's own
    yes = PColumn(pt.LONG, torch.zeros(plive.shape[0], dtype=torch.int64),
                  torch.ones(plive.shape[0], dtype=torch.bool))
    byes = PColumn(pt.LONG, torch.zeros(order.shape[0], dtype=torch.int64),
                   torch.ones(order.shape[0], dtype=torch.bool))
    _, _, (p_out,), (b_out,) = pjk.expand_pairs(
        ends, torch.from_numpy(lo), torch.from_numpy(counts),
        torch.from_numpy(order), total, out_cap, [yes], [byes])
    np.testing.assert_array_equal(p_out.validity.numpy(), pair_valid)
    np.testing.assert_array_equal(b_out.validity.numpy(), bvalid)


@pytest.mark.parametrize("xp", sorted(XPS))
def test_build_matched_flags_matches_reference(xp):
    ref_in, _ = join_inputs(5)
    order, lo, counts = rjk.count_matches(np, *ref_in)
    x = XPS[xp]
    want = np.asarray(rjk.build_matched_flags(
        x, *ref_arrays(x, [order, lo, counts, ref_in[3]]), order.shape[0]))
    got = pjk.build_matched_flags(
        torch.from_numpy(order), torch.from_numpy(lo),
        torch.from_numpy(counts), torch.from_numpy(ref_in[3]),
        order.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < ref_in[1].sum()


# ---------------------------------------------------------------------------
# joins through both sessions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sessions():
    return ((TpuSession.builder().get_or_create(), RF, rcol),
            (GpuSession(device="cpu"), PF, pcol))


def fact_table(rng, n, keys=300, null_frac=0.05):
    return pa.table({
        "k": pa.array(rng.integers(0, keys, n), mask=rng.random(n) < null_frac),
        "j": pa.array(rng.integers(0, 3, n).astype(np.int32)),
        "v": pa.array(rng.integers(-10, 10, n)),
        "f": pa.array(rng.choice(SPECIAL_DOUBLES, n)),
    })


def dim_table(rng, n, keys=200, null_frac=0.05):
    return pa.table({
        "k": pa.array(rng.integers(0, keys, n), mask=rng.random(n) < null_frac),
        "j": pa.array(rng.integers(0, 3, n).astype(np.int32)),
        "w": pa.array(rng.random(n)),
    })


def renamed(table, suffix="2"):
    return table.rename_columns([f"{n}{suffix}" for n in table.column_names])


def using(cols, how):
    return lambda s, F, col, fact, dim: s.create_dataframe(fact).join(
        s.create_dataframe(dim), on=cols, how=how)


def on(cond_fn, how):
    return lambda s, F, col, fact, dim: s.create_dataframe(fact).join(
        s.create_dataframe(renamed(dim)), on=cond_fn(col), how=how)


def q2(s, F, col, fact, dim):
    return (s.create_dataframe(fact).join(s.create_dataframe(dim), on="k",
                                          how="inner")
            .group_by(col("k")).agg(F.sum(col("w")).alias("sw")))


JOIN_HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti",
             "cross"]
SESSION_CASES = {
    **{f"using_{how}": (using("k", how), {}) for how in JOIN_HOWS},
    **{f"condition_{how}": (on(lambda c: c("k") == c("k2"), how), {})
       for how in JOIN_HOWS},
    "how_alias_outer": (using("k", "outer"), {}),
    "how_alias_leftsemi": (using("k", "leftsemi"), {}),
    "multi_key_using_inner": (using(["k", "j"], "inner"), {}),
    "multi_key_using_full": (using(["k", "j"], "full"), {}),
    "multi_key_condition_left": (
        on(lambda c: (c("k") == c("k2")) & (c("j2") == c("j")), "left"), {}),
    "conditional_inner": (
        on(lambda c: (c("k") == c("k2")) & (c("v") > c("j2")), "inner"), {}),
    "conditional_left": (
        on(lambda c: (c("k") == c("k2")) & (c("v") > 0), "left"), {}),
    "conditional_right": (
        on(lambda c: (c("k") == c("k2")) & (c("w2") > 0.5), "right"), {}),
    "double_key": (on(lambda c: c("f") == c("w2"), "inner"),
                   dict(dim_f=True)),
    "bool_key": (on(lambda c: (c("k") > 150) == (c("w2") > 0.5), "left"),
                 dict(n_fact=200, n_dim=30)),
    "inner_flips_build_side": (
        lambda s, F, col, fact, dim: s.create_dataframe(dim).join(
            s.create_dataframe(renamed(fact)), on=col("k") == col("k2")),
        {}),
    "empty_probe_inner": (using("k", "inner"), dict(n_fact=0)),
    "empty_probe_full": (using("k", "full"), dict(n_fact=0)),
    "empty_build_left": (using("k", "left"), dict(n_dim=0)),
    "empty_build_right": (using("k", "right"), dict(n_dim=0)),
    "empty_build_left_anti": (using("k", "left_anti"), dict(n_dim=0)),
    "non_equi_inner": (on(lambda c: c("k") < c("k2"), "inner"),
                       dict(n_fact=300, n_dim=60)),
    "cross_without_condition": (
        lambda s, F, col, fact, dim: s.create_dataframe(fact).join(
            s.create_dataframe(renamed(dim)), how="cross"),
        dict(n_fact=120, n_dim=40)),
    "q2": (q2, dict(n_fact=3000, n_dim=200, dim_unique=True)),
}


def case_tables(seed, n_fact=1500, n_dim=250, dim_f=False, dim_unique=False):
    rng = np.random.default_rng(seed)
    fact = fact_table(rng, n_fact)
    if dim_unique:
        # q2's dimension: every key once, keys 0..n-1 (bench.py make_tables)
        dim = pa.table({"k": pa.array(np.arange(n_dim, dtype=np.int64)),
                        "w": pa.array(rng.random(n_dim))})
    else:
        dim = dim_table(rng, n_dim)
    if dim_f:
        # XLA on the CPU flushes subnormal doubles to zero, so the
        # reference session would match 1e-310 with 0.0; the port, like
        # the reference's numpy branch and Spark, does not.  The hash
        # tests hold the port to the numpy branch on subnormals.
        normal = [x for x in SPECIAL_DOUBLES if not 0 < abs(x) < 1e-300]
        dim = dim.set_column(2, "w", pa.array(rng.choice(normal, n_dim)))
        fact = fact.set_column(3, "f", pa.array(rng.choice(normal, n_fact)))
    return fact, dim


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_join_matches_reference(sessions, case):
    build_df, spec = SESSION_CASES[case]
    fact, dim = case_tables(len(case), **spec)
    (want, got) = [build_df(s, F, col, fact, dim).collect()
                   for s, F, col in sessions]
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    if case.startswith(("using_inner", "condition_left", "condition_full",
                        "conditional_left", "inner_flips")):
        # the port emits the reference's rows in the reference's order
        assert_tables_equal(want, got, ignore_order=False,
                            approximate_float=FLOAT_RTOL)


def test_q2_plan_and_exec_level_join(sessions):
    """q2 plans aggregate <- project (USING) <- hash join <- two scans,
    and HashJoinExec alone gives pyarrow's inner join."""
    port_session, F, col = sessions[1]
    fact, dim = case_tables(7, n_fact=2000, n_dim=150, dim_unique=True)
    q2(port_session, F, col, fact, dim).collect()
    names = []
    port_session.last_plan.foreach(lambda e: names.append(type(e).__name__))
    assert names == ["GpuHashAggregateExec", "ProjectExec", "HashJoinExec",
                     "LocalScanExec", "LocalScanExec"]
    join = HashJoinExec([AttributeReference("k")], [AttributeReference("k")],
                        "inner", None, LocalScanExec(fact),
                        LocalScanExec(dim))
    got = join.execute_collect(ExecContext("cpu"))
    want = fact.join(dim, "k", join_type="inner")
    assert got.num_rows == want.num_rows
    assert got.column_names == ["k", "j", "v", "f", "k", "w"]
    assert got["v"].to_numpy().sum() == want["v"].to_numpy().sum()
    np.testing.assert_allclose(got["w"].to_numpy().sum(),
                               want["w"].to_numpy().sum(), rtol=FLOAT_RTOL)


@pytest.mark.parametrize("how", ["inner", "left", "full", "left_semi",
                                 "left_anti"])
def test_build_side_prepared_once_over_probe_batches(how, monkeypatch):
    """The build side is hashed, sorted and tabled once for all probe
    batches, and the join gives the reference's rows in its order."""
    fact, dim = case_tables(12, n_fact=1500, n_dim=250)
    calls = []
    sort_build = pjk.sort_build

    def counted(*args):
        calls.append(1)
        return sort_build(*args)
    monkeypatch.setattr(pjk, "sort_build", counted)
    join = HashJoinExec([AttributeReference("k")], [AttributeReference("k")],
                        how, None, LocalScanExec(fact, batch_rows=400),
                        LocalScanExec(dim))
    got = join.execute_collect(ExecContext("cpu"))
    ref = rjoin.HashJoinExec([rcore.AttributeReference("k")],
                             [rcore.AttributeReference("k")], how, None,
                             RLocalScanExec(fact, batch_rows=400),
                             RLocalScanExec(dim))
    want = ref.execute_collect(RExecContext())
    assert len(calls) == 1
    assert got.num_rows > 0
    assert_tables_equal(want, got, ignore_order=False)


UNSUPPORTED = {
    "conditional_full": (
        lambda s, col: s.create_dataframe(fact_table(
            np.random.default_rng(8), 50)).join(
            s.create_dataframe(renamed(dim_table(np.random.default_rng(9),
                                                 20))),
            on=(col("k") == col("k2")) & (col("v") > 0), how="full"),
        "conditional full join"),
    "string_key": (
        lambda s, col: s.create_dataframe(pa.table({"s": ["a", "b"]})).join(
            s.create_dataframe(pa.table({"s": ["b", "c"]})), on="s"),
        "string"),
    "two_partitions": (
        lambda s, col: s.create_dataframe(fact_table(
            np.random.default_rng(10), 50), num_partitions=2).join(
            s.create_dataframe(dim_table(np.random.default_rng(11), 20)),
            on="k"),
        "partition"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_join_raises(case):
    build_df, match = UNSUPPORTED[case]
    with pytest.raises(NotImplementedError, match=match):
        build_df(GpuSession(device="cpu"), pcol).collect()


@pytest.mark.parametrize("alias,how", [
    ("left_outer", "left"), ("leftouter", "left"), ("LEFT_OUTER", "left"),
    ("right_outer", "right"), ("rightouter", "right"),
    ("full_outer", "full")])
def test_outer_aliases_match_reference(sessions, alias, how):
    """Spark's outer aliases.  The reference's table never maps
    left_outer or right_outer (its keys keep the underscore that the
    lookup strips), so the port's alias is held against the reference's
    canonical name."""
    fact, dim = case_tables(12)
    (ref, _, rc), (port, _, pc) = sessions
    want = using("k", how)(ref, None, rc, fact, dim).collect()
    got = using("k", alias)(port, None, pc, fact, dim).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=FLOAT_RTOL)


def test_unknown_join_type_raises():
    with pytest.raises(ValueError, match="unknown join type 'sideways'"):
        using("k", "sideways")(GpuSession(device="cpu"), None, pcol,
                               *case_tables(13))
