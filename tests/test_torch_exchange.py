"""The port's host exchange against the reference's hash routing.

Spark's hash() (Murmur3_x86_32, seed 42) and HashPartitioning's
pmod(hash, n) go through the reference's numpy branch and the port on
CPU tensors, for each flat type with nulls (ints at their extremes,
doubles with -0.0, NaN and infinities, booleans) and for several key
columns: every hash and every partition id must be equal, bit for bit.
The in-memory ShuffleExchangeExec must put every row in the partition
those ids name, in arrival order.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar.device import batch_to_device as rupload
from spark_rapids_tpu.expr import core as rcore
from spark_rapids_tpu.expr import hashfns as rhash
from spark_rapids_tpu.shuffle import partitioning as rpart
from spark_rapids_tpu_torch.columnar.device import batch_to_device
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.basic import LocalScanExec
from spark_rapids_tpu_torch.expr import core as pcore
from spark_rapids_tpu_torch.expr import hashfns as phash
from spark_rapids_tpu_torch.shuffle import partitioning as ppart
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec

N = 700


def column(kind, rng):
    valid = rng.random(N) >= 0.15
    if kind == "int":
        vals = rng.choice(np.array([-2**31, 2**31 - 1, -1, 0, 1, 7, 42],
                                   dtype=np.int32), N)
        vals = np.where(rng.random(N) < 0.5, vals,
                        rng.integers(-2**31, 2**31, N).astype(np.int32))
    elif kind == "long":
        vals = rng.choice(np.array([-2**63, 2**63 - 1, -1, 0, 1, 2**32],
                                   dtype=np.int64), N)
        vals = np.where(rng.random(N) < 0.5, vals,
                        rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64))
    elif kind == "double":
        vals = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf,
                                    1.5, -2.25, 1e300]), N)
        vals = np.where(rng.random(N) < 0.5, vals, rng.normal(size=N))
    else:
        vals = rng.random(N) < 0.5
    return pa.array(vals, mask=~valid)


def table(kinds, seed):
    rng = np.random.default_rng(seed)
    return pa.table({f"c{i}": column(kind, rng)
                     for i, kind in enumerate(kinds)})


CASES = {
    "int": ["int"], "long": ["long"], "double": ["double"],
    "boolean": ["boolean"], "long_double_int": ["long", "double", "int"],
    "boolean_long": ["boolean", "long"],
}


def reference_hash(tbl, keys):
    rb = tbl.combine_chunks().to_batches()[0]
    batch = rupload(rb, xp=np)
    names = list(tbl.schema.names)
    dtypes = [c.dtype for c in batch.columns]
    ctx = rcore.EvalContext(np, batch)
    h = rcore.bind_expression(rhash.Murmur3Hash(keys(rcore)), names, dtypes)
    return np.asarray(h.eval(ctx).col.data)[:tbl.num_rows], batch, ctx


def port_hash(tbl, keys):
    rb = tbl.combine_chunks().to_batches()[0]
    batch = batch_to_device(rb, "cpu")
    names = list(tbl.schema.names)
    dtypes = [c.dtype for c in batch.columns]
    ctx = pcore.EvalContext(batch)
    h = pcore.bind_expression(phash.Murmur3Hash(keys(pcore)), names, dtypes)
    return h.eval(ctx).col.data[:tbl.num_rows].numpy(), batch, ctx


def key_exprs(n):
    return lambda core: [core.AttributeReference(f"c{i}") for i in range(n)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_murmur3_matches_reference(case):
    tbl = table(CASES[case], len(case))
    want, _, _ = reference_hash(tbl, key_exprs(len(CASES[case])))
    got, _, _ = port_hash(tbl, key_exprs(len(CASES[case])))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want.astype(np.int32), got)


def test_murmur3_of_a_null_literal_keeps_the_seed():
    """hash(c, NULL) is hash(c) (Spark: a null leaves the running seed).
    The reference cannot materialize a NULL-typed literal column here, so
    the port's is held against the reference's hash of c alone."""
    tbl = table(["long"], 3)
    keys = key_exprs(1)
    want, _, _ = reference_hash(tbl, keys)
    got, _, _ = port_hash(tbl, lambda core: keys(core) + [core.Literal(None)])
    np.testing.assert_array_equal(want.astype(np.int32), got)


@pytest.mark.parametrize("parts", [2, 3, 7, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_ids_match_reference(case, parts):
    n = len(CASES[case])
    tbl = table(CASES[case], 10 + len(case))
    names = list(tbl.schema.names)
    _, rbatch, rctx = reference_hash(tbl, key_exprs(n))
    _, pbatch, pctx = port_hash(tbl, key_exprs(n))
    rp = rpart.HashPartitioning(key_exprs(n)(rcore), parts).bind(
        names, [c.dtype for c in rbatch.columns])
    pp = ppart.HashPartitioning(key_exprs(n)(pcore), parts).bind(
        names, [c.dtype for c in pbatch.columns])
    want = np.asarray(rp.partition_ids(np, rctx, rbatch))[:tbl.num_rows]
    got = pp.partition_ids(pctx, pbatch)[:tbl.num_rows].numpy()
    np.testing.assert_array_equal(want, got)
    assert got.min() >= 0 and got.max() < parts


@pytest.mark.parametrize("map_parts", [1, 3])
def test_exchange_routes_every_row_by_its_partition_id(map_parts):
    """Partition p of the exchange holds, map partition by map partition,
    the rows whose reference partition id is p, in arrival order."""
    tbl = table(["long", "double", "boolean"], 21).append_column(
        "row", pa.array(np.arange(N)))
    parts = 4
    exchange = ShuffleExchangeExec(
        ppart.HashPartitioning(key_exprs(2)(pcore), parts),
        LocalScanExec(tbl, map_parts, batch_rows=150))
    ctx = ExecContext("cpu")
    got = {p: [] for p in range(parts)}
    for p in range(parts):
        for b in exchange.execute_partition(p, ctx):
            got[p] += b.columns[3].data[:b.num_rows].tolist()
    want_ids, _, _ = reference_hash(tbl, key_exprs(2))
    want_pid = np.mod(want_ids.astype(np.int32), parts)
    per = -(-N // map_parts)
    for p in range(parts):
        rows = np.flatnonzero(want_pid == p)
        # reduce side: map 0's rows, then map 1's, ... each in row order
        order = sorted(rows, key=lambda r: (r // per, r))
        assert got[p] == list(order)
    assert sorted(sum(got.values(), [])) == list(range(N))
