"""Spark's hash(): Murmur3_x86_32 with seed 42, for hash partitioning;
monotonically_increasing_id(), spark_partition_id() and rand(seed); and
md5() and input_file_name(), on the host engine only (``hashlib``; the
scan's current file), as in the reference.

Counterpart of spark_rapids_tpu/expr/hashfns.py (hash_int32, hash_int64,
hash_bytes, hash_column, Murmur3Hash), bit for bit with the reference's
numpy branch and so with Spark: ints and booleans hash as one 4-byte
block, longs as their low then high word, doubles as the bits of the
value with -0.0 read as 0.0, strings and binary over their bytes
(Spark's hashUnsafeBytes: 4-byte little-endian blocks, then each tail
byte as a signed int, kernel K15, ``csrc/hash_bytes.cu``), a struct by
folding its children in turn; a null leaves the running seed as it
was.  torch has no uint32 arithmetic, so every 32-bit word is carried in
an int64 lane in [0, 2^32) (the port's rule for unsigned words), and
products are formed from 16-bit halves so no int64 product overflows.
rand(seed) is the reference's: SplitMix64 of (row position XOR seed),
its top 53 bits times 2^-53, carried in int64 (the add and the
multiplies wrap, the right shifts are masked to be logical), so its
bits equal the reference's for every seed, partition and row position
(not Spark's XORShift stream, as in the reference).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import kernels
from .. import types as t
from ..ops.join_kernels import _GOLDEN, _mix64, _shr
from .arithmetic import wrap_int
from .core import (ColumnValue, EvalContext, Expression, evaluator,
                   make_column)

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
SEED = 42


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def hash_int32(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Murmur3 of one 4-byte block per row (Spark hashInt).  ``values``
    holds 32-bit ints in any integer dtype; ``seed`` and the result are
    uint32 words in int64."""
    k1 = _mix_k1(values.to(torch.int64) & M32)
    return _fmix(_mix_h1(seed, k1), 4)


def hash_int64(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark hashLong: the low word, then the high word."""
    v = values.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(v & M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & M32))
    return _fmix(h1, 8)


# ---------------------------------------------------------------------------
# K15: Murmur3 over byte spans
# ---------------------------------------------------------------------------

_PLAIN_BLOCKS = 1024     # rows with more blocks take the per-row loop


def _py_mix_k1(k: int) -> int:
    k = (k * _C1) & M32
    k = ((k << 15) & M32) | (k >> 17)
    return (k * _C2) & M32


def _py_mix_h1(h: int, k: int) -> int:
    h ^= k
    h = ((h << 13) & M32) | (h >> 19)
    return (h * 5 + 0xE6546B64) & M32


def _py_hash_bytes(data: bytes, seed: int) -> int:
    """hashUnsafeBytes of one row on the host, in Python ints."""
    h, nb = seed, len(data) // 4
    for b in range(nb):
        h = _py_mix_h1(h, _py_mix_k1(int.from_bytes(data[4 * b:4 * b + 4],
                                                    "little")))
    for c in data[4 * nb:]:
        h = _py_mix_h1(h, _py_mix_k1((c - 256 if c >= 128 else c) & M32))
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def hash_bytes_plain(offsets: torch.Tensor, chars: torch.Tensor,
                     seed: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K15: the reference's numpy branch, all rows
    stepping through the blocks together (a step takes only the rows that
    still have a block); a row of more than ``_PLAIN_BLOCKS`` blocks is
    hashed alone on the host.  ``seed`` and the result are uint32 words
    in int64 lanes."""
    start = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - start
    nblocks = lens // 4
    long_rows = nblocks > _PLAIN_BLOCKS
    h = seed.to(torch.int64).clone()
    short = torch.where(long_rows, torch.zeros_like(nblocks), nblocks)
    steps = int(short.max()) if short.numel() else 0
    c = chars.to(torch.int64)
    for b in range(steps):
        rows = torch.nonzero(short > b).flatten()
        at = start[rows] + 4 * b
        k = c[at] | (c[at + 1] << 8) | (c[at + 2] << 16) | (c[at + 3] << 24)
        h[rows] = _mix_h1(h[rows], _mix_k1(k))
    tail = lens % 4
    for j in range(3):
        rows = torch.nonzero((tail > j) & ~long_rows).flatten()
        byte = c[(start + 4 * nblocks + j)[rows]]
        h[rows] = _mix_h1(h[rows], _mix_k1(torch.where(
            byte >= 128, byte - 256, byte) & M32))
    h = _fmix(h, lens & M32)
    for i in torch.nonzero(long_rows).flatten().tolist():
        s, n = int(start[i]), int(lens[i])
        h[i] = _py_hash_bytes(bytes(chars[s:s + n].cpu().tolist()),
                              int(seed[i]))
    if valid is not None:
        h = torch.where(valid, h, seed.to(torch.int64))
    return h


def hash_bytes(offsets: torch.Tensor, chars: torch.Tensor,
               seed: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Murmur3 (Spark's hashUnsafeBytes) of each row's bytes from its
    seed; a row where ``valid`` is False keeps its seed (K15).  ``seed``
    and the result are uint32 words in int64 lanes."""
    if offsets.device.type == "cpu":
        return hash_bytes_plain(offsets, chars, seed, valid)
    cap = int(offsets.shape[0]) - 1
    seed32 = seed.to(torch.int32)             # the low 32 bits
    lanes = [offsets, chars, seed32] + ([] if valid is None else [valid])
    kernels.require_cuda("hash_bytes", *lanes)
    if offsets.dtype != torch.int32 or chars.dtype != torch.uint8 or \
            seed32.shape != (cap,) or \
            (valid is not None and valid.shape != (cap,)):
        raise TypeError(f"hash_bytes: offsets int32[{cap + 1}], chars "
                        f"uint8, seed and valid [{cap}]")
    out = torch.empty(cap, dtype=torch.int32, device=offsets.device)
    if cap:
        lib = kernels.library("hash_bytes")
        kernels.check(lib, lib.srt_hash_bytes(
            offsets.data_ptr(), chars.data_ptr(),
            None if valid is None else valid.data_ptr(), seed32.data_ptr(),
            cap, out.data_ptr(), kernels.stream(offsets)), "hash_bytes")
        hash_bytes.launches += 1
    return out.to(torch.int64) & M32


hash_bytes.launches = 0


def hash_column(col, seed: torch.Tensor) -> torch.Tensor:
    """Spark-compatible hash of one column, folded into the per-row
    seeds; null rows keep their seed."""
    dtype = col.dtype
    if t.is_span(dtype):
        return hash_bytes(col.offsets, col.data, seed, col.validity)
    if isinstance(dtype, t.StructType):
        # the children fold into the seeds in turn; a null struct keeps
        # its seed (the reference's struct branch)
        h = seed
        for k in col.children:
            h = hash_column(k, h)
        return torch.where(col.validity, h, seed)
    if t.is_nested(dtype):
        raise NotImplementedError(
            f"hash() of {dtype.name} is not ported (the reference's hash "
            f"has no array or map branch)")
    if dtype in (t.LONG, t.TIMESTAMP) or isinstance(dtype, t.DecimalType):
        # a decimal hashes its low word, as the reference's does (Spark's
        # unscaled long up to 18 digits)
        h = hash_int64(col.data, seed)
    elif dtype == t.DOUBLE:
        d = col.data
        d = torch.where(d == 0.0, torch.zeros_like(d), d)   # -0.0 -> 0.0
        h = hash_int64(d.view(torch.int64), seed)
    elif dtype == t.FLOAT:
        d = col.data
        d = torch.where(d == 0.0, torch.zeros_like(d), d)   # -0.0 -> 0.0
        h = hash_int32(d.view(torch.int32), seed)
    else:   # BYTE, SHORT, INT, DATE, BOOLEAN and the all-null NULL lane
        h = hash_int32(col.data.to(torch.int32), seed)
    return torch.where(col.validity, h, seed)


class Murmur3Hash(Expression):
    """hash(children...): an INT, never null."""

    def __init__(self, children: List[Expression], seed: int = SEED):
        self.children = tuple(children)
        self.seed = seed

    def data_type(self):
        return t.INT


@evaluator(Murmur3Hash)
def _eval_murmur3(e: Murmur3Hash, ctx: EvalContext):
    h = torch.full((ctx.capacity,), e.seed & M32, dtype=torch.int64,
                   device=ctx.device)
    for c in e.children:
        v = c.eval(ctx)
        if not isinstance(v, ColumnValue):
            v = make_column(ctx, c.data_type(),
                            v.value if v.value is not None else 0,
                            None if v.value is not None else False)
        h = hash_column(v.col, h)
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return make_column(ctx, t.INT, signed.to(torch.int32), None)


class MonotonicallyIncreasingID(Expression):
    """(partition id << 33) + row position within the partition, never
    null (ref GpuMonotonicallyIncreasingID.scala).  The base comes from
    the projection's running row offset (``EvalContext.row_base``)."""

    children = ()

    def data_type(self):
        return t.LONG

    def sql(self):
        return "monotonically_increasing_id()"


@evaluator(MonotonicallyIncreasingID)
def _eval_monotonic_id(e: MonotonicallyIncreasingID, ctx: EvalContext):
    pos = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device)
    return make_column(ctx, t.LONG, pos + ctx.row_base,
                       pos < ctx.batch.num_rows)


class SparkPartitionID(Expression):
    """The partition's id, never null: the high bits of the row base."""

    children = ()

    def data_type(self):
        return t.INT

    def sql(self):
        return "spark_partition_id()"


@evaluator(SparkPartitionID)
def _eval_spark_partition_id(e: SparkPartitionID, ctx: EvalContext):
    return make_column(ctx, t.INT, ctx.row_base >> 33, None)


class Rand(Expression):
    """rand([seed]): uniform in [0, 1) a row, determined by (seed,
    partition, row position), never null."""

    children = ()

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def data_type(self):
        return t.DOUBLE

    def sql(self):
        return f"rand({self.seed})"


def _splitmix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64 over uint64 bits carried in int64 (its finalizer is the
    join's ``_mix64``)."""
    return _mix64(z + _GOLDEN)


@evaluator(Rand)
def _eval_rand(e: Rand, ctx: EvalContext):
    pos = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device) \
        + ctx.row_base
    mixed = _splitmix64(pos ^ wrap_int(e.seed & (2**64 - 1), t.LONG))
    return make_column(ctx, t.DOUBLE,
                       _shr(mixed, 11).to(torch.float64) * 2.0 ** -53, None)


class InputFileName(Expression):
    """input_file_name(): the path of the file the batch came from, "" past
    an exchange or over data not read from a file; host engine only (the
    scan's per-file metadata, not device data)."""

    children = ()

    def data_type(self):
        return t.STRING

    def sql(self):
        return "input_file_name()"


@evaluator(InputFileName)
def _eval_input_file_name(e: InputFileName, ctx: EvalContext):
    from ..io.scan import current_input_file
    from .host_strings import build_string_column, host_only
    host_only(ctx, "input_file_name")
    return build_string_column(ctx, [current_input_file()] * ctx.capacity)


# expressions that read the row base (partition id << 33 + row offset)
POSITIONAL = (MonotonicallyIncreasingID, SparkPartitionID, Rand)


class Md5(Expression):
    """md5(x): the MD5 digest of each row's bytes as 32 hex digits, on the
    host engine only (tagged off the GPU, as in the reference)."""

    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.STRING


@evaluator(Md5)
def _eval_md5(e: Md5, ctx: EvalContext):
    import hashlib

    from .host_strings import build_string_column, host_only, host_string_rows
    host_only(ctx, "md5")
    v = e.children[0].eval(ctx)
    if not isinstance(v, ColumnValue):
        v = make_column(ctx, e.children[0].data_type(),
                        v.value if v.value is not None else 0,
                        None if v.value is not None else False)
    return build_string_column(ctx, [
        None if r is None else hashlib.md5(r).hexdigest()
        for r in host_string_rows(v.col, ctx.capacity, None)])
