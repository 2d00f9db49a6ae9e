"""Equi-join kernels: key hashing (kernel K6), the probe (kernel K4) and
the pair expansion with the row gathers of both sides (kernel K5).

Counterpart of spark_rapids_tpu/ops/join_kernels.py.  Each side's keys
collapse to one 64-bit combined hash per row.  The build side's hashes
are written by K6, sorted once (kernel K2) and put in K4's hash table,
one entry per run of equal hashes; each probe row's hash is computed
inside K4 and looked up there (a miss takes its exact position from a
binary search); every output position finds its probe row by a
binary search over the running match counts and gathers both sides'
lanes (K5).  Equal keys always hash equally; unequal keys collide with
probability ~2^-64, the reference's documented tradeoff.

Hashes are the reference's uint64 bits carried in int64 tensors (torch
has no uint64 arithmetic): multiplication and addition wrap the same,
and right shifts are made logical by a mask.  Where a hash is a sort key
for K2 it is carried as (hash XOR 2^63), like every K2 word, so signed
order is the reference's unsigned order.

Each kernel's wrapper takes its plain PyTorch version for CPU tensors
only; for CUDA tensors it launches the kernel (``csrc/``) or raises, and
counts the call in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from .. import types as t
from ..columnar.device import DeviceColumn
from .carry import sort_order
from .gather import gather_column
from .segmented import encode_float_ordered, encode_int_ordered


def _int64(u: int) -> int:
    """The int64 with the bits of the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_SIGN = -2**63
_SEED = 0x12345678DEADBEEF
_MIX = _int64(0xBF58476D1CE4E5B9)
_MIX2 = _int64(0x94D049BB133111EB)
_GOLDEN = _int64(0x9E3779B97F4A7C15)
_NULL_BUILD = _GOLDEN                       # sentinel: build-side null key
_NULL_PROBE = _int64(0xC2B2AE3D27D4EB4F)    # distinct: probe-side null key
_NULL_STEP = 2654435761
_PARKED = -1                                # 0xFFFF...FFFF: dead build rows


def _shr(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` is arithmetic)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def _mix64(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _shr(h, 30)) * _MIX
    h = (h ^ _shr(h, 27)) * _MIX2
    return h ^ _shr(h, 31)


# Key column kinds of csrc/join_hash.cuh, and the lane type each reads.
_KEY_KINDS = {t.BOOLEAN: (0, torch.bool), t.INT: (1, torch.int32),
              t.LONG: (2, torch.int64), t.DOUBLE: (3, torch.float64)}


def _key_word(col: DeviceColumn) -> torch.Tensor:
    """The reference's uint64 value word of a key column, as int64 bits:
    the port's order-preserving word (ops/segmented.py) with its sign bit
    flipped back."""
    if col.data.is_floating_point():
        return encode_float_ordered(col.data) ^ _SIGN
    return encode_int_ordered(col.data) ^ _SIGN


def _check_keys(key_cols: Sequence[DeviceColumn], cap: int) -> None:
    if not key_cols:
        raise ValueError("a join key hash needs at least one key column")
    for col in key_cols:
        if col.dtype not in _KEY_KINDS:
            raise NotImplementedError(
                f"join keys of type {col.dtype} are not ported yet")
        if col.data.shape != (cap,) or col.validity.shape != (cap,):
            raise ValueError(f"join key column {col} does not have {cap} "
                             "rows")


def combined_key_hash_plain(key_cols: Sequence[DeviceColumn], cap: int,
                            null_matches: bool = False,
                            side: str = "build") -> torch.Tensor:
    """Plain version of K6: the hash as a chain of torch passes over whole
    lanes.  See ``combined_key_hash``."""
    _check_keys(key_cols, cap)
    dev = key_cols[0].data.device
    h = torch.full((cap,), _SEED, dtype=torch.int64, device=dev)
    any_null = torch.zeros(cap, dtype=torch.bool, device=dev)
    for col in key_cols:
        w = _mix64(_key_word(col))
        h = _mix64(h ^ (w + _GOLDEN + (h << 6) + _shr(h, 2)))
        any_null |= ~col.validity
    if not null_matches:
        sentinel = _NULL_BUILD if side == "build" else _NULL_PROBE
        h = torch.where(any_null, sentinel + torch.arange(
            cap, dtype=torch.int64, device=dev) * _NULL_STEP, h)
    return h


def _key_desc(what: str, key_cols: Sequence[DeviceColumn], cap: int
              ) -> torch.Tensor:
    """The key columns as csrc/join_hash.cuh's KeyCols reads them: a
    device array of their data pointers, validity pointers and kinds."""
    _check_keys(key_cols, cap)
    kernels.require_cuda(what, *[x for c in key_cols
                                 for x in (c.data, c.validity)])
    for col in key_cols:
        dtype = _KEY_KINDS[col.dtype][1]
        if col.data.dtype != dtype or col.validity.dtype != torch.bool:
            raise TypeError(f"{what}: key column {col} must hold {dtype} "
                            "with a bool validity lane")
    return kernels.device_int64s(
        [c.data.data_ptr() for c in key_cols]
        + [c.validity.data_ptr() for c in key_cols]
        + [_KEY_KINDS[c.dtype][0] for c in key_cols],
        key_cols[0].data.device)


def combined_key_hash(key_cols: Sequence[DeviceColumn], cap: int,
                      null_matches: bool = False,
                      side: str = "build") -> torch.Tensor:
    """int64[cap] holding the reference's uint64 combined hash over the
    key columns, bit for bit (K6); a row with any null key gets a
    per-row side-specific sentinel so nulls never match (unless
    ``null_matches``, for null-safe equality)."""
    if side not in ("build", "probe"):
        raise ValueError(f"side must be 'build' or 'probe', not {side!r}")
    if key_cols and key_cols[0].data.device.type == "cpu":
        return combined_key_hash_plain(key_cols, cap, null_matches, side)
    desc = _key_desc("combined_key_hash", key_cols, cap)
    dev = key_cols[0].data.device
    out = torch.empty(cap, dtype=torch.int64, device=dev)
    if cap == 0:
        return out
    lib = kernels.library("key_hash")
    kernels.check(lib, lib.srt_key_hash(
        desc.data_ptr(), len(key_cols), cap, int(null_matches),
        int(side == "probe"), out.data_ptr(), kernels.stream(out)),
        "combined_key_hash")
    combined_key_hash.launches += 1
    return out


combined_key_hash.launches = 0


# ---------------------------------------------------------------------------
# the build side: K2's sort and K4's table
# ---------------------------------------------------------------------------

class BuildSide(NamedTuple):
    """The build side as the probe reads it: K2's order of the build
    hashes (dead rows parked last), the hashes in that order (ascending
    unsigned), and K4's hash table over them (None on the CPU)."""
    order: torch.Tensor
    sorted_hash: torch.Tensor
    table: Optional[torch.Tensor]


def _parked_build(build_hash: torch.Tensor,
                  build_live: torch.Tensor) -> torch.Tensor:
    """Dead build rows parked at the largest unsigned hash."""
    return torch.where(build_live, build_hash,
                       torch.full_like(build_hash, _PARKED))


def hash_table(sorted_hash: torch.Tensor) -> torch.Tensor:
    """K4's table over the sorted build hashes (CUDA only): one 16-byte
    slot (hash, run start, run length) per run of equal hashes, in an
    open-addressing table of at least twice as many slots as rows."""
    kernels.require_cuda("hash_table", sorted_hash)
    if sorted_hash.dtype != torch.int64 or sorted_hash.dim() != 1:
        raise TypeError("hash_table: sorted hashes must be int64[n]")
    nb = int(sorted_hash.shape[0])
    lib = kernels.library("join_probe")
    slots = lib.srt_join_table_slots(nb)
    if slots < 0:
        raise ValueError(f"hash_table: {nb} build rows; at most 2^29 - 1")
    table = torch.empty(2 * slots, dtype=torch.int64,
                        device=sorted_hash.device)
    kernels.check(lib, lib.srt_join_build_table(
        sorted_hash.data_ptr(), nb, table.data_ptr(), slots,
        kernels.stream(sorted_hash)), "hash_table")
    if nb:
        hash_table.launches += 1
    return table


hash_table.launches = 0


def sort_build_plain(build_hash: torch.Tensor, build_live: torch.Tensor
                     ) -> BuildSide:
    """Plain version of ``sort_build``: a stable argsort, no table."""
    bh = _parked_build(build_hash, build_live)
    order = torch.argsort(bh ^ _SIGN, stable=True).to(torch.int32)
    return BuildSide(order, bh[order.long()], None)


def sort_build(build_hash: torch.Tensor, build_live: torch.Tensor
               ) -> BuildSide:
    """The build side sorted by hash (K2) with K4's table over it, made
    once per build side and read by every probe batch."""
    bh = _parked_build(build_hash, build_live)
    order = sort_order([bh ^ _SIGN])
    sorted_hash = bh[order.long()]
    table = None if bh.device.type == "cpu" else hash_table(sorted_hash)
    return BuildSide(order, sorted_hash, table)


# ---------------------------------------------------------------------------
# K4: the probe, with the probe side's hash fused in
# ---------------------------------------------------------------------------

def _live_rows(cap: int, num_rows: int, device) -> torch.Tensor:
    return torch.arange(cap, device=device) < num_rows


def join_probe_plain(sorted_hash: torch.Tensor, probe_hash: torch.Tensor,
                     probe_live: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per probe hash its range of equal hashes in ``sorted_hash``, by two
    searchsorted calls on the XOR-2^63 words: (lo int32, counts int64),
    ``lo`` the unsigned lower bound of every row, live or not (the
    reference's searchsorted side="left"), ``counts`` 0 where the row is
    dead."""
    s = sorted_hash ^ _SIGN
    p = probe_hash ^ _SIGN
    lo = torch.searchsorted(s, p)
    hi = torch.searchsorted(s, p, right=True)
    counts = torch.where(probe_live, hi - lo, torch.zeros_like(lo))
    return lo.to(torch.int32), counts.to(torch.int64)


def join_probe_keys_plain(sorted_hash: torch.Tensor,
                          key_cols: Sequence[DeviceColumn], num_rows: int,
                          null_matches: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: the probe side's hashes by K6's plain version,
    then ``join_probe_plain``.  See ``join_probe``."""
    cap = int(key_cols[0].data.shape[0]) if key_cols else 0
    ph = combined_key_hash_plain(key_cols, cap, null_matches, side="probe")
    return join_probe_plain(sorted_hash, ph,
                            _live_rows(cap, num_rows, ph.device))


def join_probe(build: BuildSide, key_cols: Sequence[DeviceColumn],
               num_rows: int, null_matches: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per probe row, its range of equal hashes in the sorted build hashes
    (K4): the row's combined key hash (side "probe") is computed from
    ``key_cols`` and looked up, never written out.  The first
    ``num_rows`` rows are live.  Returns (lo int32, counts int64) as
    ``join_probe_plain`` on those hashes: build rows
    ``build.order[lo[i]:lo[i] + counts[i]]`` match probe row i."""
    cap = int(key_cols[0].data.shape[0]) if key_cols else 0
    if build.sorted_hash.device.type == "cpu":
        return join_probe_keys_plain(build.sorted_hash, key_cols, num_rows,
                                     null_matches)
    desc = _key_desc("join_probe", key_cols, cap)
    kernels.require_cuda("join_probe", build.sorted_hash, build.table,
                         key_cols[0].data)
    if build.sorted_hash.dtype != torch.int64 or \
            build.table.dtype != torch.int64:
        raise TypeError("join_probe: sorted hashes and table must be int64")
    if not 0 <= num_rows <= cap:
        raise ValueError(f"join_probe: {num_rows} live rows of {cap}")
    dev = build.sorted_hash.device
    lo = torch.empty(cap, dtype=torch.int32, device=dev)
    counts = torch.empty(cap, dtype=torch.int64, device=dev)
    if cap == 0:
        return lo, counts
    lib = kernels.library("join_probe")
    kernels.check(lib, lib.srt_join_probe(
        build.sorted_hash.data_ptr(), int(build.sorted_hash.shape[0]),
        build.table.data_ptr(), int(build.table.shape[0]) // 2,
        desc.data_ptr(), len(key_cols), cap, num_rows, int(null_matches),
        lo.data_ptr(), counts.data_ptr(), kernels.stream(lo)), "join_probe")
    join_probe.launches += 1
    return lo, counts


join_probe.launches = 0


def count_matches_plain(build_cols: Sequence[DeviceColumn], n_b: int,
                        probe_cols: Sequence[DeviceColumn], n_p: int,
                        null_matches: bool = False):
    """Plain version of ``count_matches``: K6's, K2's and K4's plain
    versions."""
    cap_b = int(build_cols[0].data.shape[0])
    bh = combined_key_hash_plain(build_cols, cap_b, null_matches, "build")
    build = sort_build_plain(bh, _live_rows(cap_b, n_b, bh.device))
    lo, counts = join_probe_keys_plain(build.sorted_hash, probe_cols, n_p,
                                       null_matches)
    return build.order, lo, counts


def count_matches(build_cols: Sequence[DeviceColumn], n_b: int,
                  probe_cols: Sequence[DeviceColumn], n_p: int,
                  null_matches: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-probe-row match ranges of one build and one probe side, the
    first ``n_b`` and ``n_p`` rows of each live: K6 hashes the build
    keys, K2 sorts them (dead rows parked last), K4 builds its table and
    probes it with the probe keys' hashes.

    Returns (order int32[cap_b], lo int32[cap_p], counts int64[cap_p]):
    build rows ``order[lo[i]:lo[i] + counts[i]]`` match probe row i."""
    cap_b = int(build_cols[0].data.shape[0])
    bh = combined_key_hash(build_cols, cap_b, null_matches, "build")
    build = sort_build(bh, _live_rows(cap_b, n_b, bh.device))
    lo, counts = join_probe(build, probe_cols, n_p, null_matches)
    return build.order, lo, counts


def effective_counts(counts: torch.Tensor, probe_live: torch.Tensor,
                     join_type: str) -> torch.Tensor:
    """Output rows per probe row: its matches, at least one for a left or
    full join (the null-extended row), none for a dead row."""
    eff = counts.clamp(min=1) if join_type in ("left", "full") else counts
    return torch.where(probe_live, eff, torch.zeros_like(eff))


# ---------------------------------------------------------------------------
# K5: pair expansion fused with the gathers of both sides
# ---------------------------------------------------------------------------

def _null_columns(cols: Sequence[DeviceColumn], cap: int
                  ) -> List[DeviceColumn]:
    return [DeviceColumn(c.dtype, torch.zeros(cap, dtype=c.data.dtype,
                                              device=c.data.device),
                         torch.zeros(cap, dtype=torch.bool,
                                     device=c.data.device))
            for c in cols]


def expand_pairs_plain(ends, lo, counts, order, total, out_cap,
                       probe_cols, build_cols):
    """Plain version of K5: searchsorted over the running counts, then
    ``gather_column`` of each side.  See ``expand_pairs``."""
    n_p, n_b = int(ends.shape[0]), int(order.shape[0])
    dev = ends.device
    if n_p == 0:
        zeros = torch.zeros(out_cap, dtype=torch.int32, device=dev)
        return (zeros, zeros.clone(), _null_columns(probe_cols, out_cap),
                _null_columns(build_cols, out_cap))
    p = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(ends, p, right=True).clamp(max=n_p - 1)
    start = torch.where(row > 0, ends[(row - 1).clamp(min=0)],
                        torch.zeros_like(row))
    cnt = counts[row]
    pos = lo[row].to(torch.int64) + torch.minimum(p - start,
                                                  (cnt - 1).clamp(min=0))
    pair = p < total
    matched = pair & (cnt > 0)
    probe_out = [gather_column(c, row, pair) for c in probe_cols]
    if n_b == 0:
        bidx = torch.zeros(out_cap, dtype=torch.int64, device=dev)
        build_out = _null_columns(build_cols, out_cap)
    else:
        bidx = order[pos.clamp(0, n_b - 1)].to(torch.int64)
        build_out = [gather_column(c, bidx, matched) for c in build_cols]
    return (row.to(torch.int32), bidx.to(torch.int32), probe_out,
            build_out)


_MAX_COLS = 32                                 # kMaxCols in csrc


def expand_pairs(ends: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor,
                 order: torch.Tensor, total: int, out_cap: int,
                 probe_cols: Sequence[DeviceColumn],
                 build_cols: Sequence[DeviceColumn]):
    """Materialise the join's pairs at capacity ``out_cap`` and gather
    both sides' columns into them (K5).

    ``ends`` (int64[cap_p]) is the running sum of ``effective_counts``
    and ``total`` its last element.  Output position p belongs to probe
    row ``row``, the first with ``ends[row] > p``, and is its k-th pair
    (``k = p`` minus the row's start); its build row is
    ``order[lo[row] + min(k, max(counts[row] - 1, 0))]``.  Probe columns
    are valid where the source row is and ``p < total``; build columns
    where, besides, the probe row has a match (a left or full join's
    unmatched row gets a null build side).  Data is zero where invalid;
    with no probe rows every position is padding.  Returns (probe_idx
    int32[out_cap], build_idx int32[out_cap], probe columns, build
    columns)."""
    if ends.device.type == "cpu":
        return expand_pairs_plain(ends, lo, counts, order, total, out_cap,
                                  probe_cols, build_cols)
    n_p, n_b = int(ends.shape[0]), int(order.shape[0])
    lanes = [x for c in (*probe_cols, *build_cols)
             for x in (c.data, c.validity)]
    kernels.require_cuda("expand_pairs", ends, lo, counts, order, *lanes)
    if ends.dtype != torch.int64 or counts.dtype != torch.int64 or \
            lo.dtype != torch.int32 or order.dtype != torch.int32 or \
            lo.shape != (n_p,) or counts.shape != (n_p,):
        raise TypeError("expand_pairs: ends and counts must be int64, lo "
                        f"int32, all [{n_p}]; order int32")
    if not 0 <= total <= out_cap < 2**31:
        raise ValueError(f"expand_pairs: total {total} and capacity "
                         f"{out_cap} must satisfy 0 <= total <= capacity "
                         "< 2^31")
    for side, cols, n in (("probe", probe_cols, n_p),
                          ("build", build_cols, n_b)):
        for c in cols:
            if c.data.shape != (n,) or c.validity.shape != (n,) or \
                    c.validity.dtype != torch.bool or \
                    c.data.element_size() not in (1, 4, 8):
                raise TypeError(f"expand_pairs: {side} column {c} does not "
                                f"have {n} rows of 1, 4 or 8 bytes")
    if n_p == 0 and total != 0:
        raise ValueError(f"expand_pairs: no probe rows, but total {total}")
    dev = ends.device
    pidx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    bidx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    sides = [(c, 0) for c in probe_cols] + [(c, 1) for c in build_cols]
    outs = [DeviceColumn(c.dtype,
                         torch.empty(out_cap, dtype=c.data.dtype, device=dev),
                         torch.empty(out_cap, dtype=torch.bool, device=dev))
            for c, _ in sides]
    lib = kernels.library("join_expand")
    # every launch writes the pair indices; columns go in chunks of 32
    for s in range(0, max(len(sides), 1), _MAX_COLS):
        chunk = sides[s:s + _MAX_COLS]
        out_chunk = outs[s:s + _MAX_COLS]
        kernels.check(lib, lib.srt_join_expand(
            ends.data_ptr(), n_p, lo.data_ptr(), counts.data_ptr(),
            order.data_ptr(), n_b, total, out_cap, pidx.data_ptr(),
            bidx.data_ptr(), len(chunk),
            kernels.pointers([c.data for c, _ in chunk]),
            kernels.pointers([c.validity for c, _ in chunk]),
            kernels.pointers([o.data for o in out_chunk]),
            kernels.pointers([o.validity for o in out_chunk]),
            kernels.ints(c.data.element_size() for c, _ in chunk),
            kernels.ints(side for _, side in chunk),
            kernels.stream(ends)), "expand_pairs")
        expand_pairs.launches += 1
    n_probe = len(probe_cols)
    return pidx, bidx, outs[:n_probe], outs[n_probe:]


expand_pairs.launches = 0


def build_matched_flags(order: torch.Tensor, lo: torch.Tensor,
                        counts: torch.Tensor, probe_live: torch.Tensor,
                        build_cap: int) -> torch.Tensor:
    """bool[build_cap]: build rows matched by at least one probe row (for
    right/full outer unmatched emission).  +1 at each live range's start
    and -1 after its end over sorted positions (an integer scatter-add,
    so its result does not depend on the order of the adds), a prefix
    sum, then a scatter back through ``order``."""
    dev = lo.device
    delta = torch.zeros(build_cap + 1, dtype=torch.int32, device=dev)
    starts = lo.to(torch.int64).clamp(0, build_cap)
    ends = (lo.to(torch.int64) + counts).clamp(0, build_cap)
    ones = (probe_live & (counts > 0)).to(torch.int32)
    delta.index_add_(0, starts, ones)
    delta.index_add_(0, ends, -ones)
    covered = torch.cumsum(delta[:-1], 0) > 0
    matched = torch.zeros(build_cap, dtype=torch.bool, device=dev)
    matched[order.long()] = covered
    return matched
