"""The packed device-to-host fetch of a batch.

Counterpart of spark_rapids_tpu/columnar/fetch.py (``_lane_stats``,
``_build_plan``, ``_make_shrink_pack_fn``, ``_unpack_column`` and
``fetch_batch``) for flat, string, binary and nested columns.  A batch
comes to the host in one small read and one packed copy, of the live
rows only and of only the bytes that carry information:

  1. K9 ``lane_stats`` (``csrc/fetch_pack.cu``) reduces every lane of the
     batch in one launch into one int64 tensor, two numbers a lane: a
     bool lane's (all true, 0), an integer lane's (min, max) over the
     live rows; the host reads it in one copy;
  2. the host builds the transfer plan by the reference's rules
     (``build_plan``): a bool lane that is all true is skipped, another
     is bit-packed, an int32 or int64 lane whose live span fits 1, 2 or
     4 bytes travels as (value - min) in that width, anything else as
     it is (a BYTE, SHORT or FLOAT lane among them: K9 takes no stats
     of it, and K10 copies its 1, 2 or 4 bytes a row; a DECIMAL128's
     high words are one more int64 lane, after its validity);
  3. K10 ``pack_lanes`` writes every kept lane into its slice of one
     device byte buffer, each slice 8-byte aligned (``layout``);
  4. one ``cudaMemcpyAsync`` copies the buffer into a pinned host staging
     buffer, kept per device and grown as needed, and the host waits for
     it on an event;
  5. the host rebuilds ``HostColumn``s from the staging buffer, copying
     every lane out of it (the next fetch reuses it): narrowed lanes are
     widened and the min added back with multithreaded torch CPU ops, a
     bit-packed validity lane stays an Arrow bitmap.

A string column has two lanes that behave differently.  Its offsets are
row-aligned: the lane is ``offsets[1:n + 1]`` (``offsets[0]`` is always
0), which K9 reduces and K10 narrows like an int lane, over the full
lane's minimum, 0 (the reference's ``_shrink_column``); the lane's max
is the byte count, so the sizes still come in the one small read (the
reference's ``_var_sizes``).  Its chars are ``offsets[n]`` bytes, not n
rows: they are copied raw into their slice of the packed buffer, after
every row lane, and the host builds the Arrow array from the two
buffers.  A binary column is fetched the same way.

A STRUCT's validity and its children's lanes are row lanes of the batch
(its children are row-aligned).  An ARRAY's or MAP's offsets lane is
row-aligned like a string's, and its max is the child total: its
children are fetched as a group of their own at that row count, one K9
launch and one K10 buffer a group, each nesting level's stats read in
one host read (the reference's nested ``_var_sizes`` and
``_unpack_column``), every group's buffer copied into the staging
buffer before the one wait; the host builds the Arrow arrays from the
offsets, bitmaps and children, never through Python lists.

The reference's ride-along ``extra_scalars`` (deferred guards of the
speculative join sizing) waits for that sizing (ROADMAP Queue 2), and
its speculative dispatch of the pack before the plan is read is not
ported: the card's read of the stats is one short copy, not a tunnel
round trip.  Each kernel's wrapper takes its plain PyTorch version for
CPU tensors only, launches the kernel for CUDA tensors or raises, and
counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import torch

from .. import kernels
from .. import types as t
from .device import (DeviceBatch, DeviceColumn, HostColumn, move_batch,
                     unpack_bits)

KIND_BOOL, KIND_INT32, KIND_INT64, KIND_OTHER = 0, 1, 2, 3
_INT_RANGE = {KIND_INT32: (2**31 - 1, -2**31),
              KIND_INT64: (2**63 - 1, -2**63)}
_NARROW_TORCH = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def lane_kind(lane: torch.Tensor) -> int:
    if lane.dtype == torch.bool:
        return KIND_BOOL
    if lane.dtype == torch.int32:
        return KIND_INT32
    if lane.dtype == torch.int64:
        return KIND_INT64
    return KIND_OTHER


def _column_lanes(c: DeviceColumn) -> List[torch.Tensor]:
    """One column's row lanes in the reference's walk order
    (``_walk_lanes``): its data, or a span column's offsets lane
    (``offsets[1:]``), then its validity, then a DECIMAL128's high
    words; a STRUCT's validity, then each child's lanes (its children
    are row-aligned with it).  An ARRAY's or MAP's children are not row
    lanes: they are the next level of the fetch."""
    if isinstance(c.dtype, t.StructType):
        return [c.validity] + [x for k in c.children
                               for x in _column_lanes(k)]
    return [x for x in (c.data if c.offsets is None else c.offsets[1:],
                        c.validity, c.data_hi) if x is not None]


def batch_lanes(batch: DeviceBatch) -> List[torch.Tensor]:
    """Every row lane of a batch in the reference's walk order
    (``_column_lanes``); a string column's offsets lane takes the data's
    place (its chars are not a row lane, ``fetch_batch``)."""
    return [x for c in batch.columns for x in _column_lanes(c)]


def _span_lanes(cols: Sequence[DeviceColumn]) -> Tuple[List[int], list]:
    """The lane index of each span column's offsets lane (strings,
    binary, arrays and maps, in walk order), and those columns."""
    idx, found, at = [], [], 0

    def walk(c):
        nonlocal at
        if isinstance(c.dtype, t.StructType):
            at += 1
            for k in c.children:
                walk(k)
            return
        if c.offsets is not None:
            idx.append(at)
            found.append(c)
        at += len(_column_lanes(c))
    for c in cols:
        walk(c)
    return idx, found


def _seed(kinds: Sequence[int]) -> List[int]:
    """The stats of an empty batch: 1, 0 for a bool lane, dtype max and
    dtype min for an integer lane (so the plan never narrows it), 0, 0
    otherwise."""
    out = []
    for k in kinds:
        if k == KIND_BOOL:
            out += [1, 0]
        elif k in _INT_RANGE:
            out += list(_INT_RANGE[k])
        else:
            out += [0, 0]
    return out


# ---------------------------------------------------------------------------
# K9: per-lane statistics
# ---------------------------------------------------------------------------

def lane_stats_plain(lanes: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Plain version of K9: int64[2 * lanes] over rows [0, n)."""
    kinds = [lane_kind(x) for x in lanes]
    out = _seed(kinds)
    if n > 0:
        for i, (x, k) in enumerate(zip(lanes, kinds)):
            if k == KIND_BOOL:
                out[2 * i] = int(torch.all(x[:n]))
            elif k in _INT_RANGE:
                mn, mx = torch.aminmax(x[:n])
                out[2 * i], out[2 * i + 1] = int(mn), int(mx)
    dev = lanes[0].device if lanes else torch.device("cpu")
    return torch.tensor(out, dtype=torch.int64, device=dev)


def lane_stats(lanes: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Per-lane (all true, 0) or (min, max) over the live rows [0, n),
    in one int64[2 * lanes] tensor on the lanes' device (K9)."""
    if not lanes:
        raise ValueError("lane_stats needs at least one lane")
    if lanes[0].device.type == "cpu":
        return lane_stats_plain(lanes, n)
    kernels.require_cuda("lane_stats", *lanes)
    for x in lanes:
        if x.dim() != 1 or x.shape[0] < n:
            raise ValueError(f"lane_stats: lane {x.dtype}{tuple(x.shape)} "
                             f"is not 1-D with at least {n} rows")
    kinds = [lane_kind(x) for x in lanes]
    nl = len(lanes)
    # pointers, kinds and the seeded stats cross in one pinned copy
    buf = kernels.device_int64s(
        [x.data_ptr() for x in lanes] + kinds + _seed(kinds), lanes[0].device)
    stats = buf[2 * nl:]
    if n == 0:
        return stats
    lib = kernels.library("fetch_pack")
    kernels.check(lib, lib.srt_lane_stats(
        buf.data_ptr(), nl, n, stats.data_ptr(), kernels.stream(buf)),
        "lane_stats")
    lane_stats.launches += 1
    return stats


lane_stats.launches = 0


# ---------------------------------------------------------------------------
# the transfer plan
# ---------------------------------------------------------------------------

def build_plan(lanes: Sequence[torch.Tensor], stats: Sequence[int],
               offsets_lanes: Sequence[int] = ()
               ) -> Tuple[Tuple[tuple, ...], List[int]]:
    """Per-lane transfer steps and minima by the reference's rules
    (``_build_plan``): ("skip",) | ("bit",) | ("narrow", bytes) |
    ("none",).  The span is taken in Python ints: max - min overflows
    int64 at the extremes.  A bool lane bit-packs when its capacity is a
    multiple of 8, as in the reference (the port packs the live rows and
    could pack any lane; the plan is kept the reference's).  An offsets
    lane (``offsets_lanes``) narrows over its full lane's minimum, 0."""
    plan: List[tuple] = []
    mins: List[int] = []
    for i, lane in enumerate(lanes):
        s1, s2 = int(stats[2 * i]), int(stats[2 * i + 1])
        if i in offsets_lanes:
            s1 = 0
        kind = lane_kind(lane)
        if kind == KIND_BOOL:
            if s1:
                plan.append(("skip",))
            elif lane.shape[0] % 8 == 0:
                plan.append(("bit",))
            else:
                plan.append(("none",))
            mins.append(0)
            continue
        if kind in _INT_RANGE:
            size = lane.element_size()
            span = s2 - s1
            if 0 <= span < (1 << 8):
                plan.append(("narrow", 1))
            elif 0 <= span < (1 << 16):
                plan.append(("narrow", 2))
            elif 0 <= span < (1 << 32) and size > 4:
                plan.append(("narrow", 4))
            else:
                plan.append(("none",))
            mins.append(s1)
            continue
        plan.append(("none",))
        mins.append(0)
    return tuple(plan), mins


def _wire_bytes(lane: torch.Tensor, step: tuple) -> int:
    """Bytes a row on the wire; 0 for a bit-packed lane."""
    if step[0] == "bit":
        return 0
    if step[0] == "narrow":
        return step[1]
    return lane.element_size()


def layout(lanes: Sequence[torch.Tensor], plan: Sequence[tuple], n: int
           ) -> Tuple[List[Tuple[int, int]], int]:
    """(offset, bytes) of every lane's slice in the packed buffer, (0, 0)
    for a skipped lane, and the buffer's size: slices in lane order, each
    starting 8-byte aligned."""
    slices, off = [], 0
    for lane, step in zip(lanes, plan):
        if step[0] == "skip":
            slices.append((0, 0))
            continue
        w = _wire_bytes(lane, step)
        size = (n + 7) // 8 if w == 0 else n * w
        slices.append((off, size))
        off += (size + 7) // 8 * 8
    return slices, off


# ---------------------------------------------------------------------------
# K10: the pack
# ---------------------------------------------------------------------------

def pack_bits_plain(x: torch.Tensor) -> torch.Tensor:
    """uint8[ceil(n / 8)]: bool[n] 8 rows a byte, least significant bit
    first; the spare bits of the last byte are 0."""
    n = int(x.shape[0])
    m = (n + 7) // 8
    padded = torch.zeros(m * 8, dtype=torch.uint8, device=x.device)
    padded[:n] = x.to(torch.uint8)
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=x.device)
    return (padded.view(m, 8) * weights).sum(1).to(torch.uint8)


def pack_lanes_plain(lanes: Sequence[torch.Tensor], plan: Sequence[tuple],
                     mins: Sequence[int], n: int, extra: int = 0
                     ) -> torch.Tensor:
    """Plain version of K10: torch ops per lane, then one ``torch.cat``
    (and ``extra`` zero bytes)."""
    kernels.require_row_lanes("pack_lanes", lanes)
    slices, total = layout(lanes, plan, n)
    total += extra
    dev = lanes[0].device if lanes else torch.device("cpu")
    pieces, at = [], 0
    for lane, step, minv, (off, size) in zip(lanes, plan, mins, slices):
        if step[0] == "skip":
            continue
        x = lane[:n]
        if step[0] == "bit":
            piece = pack_bits_plain(x)
        elif step[0] == "narrow":
            d = x.to(torch.int64) - minv
            piece = d.to(_NARROW_TORCH[step[1]]).view(torch.uint8)
        else:
            piece = x.contiguous().view(torch.uint8)
        if off > at:
            pieces.append(torch.zeros(off - at, dtype=torch.uint8,
                                      device=dev))
        pieces.append(piece)
        at = off + size
    if total > at:
        pieces.append(torch.zeros(total - at, dtype=torch.uint8, device=dev))
    if not pieces:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    return torch.cat(pieces)


def pack_lanes(lanes: Sequence[torch.Tensor], plan: Sequence[tuple],
               mins: Sequence[int], n: int, extra: int = 0) -> torch.Tensor:
    """The kept lanes' live rows packed into one uint8 buffer by the plan,
    laid out as ``layout`` says (K10), and ``extra`` bytes after them
    for the caller to fill."""
    if len(plan) != len(lanes) or len(mins) != len(lanes):
        raise ValueError("pack_lanes: one plan step and one min a lane")
    if not lanes or lanes[0].device.type == "cpu":
        return pack_lanes_plain(lanes, plan, mins, n, extra)
    kernels.require_cuda("pack_lanes", *lanes)
    kernels.require_row_lanes("pack_lanes", lanes)
    slices, total = layout(lanes, plan, n)
    dev = lanes[0].device
    out = torch.empty(total + extra, dtype=torch.uint8, device=dev)
    desc = []
    for lane, step, minv, (off, size) in zip(lanes, plan, mins, slices):
        if step[0] == "skip":
            continue
        if lane.dim() != 1 or lane.shape[0] < n or \
                lane.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"pack_lanes: lane {lane.dtype}"
                             f"{tuple(lane.shape)} cannot be packed")
        if step[0] == "narrow" and lane_kind(lane) not in _INT_RANGE:
            raise ValueError("pack_lanes: only integer lanes narrow")
        end = off + (size + 7) // 8 * 8
        desc += [lane.data_ptr(), lane.element_size(),
                 _wire_bytes(lane, step), off, end,
                 minv if step[0] == "narrow" else 0]
    if n == 0 or not desc:
        return out.zero_()
    if extra:
        out[total:].zero_()
    lib = kernels.library("fetch_pack")
    d = kernels.device_int64s(desc, dev)
    kernels.check(lib, lib.srt_pack_lanes(
        d.data_ptr(), len(desc) // 6, n, out.data_ptr(), kernels.stream(out)),
        "pack_lanes")
    pack_lanes.launches += 1
    return out


pack_lanes.launches = 0


# ---------------------------------------------------------------------------
# the pinned staging buffer and the host rebuild
# ---------------------------------------------------------------------------

_staging_lock = threading.Lock()
_staging: Dict[torch.device, torch.Tensor] = {}


def staging_buffer(device: torch.device, nbytes: int) -> torch.Tensor:
    """A pinned host uint8 buffer of at least ``nbytes`` for ``device``'s
    fetches, kept and grown (to the next power of two) as needed; the
    caller holds ``_staging_lock`` while it uses the buffer."""
    buf = _staging.get(device)
    if buf is None or buf.shape[0] < nbytes:
        size = 1 << max(nbytes - 1, 1).bit_length()
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        _staging[device] = buf
    return buf


def _widen(raw: torch.Tensor, width: int, dtype: torch.dtype, minv: int,
           span: int, n: int) -> torch.Tensor:
    """A narrowed lane back at ``dtype``: value = min + unsigned wire
    value.  The wire bytes are read as a signed view (torch's CPU ops
    want signed widths), so the sign extension is masked off only where
    the span reaches the top bit, and the min is added only where it is
    not 0."""
    out = torch.empty(n, dtype=dtype)
    out.copy_(raw.view(_NARROW_TORCH[width])[:n])
    if width > 1 and span >= 1 << (8 * width - 1):
        out.bitwise_and_((1 << (8 * width)) - 1)
    if minv:
        out.add_(minv)
    return out


class _Group:
    """Columns fetched with one row count: the batch's columns, or an
    ARRAY's or MAP's children (their count the parent's child total).
    Each group has its own K9 stats, plan and K10 buffer."""

    def __init__(self, cols: Sequence[DeviceColumn], n: int):
        self.cols, self.n = list(cols), n
        self.lanes = [x for c in self.cols for x in _column_lanes(c)]
        self.spans, self.span_cols = _span_lanes(self.cols)
        self.kids: Dict[int, "_Group"] = {}     # id(column) -> children

    def plan(self, stats: List[int]) -> None:
        """The transfer plan from the stats; each string or binary
        column's bytes after the row lanes, 8-byte aligned (the offsets
        lane's max is the byte count), and each ARRAY's or MAP's children
        as a group of their own (the max is the child total)."""
        self.stats = stats
        self.plan_, self.mins = build_plan(self.lanes, stats, self.spans)
        self.slices, self.rows_end = layout(self.lanes, self.plan_, self.n)
        self.char_slices, total = [], self.rows_end
        for j, c in zip(self.spans, self.span_cols):
            inner = int(stats[2 * j + 1])
            if t.is_span(c.dtype):
                self.char_slices.append((total, inner))
                total += (inner + 7) // 8 * 8
            elif inner > _INT32_MAX:
                raise ValueError(f"a nested column of {inner} child rows "
                                 f"exceeds the 2^31-1 rows of int32 offsets")
            else:
                self.kids[id(c)] = _Group(c.children, inner)
        self.total = total

    def pack(self) -> torch.Tensor:
        packed = pack_lanes(self.lanes, self.plan_, self.mins, self.n,
                            self.total - self.rows_end)
        chars = [c for c in self.span_cols if t.is_span(c.dtype)]
        for c, (off, size) in zip(chars, self.char_slices):
            packed[off:off + size].copy_(c.data[:size])
        return packed


_INT32_MAX = 2**31 - 1


def _levels(root: _Group) -> List[List[_Group]]:
    """The groups of a fetch, level by level: each level's K9 stats are
    read in one host read, which gives the next level's row counts."""
    levels, level = [], [root]
    while level:
        stats = [lane_stats(g.lanes, g.n) for g in level]
        flat = torch.cat(stats).tolist()           # the level's one read
        at = 0
        for g in level:
            g.plan(flat[at:at + 2 * len(g.lanes)])
            at += 2 * len(g.lanes)
        levels.append(level)
        level = [k for g in level for k in g.kids.values() if k.n > 0]
    return levels


def _rebuild_columns(g: _Group, host: torch.Tensor,
                     hosts: Dict[int, torch.Tensor]) -> List[DeviceColumn]:
    """``HostColumn``s of a group's live rows from its packed bytes in
    ``host``, every lane copied out of it; an ARRAY's or MAP's children
    from their own group's bytes (``hosts``, by group id)."""
    n, lanes, plan, mins, stats = g.n, g.lanes, g.plan_, g.mins, g.stats
    at = 0
    chars_at = iter(g.char_slices)

    def lane(j):
        step, (off, size) = plan[j], g.slices[j]
        raw = host[off:off + size]
        if step[0] == "skip":
            return None
        if step[0] == "bit":
            return raw.clone()
        if step[0] == "narrow":
            return _widen(raw, step[1], lanes[j].dtype, mins[j],
                          int(stats[2 * j + 1]) - mins[j], n)
        return raw.view(lanes[j].dtype)[:n].clone()

    def bitmap(j):
        valid = lane(j)
        if plan[j][0] == "none":             # bytes: make the bitmap
            valid = pack_bits_plain(valid)
        return valid

    def build(c):
        nonlocal at
        j0 = at
        if isinstance(c.dtype, t.StructType):
            at += 1
            kids = [build(k) for k in c.children]
            return HostColumn(c.dtype, None, bitmap(j0), None, None, kids,
                              rows=n)
        at += len(_column_lanes(c))
        data, valid = lane(j0), bitmap(j0 + 1)
        if c.offsets is not None:
            offs = torch.zeros(n + 1, dtype=torch.int32)
            offs[1:] = data
            if t.is_span(c.dtype):
                off, size = next(chars_at)
                return HostColumn(c.dtype, host[off:off + size].clone(),
                                  valid, offs)
            kid = g.kids[id(c)]
            kids = _rebuild_columns(kid, hosts[id(kid)], hosts) if kid.n \
                else [_empty_host(k.dtype) for k in c.children]
            return HostColumn(c.dtype, None, valid, offs, None, kids)
        if plan[j0][0] == "skip":                # a BOOLEAN lane, all true
            data = torch.ones(n, dtype=torch.bool)
        elif plan[j0][0] == "bit":
            data = unpack_bits(data, n)
        return HostColumn(c.dtype, data, valid, None,
                          lane(j0 + 2) if c.data_hi is not None else None)
    return [build(c) for c in g.cols]


def _empty_host(dtype: t.DataType) -> HostColumn:
    """A column of no rows."""
    if isinstance(dtype, t.StructType):
        return HostColumn(dtype, None, None, None, None,
                          [_empty_host(f.data_type) for f in dtype.fields],
                          rows=0)
    if isinstance(dtype, (t.ArrayType, t.MapType)):
        return HostColumn(dtype, None, None, torch.zeros(1, dtype=torch.int32),
                          None, [_empty_host(k) for k in t.child_types(dtype)])
    if t.is_span(dtype):
        return HostColumn(dtype, torch.zeros(0, dtype=torch.uint8), None,
                          torch.zeros(1, dtype=torch.int32))
    return HostColumn(dtype, torch.zeros(0, dtype=dtype.torch_dtype), None,
                      None, torch.zeros(0, dtype=torch.int64)
                      if t.is_dec128(dtype) else None)


def fetch_batch(batch: DeviceBatch) -> DeviceBatch:
    """A batch's live rows on the host, as ``HostColumn``s: one read of
    the lane stats (K9), one packed buffer (K10) and, for a batch on the
    card, one ``cudaMemcpyAsync`` of it into the pinned staging buffer,
    then the host rebuild.  An ARRAY's or MAP's children come as a group
    of their own, at their own row count, which the parent's offsets
    lane's stats give: one K9 launch a group and one host read of the
    stats a nesting level, one K10 launch a group, every group's buffer
    copied into the one staging buffer before the one wait.  A batch on
    the CPU takes the same steps through the plain versions; one with no
    live rows moves as ``move_batch`` moves it (one row a lane)."""
    n = batch.num_rows
    if not batch.columns or n == 0:
        return move_batch(batch, torch.device("cpu"), live_only=True)
    root = _Group(batch.columns, n)
    groups = [g for level in _levels(root) for g in level]
    packed = [g.pack() for g in groups]
    if packed[0].device.type == "cpu":
        hosts = {id(g): p for g, p in zip(groups, packed)}
        return DeviceBatch(_rebuild_columns(root, packed[0], hosts), n,
                           batch.names)
    total = sum(g.total for g in groups)
    with _staging_lock:
        host = staging_buffer(batch.device, total)
        hosts, at = {}, 0
        for g, p in zip(groups, packed):
            hosts[id(g)] = host[at:at + g.total]
            hosts[id(g)].copy_(p, non_blocking=True)
            at += g.total
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(batch.device))
        done.synchronize()
        return DeviceBatch(_rebuild_columns(root, hosts[id(root)], hosts), n,
                           batch.names)
