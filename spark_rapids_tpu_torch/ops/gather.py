"""Row gather over device columns.

Counterpart of spark_rapids_tpu/ops/gather.py: row i of the output is
row ``indices[i]`` of the input, and null where ``valid[i]`` is False.
A string or binary column takes the span branch (the reference's
``gather_spans``): K16 (ops/strings.py:gather_strings) writes its new
offsets and copies its bytes, and the totals of every span column of
one gather are read to the host together, once.  An ARRAY or MAP takes
the same first launch over its offsets, then K18 ``span_rows``
(``csrc/span_rows.cu``, the child branch of ``gather_spans``) turns the
gathered spans into child rows, and its children are gathered through
them, a nesting level at a time; a STRUCT's children take its rows.
``gather_rows`` moves row lanes through a sort's order with kernel K8
(``csrc/gather_rows.cu``: one pass a lane, or the source rows packed
into records and one record read a row, as ``gather_plan`` chooses by
the bytes each moves); a nested column's lanes move through it too.
``scatter_rows``, its dual, moves them back to input order with kernel
K13 (``csrc/scatter_rows.cu``).  Each wrapper takes its plain version for
CPU tensors only, launches its kernel for CUDA tensors or raises, and
counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from .. import types as t
from ..columnar.device import (DEFAULT_CHAR_BUCKETS, DeviceBatch,
                               DeviceColumn, bucket_for)
from . import strings as sops

_MAX_LANES = 16          # lanes a launch (kMaxLanes in csrc)


def gather_rows_plain(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Plain version of K8: one ``index_select`` per lane."""
    idx = order.to(torch.int64)
    return [x.index_select(0, idx) for x in lanes]


_RECORD_SIZES = (16, 32, 64)       # K8's record widths
# K8 keeps the single pass while the source lanes are at most this many
# bytes: its random reads then mostly hit the 50 MB L2.  The H100 sweep
# in chip_smoke.py (_k8_sweep) found the single pass faster at 57 MB of
# q3's lanes and the record path faster at 113 MB.
_GATHER_SINGLE_BYTES = 96 << 20


def record_layout(widths: Sequence[int]) -> Tuple[int, List[int]]:
    """K8's row record for lanes of ``widths`` bytes: (record bytes, each
    lane's byte offset).  Each lane sits at the first free offset that is
    a multiple of its width, the widest lanes first, so the holes fill.
    The record is 16, 32 or 64 bytes, or 0 when the lanes need more."""
    used: List[bool] = []
    offsets = [0] * len(widths)
    for j in sorted(range(len(widths)), key=lambda j: -widths[j]):
        w = widths[j]
        off = 0
        while any(used[off:off + w]):
            off += w
        used.extend([False] * (off + w - len(used)))
        used[off:off + w] = [True] * w
        offsets[j] = off
    size = next((r for r in _RECORD_SIZES if r >= len(used)), 0)
    return size, offsets


def gather_chunks(widths: Sequence[int], packed: bool) -> List[List[int]]:
    """The lanes (indices into ``widths``) of each K8 launch: 16 a launch
    on the single pass; on the record path as many as one record of at
    most 64 bytes holds, at most 16."""
    chunks: List[List[int]] = []
    for j in range(len(widths)):
        if chunks and len(chunks[-1]) < _MAX_LANES and (
                not packed or record_layout(
                    [widths[i] for i in chunks[-1] + [j]])[0]):
            chunks[-1].append(j)
        else:
            chunks.append([j])
    return chunks


class GatherPlan(NamedTuple):
    """How K8 moves ``n`` rows out of lanes of ``m`` rows: through row
    records (packed) or on the single pass, with the device-memory bytes
    each path moves (a random read counted as the 32-byte sector it
    pulls) and the scratch bytes the record path takes (the widest
    chunk's record for each of the ``m`` source rows)."""
    packed: bool
    single_bytes: int
    packed_bytes: int
    scratch_bytes: int


def gather_plan(n: int, m: int, lane_bytes: Sequence[int]) -> GatherPlan:
    """K8's plan: the record path where it moves fewer bytes and the
    source lanes outgrow ``_GATHER_SINGLE_BYTES`` (below that the single
    pass's random reads mostly hit L2).  The single pass reads the order and one
    sector a lane for each row and writes the lanes: n (36 L + S) for L
    lanes of S bytes.  The record path packs the m source rows into
    records of R bytes and reads one record a row: m (S + R) + n (4 + R +
    S), a chunk at a time."""
    sizes = [(sum(lane_bytes[i] for i in c),
              record_layout([lane_bytes[i] for i in c])[0])
             for c in gather_chunks(lane_bytes, True)]
    single = n * (36 * len(lane_bytes) + sum(lane_bytes))
    packed = sum(m * (s + r) + n * (4 + r + s) for s, r in sizes)
    use = packed < single and m * sum(lane_bytes) > _GATHER_SINGLE_BYTES
    return GatherPlan(use, single, packed,
                      m * max((r for _, r in sizes), default=0) if use
                      else 0)


def gather_rows(order: torch.Tensor, lanes: Sequence[torch.Tensor],
                packed: Optional[bool] = None) -> List[torch.Tensor]:
    """``out[l][i] = lanes[l][order[i]]`` (K8): ``order`` is int32[n], as
    K2 returns it, and may repeat rows; each lane is 1-D with 1, 4 or
    8-byte elements and holds every row the order names.  ``packed``
    forces K8's path (default: ``gather_plan``)."""
    if order.dtype != torch.int32 or order.dim() != 1:
        raise TypeError(f"gather_rows: order must be int32[n], got "
                        f"{order.dtype}{tuple(order.shape)}")
    kernels.require_row_lanes("gather_rows", lanes)
    if order.device.type == "cpu":
        return gather_rows_plain(order, lanes)
    kernels.require_cuda("gather_rows", order, *lanes)
    for x in lanes:
        if x.dim() != 1 or x.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"gather_rows: lane {x.dtype}{tuple(x.shape)} "
                            f"is not 1-D with 1, 2, 4 or 8-byte elements")
    n = int(order.shape[0])
    outs = [torch.empty(n, dtype=x.dtype, device=x.device) for x in lanes]
    if n == 0 or not lanes:
        return outs
    lib = kernels.library("gather_rows")
    st = kernels.stream(order)
    widths = [x.element_size() for x in lanes]
    m = min(int(x.shape[0]) for x in lanes)   # rows every lane holds
    plan = gather_plan(n, m, widths)
    use = plan.packed if packed is None else packed
    chunks = gather_chunks(widths, use)
    layouts = [record_layout([widths[i] for i in c]) for c in chunks]
    # the record path: one buffer of records, for every chunk in turn
    records = torch.empty(m * max(r for r, _ in layouts) if use else 0,
                          dtype=torch.uint8, device=order.device)
    for c, (size, offsets) in zip(chunks, layouts):
        args = (len(c), kernels.pointers([lanes[i] for i in c]),
                kernels.pointers([outs[i] for i in c]),
                kernels.ints(widths[i] for i in c))
        if use:
            err = lib.srt_gather_packed(
                order.data_ptr(), n, m, *args, kernels.ints(offsets), size,
                records.data_ptr(), st)
        else:
            err = lib.srt_gather_rows(order.data_ptr(), n, *args, st)
        kernels.check(lib, err, "gather_rows")
        gather_rows.launches += 1
    return outs


gather_rows.launches = 0


def _check_lanes(what: str, order: torch.Tensor,
                 lanes: Sequence[torch.Tensor]) -> None:
    if order.dtype != torch.int32 or order.dim() != 1:
        raise TypeError(f"{what}: order must be int32[n], got "
                        f"{order.dtype}{tuple(order.shape)}")
    n = order.shape[0]
    for x in lanes:
        if x.shape != (n,) or x.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"{what}: lane {x.dtype}{tuple(x.shape)} is not "
                            f"[{n}] with 1, 4 or 8-byte elements")


def scatter_rows_plain(order: torch.Tensor, lanes: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """Plain version of K13: one indexed assignment per lane."""
    idx = order.to(torch.int64)
    outs = []
    for x in lanes:
        out = torch.empty_like(x)
        out[idx] = x
        outs.append(out)
    return outs


_BUCKET_BITS = 8                   # 256 buckets (kBuckets in csrc)
_SINGLE_PASS_BYTES = 48 << 20      # outputs this small stay in L2


class ScatterPlan(NamedTuple):
    """How K13 moves ``n`` rows of lanes of ``lane_bytes`` bytes: binned
    (two passes through a binned copy) or single, the bucket shift (the
    destination's bits below the 8 that name its bucket) and the scratch
    bytes the binned copy takes (4 B of destination and the lanes a
    row)."""
    binned: bool
    shift: int
    scratch_bytes: int


def scatter_plan(n: int, lane_bytes: Sequence[int]) -> ScatterPlan:
    """K13's plan: the single pass while the output fits in
    ``_SINGLE_PASS_BYTES`` (its random partial writes then merge in L2),
    else the binned path over at most 256 buckets of destinations."""
    shift = max(0, (n - 1).bit_length() - _BUCKET_BITS) if n > 0 else 0
    binned = n * sum(lane_bytes) > _SINGLE_PASS_BYTES
    return ScatterPlan(binned, shift,
                       n * (4 + sum(lane_bytes)) if binned else 0)


def scatter_rows(order: torch.Tensor, lanes: Sequence[torch.Tensor],
                 binned: Optional[bool] = None) -> List[torch.Tensor]:
    """``out[l][order[i]] = lanes[l][i]`` (K13), the inverse of
    ``gather_rows``: rows sorted by K2's ``order`` go back to input order.
    ``order`` is a permutation, int32[n]; each lane is [n] with 1, 4 or
    8-byte elements.  ``binned`` forces K13's path (default:
    ``scatter_plan``)."""
    _check_lanes("scatter_rows", order, lanes)
    kernels.require_row_lanes("scatter_rows", lanes)
    if order.device.type == "cpu":
        return scatter_rows_plain(order, lanes)
    kernels.require_cuda("scatter_rows", order, *lanes)
    n = int(order.shape[0])
    outs = [torch.empty_like(x) for x in lanes]
    if n == 0 or not lanes:
        return outs
    lib = kernels.library("scatter_rows")
    for s in range(0, len(lanes), _MAX_LANES):
        chunk, out_chunk = lanes[s:s + _MAX_LANES], outs[s:s + _MAX_LANES]
        widths = [x.element_size() for x in chunk]
        plan = scatter_plan(n, widths)
        use_bins = plan.binned if binned is None else binned
        cursor = bins = dest = None
        if use_bins:
            cursor = torch.zeros(1 << _BUCKET_BITS, dtype=torch.int32,
                                 device=order.device)
            dest = torch.empty(n, dtype=torch.int32, device=order.device)
            bins = [torch.empty_like(x) for x in chunk]
        kernels.check(lib, lib.srt_scatter_rows(
            order.data_ptr(), n, len(chunk), kernels.pointers(chunk),
            kernels.pointers(out_chunk), kernels.ints(widths), plan.shift,
            0 if cursor is None else cursor.data_ptr(),
            0 if dest is None else dest.data_ptr(),
            kernels.pointers(bins or []), kernels.stream(order)),
            "scatter_rows")
        scatter_rows.launches += 1
    return outs


scatter_rows.launches = 0


# ---------------------------------------------------------------------------
# K18: the child rows of gathered spans
# ---------------------------------------------------------------------------

def span_rows_plain(starts: torch.Tensor, new_offsets: torch.Tensor,
                    total: int, child_cap: int) -> torch.Tensor:
    """Plain version of K18: each output child slot's row by
    ``repeat_interleave`` of the new spans' lengths, a step of rows at a
    time (as ``ops/strings.py:copy_spans_plain``), then its source child
    row ``starts[row] + p - new_offsets[row]``; 0 from ``total`` on."""
    dev = starts.device
    out = torch.zeros(child_cap, dtype=torch.int32, device=dev)
    n = int(starts.shape[0])
    for s in range(0, n, sops._PLAIN_ROWS):
        e = min(s + sops._PLAIN_ROWS, n)
        first, last = int(new_offsets[s]), int(new_offsets[e])
        if last == first:
            continue
        lens = (new_offsets[s + 1:e + 1] - new_offsets[s:e]).to(torch.int64)
        row = torch.repeat_interleave(torch.arange(s, e, device=dev), lens)
        p = torch.arange(first, last, dtype=torch.int64, device=dev)
        out[first:last] = (starts[row].to(torch.int64) + p -
                           new_offsets[row].to(torch.int64)).to(torch.int32)
    return out


def span_rows(starts: torch.Tensor, new_offsets: torch.Tensor, total: int,
              child_cap: int) -> torch.Tensor:
    """int32[child_cap]: for each output child slot p < ``total`` the
    source child row ``starts[r] + p - new_offsets[r]``, r the row whose
    new span holds p; 0 from ``total`` on (K18, ``csrc/span_rows.cu``).
    ``starts`` and ``new_offsets`` come from K16's first launch
    (``ops/strings.py:gather_offsets``), ``total`` is
    ``new_offsets[-1]``, read by the caller."""
    if starts.dtype != torch.int32 or new_offsets.dtype != torch.int32 or \
            new_offsets.shape != (starts.shape[0] + 1,):
        raise TypeError(f"span_rows: starts int32[n] and new_offsets "
                        f"int32[n + 1], got {starts.dtype}"
                        f"{tuple(starts.shape)} and {new_offsets.dtype}"
                        f"{tuple(new_offsets.shape)}")
    if not 0 <= total <= min(child_cap, sops._INT32_MAX):
        raise ValueError(f"span_rows: {total} child rows into {child_cap}; "
                         f"at most 2^31-1")
    if starts.device.type == "cpu":
        return span_rows_plain(starts, new_offsets, total, child_cap)
    kernels.require_cuda("span_rows", starts, new_offsets)
    n = int(starts.shape[0])
    if n == 0 or total == 0:
        return torch.zeros(child_cap, dtype=torch.int32, device=starts.device)
    out = torch.empty(child_cap, dtype=torch.int32, device=starts.device)
    lib = kernels.library("span_rows")
    kernels.check(lib, lib.srt_span_rows(
        starts.data_ptr(), new_offsets.data_ptr(), n, total, out.data_ptr(),
        child_cap, kernels.stream(starts)), "span_rows")
    span_rows.launches += 1
    return out


span_rows.launches = 0


# ---------------------------------------------------------------------------
# the column gather
# ---------------------------------------------------------------------------

class _Node:
    """One non-flat column (or a flat child of a nested one) in a gather:
    the order and validity it is gathered by, its new validity, and for
    a span column K16's new offsets, total and source starts."""
    __slots__ = ("col", "parent", "order", "valid", "offs", "total",
                 "starts", "kids", "out")

    def __init__(self, col: DeviceColumn, parent: Optional["_Node"] = None):
        self.col = col
        self.parent = parent
        self.order = self.valid = None
        self.offs = self.total = self.starts = None
        self.kids: List[_Node] = []
        self.out: Optional[DeviceColumn] = None


def _tree(col: DeviceColumn, parent=None) -> List["_Node"]:
    """A column's node and its STRUCT descendants' (row-aligned with it),
    parents first."""
    node = _Node(col, parent)
    nodes = [node]
    if isinstance(col.dtype, t.StructType):
        for k in col.children:
            sub = _tree(k, node)
            node.kids.append(sub[0])
            nodes += sub
    return nodes


def _zeroed(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def _gather_lanes(nodes: List["_Node"], order: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> None:
    """One level's row lanes through K8 (one call, every validity lane
    and every flat column's data): each node's new validity is its own
    ANDed with its parent's new validity (a STRUCT's) or with ``valid``,
    and the data under a new null is zeroed."""
    lanes = []
    for n in nodes:
        n.order = order
        lanes.append(n.col.validity)
        if n.col.is_flat:
            lanes += [n.col.data] + ([] if n.col.data_hi is None
                                     else [n.col.data_hi])
    moved = iter(gather_rows(order, lanes))
    for n in nodes:                       # parents first
        v = next(moved)
        base = valid if n.parent is None else n.parent.valid
        n.valid = v if base is None else v & base
        c = n.col
        if c.is_flat:
            data = _zeroed(next(moved), n.valid)
            hi = None if c.data_hi is None else _zeroed(next(moved), n.valid)
            n.out = DeviceColumn(c.dtype, data, n.valid, None, hi)


def _child_level(n: "_Node"):
    """An ARRAY's or MAP's children as the next level: K18 turns the
    gathered spans into child rows; slots past the total are out of
    range."""
    cap = bucket_for(max(n.total, 1))
    src = span_rows(n.starts, n.offs, n.total, cap)
    in_range = torch.arange(cap, device=src.device) < n.total
    nodes = []
    for k in n.col.children:
        tree = _tree(k)
        n.kids.append(tree[0])
        nodes += tree
    return nodes, src, in_range


def _build(node: "_Node") -> DeviceColumn:
    if node.out is not None:
        return node.out
    return DeviceColumn(node.col.dtype, None, node.valid, node.offs, None,
                        [_build(k) for k in node.kids])


def gather_columns(cols: Sequence[DeviceColumn], indices: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   span_bytes: Optional[Sequence[Optional[int]]] = None
                   ) -> List[DeviceColumn]:
    """Every column's rows ``indices``, null where ``valid`` is False (or
    the source row is null).  A string or binary column goes through
    K16: all span offsets first, then one host read of their totals
    (none for a top-level column whose total the caller knows:
    ``span_bytes[k]`` for column k, None where it does not), then the
    copies.  A nested column (the reference's ``gather_column`` ARRAY,
    MAP and STRUCT branches) moves level by level: its row lanes and its
    STRUCT descendants' through K8, the offsets of its span columns
    through K16's first launch, then, after one host read of every total
    of the level, the bytes through K16's copy and an ARRAY's or MAP's
    child rows through K18, its children making the next level; a
    STRUCT's children take its rows with its new validity ANDed in."""
    if not cols:
        return []
    idx = indices.to(torch.int64)
    order = indices.to(torch.int32)
    out: List[Optional[DeviceColumn]] = [None] * len(cols)
    known = {}                   # node -> a total the caller gave
    first: List[_Node] = []      # top-level string and binary columns
    roots: List[Tuple[int, _Node]] = []
    level = []
    for k, c in enumerate(cols):
        if c.is_flat or t.is_span(c.dtype):
            validity = c.validity[idx]
            if valid is not None:
                validity = validity & valid
        if c.is_flat:
            data = c.data[idx]
            hi = None if c.data_hi is None else c.data_hi[idx]
            if valid is not None:
                data = _zeroed(data, validity)
                if hi is not None:
                    hi = _zeroed(hi, validity)
            out[k] = DeviceColumn(c.dtype, data, validity, None, hi)
            continue
        if t.is_span(c.dtype):
            node = _Node(c)
            node.order, node.valid = order, validity
            first.append(node)
        else:
            tree = _tree(c)
            level += tree
            node = tree[0]
        roots.append((k, node))
        if span_bytes is not None and span_bytes[k] is not None:
            known[node] = span_bytes[k]
    levels = [(level, order, valid)] if level else []
    while first or levels:
        spans = list(first)
        for nodes, ordr, vld in levels:
            _gather_lanes(nodes, ordr, vld)
            spans += [n for n in nodes if n.col.offsets is not None]
        for n in spans:
            n.offs, n.total, n.starts = sops.gather_offsets(
                n.col.offsets, n.order, n.valid)
        unknown = [n for n in spans if n not in known]
        for n, v in zip(unknown, sops.read_totals([n.total
                                                   for n in unknown])):
            n.total = v
        for n in spans:
            n.total = known.get(n, n.total)
            if t.is_span(n.col.dtype):
                n.out = DeviceColumn(n.col.dtype, sops.gather_chars(
                    n.col.data, n.starts, n.offs, n.total,
                    bucket_for(max(n.total, 1), DEFAULT_CHAR_BUCKETS)),
                    n.valid, n.offs)
        levels = [_child_level(n) for n in spans
                  if not t.is_span(n.col.dtype)]
        first = []
    for k, node in roots:
        out[k] = _build(node)
    return out


def gather_column(col: DeviceColumn, indices: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    return gather_columns([col], indices, valid)[0]


def gather_batch(batch: DeviceBatch, indices: torch.Tensor,
                 valid: Optional[torch.Tensor], num_rows: int) -> DeviceBatch:
    return DeviceBatch(gather_columns(batch.columns, indices, valid),
                       num_rows, batch.names)
