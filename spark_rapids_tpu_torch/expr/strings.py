"""String functions over the span layout (offsets int32[cap + 1] over
uint8 chars).

Counterpart of spark_rapids_tpu/expr/strings.py: Upper, Lower, Length,
Ascii, BitLength, Substring, Concat, ConcatWs, Trim, TrimLeft,
TrimRight, Contains, StartsWith, EndsWith, Like, StringReplace,
StringRepeat, Reverse, StringLocate, StringLPad, StringRPad, InitCap and
SubstringIndex.  The kernels (``ops/strings.py``):

* K19 ``string_find``: contains, startswith, endswith, locate, the
  delimiter count of substring_index, and a LIKE pattern (its tokens
  between ``%`` in one launch, each from where the one before ended;
  ``_`` matches one byte, not one character, as in the reference), and
  the match mask of replace;
* K20 ``utf8_cut``: length (UTF-8 lead bytes), the byte cut of substring
  (Spark's pos rules) and of the trims (spaces only); the cut is copied
  by K16's copy (``gather_chars``);
* K21 ``string_map``: upper, lower and initcap (ASCII letters only, as in
  the reference) and reverse, which reverses UTF-8 characters (Spark's
  answer; the reference reverses bytes);
* torch compositions: concat, the pads (which count bytes, as the
  reference's do), repeat (at most 64 times), replace's output, ascii
  and bit_length.

The search arguments of contains, startswith, endswith, like, replace
and locate must be literals (the rule's tag); replace refuses a pattern
that overlaps itself, as the reference does.  concat_ws and a
substring_index whose delimiter is not one byte evaluate on the host
engine only (``expr/host_strings.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types as t
from ..columnar.device import DEFAULT_CHAR_BUCKETS, DeviceColumn, bucket_for
from ..ops import strings as so
from .core import (ColumnValue, EvalContext, Expression, Literal,
                   and_validity, data_of, evaluator, make_column,
                   validity_of)
from .host_strings import build_string_column, host_only, host_string_rows


def _col(ctx: EvalContext, v) -> DeviceColumn:
    """A value as a STRING column (a literal broadcast)."""
    if isinstance(v, ColumnValue):
        return v.col
    return make_column(ctx, t.STRING, v.value,
                       None if v.value is not None else False).col


def _input(ctx: EvalContext, e: Expression) -> DeviceColumn:
    return _col(ctx, e.eval(ctx))


def _literal_bytes(e: Expression) -> Optional[bytes]:
    """A STRING or BINARY literal's bytes (None for anything else)."""
    if isinstance(e, Literal) and isinstance(e.dtype, (t.StringType,
                                                       t.BinaryType)):
        return None if e.value is None else bytes(e.value)
    return None


def _ints(ctx: EvalContext, v) -> torch.Tensor:
    """int64[cap] of an integral value (a literal broadcast)."""
    d = _int_or_column(v)
    if isinstance(d, torch.Tensor):
        return d
    return torch.full((ctx.capacity,), d, dtype=torch.int64,
                      device=ctx.device)


def _int_or_column(v):
    """An integral value as K20 takes it: a literal's int, a column's
    int64[cap]."""
    d = data_of(v)
    if isinstance(d, torch.Tensor):
        return d.to(torch.int64).contiguous()
    return int(d)


def _from_lengths(ctx: EvalContext, lens: torch.Tensor, valid: torch.Tensor):
    """(int32 offsets, byte total) of rows of ``lens`` bytes (0 where not
    ``valid``)."""
    lens = torch.where(valid, lens.to(torch.int64),
                       torch.zeros((), dtype=torch.int64, device=ctx.device))
    offs = torch.zeros(ctx.capacity + 1, dtype=torch.int64, device=ctx.device)
    torch.cumsum(lens, 0, out=offs[1:])
    return offs.to(torch.int32), int(offs[-1])


def _cut(ctx: EvalContext, col: DeviceColumn, b0: torch.Tensor,
         b1: torch.Tensor, valid: torch.Tensor) -> ColumnValue:
    """The bytes [b0, b1) of each row as a new column, copied by K16."""
    offs, total = _from_lengths(ctx, b1 - b0, valid)
    chars = so.gather_chars(col.data, b0.to(torch.int32).contiguous(), offs,
                            total, max(int(col.data.shape[0]), total, 1))
    return ColumnValue(DeviceColumn(t.STRING, chars, valid, offs))


def _spread(ctx: EvalContext, lens: torch.Tensor):
    """(row, position within the row) of every output byte of rows of
    ``lens`` bytes laid end to end."""
    dev = ctx.device
    row = torch.repeat_interleave(
        torch.arange(ctx.capacity, dtype=torch.int64, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    within = torch.arange(row.shape[0], dtype=torch.int64, device=dev) - \
        first[row]
    return row, within


def _span_column(ctx: EvalContext, offs: torch.Tensor, total: int,
                 body: torch.Tensor, valid: torch.Tensor) -> ColumnValue:
    chars = torch.zeros(bucket_for(max(total, 1), DEFAULT_CHAR_BUCKETS),
                        dtype=torch.uint8, device=ctx.device)
    chars[:total] = body
    return ColumnValue(DeviceColumn(t.STRING, chars, valid, offs))


# ---------------------------------------------------------------------------
# unary maps and lengths
# ---------------------------------------------------------------------------

class StringUnary(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return t.STRING


class Upper(StringUnary):
    pass


class Lower(StringUnary):
    pass


class InitCap(StringUnary):
    """The first letter of each word upper case, the rest lower (ASCII)."""


class Reverse(StringUnary):
    """The row's UTF-8 characters in reverse order."""


_MAPS = {Upper: so.MAP_UPPER, Lower: so.MAP_LOWER, InitCap: so.MAP_INITCAP,
         Reverse: so.MAP_REVERSE}


def _eval_map(e: StringUnary, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    out = so.string_map(col.offsets, col.data, _MAPS[type(e)])
    return ColumnValue(DeviceColumn(t.STRING, out, col.validity,
                                    col.offsets))


for _cls in _MAPS:
    evaluator(_cls)(_eval_map)


class Length(StringUnary):
    def data_type(self):
        return t.INT


@evaluator(Length)
def _eval_length(e, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    count, _, _ = so.utf8_cut(col.offsets, col.data, so.CUT_LENGTH)
    return make_column(ctx, t.INT, count, col.validity)


class Ascii(StringUnary):
    """The code point of the first character (a full UTF-8 decode of its
    1-4 bytes); 0 for an empty string."""

    def data_type(self):
        return t.INT


@evaluator(Ascii)
def _eval_ascii(e, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    o0 = col.offsets[:-1]
    lens = so.lengths(col.offsets).to(torch.int64)
    last = max(int(col.data.shape[0]) - 1, 0)

    def byte_at(k):
        idx = (o0.to(torch.int64) + k).clamp(0, last)
        b = col.data[idx].to(torch.int32) if col.data.shape[0] else \
            torch.zeros_like(lens, dtype=torch.int32)
        return torch.where(lens > k, b, torch.zeros_like(b))

    b0, b1, b2, b3 = (byte_at(k) for k in range(4))
    c2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    c3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    c4 = ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | \
        (b3 & 0x3F)
    out = torch.where(b0 < 0x80, b0, torch.where(
        b0 < 0xE0, c2, torch.where(b0 < 0xF0, c3, c4)))
    out = torch.where(lens == 0, torch.zeros_like(out), out)
    return make_column(ctx, t.INT, out, col.validity)


class BitLength(StringUnary):
    def data_type(self):
        return t.INT


@evaluator(BitLength)
def _eval_bitlength(e, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    return make_column(ctx, t.INT, so.lengths(col.offsets) * 8, col.validity)


# ---------------------------------------------------------------------------
# cuts: substring, trim, substring_index
# ---------------------------------------------------------------------------

class Substring(Expression):
    """substring(str, pos[, len]): 1-based, in characters, a negative pos
    counts from the end (Spark)."""

    def __init__(self, child, pos, length=None):
        self.children = (child, pos) + ((length,) if length is not None
                                        else ())

    def data_type(self):
        return t.STRING


@evaluator(Substring)
def _eval_substring(e: Substring, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    pos = _int_or_column(e.children[1].eval(ctx))
    length = _int_or_column(e.children[2].eval(ctx)) \
        if len(e.children) > 2 else None
    _, b0, b1 = so.utf8_cut(col.offsets, col.data, so.CUT_SUBSTRING, pos,
                            length)
    return _cut(ctx, col, b0, b1, col.validity)


class Trim(StringUnary):
    mode = so.CUT_TRIM


class TrimLeft(Trim):
    mode = so.CUT_TRIM_LEFT


class TrimRight(Trim):
    mode = so.CUT_TRIM_RIGHT


def _eval_trim(e: Trim, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    _, b0, b1 = so.utf8_cut(col.offsets, col.data, e.mode)
    return _cut(ctx, col, b0, b1, col.validity)


for _cls in (Trim, TrimLeft, TrimRight):
    evaluator(_cls)(_eval_trim)


class SubstringIndex(Expression):
    """substring_index(str, delim, count): the part before the count-th
    delimiter (from the end when count < 0).  A one-byte delimiter runs
    on the device (K19 counts the delimiters); any other delimiter needs
    a sequential non-overlapping search and stays on the host engine."""

    def __init__(self, child, delim, count):
        self.children = (child,)
        self.delim = delim
        self.count = int(count)

    def data_type(self):
        return t.STRING

    def delim_bytes(self) -> bytes:
        """The delimiter's bytes: the rule's tag and the evaluator both
        gate on their number."""
        return self.delim.encode() if isinstance(self.delim, str) \
            else bytes(self.delim)

    def sql(self):
        return (f"substring_index({self.children[0].sql()}, "
                f"'{self.delim}', {self.count})")


def _substring_index_host(e: SubstringIndex, ctx: EvalContext,
                          col: DeviceColumn) -> ColumnValue:
    """Python's split, which matches Spark's indexOf scan."""
    host_only(ctx, "substring_index with a delimiter of other than one "
                   "byte")
    d = e.delim_bytes().decode("utf-8", "surrogateescape")
    out = []
    for s in host_string_rows(col, ctx.capacity, "surrogateescape"):
        if s is None or e.count == 0 or not d:
            out.append("" if s is not None else None)
        elif e.count > 0:
            out.append(d.join(s.split(d)[:e.count]))
        else:
            out.append(d.join(s.split(d)[e.count:]))
    return build_string_column(ctx, out)


@evaluator(SubstringIndex)
def _eval_substring_index(e: SubstringIndex, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    delim = e.delim_bytes()
    if len(delim) != 1:
        return _substring_index_host(e, ctx, col)
    o0, o1 = col.offsets[:-1], col.offsets[1:]
    if e.count == 0:
        return _cut(ctx, col, o0, o0, col.validity)
    pat = so.FindPattern([delim], repeat=abs(e.count), reverse=e.count < 0)
    hit = so.string_find(col.offsets, col.data, pat)
    if e.count > 0:
        return _cut(ctx, col, o0, torch.where(hit >= 0, hit, o1),
                    col.validity)
    return _cut(ctx, col, torch.where(hit >= 0, hit + 1, o0), o1,
                col.validity)


# ---------------------------------------------------------------------------
# searches: contains, startswith, endswith, like, locate
# ---------------------------------------------------------------------------

class StringPredicate(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self):
        return t.BOOLEAN


class Contains(StringPredicate):
    pass


class StartsWith(StringPredicate):
    pass


class EndsWith(StringPredicate):
    pass


_ANCHOR = {Contains: 0, StartsWith: so.FIND_AT_START,
           EndsWith: so.FIND_AT_END}


def _eval_contains(e: StringPredicate, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    needle = _literal_bytes(e.children[1])
    if needle is None:
        if isinstance(e.children[1], Literal):
            return make_column(ctx, t.BOOLEAN, False, False)
        raise NotImplementedError(f"{type(e).__name__} requires a literal "
                                  f"search argument")
    col = _col(ctx, v)
    if not needle:
        return make_column(ctx, t.BOOLEAN, True, validity_of(v))
    pat = so.FindPattern([needle], modes=[_ANCHOR[type(e)]])
    hit = so.string_find(col.offsets, col.data, pat)
    return make_column(ctx, t.BOOLEAN, hit >= 0, validity_of(v))


for _cls in _ANCHOR:
    evaluator(_cls)(_eval_contains)


class Like(Expression):
    """SQL LIKE: ``%`` any bytes, ``_`` one byte."""

    def __init__(self, child, pattern: Expression):
        self.children = (child, pattern)

    def data_type(self):
        return t.BOOLEAN

    def pattern_bytes(self):
        return _literal_bytes(self.children[1])


def like_pattern(pat: bytes):
    """(FindPattern or None, the least length a match needs, whether only
    the empty string matches): a LIKE pattern as K19's tokens."""
    wc = ord("_")
    if b"%" not in pat:
        if not pat:
            return None, 0, True
        return so.FindPattern([pat], modes=[so.FIND_AT_START |
                                            so.FIND_AT_END],
                              wildcard=wc), len(pat), False
    parts = pat.split(b"%")
    first, last = parts[0], parts[-1]
    tokens, modes, reserves = [], [], []
    if first:
        tokens.append(first)
        modes.append(so.FIND_AT_START)
        reserves.append(len(last))
    for tok in parts[1:-1]:
        if tok:
            tokens.append(tok)
            modes.append(0)
            reserves.append(len(last))
    if last:
        tokens.append(last)
        modes.append(so.FIND_AT_END)
        reserves.append(0)
    min_len = sum(len(p) for p in parts)
    if not tokens:
        return None, min_len, False
    return so.FindPattern(tokens, modes, reserves, wildcard=wc), min_len, \
        False


@evaluator(Like)
def _eval_like(e: Like, ctx: EvalContext):
    pat = e.pattern_bytes()
    if pat is None:
        raise NotImplementedError("LIKE requires a literal pattern")
    v = e.children[0].eval(ctx)
    col = _col(ctx, v)
    lens = so.lengths(col.offsets)
    found, min_len, empty_only = like_pattern(pat)
    if empty_only:
        return make_column(ctx, t.BOOLEAN, lens == 0, validity_of(v))
    data = lens >= min_len
    if found is not None:
        hit = so.string_find(col.offsets, col.data, found)
        data = data & (hit >= 0)
    return make_column(ctx, t.BOOLEAN, data, validity_of(v))


class StringLocate(Expression):
    """locate(substr, str[, start]): the 1-based BYTE position of the
    first match at or after start, 0 if none (the reference's)."""

    def __init__(self, substr, child, start=None):
        self.children = (substr, child) + ((start,) if start is not None
                                           else ())

    def data_type(self):
        return t.INT


@evaluator(StringLocate)
def _eval_locate(e: StringLocate, ctx: EvalContext):
    needle = _literal_bytes(e.children[0])
    if needle is None:
        raise NotImplementedError("locate requires a literal substring")
    v = e.children[1].eval(ctx)
    col = _col(ctx, v)
    if not needle:
        return make_column(ctx, t.INT, 1, validity_of(v))
    o0 = col.offsets[:-1]
    start = None
    if len(e.children) > 2:
        s = _ints(ctx, e.children[2].eval(ctx))
        start = (o0.to(torch.int64) + (s - 1).clamp(min=0)).clamp(
            max=2**31 - 1).to(torch.int32)
    hit = so.string_find(col.offsets, col.data, so.FindPattern([needle]),
                         start)
    return make_column(ctx, t.INT, torch.where(
        hit >= 0, hit - o0 + 1, torch.zeros_like(hit)), validity_of(v))


# ---------------------------------------------------------------------------
# concat, replace, repeat and the pads (torch compositions)
# ---------------------------------------------------------------------------

class Concat(Expression):
    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self):
        return t.STRING


@evaluator(Concat)
def _eval_concat(e: Concat, ctx: EvalContext):
    """Null if any input is null; each row's pieces laid end to end."""
    cols = [_input(ctx, c) for c in e.children]
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    zero = torch.zeros((), dtype=torch.int64, device=ctx.device)
    lens = [torch.where(valid, so.lengths(c.offsets).to(torch.int64), zero)
            for c in cols]
    offs, total = _from_lengths(ctx, sum(lens), valid)
    body = torch.zeros(total, dtype=torch.uint8, device=ctx.device)
    before = torch.zeros(ctx.capacity, dtype=torch.int64, device=ctx.device)
    for c, ln in zip(cols, lens):
        row, within = _spread(ctx, ln)
        body[offs[:-1].to(torch.int64)[row] + before[row] + within] = \
            c.data[c.offsets[:-1].to(torch.int64)[row] + within]
        before = before + ln
    return _span_column(ctx, offs, total, body, valid)


class ConcatWs(Expression):
    """concat_ws(sep, s1, ...): null inputs are skipped, a null separator
    gives null; evaluated on the host engine."""

    def __init__(self, sep, *children):
        self.children = (sep,) + tuple(children)

    def data_type(self):
        return t.STRING

    @property
    def nullable(self):
        return self.children[0].nullable


@evaluator(ConcatWs)
def _eval_concat_ws(e: ConcatWs, ctx: EvalContext):
    host_only(ctx, "concat_ws")
    cap = ctx.capacity
    rows = [host_string_rows(_input(ctx, c), cap) for c in e.children]
    seps, args = rows[0], rows[1:]
    return build_string_column(ctx, [
        None if seps[i] is None else
        seps[i].join(r[i] for r in args if r[i] is not None)
        for i in range(cap)])


class StringReplace(Expression):
    def __init__(self, child, search, replace):
        self.children = (child, search, replace)

    def data_type(self):
        return t.STRING


def _pattern_self_overlaps(pat: bytes) -> bool:
    """Whether the pattern can overlap itself (it has a proper border)."""
    return any(pat[:len(pat) - k] == pat[k:] for k in range(1, len(pat)))


@evaluator(StringReplace)
def _eval_replace(e: StringReplace, ctx: EvalContext):
    search = _literal_bytes(e.children[1])
    repl = _literal_bytes(e.children[2])
    if search is None or repl is None:
        raise NotImplementedError("replace requires literal search/replace")
    col = _input(ctx, e.children[0])
    if not search:
        return ColumnValue(col)
    if _pattern_self_overlaps(search):
        raise NotImplementedError("replace with self-overlapping pattern")
    dev = ctx.device
    n = int(col.offsets[-1])
    L, R = len(search), len(repl)
    m = so.string_match_mask(col.offsets, col.data, search)[:n]
    # each input byte's output length: R where a match starts, 0 inside
    # one, else 1
    tail = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(1, L):
        tail[j:] |= m[:n - j]
    contrib = torch.where(m, torch.full((), R, device=dev), torch.where(
        tail, torch.zeros((), dtype=torch.int64, device=dev),
        torch.ones((), dtype=torch.int64, device=dev)))
    pre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(contrib, 0, out=pre[1:])
    offs = pre[col.offsets.to(torch.int64).clamp(max=n)].to(torch.int32)
    total = int(pre[-1])
    p = torch.arange(total, dtype=torch.int64, device=dev)
    src = torch.searchsorted(pre[1:], p, right=True)
    within = p - pre[src]
    rb = torch.tensor(list(repl) or [0], dtype=torch.uint8, device=dev)
    body = torch.where(m[src], rb[within.clamp(max=max(R - 1, 0))],
                       col.data[src])
    return _span_column(ctx, offs, total, body, col.validity)


class StringRepeat(Expression):
    def __init__(self, child, times):
        self.children = (child, times)

    def data_type(self):
        return t.STRING


@evaluator(StringRepeat)
def _eval_repeat(e: StringRepeat, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    tv = e.children[1].eval(ctx)
    times = _ints(ctx, tv).clamp(0, 64)
    valid = and_validity(ctx, col.validity, validity_of(tv))
    if valid is None:
        valid = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    lens = so.lengths(col.offsets).to(torch.int64)
    offs, total = _from_lengths(ctx, lens * times, valid)
    row, within = _spread(ctx, torch.diff(offs.to(torch.int64)))
    src = col.offsets[:-1].to(torch.int64)[row] + \
        within % lens[row].clamp(min=1)
    return _span_column(ctx, offs, total, col.data[src], valid)


class StringLPad(Expression):
    """lpad(str, len, pad): ``len`` bytes, the string cut or padded on
    the left by repeats of ``pad`` (a space when not given)."""
    side = "left"

    def __init__(self, child, length, pad):
        self.children = (child, length, pad)

    def data_type(self):
        return t.STRING


class StringRPad(StringLPad):
    side = "right"


def _eval_pad(e: StringLPad, ctx: EvalContext):
    col = _input(ctx, e.children[0])
    pad = _literal_bytes(e.children[2]) or b" "
    target = _ints(ctx, e.children[1].eval(ctx)).clamp(0, 1 << 20)
    lens = so.lengths(col.offsets).to(torch.int64)
    offs, total = _from_lengths(ctx, target, col.validity)
    row, local = _spread(ctx, torch.diff(offs.to(torch.int64)))
    keep = torch.minimum(lens, target)[row]
    padlen = target[row] - keep
    o0 = col.offsets[:-1].to(torch.int64)[row]
    if e.side == "left":
        in_pad = local < padlen
        src = o0 + local - padlen
        pad_idx = local % len(pad)
    else:
        in_pad = local >= keep
        src = o0 + local
        pad_idx = (local - keep) % len(pad)
    last = max(int(col.data.shape[0]) - 1, 0)
    pb = torch.tensor(list(pad), dtype=torch.uint8, device=ctx.device)
    body = torch.where(in_pad, pb[pad_idx], col.data[src.clamp(0, last)]) \
        if col.data.shape[0] else pb[pad_idx]
    return _span_column(ctx, offs, total, body, col.validity)


evaluator(StringLPad)(_eval_pad)
evaluator(StringRPad)(_eval_pad)
