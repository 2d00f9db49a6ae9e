"""String kernels over the span layout: offsets int32[cap + 1] over uint8
chars.

Counterpart of spark_rapids_tpu/ops/strings.py (``lengths``,
``_rolling_hash``/``string_hashes``, ``string_eq``, ``prefix_words``/
``order_keys``, ``gather_strings`` and ``concat_char_buffers``) and of
spark_rapids_tpu/expr/predicates.py ``scalar_string_keys``, bit for bit:

* equality: the length and two 64-bit polynomial hashes a row,
  ``h = sum_j (c_j + 1) * base^(j - start) mod 2^64`` (K14,
  ``csrc/string_hashes.cu``); equal strings always agree, unequal ones
  collide with probability ~2^-120 a pair;
* order: the first 32 bytes as 4 big-endian words, then the length
  (K17, ``csrc/prefix_words.cu``).  Strings that share more than 32
  bytes of prefix are ordered by length only, as in the reference;
* gather: new offsets, an exclusive scan of the selected lengths, then a
  copy of the selected spans (K16, ``csrc/gather_strings.cu``);
* the string functions' kernels (expr/strings.py): K19 ``string_find``
  (``csrc/string_find.cu``), each row's first match of a literal needle,
  or of a LIKE pattern's tokens one after another, and the match mask of
  ``replace``; K20 ``utf8_cut`` (``csrc/utf8_cut.cu``), each row's
  character count and the byte cut of a substring or a trim; K21
  ``string_map`` (``csrc/string_map.cu``), a byte map into new chars
  under the same offsets (ASCII upper, lower, initcap; reverse by UTF-8
  character); and the torch compositions ``pack_rows`` and
  ``window_bytes`` (the reference's, for casts to and from strings).

The hashes are uint64 in the reference; here they are carried as int64
bits (multiplication and addition wrap the same mod 2^64).  A word that
K2 sorts is carried as (word XOR 2^63), so signed order is the
reference's unsigned order.

Each kernel's wrapper takes its plain PyTorch version for CPU tensors
only; for CUDA tensors it launches the kernel or raises, and counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels

PREFIX_BYTES = 32                       # 4 words
_M64 = (1 << 64) - 1
_HASH_BASE_1 = 0x100000001B3            # FNV-ish odd base
_HASH_BASE_2 = 0x9E3779B97F4A7C15       # golden-ratio odd base
_HASH_INV_1 = pow(_HASH_BASE_1, -1, 1 << 64)
_HASH_INV_2 = pow(_HASH_BASE_2, -1, 1 << 64)
_MIX = 0xBF58476D1CE4E5B9               # the join word's multiplier
_SIGN = -2**63
_INT32_MAX = 2**31 - 1


def _int64(u: int) -> int:
    """The int64 with the bits of the uint64 ``u``."""
    u &= _M64
    return u - (1 << 64) if u >= 1 << 63 else u


def lengths(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[1:] - offsets[:-1]


def _check_span(what: str, offsets: torch.Tensor, chars: torch.Tensor):
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or \
            offsets.shape[0] < 1:
        raise TypeError(f"{what}: offsets must be int32[cap + 1], got "
                        f"{offsets.dtype}{tuple(offsets.shape)}")
    if chars.dtype != torch.uint8 or chars.dim() != 1:
        raise TypeError(f"{what}: chars must be uint8[char_cap], got "
                        f"{chars.dtype}{tuple(chars.shape)}")


# ---------------------------------------------------------------------------
# K14: the two rolling hashes
# ---------------------------------------------------------------------------

def _powers(base: int, n: int, device) -> torch.Tensor:
    """int64[n]: base^j mod 2^64 for j in [0, n)."""
    p = torch.full((n,), _int64(base), dtype=torch.int64, device=device)
    p = torch.cumprod(p, 0)
    return torch.cat([torch.ones(1, dtype=torch.int64, device=device),
                      p[:-1]])


def _rolling_hash_plain(offsets, chars, base: int, inv: int):
    """The reference's global prefix form: prefix[k] = sum_{j<k} (c_j + 1)
    * base^j, hash_i = (prefix[end] - prefix[start]) * base^-start."""
    dev = offsets.device
    cap = offsets.shape[0] - 1
    n = int(offsets[-1]) if cap else 0
    if n == 0:
        return torch.zeros(cap, dtype=torch.int64, device=dev)
    contrib = (chars[:n].to(torch.int64) + 1) * _powers(base, n, dev)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(contrib, 0)])
    starts = offsets[:-1].to(torch.int64)
    span = prefix[offsets[1:].to(torch.int64)] - prefix[starts]
    inv_pow = _powers(inv, n, dev)
    return span * inv_pow[starts.clamp(0, n - 1)]


def string_hashes_plain(offsets: torch.Tensor, chars: torch.Tensor,
                        join_word: bool = False) -> List[torch.Tensor]:
    """Plain version of K14: [h1, h2] (and the join word) as int64 bits."""
    h1 = _rolling_hash_plain(offsets, chars, _HASH_BASE_1, _HASH_INV_1)
    h2 = _rolling_hash_plain(offsets, chars, _HASH_BASE_2, _HASH_INV_2)
    out = [h1, h2]
    if join_word:
        out.append(h1 ^ (h2 * _int64(_MIX)))
    return out


def string_hashes(offsets: torch.Tensor, chars: torch.Tensor,
                  join_word: bool = False) -> List[torch.Tensor]:
    """Each row's two 64-bit rolling hashes, the reference's uint64 bits
    in int64 tensors, and with ``join_word`` the join's key word
    ``h1 ^ (h2 * MIX)`` (K14).  A null or empty row hashes to 0."""
    _check_span("string_hashes", offsets, chars)
    if offsets.device.type == "cpu":
        return string_hashes_plain(offsets, chars, join_word)
    kernels.require_cuda("string_hashes", offsets, chars)
    cap = int(offsets.shape[0]) - 1
    outs = [torch.empty(cap, dtype=torch.int64, device=offsets.device)
            for _ in range(3 if join_word else 2)]
    if cap == 0:
        return outs
    lib = kernels.library("string_hashes")
    kernels.check(lib, lib.srt_string_hashes(
        offsets.data_ptr(), chars.data_ptr(), cap, outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr() if join_word else None,
        kernels.stream(offsets)), "string_hashes")
    string_hashes.launches += 1
    return outs


string_hashes.launches = 0


def string_eq(offs_a, chars_a, offs_b, chars_b) -> torch.Tensor:
    """Elementwise string equality (bool[cap]): lengths and both hashes."""
    a1, a2 = string_hashes(offs_a, chars_a)
    b1, b2 = string_hashes(offs_b, chars_b)
    return (lengths(offs_a) == lengths(offs_b)) & (a1 == b1) & (a2 == b2)


def scalar_string_keys(s: bytes) -> Tuple[List[int], int, int, int]:
    """(4 prefix words, h1, h2, length) of a constant string, hashed once
    on the host: the words and hashes as int64 bits, the words XOR 2^63
    as ``order_keys`` gives them (the reference's
    expr/predicates.py:scalar_string_keys)."""
    h = []
    for base in (_HASH_BASE_1, _HASH_BASE_2):
        acc, p = 0, 1
        for c in s:
            acc = (acc + (c + 1) * p) & _M64
            p = (p * base) & _M64
        h.append(_int64(acc))
    padded = s[:PREFIX_BYTES].ljust(PREFIX_BYTES, b"\0")
    words = [_int64(int.from_bytes(padded[i * 8:(i + 1) * 8], "big"))
             ^ _SIGN for i in range(PREFIX_BYTES // 8)]
    return words, h[0], h[1], len(s)


# ---------------------------------------------------------------------------
# K17: the ordering words
# ---------------------------------------------------------------------------

_PLAIN_ROWS = 1 << 22          # rows a step of the plain version gathers


def order_keys_plain(offsets: torch.Tensor, chars: torch.Tensor
                     ) -> List[torch.Tensor]:
    """Plain version of K17: the [rows, 32] byte gather of the reference's
    ``prefix_words``, a step of rows at a time."""
    cap = offsets.shape[0] - 1
    dev = offsets.device
    words = [torch.empty(cap, dtype=torch.int64, device=dev)
             for _ in range(PREFIX_BYTES // 8 + 1)]
    k = torch.arange(PREFIX_BYTES, dtype=torch.int64, device=dev)
    shifts = 8 * (7 - torch.arange(8, dtype=torch.int64, device=dev))
    last = max(chars.shape[0] - 1, 0)
    for s in range(0, cap, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, cap)
        start = offsets[s:e].to(torch.int64)
        lens = offsets[s + 1:e + 1].to(torch.int64) - start
        idx = (start[:, None] + k[None, :]).clamp(0, last)
        b = torch.where(k[None, :] < lens[:, None], chars[idx].to(torch.int64),
                        torch.zeros((), dtype=torch.int64, device=dev))
        w = (b.view(e - s, PREFIX_BYTES // 8, 8) << shifts).sum(-1)
        for j in range(PREFIX_BYTES // 8):
            words[j][s:e] = w[:, j] ^ _SIGN
        words[-1][s:e] = lens ^ _SIGN
    return words


def order_keys(offsets: torch.Tensor, chars: torch.Tensor
               ) -> List[torch.Tensor]:
    """The ordering words of each row, most significant first: the first
    32 bytes as 4 big-endian words (zero past the end), then the length,
    each XOR 2^63 (K17)."""
    _check_span("order_keys", offsets, chars)
    if offsets.device.type == "cpu":
        return order_keys_plain(offsets, chars)
    kernels.require_cuda("order_keys", offsets, chars)
    cap = int(offsets.shape[0]) - 1
    out = torch.empty((PREFIX_BYTES // 8 + 1, cap), dtype=torch.int64,
                      device=offsets.device)
    if cap:
        lib = kernels.library("prefix_words")
        kernels.check(lib, lib.srt_prefix_words(
            offsets.data_ptr(), chars.data_ptr(), cap, out.data_ptr(),
            kernels.stream(offsets)), "order_keys")
        order_keys.launches += 1
    return list(out.unbind(0))


order_keys.launches = 0


# ---------------------------------------------------------------------------
# K16: the gather of spans
# ---------------------------------------------------------------------------

def _check_gather(what, offsets, indices, valid):
    n = indices.shape[0]
    if indices.dtype != torch.int32 or indices.dim() != 1 or \
            valid.dtype != torch.bool or valid.shape != (n,):
        raise TypeError(f"{what}: indices must be int32[n] and valid "
                        f"bool[n]")
    if offsets.dtype != torch.int32:
        raise TypeError(f"{what}: offsets must be int32")


def gather_offsets_plain(offsets, indices, valid
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K16's first launch: a ``torch.cumsum`` of the
    selected lengths."""
    dev = offsets.device
    out = torch.zeros(indices.shape[0] + 1, dtype=torch.int64, device=dev)
    if offsets.shape[0] > 1:
        idx = indices.to(torch.int64).clamp(0, offsets.shape[0] - 2)
        src_len = torch.where(valid, offsets[idx + 1] - offsets[idx],
                              torch.zeros((), dtype=offsets.dtype,
                                          device=dev))
        torch.cumsum(src_len.to(torch.int64), 0, out=out[1:])
    return out.to(torch.int32), out[-1:].clone()


def span_starts_plain(offsets, indices, valid) -> torch.Tensor:
    """int32[n]: each selected row's source start (the index clamped into
    the source rows), 0 for an invalid slot: what K16's first launch
    writes beside the new offsets for its copy."""
    if offsets.shape[0] <= 1:
        return torch.zeros(indices.shape[0], dtype=torch.int32,
                           device=offsets.device)
    idx = indices.to(torch.int64).clamp(0, offsets.shape[0] - 2)
    return torch.where(valid, offsets[idx],
                       torch.zeros((), dtype=offsets.dtype,
                                   device=offsets.device))


def copy_spans_plain(chars, starts, new_offsets,
                     out_char_cap: int) -> torch.Tensor:
    """Plain version of K16's copy: row i's bytes from ``starts[i]`` to
    ``new_offsets[i]``, each output byte's row by ``repeat_interleave``,
    then one index_select, a step of rows at a time; zero past the
    total."""
    dev = chars.device
    out = torch.zeros(out_char_cap, dtype=torch.uint8, device=dev)
    n = starts.shape[0]
    for s in range(0, n, _PLAIN_ROWS):
        e = min(s + _PLAIN_ROWS, n)
        first, last = int(new_offsets[s]), int(new_offsets[e])
        if last == first:
            continue
        lens = (new_offsets[s + 1:e + 1] - new_offsets[s:e]).to(torch.int64)
        row = torch.repeat_interleave(
            torch.arange(s, e, device=dev), lens)
        p = torch.arange(first, last, dtype=torch.int64, device=dev)
        src = starts[row].to(torch.int64) + p - \
            new_offsets[row].to(torch.int64)
        out[first:last] = chars[src]
    return out


def gather_chars_plain(offsets, chars, indices, new_offsets,
                       out_char_cap: int) -> torch.Tensor:
    """Plain version of K16's two launches' bytes from the selection
    itself: each row's source start read at its index, then
    ``copy_spans_plain``."""
    every = torch.ones(indices.shape[0], dtype=torch.bool,
                       device=indices.device)
    return copy_spans_plain(chars, span_starts_plain(offsets, indices, every),
                            new_offsets, out_char_cap)


_STRETCH_BYTES = 4096    # output bytes a copy block (kStretch in csrc)


def gather_stretches(total: int) -> int:
    """The byte stretches of K16's copy that hold selected bytes, one
    block and one (first row, end row) pair each: ceil(total / 4,096).
    Blocks past them write the zero tail."""
    return -(-total // _STRETCH_BYTES)


def gather_offsets(offsets: torch.Tensor, indices: torch.Tensor,
                   valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K16's first launch: (int32[n + 1] offsets of the rows ``indices``,
    a row's length where ``valid`` and else 0, as an exclusive scan; the
    byte total as int64[1]; int32[n] each row's source start, 0 for an
    invalid slot), all on the device."""
    _check_gather("gather_strings", offsets, indices, valid)
    if offsets.device.type == "cpu":
        return gather_offsets_plain(offsets, indices, valid) + \
            (span_starts_plain(offsets, indices, valid),)
    kernels.require_cuda("gather_strings", offsets, indices, valid)
    n = int(indices.shape[0])
    dev = offsets.device
    new_offs = torch.empty(n + 1, dtype=torch.int32, device=dev)
    starts = torch.empty(n, dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    if n == 0:
        return new_offs.zero_(), total, starts
    lib = kernels.library("gather_strings")
    state = torch.zeros(1 + kernels.num_tiles(lib, n), dtype=torch.int64,
                        device=dev)
    kernels.check(lib, lib.srt_gather_offsets(
        offsets.data_ptr(), int(offsets.shape[0]) - 1, indices.data_ptr(),
        valid.data_ptr(), n, new_offs.data_ptr(), starts.data_ptr(),
        total.data_ptr(), state.data_ptr(), kernels.stream(offsets)),
        "gather_strings")
    return new_offs, total, starts


def gather_chars(chars: torch.Tensor, starts: torch.Tensor,
                 new_offsets: torch.Tensor, total: int,
                 out_char_cap: int) -> torch.Tensor:
    """K16's copy: the spans that ``gather_offsets`` located (``starts``,
    ``new_offsets``) copied to their new offsets, zero-padded to
    ``out_char_cap``; ``total`` is the byte total (``new_offsets[-1]``),
    read by the caller."""
    if not 0 <= total <= min(out_char_cap, _INT32_MAX):
        raise ValueError(f"gather_strings: {total} bytes into a buffer of "
                         f"{out_char_cap}; at most 2^31-1")
    if chars.device.type == "cpu":
        return copy_spans_plain(chars, starts, new_offsets, out_char_cap)
    kernels.require_cuda("gather_strings", chars, starts, new_offsets)
    n = int(starts.shape[0])
    if n == 0 or total == 0:
        return torch.zeros(out_char_cap, dtype=torch.uint8,
                           device=chars.device)
    out = torch.empty(out_char_cap, dtype=torch.uint8, device=chars.device)
    stretches = gather_stretches(total)
    rows = torch.empty(2 * stretches, dtype=torch.int32, device=chars.device)
    lib = kernels.library("gather_strings")
    kernels.check(lib, lib.srt_gather_chars(
        chars.data_ptr(), int(chars.shape[0]), starts.data_ptr(),
        new_offsets.data_ptr(), n, total, stretches, rows.data_ptr(),
        out.data_ptr(), out_char_cap, kernels.stream(chars)),
        "gather_strings")
    gather_strings.launches += 1
    return out


def read_totals(totals: Sequence[torch.Tensor]) -> List[int]:
    """Several gathers' byte totals (int64[1] each), in one host read;
    a total past 2^31-1 raises, as int32 offsets cannot hold it."""
    if not totals:
        return []
    out = torch.cat(list(totals)).tolist()
    for x in out:
        if x > _INT32_MAX:
            raise ValueError(f"a string gather of {x} bytes exceeds the "
                             f"2^31-1 bytes of int32 offsets; split the "
                             f"batch")
    return out


def gather_strings(offsets: torch.Tensor, chars: torch.Tensor,
                   indices: torch.Tensor, valid: torch.Tensor,
                   out_char_cap: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets', chars') of the rows ``indices`` (K16); an invalid slot
    becomes an empty string.  Without ``out_char_cap`` the byte total is
    read to size the chars at its bucket."""
    from ..columnar.device import DEFAULT_CHAR_BUCKETS, bucket_for
    new_offs, total, starts = gather_offsets(offsets, indices, valid)
    total, = read_totals([total])
    if out_char_cap is None:
        out_char_cap = bucket_for(max(total, 1), DEFAULT_CHAR_BUCKETS)
    return new_offs, gather_chars(chars, starts, new_offs, total,
                                  out_char_cap)


gather_strings.launches = 0


def concat_char_buffers(offs_list: Sequence[torch.Tensor],
                        chars_list: Sequence[torch.Tensor],
                        counts: Sequence[int], nbytes: Sequence[int],
                        out_cap: int, out_char_cap: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (offsets, chars) column of the live rows of several: piece i
    keeps its first ``counts[i]`` rows, ``nbytes[i]`` bytes, its offsets
    rebased by the bytes before it; offsets are padded to ``out_cap + 1``
    with the total and chars zero-padded to ``out_char_cap``."""
    dev = offs_list[0].device
    total_rows, total_bytes = sum(counts), sum(nbytes)
    if total_bytes > _INT32_MAX:
        raise ValueError(f"concatenating {total_bytes} string bytes "
                         f"exceeds the 2^31-1 bytes of int32 offsets")
    offs = torch.full((out_cap + 1,), total_bytes, dtype=torch.int32,
                      device=dev)
    chars = torch.zeros(out_char_cap, dtype=torch.uint8, device=dev)
    row = byte = 0
    for o, c, n, b in zip(offs_list, chars_list, counts, nbytes):
        offs[row:row + n] = o[:n] + byte
        chars[byte:byte + b] = c[:b]
        row += n
        byte += b
    return offs, chars


# ---------------------------------------------------------------------------
# pack_rows, window_bytes: the reference's byte-matrix helpers (torch)
# ---------------------------------------------------------------------------

def pack_rows(mat: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
              out_char_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets, chars) from a left-aligned byte matrix uint8[cap, W]:
    row i is ``mat[i, :lens[i]]``, an invalid row empty; chars zero-padded
    to ``out_char_cap`` (the reference's ``ops/strings.py:pack_rows``)."""
    dev = mat.device
    lens = torch.where(valid, lens.to(torch.int64),
                       torch.zeros((), dtype=torch.int64, device=dev))
    offs = torch.zeros(mat.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offs[1:])
    keep = torch.arange(mat.shape[1], device=dev)[None, :] < lens[:, None]
    body = mat[keep]
    chars = torch.zeros(max(out_char_cap, body.shape[0]), dtype=torch.uint8,
                        device=dev)
    chars[:body.shape[0]] = body
    return offs.to(torch.int32), chars


def window_bytes(offsets: torch.Tensor, chars: torch.Tensor, width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8[cap, width] each row's first ``width`` bytes, zero past its
    length; int32[cap] the lengths): the reference's
    ``ops/strings.py:window_bytes``."""
    lens = lengths(offsets)
    k = torch.arange(width, dtype=torch.int64, device=offsets.device)
    idx = (offsets[:-1].to(torch.int64)[:, None] + k[None, :]).clamp(
        0, max(chars.shape[0] - 1, 0))
    if chars.shape[0] == 0:
        return torch.zeros((lens.shape[0], width), dtype=torch.uint8,
                           device=offsets.device), lens
    b = torch.where(k[None, :] < lens[:, None], chars[idx],
                    torch.zeros((), dtype=torch.uint8, device=chars.device))
    return b, lens


def _char_starts(chars: torch.Tensor) -> torch.Tensor:
    """bool per byte: a UTF-8 sequence's lead byte (no continuation)."""
    return (chars & 0xC0) != 0x80


# ---------------------------------------------------------------------------
# K19: literal search
# ---------------------------------------------------------------------------

FIND_AT_START = 1       # a token must begin where the last one ended
FIND_AT_END = 2         # a token must end ``reserve`` bytes before the end
STRING_TILE_BYTES = 16384   # K19's and K21's kTile: rows and bytes a tile
FIND_BITMAP_TOKENS = 8      # K19's kMaxTokens: tokens phase 1 has bitmaps for


class FindPattern:
    """A search compiled on the host: tokens searched one after another in
    each row, each from where the one before ended; ``modes[k]`` anchors
    token k (FIND_AT_START, FIND_AT_END, both, or 0 for the first match),
    ``reserves[k]`` bytes are kept free after it, ``wildcard`` is a byte
    that matches any byte (LIKE's ``_``), ``repeat`` runs the token
    sequence that many times (the result is the last run's), and
    ``reverse`` searches from the end (each token the last match before
    the one found before it)."""

    __slots__ = ("tokens", "modes", "reserves", "wildcard", "repeat",
                 "reverse")

    def __init__(self, tokens: Sequence[bytes], modes=None, reserves=None,
                 wildcard: Optional[int] = None, repeat: int = 1,
                 reverse: bool = False):
        self.tokens = [bytes(x) for x in tokens]
        n = len(self.tokens)
        self.modes = list(modes) if modes is not None else [0] * n
        self.reserves = list(reserves) if reserves is not None else [0] * n
        self.wildcard = wildcard
        self.repeat = int(repeat)
        self.reverse = bool(reverse)
        if not n or any(not x for x in self.tokens):
            raise ValueError(f"string_find: non-empty tokens, got "
                             f"{self.tokens!r}")
        if self.repeat < 1 or (self.reverse and any(self.modes)):
            raise ValueError("string_find: repeat >= 1; a reverse search "
                             "takes no anchors")

    def arrays(self):
        """(bytes, wildcard flags, token offsets, modes, reserves) as the
        kernel reads them."""
        body = b"".join(self.tokens)
        wild = bytes(int(b == self.wildcard) for b in body)
        offs = [0]
        for x in self.tokens:
            offs.append(offs[-1] + len(x))
        return body, wild, offs, self.modes, self.reserves


def _total(offsets: torch.Tensor) -> int:
    """The bytes the rows hold (``offsets[cap]``): a plain version reads
    no further, so no scan runs over a bucket's padding."""
    return int(offsets[-1]) if offsets.shape[0] > 1 else 0


def _token_mask(chars: torch.Tensor, tok: bytes,
                wildcard: Optional[int]) -> torch.Tensor:
    """bool per byte: ``tok`` matches starting at this byte (the
    reference's ``_match_positions``)."""
    n = chars.shape[0]
    m = torch.zeros(n, dtype=torch.bool, device=chars.device)
    if n < len(tok):
        return m
    ok = torch.ones(n - len(tok) + 1, dtype=torch.bool, device=chars.device)
    for j, b in enumerate(tok):
        if b != wildcard:
            ok &= chars[j:n - len(tok) + 1 + j] == b
    m[:ok.shape[0]] = ok
    return m


def string_find_plain(offsets: torch.Tensor, chars: torch.Tensor,
                      pattern: FindPattern,
                      starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K19: each token's match mask over the rows' bytes,
    its prefix count and a ``searchsorted`` for the first (last) match in
    the window, as the reference searches."""
    dev = chars.device
    cap = offsets.shape[0] - 1
    chars = chars[:_total(offsets)]
    n = chars.shape[0]
    cur = offsets[:-1].to(torch.int64)
    if starts is not None:
        cur = torch.maximum(starts.to(torch.int64), cur)
    hi = offsets[1:].to(torch.int64)
    alive = torch.ones(cap, dtype=torch.bool, device=dev)
    p = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    pres = []
    for tok in pattern.tokens:
        m = _token_mask(chars, tok, pattern.wildcard)
        pre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(m.to(torch.int64), 0, out=pre[1:])
        pres.append((m, pre))
    for _ in range(pattern.repeat):
        for k, tok in enumerate(pattern.tokens):
            m, pre = pres[k]
            L = len(tok)
            limit = hi - pattern.reserves[k] - L
            lo_c = cur.clamp(0, n)
            hi_c = (limit + 1).clamp(0, n)
            room = limit >= cur
            mode = pattern.modes[k]
            if mode & (FIND_AT_START | FIND_AT_END):
                at = cur if mode & FIND_AT_START else limit
                hit = room & m[at.clamp(0, max(n - 1, 0))] if n else room & False
                if mode & FIND_AT_START and mode & FIND_AT_END:
                    hit &= cur == limit
                p = at
            else:
                hit = room & (pre[hi_c] - pre[lo_c] > 0)
                if pattern.reverse:
                    p = torch.searchsorted(pre, pre[hi_c], right=False) - 1
                else:
                    p = torch.searchsorted(pre, pre[lo_c] + 1,
                                           right=False) - 1
            alive &= hit
            if pattern.reverse:
                hi = torch.where(alive, p, hi)
            else:
                cur = torch.where(alive, p + L, cur)
    return torch.where(alive, p, torch.full_like(p, -1)).to(torch.int32)


def find_plan(pattern: FindPattern) -> str:
    """K19's path for ``pattern``: "bitmaps" (phase 1 marks every token's
    matches by bytes, then a row reads the bitmaps) while its tokens'
    bitmaps fit beside the stage, else "rows" (each row compares its
    staged bytes).  A row longer than STRING_TILE_BYTES is searched by
    its warp on either path."""
    return "bitmaps" if len(pattern.tokens) <= FIND_BITMAP_TOKENS else "rows"


def _tile_scratch(lib, offsets: torch.Tensor,
                  chars: torch.Tensor) -> torch.Tensor:
    """K19's and K21's row tiles (csrc/row_tiles.cuh): 16 bytes a tile of
    STRING_TILE_BYTES rows and bytes."""
    ntiles = lib.srt_tile_count(int(offsets.shape[0]) - 1,
                                int(chars.shape[0]))
    return torch.empty(4 * ntiles, dtype=torch.int32, device=chars.device)


def _pattern_arrays(pattern: FindPattern, dev):
    """(packed bytes and wildcard flags, int32 token offsets, modes and
    reserves) on ``dev``, copied from pinned memory on the stream."""
    body, wild, toff, modes, reserves = pattern.arrays()
    packed = torch.tensor(list(body) + list(wild), dtype=torch.uint8,
                          pin_memory=True).to(dev, non_blocking=True)
    ints32 = torch.tensor(toff + modes + reserves, dtype=torch.int32,
                          pin_memory=True).to(dev, non_blocking=True)
    return len(body), packed, ints32


def string_find(offsets: torch.Tensor, chars: torch.Tensor,
                pattern: FindPattern,
                starts: Optional[torch.Tensor] = None,
                path: Optional[str] = None) -> torch.Tensor:
    """int32[cap]: where the last token of ``pattern`` matches in row i,
    each token searched from where the one before ended, the first from
    ``starts[i]`` (an absolute byte position; None: the row start) to the
    row's end; -1 where a token does not match (K19).  ``path`` forces
    "bitmaps" or "rows" (None: ``find_plan``).  No byte past
    ``offsets[cap]`` is read."""
    _check_span("string_find", offsets, chars)
    if starts is not None and starts.dtype != torch.int32:
        raise TypeError("string_find: starts must be int32[cap]")
    path = path or find_plan(pattern)
    if path not in ("bitmaps", "rows") or (
            path == "bitmaps" and find_plan(pattern) != "bitmaps"):
        raise ValueError(f"string_find: path {path!r} for "
                         f"{len(pattern.tokens)} tokens")
    if offsets.device.type == "cpu":
        return string_find_plain(offsets, chars, pattern, starts)
    extra = [starts] if starts is not None else []
    kernels.require_cuda("string_find", offsets, chars, *extra)
    cap = int(offsets.shape[0]) - 1
    out = torch.empty(cap, dtype=torch.int32, device=offsets.device)
    if cap == 0:
        return out
    nbytes, packed, ints32 = _pattern_arrays(pattern, offsets.device)
    lib = kernels.library("string_find")
    tiles = _tile_scratch(lib, offsets, chars)
    kernels.check(lib, lib.srt_string_find(
        offsets.data_ptr(), chars.data_ptr(), cap, int(chars.shape[0]),
        packed.data_ptr(), nbytes, ints32.data_ptr(), len(pattern.tokens),
        int(pattern.wildcard is not None), pattern.repeat,
        int(pattern.reverse), None if starts is None else starts.data_ptr(),
        0 if path == "bitmaps" else 1, tiles.data_ptr(), out.data_ptr(),
        kernels.stream(offsets)), "string_find")
    string_find.launches += 1
    return out


string_find.launches = 0


def string_match_mask_plain(offsets: torch.Tensor, chars: torch.Tensor,
                            needle: bytes) -> torch.Tensor:
    """Plain version of K19's mask mode: the reference's whole-buffer
    match mask, each match kept only where it ends inside its row."""
    total = _total(offsets)
    out = torch.zeros(chars.shape[0], dtype=torch.bool, device=chars.device)
    m = _token_mask(chars[:total], needle, None)
    q = torch.arange(total, dtype=torch.int64, device=chars.device)
    end = offsets[1:].to(torch.int64)[_row_ids(offsets, total)]
    out[:total] = m & (q + len(needle) <= end)
    return out


def string_match_mask(offsets: torch.Tensor, chars: torch.Tensor,
                      needle: bytes) -> torch.Tensor:
    """bool[char_cap]: ``needle`` (non-empty) matches at this byte and
    ends inside the byte's row (K19's mask mode)."""
    _check_span("string_match_mask", offsets, chars)
    if not needle:
        raise ValueError("string_match_mask: an empty needle")
    if offsets.device.type == "cpu":
        return string_match_mask_plain(offsets, chars, needle)
    kernels.require_cuda("string_match_mask", offsets, chars)
    cap = int(offsets.shape[0]) - 1
    out = torch.zeros(chars.shape[0], dtype=torch.bool, device=chars.device)
    if cap == 0 or chars.shape[0] == 0:
        return out
    nbytes, packed, ints32 = _pattern_arrays(FindPattern([needle]),
                                             chars.device)
    lib = kernels.library("string_find")
    tiles = _tile_scratch(lib, offsets, chars)
    kernels.check(lib, lib.srt_string_match_mask(
        offsets.data_ptr(), chars.data_ptr(), cap, int(chars.shape[0]),
        packed.data_ptr(), nbytes, ints32.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), kernels.stream(offsets)),
        "string_match_mask")
    string_find.launches += 1
    return out


# ---------------------------------------------------------------------------
# K20: UTF-8 cuts
# ---------------------------------------------------------------------------

CUT_LENGTH, CUT_SUBSTRING, CUT_TRIM, CUT_TRIM_LEFT, CUT_TRIM_RIGHT = range(5)


def _row_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n]: the row each byte position lies in (the last row for a
    byte past the total)."""
    q = torch.arange(n, dtype=torch.int64, device=offsets.device)
    row = torch.searchsorted(offsets[1:].to(torch.int64), q, right=True)
    return row.clamp(0, max(offsets.shape[0] - 2, 0))


def _per_row(v, like: torch.Tensor) -> torch.Tensor:
    """int64 per row of a literal int (broadcast) or an int64[cap]."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.full_like(like, int(v))


def utf8_cut_plain(offsets: torch.Tensor, chars: torch.Tensor, mode: int,
                   pos=None, length=None):
    """Plain version of K20, the reference's way: a flag per byte, its
    global prefix count, and ``searchsorted`` per row."""
    dev = chars.device
    chars = chars[:_total(offsets)]
    n = chars.shape[0]
    o0 = offsets[:-1].to(torch.int64)
    o1 = offsets[1:].to(torch.int64)
    if mode in (CUT_LENGTH, CUT_SUBSTRING):
        flag = _char_starts(chars)
    else:
        flag = chars != 32
    pre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(flag.to(torch.int64), 0, out=pre[1:])
    base = pre[o0]
    count = pre[o1] - base
    if mode == CUT_LENGTH:
        return count.to(torch.int32), None, None
    if mode == CUT_SUBSTRING:
        p = _per_row(pos, o0)
        start = torch.where(p > 0, p - 1,
                            torch.where(p < 0, count + p,
                                        torch.zeros_like(count)))
        end = count if length is None else \
            start + _per_row(length, o0).clamp(min=0)
        start_c = torch.minimum(start.clamp(min=0), count)
        end_c = torch.minimum(torch.maximum(end, start_c), count)

        def byte_of(c):
            return torch.searchsorted(pre[1:], base + c + 1, right=False)
        b0 = torch.minimum(torch.maximum(byte_of(start_c), o0), o1)
        b1 = torch.minimum(torch.maximum(byte_of(end_c), b0), o1)
        return None, b0.to(torch.int32), b1.to(torch.int32)
    empty = count == 0
    if mode in (CUT_TRIM, CUT_TRIM_LEFT):
        b0 = torch.minimum(torch.searchsorted(pre, base + 1, right=False) - 1,
                           o1)
    else:
        b0 = o0
    if mode in (CUT_TRIM, CUT_TRIM_RIGHT):
        b1 = torch.maximum(torch.searchsorted(pre, pre[o1], right=False), b0)
    else:
        b1 = o1
    b0 = torch.where(empty, o0, b0)
    b1 = torch.where(empty, o0, b1)
    return None, b0.to(torch.int32), b1.to(torch.int32)


def utf8_cut(offsets: torch.Tensor, chars: torch.Tensor, mode: int,
             pos=None, length=None):
    """(int32[cap] characters, int32[cap] b0, int32[cap] b1) of each row
    (K20), None where the mode gives none.  CUT_LENGTH counts UTF-8 lead
    bytes (no cut); CUT_SUBSTRING cuts [b0, b1) for Spark's 1-based
    ``pos`` (0 is 1, negative counts from the end) and ``length``
    characters (None: to the end), each an int (a literal, the same in
    every row) or an int64[cap]; the trims cut the spaces (0x20) at both
    ends, the left or the right, an all-space row to [o0, o0)."""
    _check_span("utf8_cut", offsets, chars)
    cols = [x for x in (pos, length) if isinstance(x, torch.Tensor)]
    if mode == CUT_SUBSTRING and (pos is None or
                                  any(x.dtype != torch.int64 for x in cols)):
        raise TypeError("utf8_cut: a substring takes a pos and a length, "
                        "each an int or an int64[cap]")
    if offsets.device.type == "cpu":
        return utf8_cut_plain(offsets, chars, mode, pos, length)
    kernels.require_cuda("utf8_cut", offsets, chars, *cols)
    cap = int(offsets.shape[0]) - 1
    dev = offsets.device
    count = b0 = b1 = None
    if mode == CUT_LENGTH:
        count = torch.empty(cap, dtype=torch.int32, device=dev)
    else:
        b0 = torch.empty(cap, dtype=torch.int32, device=dev)
        b1 = torch.empty(cap, dtype=torch.int32, device=dev)

    def ptr(x):
        return x.data_ptr() if isinstance(x, torch.Tensor) else None

    def lit(x):
        return 0 if x is None or isinstance(x, torch.Tensor) else int(x)
    if cap:
        lib = kernels.library("utf8_cut")
        kernels.check(lib, lib.srt_utf8_cut(
            offsets.data_ptr(), chars.data_ptr(), cap, mode, ptr(pos),
            lit(pos), ptr(length), lit(length), int(length is not None),
            ptr(count), ptr(b0), ptr(b1), kernels.stream(offsets)),
            "utf8_cut")
        utf8_cut.launches += 1
    return count, b0, b1


utf8_cut.launches = 0


# ---------------------------------------------------------------------------
# K21: byte maps under the same offsets
# ---------------------------------------------------------------------------

MAP_UPPER, MAP_LOWER, MAP_INITCAP, MAP_REVERSE = range(4)


def string_map_plain(offsets: torch.Tensor, chars: torch.Tensor,
                     mode: int) -> torch.Tensor:
    """Plain version of K21 over the rows' bytes, zero past the total."""
    dev = chars.device
    total = _total(offsets)
    c = chars[:total]
    n = total
    is_lo = (c >= 97) & (c <= 122)
    is_up = (c >= 65) & (c <= 90)
    if mode == MAP_UPPER:
        out = torch.where(is_lo, c - 32, c)
    elif mode == MAP_LOWER:
        out = torch.where(is_up, c + 32, c)
    elif mode == MAP_INITCAP:
        prev = torch.cat([torch.full((1,), 32, dtype=torch.uint8,
                                     device=dev), c[:-1]])
        row_start = torch.zeros(n, dtype=torch.bool, device=dev)
        starts = offsets[:-1].to(torch.int64)
        row_start[starts[starts < n]] = True
        word = (prev == 32) | row_start
        out = torch.where(word, torch.where(is_lo, c - 32, c),
                          torch.where(is_up, c + 32, c))
    else:
        # each byte's character: from the last lead byte at or before it
        # (or the row start) to the next lead byte after it (or the row
        # end); the characters go in reverse order, each byte kept in
        # its character
        q = torch.arange(n, dtype=torch.int64, device=dev)
        row = _row_ids(offsets, n)
        o0 = offsets[:-1].to(torch.int64)[row] if n else q
        o1 = offsets[1:].to(torch.int64)[row] if n else q
        lead = _char_starts(c)
        last_lead = torch.where(lead, q, torch.full_like(q, -1))
        last_lead = torch.cummax(last_lead, 0).values
        sg = torch.maximum(last_lead, o0)
        nxt = torch.where(lead, q, torch.full_like(q, n))
        nxt = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
        nxt = torch.cat([nxt[1:], torch.full((1,), n, dtype=torch.int64,
                                             device=dev)])
        se = torch.minimum(nxt, o1)
        out = torch.zeros_like(chars)
        out[o0 + (o1 - se) + (q - sg)] = c
        return out
    full = torch.zeros_like(chars)
    full[:total] = out
    return full


def string_map(offsets: torch.Tensor, chars: torch.Tensor,
               mode: int) -> torch.Tensor:
    """New chars under the same offsets (K21): MAP_UPPER and MAP_LOWER map
    ASCII letters only, MAP_INITCAP upper-cases a letter at a row start
    or after a space and lower-cases the rest, MAP_REVERSE reverses each
    row's UTF-8 characters (the bytes inside a character keep their
    order); zero past the total."""
    _check_span("string_map", offsets, chars)
    if offsets.device.type == "cpu":
        return string_map_plain(offsets, chars, mode)
    kernels.require_cuda("string_map", offsets, chars)
    cap = int(offsets.shape[0]) - 1
    out = torch.empty_like(chars)
    if chars.shape[0] == 0:
        return out
    lib = kernels.library("string_map")
    tiles = _tile_scratch(lib, offsets, chars) if mode in (MAP_INITCAP,
                                                  MAP_REVERSE) else None
    kernels.check(lib, lib.srt_string_map(
        offsets.data_ptr(), chars.data_ptr(), cap, int(chars.shape[0]),
        mode, None if tiles is None else tiles.data_ptr(), out.data_ptr(),
        kernels.stream(offsets)), "string_map")
    string_map.launches += 1
    return out


string_map.launches = 0
