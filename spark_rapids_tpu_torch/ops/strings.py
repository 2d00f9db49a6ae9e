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
  copy of the selected spans (K16, ``csrc/gather_strings.cu``).

The hashes are uint64 in the reference; here they are carried as int64
bits (multiplication and addition wrap the same mod 2^64).  A word that
K2 sorts is carried as (word XOR 2^63), so signed order is the
reference's unsigned order.  The rest of the reference's module
(``pack_rows``, ``window_bytes``) serves expr/strings.py and is not
ported.

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
