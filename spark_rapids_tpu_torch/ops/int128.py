"""128-bit two's-complement integers over pairs of int64 tensors.

A DECIMAL wider than 18 digits is its unscaled value as (lo, hi): ``lo``
the low 64 bits (int64 bits of the unsigned word), ``hi`` the signed
high 64 bits (types.py).  torch has no 128-bit or unsigned 64-bit
arithmetic, so these helpers build it from int64 ops: an unsigned
compare is a signed compare of both words XOR 2^63, a product goes
through 32-bit limbs (each partial product's bits are its unsigned value
however int64 wraps), a division by a power of ten through 16-bit limbs,
and any other division bit by bit (``div_half_up``, ``divmod_trunc``).
Every op is exact modulo 2^128 and vectorised over rows; a Python int
stands for a constant.  The reference computes these on its CPU engine
as Python-int object arrays (``expr/arithmetic.py`` ``_widen_for``); the
results are the same integers.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]
_SIGN = -2**63
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def const(x: int) -> Tuple[int, int]:
    """A Python int (taken mod 2^128) as (lo, hi) int64 Python ints."""
    lo = x & _M64
    hi = (x >> 64) & _M64
    return (lo - (1 << 64) if lo >= 1 << 63 else lo,
            hi - (1 << 64) if hi >= 1 << 63 else hi)


def from_int64(x: torch.Tensor) -> Pair:
    """An int64 lane sign-extended to 128 bits."""
    x = x.to(torch.int64)
    return x, x >> 63


def full(x: int, like: torch.Tensor) -> Pair:
    lo, hi = const(x)
    return (torch.full_like(like, lo, dtype=torch.int64),
            torch.full_like(like, hi, dtype=torch.int64))


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b of int64 bits."""
    if not isinstance(b, torch.Tensor):
        b = const(b)[0]
    return (a ^ _SIGN) < (b ^ _SIGN)


def _pair(b, like: torch.Tensor) -> Pair:
    if isinstance(b, int):
        return full(b, like)
    return b


def add(a: Pair, b: Union[Pair, int]) -> Pair:
    blo, bhi = _pair(b, a[0])
    lo = a[0] + blo
    carry = ult(lo, a[0]).to(torch.int64)
    return lo, a[1] + bhi + carry


def neg(a: Pair) -> Pair:
    lo = -a[0]
    return lo, ~a[1] + (a[0] == 0).to(torch.int64)


def sub(a: Pair, b: Union[Pair, int]) -> Pair:
    return add(a, neg(_pair(b, a[0])))


def _limbs(a: Pair):
    lo, hi = a
    return [lo & _M32, (lo >> 32) & _M32, hi & _M32, (hi >> 32) & _M32]


def mul(a: Pair, b: Union[Pair, int]) -> Pair:
    """a * b modulo 2^128 (the exact product of two's-complement values
    whenever it fits)."""
    al = _limbs(a)
    if isinstance(b, int):
        b = b & ((1 << 128) - 1)
        bl = [(b >> (32 * i)) & _M32 for i in range(4)]
    else:
        bl = _limbs(b)
    cols = [torch.zeros_like(a[0]) for _ in range(4)]
    for i in range(4):
        for j in range(4 - i):
            if isinstance(bl[j], int) and bl[j] == 0:
                continue
            p = al[i] * bl[j]              # the bits of the unsigned product
            cols[i + j] = cols[i + j] + (p & _M32)
            if i + j + 1 < 4:
                cols[i + j + 1] = cols[i + j + 1] + ((p >> 32) & _M32)
    out = []
    carry = torch.zeros_like(a[0])
    for k in range(4):
        c = cols[k] + carry
        out.append(c & _M32)
        carry = c >> 32
    return out[0] | (out[1] << 32), out[2] | (out[3] << 32)


def is_neg(a: Pair) -> torch.Tensor:
    return a[1] < 0


def abs_(a: Pair) -> Pair:
    n = neg(a)
    s = is_neg(a)
    return torch.where(s, n[0], a[0]), torch.where(s, n[1], a[1])


def where(c: torch.Tensor, a: Pair, b: Pair) -> Pair:
    return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])


def lt(a: Pair, b: Union[Pair, int]) -> torch.Tensor:
    blo, bhi = _pair(b, a[0])
    return (a[1] < bhi) | ((a[1] == bhi) & ult(a[0], blo))


def eq(a: Pair, b: Union[Pair, int]) -> torch.Tensor:
    blo, bhi = _pair(b, a[0])
    return (a[0] == blo) & (a[1] == bhi)


def divmod_small(a: Pair, d) -> Tuple[Pair, torch.Tensor]:
    """(a // d, a % d) of a non-negative a and a divisor 0 < d < 2^47 (a
    Python int): 16-bit limbs from the top, each step's
    partial remainder times 2^16 below 2^63."""
    words = []
    for w in (a[1], a[0]):
        words += [(w >> s) & 0xFFFF for s in (48, 32, 16, 0)]
    r = torch.zeros_like(a[0])
    q = []
    for limb in words:
        cur = (r << 16) | limb
        qi = torch.div(cur, d, rounding_mode="floor")
        r = cur - qi * d
        q.append(qi)
    hi = (q[0] << 48) | (q[1] << 32) | (q[2] << 16) | q[3]
    lo = (q[4] << 48) | (q[5] << 32) | (q[6] << 16) | q[7]
    return (lo, hi), r


def div_pow10(a: Pair, k: int) -> Pair:
    """floor(a / 10^k) of a non-negative a."""
    while k > 0:
        step = min(k, 14)                  # 10^14 < 2^47
        a, _ = divmod_small(a, 10 ** step)
        k -= step
    return a


def round_half_up_pow10(a: Pair, k: int) -> Pair:
    """a / 10^k rounded half away from zero (Spark's HALF_UP)."""
    if k <= 0:
        return a
    s = is_neg(a)
    m = abs_(a)
    q = div_pow10(m, k)
    r = sub(m, mul(q, 10 ** k))
    up = ~lt(r, sub(full(10 ** k, r[0]), r))     # 2r >= 10^k, no overflow
    q = add(q, (up.to(torch.int64), torch.zeros_like(q[1])))
    return where(s, neg(q), q)


def _ult128(a: Pair, b: Pair) -> torch.Tensor:
    """Unsigned a < b of two 128-bit words."""
    return ult(a[1], b[1]) | ((a[1] == b[1]) & ult(a[0], b[0]))


def _shl1(a: Pair, bit: torch.Tensor) -> Pair:
    """(a << 1) | bit modulo 2^128."""
    return (a[0] << 1) | bit, (a[1] << 1) | ((a[0] >> 63) & 1)


def div_half_up(a: Pair, mult: int, d: Pair, a_bound: int,
                d_bound: int) -> Pair:
    """a * mult / d rounded half away from zero (Spark's HALF_UP), modulo
    2^128, for |a| < a_bound, 0 < |d| < d_bound and a Python int
    mult > 0.  Where |a| * mult fits 62 bits and |d| int64 this is one
    int64 divide.  Else a binary long division over the bits of the exact
    product |a| * mult (up to 256 bits, kept as 32-bit limbs), one
    quotient bit a step: the remainder stays below |d| <= 2^127, so a
    shifted remainder fits two unsigned words.  Both ways run on the tensors'
    device, with no host read and no branch on the data."""
    s = is_neg(a) != is_neg(d)
    if a_bound * mult <= 1 << 62 and d_bound <= 1 << 63:
        n = a[0].abs() * mult
        dm = d[0].abs()
        q = torch.div(n, dm, rounding_mode="floor")
        r = n - q * dm
        q = q + (r >= dm - r).to(torch.int64)       # 2r >= |d|
        return from_int64(torch.where(s, -q, q))
    m, dm = abs_(a), abs_(d)        # unsigned: |-2^127| is 2^127's bits
    ml = [(mult >> (32 * i)) & _M32 for i in range((mult.bit_length()
                                                    + 31) // 32)]
    al = _limbs(m)
    cols = [torch.zeros_like(m[0]) for _ in range(len(al) + len(ml) + 1)]
    for i, x in enumerate(al):
        for j, y in enumerate(ml):
            if y:
                p = x * y               # the bits of the unsigned product
                cols[i + j] = cols[i + j] + (p & _M32)
                cols[i + j + 1] = cols[i + j + 1] + ((p >> 32) & _M32)
    limbs, carry = [], torch.zeros_like(m[0])
    for c in cols:
        c = c + carry
        limbs.append(c & _M32)
        carry = c >> 32
    q, r = _long_divide(limbs, (a_bound * mult).bit_length(), dm)
    up = ~_ult128(r, sub(dm, r))                    # 2r >= |d|
    q = add(q, (up.to(torch.int64), torch.zeros_like(m[0])))
    return where(s, neg(q), q)


def _long_divide(limbs, nbits: int, dm: Pair) -> Tuple[Pair, Pair]:
    """(quotient, remainder) of the unsigned number in 32-bit ``limbs``
    (its low ``nbits`` bits) by an unsigned 128-bit ``dm > 0``: binary
    long division, one quotient bit a step."""
    zero = torch.zeros_like(dm[0])
    r, q = (zero, zero), (zero, zero)
    for b in range(nbits - 1, -1, -1):
        r = _shl1(r, (limbs[b // 32] >> (b % 32)) & 1)
        ge = ~_ult128(r, dm)
        r = where(ge, sub(r, dm), r)
        q = _shl1(q, ge.to(torch.int64))
    return q, r


def divmod_trunc(a: Pair, d: Pair, a_bound: int,
                 d_bound: int) -> Tuple[Pair, Pair]:
    """(a / d truncated toward zero, the remainder, which takes a's sign)
    for |a| < a_bound and 0 < |d| < d_bound: one int64 divide where both
    fit int64, else the long division over |a|'s bits."""
    if a_bound <= 1 << 63 and d_bound <= 1 << 63:
        q = torch.div(a[0], d[0], rounding_mode="trunc")
        return from_int64(q), from_int64(a[0] - q * d[0])
    q, r = _long_divide(_limbs(abs_(a)), min(a_bound.bit_length(), 128),
                        abs_(d))
    return (where(is_neg(a) != is_neg(d), neg(q), q),
            where(is_neg(a), neg(r), r))


def fits_digits(a: Pair, p: int) -> torch.Tensor:
    """|a| < 10^p."""
    lim = 10 ** p
    return lt(a, lim) & ~lt(a, -lim + 1) if p < 39 else \
        torch.ones_like(a[0], dtype=torch.bool)


def to_ints(a: Pair):
    """The values as Python ints, on the host (for tests and checks)."""
    lo, hi = a[0].cpu().tolist(), a[1].cpu().tolist()
    return [(h << 64) | (lw & _M64) for lw, h in zip(lo, hi)]


def from_ints(vals, device) -> Pair:
    lo, hi = zip(*(const(v) for v in vals)) if vals else ((), ())
    return (torch.tensor(lo, dtype=torch.int64, device=device),
            torch.tensor(hi, dtype=torch.int64, device=device))
