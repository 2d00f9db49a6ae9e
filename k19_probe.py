#!/usr/bin/env python3
"""K19 (string_find), K20 (utf8_cut) and K21 (string_map) on qt1's
comment column, by the kind of search, on one GPU.

    python3 k19_probe.py

Builds ``csrc/string_find.cu``, ``csrc/utf8_cut.cu`` and
``csrc/string_map.cu``, makes
``chip_smoke.py``'s o_comment column (2^25 rows of 19-78 bytes), and
times, as CUDA events over 5 calls after a warm-up: qt1's two LIKE
tokens, one token ("special", frequent first byte), a token whose first
byte never occurs, a one-byte token, an anchored token (no scan: the
staging copy alone), the third match from the end, a clone of the bytes
for scale, K20's length, trim and two literal substrings, and K21's
upper and initcap.  Prints the card's name and power limit.
"""

import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k19_probe: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.columnar.device import batch_to_device
    from spark_rapids_tpu_torch.ops import strings as sops

    kernels.build(["string_find", "utf8_cut", "string_map"])
    dev = torch.device("cuda")
    orders, _, _, _ = cs._text_tables(cs.TEXT_ROWS)
    col = batch_to_device(orders.combine_chunks().to_batches()[0],
                          dev).columns[1]
    offs, chars = col.offsets, col.data

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    print(f"card: {cs._card_line()}; {int(offs.shape[0]) - 1} rows, "
          f"{int(offs[-1])} bytes")
    for what, pat in (
            ("qt1's tokens special, requests",
             sops.FindPattern([b"special", b"requests"])),
            ("special", sops.FindPattern([b"special"])),
            ("zzzzzzz (first byte never occurs)",
             sops.FindPattern([b"zzzzzzz"])),
            ("s", sops.FindPattern([b"s"])),
            ("ab anchored at the start",
             sops.FindPattern([b"ab"], modes=[sops.FIND_AT_START])),
            ("the third e from the end",
             sops.FindPattern([b"e"], repeat=3, reverse=True))):
        t = ms(lambda: sops.string_find(offs, chars, pat))
        print(f"K19 {what}: {t:.3f} ms")
    print(f"a clone of the bytes: "
          f"{ms(lambda: chars[:int(offs[-1])].clone()):.3f} ms")
    for what, args in (("length", (sops.CUT_LENGTH,)),
                       ("trim", (sops.CUT_TRIM,)),
                       ("substring(1, 2), literals",
                        (sops.CUT_SUBSTRING, 1, 2)),
                       ("substring(-2, 2), literals",
                        (sops.CUT_SUBSTRING, -2, 2))):
        t = ms(lambda: sops.utf8_cut(offs, chars, *args))
        print(f"K20 {what}: {t:.3f} ms")
    for what, mode in (("upper", sops.MAP_UPPER),
                       ("initcap", sops.MAP_INITCAP)):
        t = ms(lambda: sops.string_map(offs, chars, mode))
        print(f"K21 {what}: {t:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
