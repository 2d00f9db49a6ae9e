#!/usr/bin/env python3
"""K19 (``string_find``) and K21 (``string_map``) of this tree against
other versions of their sources, in turns in one process on one GPU.

    python3 k19_probe.py [OTHER_STRING_FIND_CU OTHER_STRING_MAP_CU] [ROUNDS]

OTHER_STRING_FIND_CU and OTHER_STRING_MAP_CU are other versions of
``csrc/string_find.cu`` and ``csrc/string_map.cu`` (for example the parent
commit's, written out with ``git show`` into ``parent/``, which
``.gitignore`` lists), built beside them with this tree's nvcc flags;
either C interface is taken, this tree's (row tiles as scratch) or the
one before it.  Without them only this tree's build is timed.

The shapes are chip_smoke.py's: qt1's o_comment column (2^25 rows of
19-78 bytes, 1.61 GB, chars 4 bytes off alignment as uploaded) and qt4's
p_name column (2^22 rows).  Every result of both builds is held against
the plain versions exactly (over the comments, the mask mode and K21's
reverse against the plain version on the first 2^22 rows, and against
each other on all of them: the plain versions' index tensors would not
fit).  Then, ROUNDS
times (default 3), this build and the other in turns, CUDA events over 5
calls after a warm-up: K19 at qt1's call (LIKE '%special%requests%'),
one token ("special", a first byte seen often), a token whose first byte
never occurs, a one-byte token, an anchored token, the third "e" from the
end, and the mask mode of a replace ("the" over the comments, "green"
over the names, qt4's); K21's four modes over the comments and over the
names.  Prints each bound (bytes over 3.35 TB/s: K19 the rows' bytes, the
offsets and 4 B a row out, the mask mode a byte out a row byte; K21 each
row byte read and written once and the offsets), a clone of the bytes
for scale, ptxas's registers, stack and spills of this build, and the
card's name and power limit.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.columnar.device import batch_to_device
from spark_rapids_tpu_torch.ops import strings as so

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interface before row tiles (no n, no scratch)
_OLD = {"srt_string_find": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P,
                            _P],
        "srt_string_match_mask": [_P, _P, _I, _P, _I, _P, _P],
        "srt_string_map": [_P, _P, _I, _L, _I, _P, _P]}


class Build:
    """``find``, ``mask`` and ``map`` of one build of K19 and K21."""

    def __init__(self, find_lib, map_lib):
        self.fl, self.ml = find_lib, map_lib
        self.tiled = hasattr(find_lib, "srt_tile_count")

    def _tiles(self, lib, offs, chars):
        n = lib.srt_tile_count(int(offs.shape[0]) - 1, int(chars.shape[0]))
        return torch.empty(4 * n, dtype=torch.int32, device=chars.device)

    def find(self, offs, chars, pat):
        cap = int(offs.shape[0]) - 1
        out = torch.empty(cap, dtype=torch.int32, device=offs.device)
        nb, packed, ints = so._pattern_arrays(pat, offs.device)
        head = (offs.data_ptr(), chars.data_ptr(), cap)
        mid = (packed.data_ptr(), nb, ints.data_ptr(), len(pat.tokens),
               int(pat.wildcard is not None), pat.repeat, int(pat.reverse),
               None)
        if self.tiled:
            path = 0 if so.find_plan(pat) == "bitmaps" else 1
            err = self.fl.srt_string_find(
                *head, int(chars.shape[0]), *mid, path,
                self._tiles(self.fl, offs, chars).data_ptr(), out.data_ptr(),
                kernels.stream(offs))
        else:
            err = self.fl.srt_string_find(*head, *mid, out.data_ptr(),
                                          kernels.stream(offs))
        kernels.check(self.fl, err, "string_find")
        return out

    def mask(self, offs, chars, needle):
        out = torch.zeros(chars.shape[0], dtype=torch.bool,
                          device=chars.device)
        head = (offs.data_ptr(), chars.data_ptr(), int(offs.shape[0]) - 1)
        if self.tiled:
            nb, packed, ints = so._pattern_arrays(so.FindPattern([needle]),
                                                  chars.device)
            err = self.fl.srt_string_match_mask(
                *head, int(chars.shape[0]), packed.data_ptr(), nb,
                ints.data_ptr(), self._tiles(self.fl, offs, chars).data_ptr(),
                out.data_ptr(), kernels.stream(offs))
        else:
            pat = torch.tensor(list(needle), dtype=torch.uint8).to(
                chars.device)
            err = self.fl.srt_string_match_mask(
                *head, pat.data_ptr(), len(needle), out.data_ptr(),
                kernels.stream(offs))
        kernels.check(self.fl, err, "string_match_mask")
        return out

    def map(self, offs, chars, mode):
        out = torch.empty_like(chars)
        head = (offs.data_ptr(), chars.data_ptr(), int(offs.shape[0]) - 1,
                int(chars.shape[0]), mode)
        if self.tiled:
            tiles = self._tiles(self.ml, offs, chars)
            err = self.ml.srt_string_map(*head, tiles.data_ptr(),
                                         out.data_ptr(), kernels.stream(offs))
        else:
            err = self.ml.srt_string_map(*head, out.data_ptr(),
                                         kernels.stream(offs))
        kernels.check(self.ml, err, "string_map")
        return out


def _other(src: str, name: str) -> ctypes.CDLL:
    """The other source of kernel ``name``, built beside it."""
    lib_path = Path(src).with_suffix(".so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                        str(kernels.CSRC), "-o", str(lib_path), src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    tiled = hasattr(lib, "srt_tile_count")
    for fn, args in (kernels._SIGNATURES[name] if tiled else
                     {k: v for k, v in _OLD.items()
                      if hasattr(lib, k)}).items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.srt_error_string.argtypes = [_I]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, reps=5):
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


def _bound(nbytes):
    return nbytes / cs.HBM_BYTES_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k19_probe: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    rounds = int(args.pop()) if args and args[-1].isdigit() else 3
    if len(args) not in (0, 2):
        print(__doc__)
        return 2
    card = cs._card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build(["string_find", "string_map"])
    for name in ("string_find", "string_map"):
        log = kernels.library_path(name).with_suffix(".log").read_text()
        fn = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                fn = line.split("'")[1]
            if "registers" in line or "stack frame" in line:
                print(f"ptxas {name} {fn.split('_cu_')[-1][:40]}: "
                      f"{line.strip()}")
    this = Build(kernels.library("string_find"), kernels.library("string_map"))
    builds = [("this", this)]
    if args:
        builds.append(("other", Build(_other(args[0], "string_find"),
                                      _other(args[1], "string_map"))))
    dev = torch.device("cuda")
    orders, part, _, _ = cs._text_tables(cs.TEXT_ROWS)
    com = batch_to_device(orders.combine_chunks().to_batches()[0],
                          dev).columns[1]
    nam = batch_to_device(part.select(["p_name"]).slice(0, cs.TEXT_PROJ_ROWS)
                          .combine_chunks().to_batches()[0], dev).columns[0]
    del orders, part
    cols = {"comments": (com.offsets, com.data), "names": (nam.offsets,
                                                           nam.data)}
    for what, (o, c) in cols.items():
        print(f"{what}: {int(o.shape[0]) - 1} rows, {int(o[-1])} bytes in "
              f"{int(c.shape[0])}, chars at {c.data_ptr() % 16} mod 16")
    o, c = cols["comments"]
    total = int(o[-1])
    rows = int(o.shape[0]) - 1
    cases = [(f"K19 {what}", "find", "comments", pat) for what, pat in (
        ("qt1's call", so.FindPattern([b"special", b"requests"])),
        ("special", so.FindPattern([b"special"])),
        ("zzzzzzz (first byte never occurs)", so.FindPattern([b"zzzzzzz"])),
        ("s", so.FindPattern([b"s"])),
        ("ab anchored at the start",
         so.FindPattern([b"ab"], modes=[so.FIND_AT_START])),
        ("the third e from the end",
         so.FindPattern([b"e"], repeat=3, reverse=True)))]
    cases += [("K19 mask 'the'", "mask", "comments", b"the"),
              ("K19 mask 'green' (qt4's replace)", "mask", "names", b"green")]
    cases += [(f"K21 {m} over the {col}", "map", col, mode)
              for col in ("comments", "names")
              for mode, m in enumerate(("upper", "lower", "initcap",
                                        "reverse"))]
    for what, kind, col, arg in cases:
        o, c = cols[col]
        total, rows = int(o[-1]), int(o.shape[0]) - 1
        outs = [getattr(b, kind)(o, c, arg) for _, b in builds]
        if col == "comments" and (kind == "mask" or
                                  (kind == "map" and arg == so.MAP_REVERSE)):
            # the plain version's int64 index tensors over 1.61 GB would
            # not fit: the first 2^22 rows, and the builds against each
            # other on all of them
            k = 1 << 22
            plain = (so.string_match_mask_plain if kind == "mask" else
                     so.string_map_plain)
            want = plain(o[:k + 1], c[:int(o[k])], arg)
            ok = all(torch.equal(x[:int(o[k])], want[:int(o[k])])
                     for x in outs) and all(torch.equal(x, outs[0])
                                            for x in outs)
        else:
            want = {"find": so.string_find_plain,
                    "mask": so.string_match_mask_plain,
                    "map": so.string_map_plain}[kind](o, c, arg)
            ok = all(torch.equal(x, want) for x in outs)
        del outs, want
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{what} differs from its plain version")
        moved = {"find": total + 8 * rows + 4, "mask": 2 * total + 4 * rows,
                 "map": 2 * total + 4 * rows + 4}[kind]
        times = {name: [] for name, _ in builds}
        for _ in range(rounds):
            for name, b in builds:
                times[name].append(_ms(lambda: getattr(b, kind)(o, c, arg)))
        print(f"{what}: equal; " + ", ".join(
            f"{name} {[round(x, 3) for x in ts]} ms"
            for name, ts in times.items())
            + f"; bound {_bound(moved):.3f} ms", flush=True)
    o, c = cols["comments"]
    print(f"a clone of the comments' bytes: "
          f"{_ms(lambda: c[:int(o[-1])].clone()):.3f} ms")
    print(f"K19, K21 against {args or 'nothing'}: done; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
