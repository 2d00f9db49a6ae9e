"""K18 (``span_rows``) of this tree against another version of its source,
in turns in one process on the card.

    python3 k18_ab.py OTHER_SPAN_ROWS_CU [ROUNDS]

OTHER_SPAN_ROWS_CU is another version of ``csrc/span_rows.cu`` with the
same C interface (for example the parent commit's, written out with
``git show`` into a directory that ``.gitignore`` lists).  It is built
beside it with this tree's nvcc flags.  Both builds run chip_smoke.py's
K18 edge cases and a call shaped like qa1's (TPC-H SF5's 7,500,000
orders of 1-7 lines, 1 % empty, 48.7 % kept, over 8,388,608 rows), and
each result must equal the plain version's exactly.  The skewed and the
large cases are then timed with CUDA events, this / other, ROUNDS times
(default 3), beside the plain version and the bound (4 B written a
child slot, 8 B read for each row that holds one).  Prints ptxas's
registers and spills of this build and the card's name and power limit.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from spark_rapids_tpu_torch import kernels
from spark_rapids_tpu_torch.ops import gather as g
from spark_rapids_tpu_torch.ops import strings as sops

TIMED = ("2^24", "10^6", "random", "4M", "qa1")


def _other(src: str):
    """``span_rows(starts, new_offsets, total, cap)`` of the other
    source, built next to it."""
    lib_path = Path(src).with_suffix(".so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                        str(lib_path), src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.srt_span_rows.argtypes = [p, p, i, i, p, ll, p]
    lib.srt_span_rows.restype = i

    def span_rows(starts, offs, total, cap):
        out = torch.zeros(cap, dtype=torch.int32, device=starts.device)
        n = int(starts.shape[0])
        if n and total:
            err = lib.srt_span_rows(starts.data_ptr(), offs.data_ptr(), n,
                                    total, out.data_ptr(), cap,
                                    kernels.stream(starts))
            if err:
                raise RuntimeError(f"{src}: CUDA error {err}")
        return out
    return span_rows


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _qa1_like(dev):
    rng = np.random.default_rng(cs.SEED)
    n_ord, cap_rows = 7_500_000, 8_388_608
    lens = rng.integers(1, 8, n_ord)
    lens[rng.random(n_ord) < 0.01] = 0
    keep = np.flatnonzero(rng.random(n_ord) < 0.487)
    offs = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lens)]).astype(np.int32)).to(dev)
    idx = np.zeros(cap_rows, np.int32)
    idx[:len(keep)] = keep
    valid = np.zeros(cap_rows, bool)
    valid[:len(keep)] = True
    new_offs, total, starts = sops.gather_offsets(
        offs, torch.from_numpy(idx).to(dev), torch.from_numpy(valid).to(dev))
    total = int(total)
    return ("qa1-like call", starts, new_offs, total,
            1 << (total - 1).bit_length())


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    card = cs._card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    kernels.build(["span_rows", "gather_strings"])
    for line in kernels.library_path("span_rows").with_suffix(
            ".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas span_rows: {line.strip()}")
    other = _other(sys.argv[1])
    dev = torch.device("cuda")
    cases = cs._k18_case_inputs(torch, dev, sops) + [_qa1_like(dev)]
    for what, starts, offs, total, cap in cases:
        want = g.span_rows_plain(starts, offs, total, cap)
        if not (torch.equal(g.span_rows(starts, offs, total, cap), want)
                and torch.equal(other(starts, offs, total, cap), want)):
            raise AssertionError(f"K18 differs from its plain version: {what}")
        line = f"{what}: {int(starts.shape[0])} rows, {total} child rows, equal"
        if what.startswith(TIMED):
            held = int((offs[1:] > offs[:-1]).sum())
            this_ms, other_ms = [], []
            for _ in range(rounds):
                this_ms.append(_ms(lambda: g.span_rows(starts, offs, total,
                                                       cap)))
                other_ms.append(_ms(lambda: other(starts, offs, total, cap)))
            plain = _ms(lambda: g.span_rows_plain(starts, offs, total, cap), 2)
            line += (f"; this {[round(x, 4) for x in this_ms]} ms, other "
                     f"{[round(x, 4) for x in other_ms]} ms, plain "
                     f"{plain:.3f} ms, bound "
                     f"{(4 * cap + 8 * held + 4) / cs.HBM_BYTES_PER_S * 1e3:.4f}"
                     f" ms")
        print(line, flush=True)
    print(f"K18 against {sys.argv[1]}: done; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
