"""K3 (``segment_reduce_sorted``) of this tree against another tree's,
in turns in one process on the card.

    python3 k3_ab.py OTHER_TREE [ROUNDS]

OTHER_TREE holds another version of the ``spark_rapids_tpu_torch/``
package (for example the parent commit, unpacked with ``git archive``
into a directory that ``.gitignore`` lists).  Both builds run the same
K3 calls, captured from chip_smoke.py's q1 and q1x at 2^25 rows over one
partition.  Each build's result must equal the plain version's (integer
results and counts exactly, float sums to chip_smoke's FLOAT_RTOL).
Then the two are timed with CUDA events in turns, other / this / this /
other, ROUNDS times (default 5).  Prints ptxas's registers and spills of
each build's fold kernels, the card's name and power limit, and as its
last line one JSON object of the times in ms.
"""

import importlib
import importlib.util
import json
import statistics
import sys
import threading
from pathlib import Path

import chip_smoke as cs


def _load(tree: str, alias: str):
    """The package of ``tree`` imported as ``alias`` (its imports within
    the package are relative, so it loads beside this tree's)."""
    init = Path(tree).resolve() / "spark_rapids_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.kernels"), \
        importlib.import_module(f"{alias}.exec.aggregate")


def _ptxas(kernels_mod):
    """(kernel, registers, spill line) of each fold kernel in ptxas's
    log of K3's build."""
    log = kernels_mod.library_path("segment_reduce").with_suffix(".log")
    out, name = [], None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            spill = ""
        elif name and "fold_kernel" in name:
            if "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif "Used" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                # the template arguments, e.g. fold_kernelILi8ELb0ELb0EE
                at = name.find("fold_kernel")
                out.append((name[at:name.find("EE", at) + 2], int(regs),
                            spill))
                name = None
    return out


def main(argv) -> int:
    import torch
    if len(argv) < 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 1
    other_kernels, other_agg = _load(argv[1], "other_port")
    rounds = int(argv[2]) if len(argv) > 2 else 5
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.exec import aggregate as agg

    other_build = threading.Thread(
        target=other_kernels.build, args=(["segment_reduce"],))
    other_build.start()
    kernels.build()
    other_build.join()
    if not other_kernels.library_path("segment_reduce").exists():
        raise RuntimeError("the other tree's K3 did not build")
    card = cs._card_line()
    for what, mod in (("this", kernels), ("other", other_kernels)):
        for name, regs, spill in _ptxas(mod):
            print(f"ptxas {what}: {name}: {regs} registers; {spill}")

    table, _ = cs._make_tables(cs.ROWS)
    session = GpuSession()
    queries = {
        "q1": session.create_dataframe(table).filter(
            col("v") > cs.THRESHOLD).group_by("k").agg(
            F.sum("v"), F.avg("f"), F.count("*")),
        "q1x": cs._q1x_df(session, table, 1, F, col, lit)}

    def cuda_ms(fn, reps=5):
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

    result = {}
    for name, df in queries.items():
        df.collect()
        with cs._Capture(agg, "segment_reduce_sorted") as cap:
            df.collect()
        (_, args), = cap.calls
        ops = [op or "count" for op in (args[6] if len(args) > 6 else [
            "sum" if v is not None else None for v in args[2]])]
        want = agg.segment_reduce_sorted_plain(*args)
        this_k3 = cap.orig["segment_reduce_sorted"]
        for who, fn in (("this", this_k3),
                        ("other", other_agg.segment_reduce_sorted)):
            cs._k3_minmax_diff(torch, fn(*args), want, ops,
                               f"at {name}'s shapes ({who} tree)")
        turns = {"other": [], "this": []}
        for _ in range(rounds):
            for who in ("other", "this", "this", "other"):
                fn = this_k3 if who == "this" else \
                    other_agg.segment_reduce_sorted
                turns[who].append(cuda_ms(lambda: fn(*args)))
        n = int(args[3][0].shape[0])
        result[name] = dict(
            rows=n, ops=ops, this_ms=turns["this"], other_ms=turns["other"],
            this_median_ms=statistics.median(turns["this"]),
            other_median_ms=statistics.median(turns["other"]))
        print(f"K3 at {name}'s shapes ({n} rows, ops {ops}): this "
              f"{', '.join(f'{x:.3f}' for x in turns['this'])} ms; other "
              f"{', '.join(f'{x:.3f}' for x in turns['other'])} ms; {card}")
        del want
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
