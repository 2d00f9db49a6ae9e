"""K3 (``segment_reduce_sorted``) and K5 (``expand_pairs``) of this
tree against another tree's, in turns in one process on the card, and
K3's run path against its tiles of sorted rows over orders of few runs.

    python3 k3_ab.py OTHER_TREE [ROUNDS]

OTHER_TREE holds another version of the ``spark_rapids_tpu_torch/``
package (for example the parent commit, unpacked with ``git archive``
into a directory that ``.gitignore`` lists).  The calls timed:
  * q1's and q1x's K3 calls at 2^25 rows over one partition, captured
    from this tree, and the synthetic 128-bit call of chip_smoke.py
    (``_k3_128_args``: 2^25 rows, 6 groups): both builds run the same
    arguments;
  * q1d's (TPC-H Q1 over DECIMAL(15,2) and DATE) K3 calls over one and
    over four partitions: each tree runs the query through its own
    session and times the calls it made, since the trees may hand K3
    different lanes for the same query (a sum of a DECIMAL64 column is
    read with or without a materialised lane of signs);
  * K5's call of q2 (the 2^25-row fact table joined USING k with the
    100,000-row dimension), captured from this tree;
  * this tree's K3 on the direct path forced onto the run path and kept
    in tiles of sorted rows (``path="run"``, ``path="direct"``), over
    2^25 rows in 6, 16, 32 and 64 groups (so as many runs of K2's
    order): the synthetic 128-bit call and q1's 64-bit ops (an int64
    sum, a float64 sum and a count).
Each build's result must equal its own plain version's (integer and
128-bit results, counts and K5's pairs exactly, float sums to
chip_smoke's FLOAT_RTOL).  Then the two are timed with CUDA events in
turns, other / this / this / other (direct / run / run / direct), ROUNDS
times (default 5).  Last, each tree's q1d
call (and this tree's with the run path off, and q1x's) is profiled
with ``torch.profiler``: device microseconds a call by kernel, and the
host's wall a call (10 calls, synchronised).  Prints ptxas's registers
and spills of each build's K3 kernels and of this build's K5, the
card's name and power limit, and as its last line one JSON object of the
times in ms.
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
    return {name: importlib.import_module(f"{alias}.{name}") for name in (
        "kernels", "exec.aggregate", "api.session", "api.functions",
        "api.column", "ops.join_kernels")}


_KERNELS = ("run_fold_kernel", "run_starts_kernel", "pieces_kernel",
            "fold_kernel", "fixup_kernel", "pack_kernel", "varying_kernel")


def _ptxas(kernels_mod):
    """(kernel, registers, spill line) of each K3 kernel in ptxas's log
    of K3's build."""
    log = kernels_mod.library_path("segment_reduce").with_suffix(".log")
    out, name, spill = [], None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            spill = ""
        elif name:
            if "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                short = next((k for k in _KERNELS if k in name), name)
                at = name.find(short)
                # the template arguments, e.g. fold_kernelILi8ELb0ELb1EE
                end = name.find("EE", at)
                out.append((name[at:end + 2] if end > 0 else short,
                            int(regs), spill))
                name = None
    return out


def _check(torch, got, want, ops, what):
    """Raises unless ``got`` equals the plain version's ``want``: a
    128-bit op's (lo, hi) pair and every count exactly, the rest as
    chip_smoke's ``_k3_minmax_diff``."""
    flat = []
    for k, (x, y) in enumerate(zip(got[1], want[1])):
        if not torch.equal(got[2][k], want[2][k]):
            raise AssertionError(f"K3 counts of op {k} differ {what}")
        if isinstance(y, tuple):
            if not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])):
                raise AssertionError(f"K3 128-bit op {k} differs {what}")
        else:
            flat.append(k)
    cs._k3_minmax_diff(
        torch, *[(r[0], [r[1][k] for k in flat], [r[2][k] for k in flat],
                  r[3]) for r in (got, want)], [ops[k] for k in flat], what)


def _ops(args):
    return [op or "count" for op in (args[6] if len(args) > 6 else [
        "sum" if v is not None else None for v in args[2]])]


def main(argv) -> int:
    import torch
    if len(argv) < 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 1
    other = _load(argv[1], "other_port")
    rounds = int(argv[2]) if len(argv) > 2 else 5
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.exec import aggregate as agg
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import join_kernels as jk

    other_build = threading.Thread(
        target=other["kernels"].build,
        args=(["segment_reduce", "join_expand"],))
    other_build.start()
    kernels.build()
    other_build.join()
    if not other["kernels"].library_path("segment_reduce").exists():
        raise RuntimeError("the other tree's K3 did not build")
    card = cs._card_line()
    for what, mod in (("this", kernels), ("other", other["kernels"])):
        for name, regs, spill in _ptxas(mod):
            print(f"ptxas {what}: {name}: {regs} registers; {spill}")
    log = kernels.library_path("join_expand").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas this: join_expand: {line.strip()}")

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

    def timed(name, fns, rows, extra, kernel="K3"):
        """``fns``' two sides timed a / b / b / a, ROUNDS times."""
        a, b = fns
        turns = {a: [], b: []}
        for _ in range(rounds):
            for who in (a, b, b, a):
                turns[who].append(cuda_ms(fns[who]))
        result[name] = dict(rows=rows, **extra)
        for who in (b, a):
            result[name][f"{who}_ms"] = turns[who]
            result[name][f"{who}_median_ms"] = statistics.median(turns[who])
        print(f"{kernel} at {name} ({rows} rows, {extra}): " + "; ".join(
            f"{who} {', '.join(f'{x:.3f}' for x in turns[who])} ms"
            for who in (b, a)) + f"; {card}", flush=True)

    result = {}
    dev = torch.device("cuda")
    this_k3 = agg.segment_reduce_sorted
    other_k3 = other["exec.aggregate"].segment_reduce_sorted
    # the same arguments through both builds
    table, dim = cs._make_tables(cs.ROWS)
    session = GpuSession()
    shared = {
        "q1": session.create_dataframe(table).filter(
            col("v") > cs.THRESHOLD).group_by("k").agg(
            F.sum("v"), F.avg("f"), F.count("*")),
        "q1x": cs._q1x_df(session, table, 1, F, col, lit)}
    calls = {}
    for name, df in shared.items():
        df.collect()
        with cs._Capture(agg, "segment_reduce_sorted") as cap:
            df.collect()
        (_, args), = cap.calls
        calls[name] = (args, {})
    # K5 at q2's call
    q2 = (session.create_dataframe(table)
          .join(session.create_dataframe(dim), on="k", how="inner")
          .group_by(col("k")).agg(F.sum(col("w")).alias("sw")))
    q2.collect()
    with cs._Capture(jk, "expand_pairs") as cap:
        q2.collect()
    (_, k5_args), = cap.calls
    this_k5 = cap.orig["expand_pairs"]
    other_k5 = other["ops.join_kernels"].expand_pairs
    want = jk.expand_pairs_plain(*k5_args)
    for who, fn in (("this", this_k5), ("other", other_k5)):
        if not cs._same_expansion(torch, fn(*k5_args), want):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"q2's call ({who} tree)")
    timed("q2", {"other": lambda: other_k5(*k5_args),
                 "this": lambda: this_k5(*k5_args)},
          int(k5_args[0].shape[0]), dict(pairs=int(k5_args[4])), "K5")
    del table, dim, shared, q2, k5_args, want
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 18)
    args, his = cs._k3_128_args(torch, dev, carry, gen, cs.ROWS, 6)
    calls["synthetic 128-bit"] = (args, dict(values_hi=his))
    calls_q1x = calls["q1x"]
    for name, (args, kw) in calls.items():
        ops = _ops(args)
        want = agg.segment_reduce_sorted_plain(*args, **kw)
        for who, fn in (("this", this_k3), ("other", other_k3)):
            _check(torch, fn(*args, **kw), want, ops,
                   f"at {name}'s shapes ({who} tree)")
        del want
        timed(name, {"other": lambda: other_k3(*args, **kw),
                     "this": lambda: this_k3(*args, **kw)},
              int(args[3][0].shape[0]), dict(ops=ops))
    calls.clear()

    # the run path against tiles of sorted rows over few runs
    for groups in (6, 16, 32, 64):
        args, his = cs._k3_128_args(torch, dev, carry, gen, cs.ROWS, groups)
        words, order = args[0], args[5]
        v = torch.randint(-10**6, 10**6, (cs.ROWS,), generator=gen,
                          device=dev)
        f = torch.rand(cs.ROWS, generator=gen, device=dev,
                       dtype=torch.float64)
        sweep = {"128-bit": (args, dict(values_hi=his)),
                 "q1's ops": ((words, None, [v, f, None], list(args[3][:3]),
                               False, order), {})}
        for what, (a, kw) in sweep.items():
            want = agg.segment_reduce_sorted_plain(*a, **kw)
            plans = {}
            for path in ("direct", "run"):
                _check(torch, this_k3(*a, path=path, **kw), want, _ops(a),
                       f"at {what} in {groups} runs, path={path}")
                plans[path] = this_k3.last_plan
            timed(f"{what} in {groups} runs", {
                p: (lambda p=p: this_k3(*a, path=p, **kw))
                for p in ("direct", "run")}, cs.ROWS, dict(
                run_path=plans["run"].run_path, **{
                    f"{p}_scratch_bytes": plans[p].scratch_bytes
                    for p in plans}))
            del want
        del args, his, words, order, v, f, sweep

    # q1d through each tree's own session
    lineitem, _ = cs._lineitem(cs.ROWS)
    trees = {
        "this": (agg, GpuSession, F, col, lit),
        "other": (other["exec.aggregate"], other["api.session"].GpuSession,
                  other["api.functions"], other["api.column"].col,
                  other["api.column"].lit)}
    profiled = {}
    for parts in (1, 4):
        own = {}
        for who in ("other", "this"):
            agg_mod, session_cls, F_, col_, lit_ = trees[who]
            df = cs._q1d_df(session_cls(), lineitem, parts, F_, col_, lit_)
            df.collect()
            with cs._Capture(agg_mod, "segment_reduce_sorted") as cap:
                df.collect()
            fn = cap.orig["segment_reduce_sorted"]
            runs = list(zip([a for _, a in cap.calls], cap.kwargs))
            for a, kw in runs:
                _check(torch, fn(*a, **kw),
                       agg_mod.segment_reduce_sorted_plain(*a, **kw),
                       _ops(a), f"at q1d x{parts} ({who} tree)")
            fn(*runs[0][0], **runs[0][1])
            plan = fn.last_plan
            own[who] = (fn, runs, dict(
                calls=len(runs), lanes=len(plan.sets[0].lanes),
                path="record" if plan.packed else "direct",
                run_path=getattr(plan, "run_path", False)))
            print(f"q1d x{parts} ({who} tree): {own[who][2]}", flush=True)
            if parts == 1:
                profiled[f"q1d ({who} tree)"] = (fn, runs[0])
                if who == "this":
                    profiled["q1d (this tree, run path off)"] = (
                        fn, (runs[0][0], dict(runs[0][1], path="direct")))
        timed(f"q1d x{parts}", {
            who: (lambda f=f, r=r: [f(*a, **kw) for a, kw in r])
            for who, (f, r, _) in own.items()},
            int(own["this"][1][0][0][3][0].shape[0]),
            dict(this=own["this"][2], other=own["other"][2]))
        own.clear()
    profiled["q1x (this tree)"] = (this_k3, calls_q1x)
    result["profile"] = {what: _profile(torch, fn, a, kw, what, card)
                         for what, (fn, (a, kw)) in profiled.items()}
    print(card)
    print(json.dumps(result))
    return 0


def _profile(torch, fn, args, kw, what, card):
    """Device microseconds a call by kernel (``torch.profiler`` over 3
    calls) and the host's wall ms a call (10 calls, synchronised)."""
    import time
    from torch.profiler import ProfilerActivity, profile
    fn(*args, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        fn(*args, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 100
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(*args, **kw)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us and ("kernel" in ev.key or "Memset" in ev.key or
                   "Memcpy" in ev.key):
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            kernels[name] = round(kernels.get(name, 0) + us / 3, 1)
    busy = round(sum(kernels.values()) / 1e3, 3)
    print(f"K3 profile at {what}: wall {wall:.3f} ms a call, device "
          f"{busy} ms: " + ", ".join(f"{k} {v} us" for k, v in sorted(
              kernels.items(), key=lambda x: -x[1])) + f"; {card}",
          flush=True)
    return dict(wall_ms=wall, device_ms=busy, kernels_us=kernels)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
