"""K3 (``segment_reduce_sorted``) and K5 (``expand_pairs``) of this
tree against another tree's, in turns in one process on the card, and
K3's run path against its tiles of sorted rows over orders of few runs.

    python3 k3_ab.py OTHER_TREE [ROUNDS] [--only PHASE,...]

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
    sum, a float64 sum and a count);
  * qg2's K3 call (first, last, collect_list, collect_set and count per
    customer over TPC-H SF5's 7.5M orders) and qg4's four K23 calls
    (first and last over four frames of 2^25 rows), each tree's own
    through its own session, and both queries' warm walls; this tree's
    qg2 call again on each K3 path it may take.
Each build's result must equal its own plain version's (integer and
128-bit results, counts, positions, K23's picks and K5's pairs exactly,
float sums to chip_smoke's FLOAT_RTOL).  Then the two are timed with CUDA
events in turns, other / this / this / other (direct / run / run /
direct), ROUNDS times (default 5).  Last, each tree's q1d, qg2 and qg4
calls (and this tree's q1d with the run path off, and q1x's) are
profiled with ``torch.profiler``: device microseconds a call by kernel,
and the host's wall a call (10 calls, synchronised).  ``--only`` runs
the named phases alone, of q1 (q1's and q1x's calls), q2, synthetic,
runs, q1d, qg2, qg4, random (K3 over a random order: distinct's empty
op set, a count, qg2's op set, and this tree's direct and record paths
for qg2's op set over 2^23 to 2^25 rows) and host (this tree's host
caches at qg2's call against the same steps done anew).  Prints ptxas's registers
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
        "api.column", "ops.join_kernels", "ops.scan", "exec.window",
        "expr.window")}


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
    phases = set(PHASES)
    if "--only" in argv:
        at = argv.index("--only")
        phases = set(argv[at + 1].split(","))
        argv = argv[:at] + argv[at + 2:]
        if not phases <= set(PHASES):
            print(f"k3_ab: phases are {PHASES}", file=sys.stderr)
            return 2
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
        args=(["segment_reduce", "join_expand", "frame_pick"],))
    other_build.start()
    kernels.build()
    other_build.join()
    for name in ("segment_reduce", "frame_pick"):
        if not other["kernels"].library_path(name).exists():
            raise RuntimeError(f"the other tree's {name} did not build")
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
    profiled = {}
    table = dim = None
    if phases & {"q1", "q2", "qg4"}:
        table, dim = cs._make_tables(cs.ROWS)
    calls = {}
    trees = {
        "this": (agg, GpuSession, F, col, lit),
        "other": (other["exec.aggregate"], other["api.session"].GpuSession,
                  other["api.functions"], other["api.column"].col,
                  other["api.column"].lit)}
    if "q1" in phases:
        # each tree's own call: the trees may hand K3 other masks for the
        # same query (count(*) over every row has none here)
        def q1(session_cls, F_, col_, lit_):
            return session_cls().create_dataframe(table).filter(
                col_("v") > cs.THRESHOLD).group_by("k").agg(
                F_.sum("v"), F_.avg("f"), F_.count("*"))
        for name, make in (("q1", q1), ("q1x", lambda s_, F_, c_, l_:
                                        cs._q1x_df(s_(), table, 1, F_, c_,
                                                   l_))):
            own = _own_k3(torch, trees, name, make, profiled)
            timed(name, {who: (lambda f=f, a=a, kw=kw: f(*a, **kw))
                         for who, (f, a, kw, _) in own.items()},
                  cs._k3_rows(own["this"][1]),
                  dict(this=own["this"][3], other=own["other"][3]))
    if "q2" in phases:
        # K5 at q2's call
        session = GpuSession()
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
        del q2, k5_args, want
    if "qg4" in phases:
        _qg4(torch, other, table, timed, cuda_ms, profiled, rounds, result,
             card)
    del table, dim
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 18)
    if "synthetic" in phases:
        args, his = cs._k3_128_args(torch, dev, carry, gen, cs.ROWS, 6)
        calls["synthetic 128-bit"] = (args, dict(values_hi=his))
    for name, (args, kw) in calls.items():
        ops = _ops(args)
        want = agg.segment_reduce_sorted_plain(*args, **kw)
        for who, fn in (("this", this_k3), ("other", other_k3)):
            _check(torch, fn(*args, **kw), want, ops,
                   f"at {name}'s shapes ({who} tree)")
        del want
        timed(name, {"other": lambda: other_k3(*args, **kw),
                     "this": lambda: this_k3(*args, **kw)},
              cs._k3_rows(args), dict(ops=ops))
    calls.clear()

    # the run path against tiles of sorted rows over few runs
    for groups in ((6, 16, 32, 64) if "runs" in phases else ()):
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

    if "qg2" in phases:
        _qg2(torch, trees, timed, cuda_ms, profiled, result, card)
    if "random" in phases:
        _random(torch, other, timed, cuda_ms, profiled, result, card)
    if "host" in phases:
        _host(torch, result, card)
    # q1d through each tree's own session
    lineitem = cs._lineitem(cs.ROWS)[0] if "q1d" in phases else None
    for parts in ((1, 4) if "q1d" in phases else ()):
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
            cs._k3_rows(own["this"][1][0][0]),
            dict(this=own["this"][2], other=own["other"][2]))
        own.clear()
    del lineitem
    result["profile"] = {what: _profile(torch, fn, a, kw, what, card)
                         for what, (fn, (a, kw)) in profiled.items()}
    print(card)
    print(json.dumps(result))
    return 0


PHASES = ("q1", "q2", "synthetic", "runs", "q1d", "qg2", "qg4", "random",
          "host")


def _walls(torch, fns, rounds):
    """Each query's warm wall (ms, synchronised) in turns, other / this /
    this / other, ``rounds`` times."""
    import time
    out = {who: [] for who in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for who in ("other", "this", "this", "other"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[who]()
            torch.cuda.synchronize()
            out[who].append((time.perf_counter() - t) * 1e3)
    return out


def _own_k3(torch, trees, name, make_df, profiled):
    """The K3 call of the query ``make_df(session class, functions, col,
    lit)`` through each tree's own session, checked against that tree's
    plain version and profiled.  Returns {tree: (wrapper, args, kwargs,
    the plan's path, masks and modelled traffic)}."""
    own = {}
    for who in ("other", "this"):
        agg_mod, session_cls, F_, col_, lit_ = trees[who]
        df = make_df(session_cls, F_, col_, lit_)
        df.collect()
        with cs._Capture(agg_mod, "segment_reduce_sorted") as cap:
            df.collect()
        fn = cap.orig["segment_reduce_sorted"]
        (_, a), = cap.calls
        kw = cap.kwargs[0]
        _check(torch, fn(*a, **kw),
               agg_mod.segment_reduce_sorted_plain(*a, **kw), _ops(a),
               f"at {name}'s call ({who} tree)")
        plan = fn.last_plan
        own[who] = (fn, a, kw, {} if plan is None else dict(
            masks=len(plan.sets[0].masks), path=cs._k3_path_name(plan),
            traffic_bytes_a_row=round(
                cs._k3_traffic(plan) / max(cs._k3_rows(a), 1), 2)))
        profiled[f"{name} ({who} tree)"] = (fn, (a, kw))
        print(f"{name}'s K3 call ({who} tree): {own[who][3]}", flush=True)
    return own


def _qg2(torch, trees, timed, cuda_ms, profiled, result, card):
    """qg2's K3 call through each tree's own session, checked against its
    own plain version and timed in turns; this tree's call again on every
    K3 path (each checked, timed in turns against the planned one); both
    queries' warm walls in turns."""
    orders, _ = cs._qg2_table()

    def qg2(session_cls, F_, col_, lit_):
        return cs._qg2_df(session_cls(), orders, 1, F_, col_)
    own = _own_k3(torch, trees, "qg2", qg2, profiled)
    timed("qg2", {who: (lambda f=f, a=a, kw=kw: f(*a, **kw))
                  for who, (f, a, kw, _) in own.items()},
          cs._k3_rows(own["this"][1]),
          dict(this=own["this"][3], other=own["other"][3]))
    fn, a, kw, _ = own["this"]
    want = trees["this"][0].segment_reduce_sorted_plain(*a, **kw)
    paths = {}
    for path in trees["this"][0].K3_PATHS:
        cs._k3_diff_exact(torch, fn(*a, **{**kw, "path": path}), want,
                          f"qg2's call, path={path}")
    for _ in range(2):
        for path in trees["this"][0].K3_PATHS:
            paths.setdefault(str(path), []).append(
                cuda_ms(lambda: fn(*a, **{**kw, "path": path})))
    print(f"K3 at qg2's call by path (ms, two rounds): {paths}; {card}",
          flush=True)
    result["qg2 paths"] = paths
    walls = _walls(torch, {who: qg2(*trees[who][1:]).collect
                           for who in ("other", "this")}, 3)
    result["qg2 walls"] = walls
    print(f"qg2 warm walls (ms): {walls}; {card}", flush=True)


def _random(torch, other, timed, cuda_ms, profiled, result, card):
    """K3 over a random order of 2^25 rows in 100,000 groups (two key
    words): an empty op set (distinct's call), a count of a mask, and
    qg2's op set (first and count(*) over every row, last and two counts
    over three masks), each through both builds in turns; then qg2's op
    set on this tree's direct and record paths in turns over random
    orders of 2^23 to 2^25 rows, with the path it plans."""
    from spark_rapids_tpu_torch.exec import aggregate as agg
    from spark_rapids_tpu_torch.ops import carry
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 25)
    n = cs.ROWS
    keys = torch.randint(0, 100_000, (n,), generator=gen, device=dev)
    words = [keys, keys % 7]
    order = carry.sort_order(words)
    m = [torch.rand(n, generator=gen, device=dev) < f for f in (0.9, 1.0, 0.5)]
    every = torch.ones(n, dtype=torch.bool, device=dev)
    pos_ops = ["first", "last", "sum", "sum", "sum"]
    shapes = {
        "distinct over a random order": (
            (words, None, [], [], False, order, []), None),
        "a count over a random order": (
            (words, None, [None], [m[0]], False, order, ["sum"]), None),
        "qg2's ops over a random order": (
            (words, None, [None] * 5, [None, m[0], m[1], m[2], None], False,
             order, pos_ops),
            # the parent takes a mask of every row in place of None
            (words, None, [None] * 5, [every, m[0], m[1], m[2], every],
             False, order, pos_ops))}
    fns = {"this": agg.segment_reduce_sorted,
           "other": other["exec.aggregate"].segment_reduce_sorted}
    for name, (a, a_other) in shapes.items():
        args = {"this": a, "other": a_other or a}
        want = agg.segment_reduce_sorted_plain(*a)
        for who, fn in fns.items():
            cs._k3_diff_exact(torch, fn(*args[who]), want, f"{name} ({who})")
        timed(name, {who: (lambda f=fn, x=args[who]: f(*x))
                     for who, fn in fns.items()}, n, {})
        for who, fn in fns.items():
            profiled[f"{name} ({who} tree)"] = (fn, (args[who], {}))
    del shapes, a, a_other, args, want
    # qg2's op set on the direct and record paths around the masks' L2
    # edge (agg._K3_MASKS_CACHED): three masks of 24, 48, 72 and 96 MiB
    paths = {}
    for n in (1 << 23, 1 << 24, 3 << 23, 1 << 25):
        keys = torch.randint(0, 100_000, (n,), generator=gen, device=dev)
        words = [keys, keys % 7]
        order = carry.sort_order(words)
        m = [torch.rand(n, generator=gen, device=dev) < f
             for f in (0.9, 1.0, 0.5)]
        a = (words, None, [None] * 5, [None, m[0], m[1], m[2], None], False,
             order, pos_ops)
        want = agg.segment_reduce_sorted_plain(*a)
        for p in (None, "direct", "record"):
            cs._k3_diff_exact(torch, fns["this"](*a, path=p), want,
                              f"qg2's ops over {n} random rows, path={p}")
        fns["this"](*a)
        got = {"planned": cs._k3_path_name(fns["this"].last_plan),
               "direct": [], "record": []}
        for _ in range(3):
            for p in ("direct", "record", "record", "direct"):
                got[p].append(cuda_ms(lambda: fns["this"](*a, path=p)))
        paths[n] = got
        print(f"K3 at qg2's ops over {n} rows in a random order by path "
              f"(ms): {got}; {card}", flush=True)
        del keys, words, order, m, a, want
    result["random paths"] = paths


def _host(torch, result, card):
    """The wrapper's host caches at qg2's call shape (7.5M rows, one
    varying key word of two, five ops over three masks), each against
    the same step done anew as the parent did it: microseconds a call
    over 2,000 calls, the card synchronised before the clock stops."""
    import time
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.exec import aggregate as agg
    dev = torch.device("cuda")
    n = 7_500_000
    words = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2)]
    plan = agg.k3_plan(n, [None] * 5, [None, "a", "b", "c", None], 1, True)
    kinds = (agg._KIND_POS["first"], agg._KIND_POS["last"],
             agg._KIND_COUNT, agg._KIND_COUNT, agg._KIND_COUNT)
    flags = (True, False)

    def varying_anew():
        v = torch.empty(len(flags) + 1 + agg._K3_FEW_RUNS,
                        dtype=torch.int32, device=dev)
        v[:len(flags)].copy_(torch.tensor([int(f) for f in flags],
                                          dtype=torch.int32,
                                          pin_memory=True), non_blocking=True)
        return v

    def blocks_anew():
        agg._K3_BLOCKS.clear()
        return agg._k3_call_args(plan, kinds, False)
    steps = {
        "argument blocks": (lambda: agg._k3_call_args(plan, kinds, False),
                            blocks_anew),
        "word pointers": (lambda: agg._word_pointers(words, dev),
                          lambda: kernels.device_int64s(
                              [w.data_ptr() for w in words], dev)),
        "varying flags": (lambda: agg._shared_varying(flags, dev),
                          varying_anew)}
    out = {}
    for name, pair in steps.items():
        us = []
        for fn in pair * 2:
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t) / 2000 * 1e6)
        out[name] = dict(cached_us=[us[0], us[2]], anew_us=[us[1], us[3]])
        print(f"host at qg2's call, {name}: cached {us[0]:.2f}, {us[2]:.2f}"
              f" us; anew {us[1]:.2f}, {us[3]:.2f} us; {card}", flush=True)
    result["host"] = out


def _qg4(torch, other, table, timed, cuda_ms, profiled, rounds, result,
         card):
    """qg4's four K23 calls through each tree's own session, each checked
    against its own plain version and timed in turns; both queries' warm
    walls in turns."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.exec import window as window_mod
    from spark_rapids_tpu_torch.expr import window as W
    from spark_rapids_tpu_torch.ops import scan
    tab4, _ = cs._qg4_table(table)
    trees = {"this": (window_mod, scan, GpuSession, F, col, W),
             "other": (other["exec.window"], other["ops.scan"],
                       other["api.session"].GpuSession,
                       other["api.functions"], other["api.column"].col,
                       other["expr.window"])}
    own, dfs = {}, {}
    for who in ("other", "this"):
        wmod, smod, session_cls, F_, col_, W_ = trees[who]
        df = cs._qg4_df(session_cls(), tab4, 1, F_, col_, W_)
        df.collect()
        with cs._Capture(wmod, "frame_pick") as cap:
            df.collect()
        fn = cap.orig["frame_pick"]
        calls = [(a, kw) for (_, a), kw in zip(cap.calls, cap.kwargs)]
        if len(calls) != 4:
            raise AssertionError(f"qg4 made {len(calls)} K23 calls "
                                 f"({who} tree)")
        for a, kw in calls:
            got, ref = fn(*a, **kw), smod.frame_pick_plain(*a, **kw)
            if not torch.equal(got[1], ref[1]) or not torch.equal(
                    got[0][ref[1]], ref[0][ref[1]]):
                raise AssertionError(f"K23 differs from its plain version "
                                     f"at qg4 ({who} tree)")
        own[who] = (fn, calls)
        dfs[who] = df
    names = ("forward fill", "first over ROWS 6 PRECEDING",
             "last over the partition", "first ignoring nulls over RANGE")
    for q, name in enumerate(names):
        timed(f"qg4 {name}", {
            who: (lambda f=f, c=c[q]: f(*c[0], **c[1]))
            for who, (f, c) in own.items()},
            int(tab4.num_rows), dict(call=q), "K23")
        for who, (f, c) in own.items():
            profiled[f"qg4 {name} ({who} tree)"] = (f, c[q])
    walls = _walls(torch, {who: df.collect for who, df in dfs.items()},
                   rounds)
    result["qg4 walls"] = walls
    print(f"qg4 warm walls (ms): {walls}; {card}", flush=True)


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
    print(f"profile at {what}: wall {wall:.3f} ms a call, device "
          f"{busy} ms: " + ", ".join(f"{k} {v} us" for k, v in sorted(
              kernels.items(), key=lambda x: -x[1])) + f"; {card}",
          flush=True)
    return dict(wall_ms=wall, device_ms=busy, kernels_us=kernels)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
