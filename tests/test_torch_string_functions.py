"""The string functions in the port against the reference, on the CPU.

* Every non-regex test of the reference's tests/test_strings.py
  (upper/lower/length against pyarrow, substring, concat and trim,
  contains/startswith/endswith, replace, like, pad/repeat/reverse/initcap,
  the fuzz differential, locate), each query run through
  ``GpuSession(device="cpu")`` (the GPU-placed plan on CPU tensors, so
  every kernel's plain version) and ``TpuSession``, compared with the
  reference's ``assert_tables_equal``; each port plan is GPU-placed but
  for its DeviceToHostExec.
* Edge cases over empty, null and multi-byte rows, a row of 5,000 bytes
  among short ones, a needle at a row's end, overlapping occurrences,
  and ``_`` and ``%`` at a pattern's ends; the two trims, ascii,
  bit_length, substring_index, locate with a start, the pads, repeat and
  replace; string CASE WHEN, IF, COALESCE, NULLIF and NVL on the GPU.
* The host-only rules (concat_ws, md5, a substring_index delimiter of
  other than one byte) and a column needle stay on the CPU engine with
  the reference's reasons.
* Pinned: reverse of multi-byte rows (the port reverses characters,
  Spark's answer; the reference reverses bytes).
* The plain versions of K19 ``string_find``, K20 ``utf8_cut`` and K21
  ``string_map``, and ``pack_rows``/``window_bytes``, against the
  reference's functions on seeded numpy inputs; and on the shapes the
  kernels' byte tiles make hard: a token across two rows, a match ending
  at a row's last byte, empty rows and rows of 1, 15, 16, 17 and 4,096
  bytes, repeated and reversed searches over overlapping runs, wildcard
  tokens, initcap after a letter and after a space; reverse over invalid
  UTF-8 against a Python oracle of the plain version's rule.
"""

import types as pytypes

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import Column as RColumn
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import conditional as rcond
from spark_rapids_tpu.expr import hashfns as rhf
from spark_rapids_tpu.expr import strings as rse
from spark_rapids_tpu.expr.core import Literal as RLiteral
from spark_rapids_tpu.ops import strings as rso
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (IntegerGen, StringGen,
                                               gen_table)
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import Column as PColumn
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import conditional as pcond
from spark_rapids_tpu_torch.expr import hashfns as phf
from spark_rapids_tpu_torch.expr import strings as pse
from spark_rapids_tpu_torch.expr.core import Literal as PLiteral
from spark_rapids_tpu_torch.ops import strings as pso

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


def _side(F, col, lit, se, hf, cond, Lit, Col):
    def ex(cls_name, *args):
        """Column(cls(*args)): a Column argument as its expression, any
        other value as a literal."""
        mod = hf if cls_name == "Md5" else cond if cls_name in (
            "If", "NullIf", "Nvl") else se
        return Col(getattr(mod, cls_name)(*[
            a.expr if isinstance(a, Col) else
            a if isinstance(a, (int, str)) and cls_name == "SubstringIndex"
            and i > 0 else Lit(a) for i, a in enumerate(args)]))
    return pytypes.SimpleNamespace(F=F, col=col, lit=lit, ex=ex)


REF = _side(RF, rcol, rlit, rse, rhf, rcond, RLiteral, RColumn)
PORT = _side(PF, pcol, plit, pse, phf, pcond, PLiteral, PColumn)


def sessions():
    b = TpuSession.builder()
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu")


def gpu_placed(port):
    nodes = []
    port.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    assert all(p == "gpu" for n, p in nodes if n != "DeviceToHostExec"), \
        nodes


def run_both(table, query, partitions=1, ignore_order=False, gpu=True):
    """``query(df, X)`` through both sessions; the results must agree.
    Returns (reference's, port's, port session)."""
    ref, port = sessions()
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=ignore_order)
    if gpu:
        gpu_placed(port)
    return want, got, port


_SAMPLE = ["hello world", "", None, "  padded  ", "UPPER lower",
           "a", "abcabcabc", "xyz", "foo bar baz", "  ", "ab_cd%ef"]


def _sample():
    return pa.table({"s": pa.array(_SAMPLE, type=pa.string()),
                     "n": pa.array(list(range(len(_SAMPLE))),
                                   type=pa.int32())})


# ---------------------------------------------------------------------------
# tests/test_strings.py, lines 25-169
# ---------------------------------------------------------------------------

def test_upper_lower_length_vs_arrow():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.F.upper(X.col("s")).alias("u"), X.F.lower(X.col("s")).alias("l"),
        X.F.length(X.col("s")).alias("n")))
    arr = pa.array(_SAMPLE, type=pa.string())
    assert got.column("u").to_pylist() == pc.utf8_upper(arr).to_pylist()
    assert got.column("l").to_pylist() == pc.utf8_lower(arr).to_pylist()
    assert got.column("n").to_pylist() == pc.utf8_length(arr).to_pylist()


def test_substring():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.F.substring(X.col("s"), 1, 3).alias("a"),
        X.F.substring(X.col("s"), 3, 100).alias("b"),
        X.F.substring(X.col("s"), -3, 2).alias("c")))
    assert got.column("a").to_pylist() == \
        [None if s is None else s[0:3] for s in _SAMPLE]

    def sub_sql(s, pos, n):
        start = len(s) + pos if pos < 0 else (pos - 1 if pos > 0 else 0)
        return s[max(start, 0):max(min(start + n, len(s)), 0)]
    assert got.column("c").to_pylist() == \
        [None if s is None else sub_sql(s, -3, 2) for s in _SAMPLE]


def test_concat_trim():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.F.concat(X.col("s"), X.lit("!"), X.col("s")).alias("cc"),
        X.ex("Trim", X.col("s")).alias("tr")))
    assert got.column("cc").to_pylist() == \
        [None if s is None else s + "!" + s for s in _SAMPLE]
    assert got.column("tr").to_pylist() == \
        [None if s is None else s.strip(" ") for s in _SAMPLE]


def test_contains_startswith_endswith():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.col("s").contains("ab").alias("c"),
        X.col("s").startswith("he").alias("st"),
        X.col("s").endswith("z").alias("en")))
    assert got.column("c").to_pylist() == \
        [None if s is None else "ab" in s for s in _SAMPLE]
    assert got.column("st").to_pylist() == \
        [None if s is None else s.startswith("he") for s in _SAMPLE]
    assert got.column("en").to_pylist() == \
        [None if s is None else s.endswith("z") for s in _SAMPLE]


def test_replace():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.ex("StringReplace", X.col("s"), "ab", "XYZ").alias("r")))
    assert got.column("r").to_pylist() == \
        [None if s is None else s.replace("ab", "XYZ") for s in _SAMPLE]


def test_like():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.ex("Like", X.col("s"), "h%").alias("p"),
        X.ex("Like", X.col("s"), "%z").alias("sfx"),
        X.ex("Like", X.col("s"), "%bar%").alias("mid"),
        X.ex("Like", X.col("s"), "a_c%").alias("w")))
    assert got.column("p").to_pylist() == \
        [None if s is None else s.startswith("h") for s in _SAMPLE]
    assert got.column("sfx").to_pylist() == \
        [None if s is None else s.endswith("z") for s in _SAMPLE]
    assert got.column("mid").to_pylist() == \
        [None if s is None else "bar" in s for s in _SAMPLE]


def test_pad_repeat_reverse_initcap():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.ex("StringLPad", X.col("s"), 8, "*").alias("lp"),
        X.ex("StringRPad", X.col("s"), 8, "*").alias("rp"),
        X.ex("StringRepeat", X.col("s"), 2).alias("rep"),
        X.ex("Reverse", X.col("s")).alias("rev"),
        X.ex("InitCap", X.col("s")).alias("ic")))
    assert got.column("lp").to_pylist() == \
        [None if s is None else s.rjust(8, "*")[:8] if len(s) <= 8
         else s[:8] for s in _SAMPLE]
    assert got.column("rep").to_pylist() == \
        [None if s is None else s * 2 for s in _SAMPLE]
    assert got.column("rev").to_pylist() == \
        [None if s is None else s[::-1] for s in _SAMPLE]


@pytest.mark.parametrize("partitions", [1, 2])
def test_string_fuzz_differential(partitions):
    t = gen_table([("s", StringGen(max_len=12)),
                   ("p", IntegerGen(lo=-5, hi=8))], 512)
    run_both(t, lambda d, X: d.select(
        X.F.upper(X.col("s")).alias("u"),
        X.F.length(X.col("s")).alias("n"),
        X.F.substring(X.col("s"), 2, 4).alias("sub"),
        X.F.concat(X.col("s"), X.lit("-"), X.col("s")).alias("cc"),
        X.col("s").contains("a").alias("ca")), partitions=partitions,
        ignore_order=True)


def test_locate():
    _, got, _ = run_both(_sample(), lambda d, X: d.select(
        X.ex("StringLocate", "b", X.col("s")).alias("l1")))
    assert got.column("l1").to_pylist() == \
        [None if s is None else (s.find("b") + 1) for s in _SAMPLE]


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

_LONG = "x" * 5000 + "needle"
_EDGE = ["", None, "a", "é", "中文字", "ab%_cd", "%_", "_", "%",
         "xx special yy requests zz", "special requests", "aaaa", "abab",
         _LONG, "hay needle", "needle", "needleneedle", "a b  c ",
         " lead", "trail ", "\tTab", "mixed Case wORDS", "é中a é", None,
         "requests special", "aXbXc", "PROMO BRUSHED COPPER", "MEDIUM "
         "POLISHED TIN", "25-989-741-2988"]


def _edge(n_copies=1):
    s = _EDGE * n_copies
    return pa.table({"s": pa.array(s, type=pa.string()),
                     "i": pa.array(list(range(len(s))), type=pa.int64())})


_ASCII = [s if s is None or s.isascii() else s.encode("ascii", "replace")
          .decode() for s in _EDGE]


@pytest.mark.parametrize("pattern", [
    "", "%", "%%", "_", "__", "a%", "%a", "%a%", "a_", "_a", "%_", "_%",
    "%special%requests%", "%needle", "needle%", "x%needle", "%a%a%",
    "ab%cd", "a%b%c", "%%a%%", "%_%", "PROMO%", "MEDIUM POLISHED%",
    "%e%e%", "needle", "a_c", "%é%", "中_", "%ne_dle"])
@pytest.mark.parametrize("partitions", [1, 2])
def test_like_edge_patterns(pattern, partitions):
    run_both(_edge(), lambda d, X: d.select(
        X.col("i"), X.ex("Like", X.col("s"), pattern).alias("m")),
        partitions=partitions, ignore_order=True)


@pytest.mark.parametrize("needle", ["a", "aa", "needle", "é", "", "中文",
                                    " ", "requests", "ab"])
def test_search_edges(needle):
    _, got, _ = run_both(_edge(), lambda d, X: d.select(
        X.col("s").contains(needle).alias("c"),
        X.col("s").startswith(needle).alias("st"),
        X.col("s").endswith(needle).alias("en"),
        X.ex("StringLocate", needle, X.col("s")).alias("l")))
    assert got.column("c").to_pylist() == \
        [None if s is None else needle in s for s in _EDGE]


@pytest.mark.parametrize("start", [0, 1, 2, 5, -1, 100, 5003])
def test_locate_with_start(start):
    run_both(_edge(), lambda d, X: d.select(
        X.ex("StringLocate", "e", X.col("s"), start).alias("l"),
        X.ex("StringLocate", "needle", X.col("s"), start).alias("l2")))


@pytest.mark.parametrize("pos,length", [(1, 3), (0, 2), (-2, 5), (3, 100),
                                        (-100, 3), (2, 0), (2, -1),
                                        (5000, 6), (-6, 6), (2, None)])
def test_substring_edges(pos, length):
    def q(d, X):
        if length is None:
            return d.select(X.ex("Substring", X.col("s"), pos).alias("r"))
        return d.select(X.F.substring(X.col("s"), pos, length).alias("r"),
                        X.col("s").substr(pos, length).alias("r2"))
    run_both(_edge(), q)


def test_substring_by_column_positions():
    t = pa.table({"s": pa.array(["hello", "é中x", None, "abc", ""]),
                  "p": pa.array([2, -2, 1, None, 1], pa.int32()),
                  "n": pa.array([3, 1, 2, 2, None], pa.int32())})
    run_both(t, lambda d, X: d.select(X.ex("Substring", X.col("s"),
                                           X.col("p"), X.col("n"))))


def test_unary_edges():
    run_both(_edge(), lambda d, X: d.select(
        X.F.upper(X.col("s")).alias("u"), X.F.lower(X.col("s")).alias("l"),
        X.ex("InitCap", X.col("s")).alias("ic"),
        X.F.length(X.col("s")).alias("n"), X.F.ascii(X.col("s")).alias("a"),
        X.ex("BitLength", X.col("s")).alias("b"),
        X.ex("Trim", X.col("s")).alias("t"),
        X.ex("TrimLeft", X.col("s")).alias("tl"),
        X.ex("TrimRight", X.col("s")).alias("tr")), partitions=2,
        ignore_order=True)


def test_reverse_ascii_edges():
    t = pa.table({"s": pa.array(_ASCII, type=pa.string())})
    run_both(t, lambda d, X: d.select(X.ex("Reverse", X.col("s"))))


def test_reverse_multibyte_pinned():
    """The port reverses UTF-8 characters (Spark's answer); the reference
    reverses bytes, which breaks a multi-byte character."""
    t = pa.table({"s": pa.array(["é中x", "ab", None], type=pa.string())})
    ref, port = sessions()
    got = port.create_dataframe(t).select(
        PColumn(pse.Reverse(pcol("s").expr)).alias("r")).collect()
    assert got.column("r").to_pylist() == ["x中é", "ba", None]
    gpu_placed(port)
    want = ref.create_dataframe(t).select(
        RColumn(rse.Reverse(rcol("s").expr)).alias("r"))
    raw = "é中x".encode()[::-1]
    try:
        out = want.collect().column("r").cast(pa.binary()).to_pylist()
        assert out[0] == raw
    except (pa.ArrowInvalid, UnicodeDecodeError) as ex:  # invalid UTF-8
        assert "utf" in str(ex).lower()


@pytest.mark.parametrize("delim,count", [("a", 1), ("a", 2), ("a", -1),
                                         ("a", -2), (" ", 1), (" ", -3),
                                         ("e", 5), ("e", -5), ("x", 0),
                                         ("X", 1)])
def test_substring_index_one_byte(delim, count):
    run_both(_edge(), lambda d, X: d.select(
        X.ex("SubstringIndex", X.col("s"), delim, count).alias("r")))


@pytest.mark.parametrize("target,pad", [(0, "*"), (3, "ab"), (10, "ab"),
                                        (60, "-")])
def test_pads(target, pad):
    """The pads count bytes in both packages, so the rows are ASCII."""
    t = pa.table({"s": pa.array(_ASCII, type=pa.string())})
    run_both(t, lambda d, X: d.select(
        X.ex("StringLPad", X.col("s"), target, pad).alias("l"),
        X.ex("StringRPad", X.col("s"), target, pad).alias("r")))


@pytest.mark.parametrize("times", [0, 1, 3])
def test_repeat(times):
    run_both(_edge(), lambda d, X: d.select(
        X.ex("StringRepeat", X.col("s"), times).alias("r")))


@pytest.mark.parametrize("search,repl", [("a", "XY"), ("needle", ""),
                                         ("ab", "Z"), ("é", "e"),
                                         ("requests", "R"), ("yy ", "")])
def test_replace_edges(search, repl):
    run_both(_edge(), lambda d, X: d.select(
        X.ex("StringReplace", X.col("s"), search, repl).alias("r")))


def test_replace_self_overlapping_raises_in_both():
    ref, port = sessions()
    for s, X in ((ref, REF), (port, PORT)):
        with pytest.raises(NotImplementedError, match="self-overlapping"):
            s.create_dataframe(_edge()).select(X.ex(
                "StringReplace", X.col("s"), "aa", "b")).collect()


def test_concat_with_nulls_and_literals():
    t = pa.table({"a": pa.array(["x", None, "", "é"]),
                  "b": pa.array(["1", "2", None, "中"])})
    run_both(t, lambda d, X: d.select(
        X.F.concat(X.col("a"), X.col("b")).alias("ab"),
        X.F.concat(X.lit("<"), X.col("a"), X.lit(">")).alias("w")))


@pytest.mark.parametrize("partitions", [1, 2])
def test_string_conditionals_on_gpu(partitions):
    t = gen_table([("s", StringGen(max_len=6)), ("v", IntegerGen())], 300,
                  21)

    def q(d, X):
        F, col, lit = X.F, X.col, X.lit
        return d.select(
            F.when(col("v") > 0, col("s")).otherwise(lit("neg")).alias("w"),
            X.ex("If", col("v") > 10, F.upper(col("s")), col("s"))
            .alias("i"),
            F.coalesce(col("s"), lit("none")).alias("c"),
            X.ex("NullIf", col("s"), "a").alias("n"))
    run_both(t, q, partitions=partitions, ignore_order=True)
    # NVL: the reference has no evaluator for it; the port's is COALESCE's
    port = GpuSession(device="cpu")
    got = port.create_dataframe(t, num_partitions=partitions).select(
        PORT.ex("Nvl", pcol("s"), "z").alias("v"),
        PF.coalesce(pcol("s"), plit("z")).alias("c")).collect()
    assert got.column("v").to_pylist() == got.column("c").to_pylist()
    gpu_placed(port)


def test_filter_and_group_by_string_functions():
    t = pa.table({"s": pa.array(_EDGE * 4, type=pa.string()),
                  "v": pa.array(list(range(len(_EDGE) * 4)), pa.int64())})
    run_both(t, lambda d, X: d.filter(
        ~X.ex("Like", X.col("s"), "%special%requests%")).group_by(
        X.F.substring(X.col("s"), 1, 2).alias("k")).agg(
        X.F.count("*").alias("c"), X.F.sum(X.col("v")).alias("sv")),
        partitions=2, ignore_order=True)


# ---------------------------------------------------------------------------
# host-only rules and column needles: the CPU engine, the reference's
# reasons
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["concat_ws", "md5", "substring_index"])
def test_host_only_rules_stay_on_cpu(case):
    reason = {
        "concat_ws": "concat_ws's variadic null/separator semantics "
                     "evaluate on the host engine",
        "md5": "md5 digests run on the host engine (byte-serial digest)",
        "substring_index": "substring_index with a multi-byte or empty "
                           "delimiter needs sequential non-overlapping "
                           "search; host engine"}[case]

    def q(d, X):
        if case == "concat_ws":
            return d.select(X.F.concat_ws("-", X.col("s"), X.col("s"),
                                          X.lit(None)).alias("r"))
        if case == "md5":
            return d.select(X.F.md5(X.col("s")).alias("r"))
        return d.select(X.ex("SubstringIndex", X.col("s"), "ee", -1)
                        .alias("r"), X.ex("SubstringIndex", X.col("s"),
                                          "", 1).alias("r2"))
    _, _, port = run_both(_edge(), q, gpu=False)
    nodes = []
    port.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    assert ("ProjectExec", "cpu") in nodes
    assert reason in port.last_explain


def test_column_needle_stays_on_cpu_and_raises_in_both():
    t = pa.table({"s": ["abc", "b"], "n": ["b", "c"]})
    ref, port = sessions()
    for s, X in ((ref, REF), (port, PORT)):
        df = s.create_dataframe(t).select(
            X.col("s").contains(X.col("n")).alias("c"))
        with pytest.raises(NotImplementedError, match="literal"):
            df.collect()
    assert "Contains requires a literal search argument on GPU" in \
        port.last_explain


def test_string_function_rules_registered():
    """The reference's 23 string rules and md5, by class name."""
    from spark_rapids_tpu.plan import overrides as ro
    from spark_rapids_tpu_torch.plan import overrides as po
    names = {"Upper", "Lower", "Substring", "SubstringIndex", "Concat",
             "ConcatWs", "Contains", "StartsWith", "EndsWith", "Like",
             "Length", "BitLength", "Ascii", "InitCap", "Trim", "TrimLeft",
             "TrimRight", "StringLPad", "StringRPad", "StringLocate",
             "StringRepeat", "StringReplace", "Reverse", "Md5"}
    ref = {c.__name__ for c in ro.EXPR_RULES}
    port = {c.__name__ for c in po.EXPR_RULES}
    assert names <= ref and names <= port


# ---------------------------------------------------------------------------
# the plain versions of K19-K21 against the reference's functions
# ---------------------------------------------------------------------------

def _random_strings(seed, n=400, alphabet=b"ab \xc3\xa9_%x"):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(0, 40)) if i % 50 else int(rng.integers(200,
                                                                      600))
        rows.append(bytes(rng.choice(list(alphabet), size=k).tolist()))
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    chars = np.frombuffer(b"".join(rows) + b"\0" * 64, np.uint8).copy()
    return rows, offs, chars


def _torch_span(offs, chars):
    return torch.from_numpy(offs.copy()), torch.from_numpy(chars.copy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("needle", [b"a", b"ab", b"a a", b"\xc3\xa9",
                                    b"aa", b"a_b"])
def test_string_find_plain_matches_reference_match_positions(seed, needle):
    rows, offs, chars = _random_strings(seed)
    to, tc = _torch_span(offs, chars)
    wc = ord("_")
    m = rse._match_positions(np, chars, needle, wc)
    o0, o1 = offs[:-1], offs[1:]
    pat = pso.FindPattern([needle], wildcard=wc)
    got = pso.string_find_plain(to, tc, pat)
    for i in range(len(rows)):
        hits = [p for p in range(o0[i], o1[i] - len(needle) + 1) if m[p]]
        assert int(got[i]) == (hits[0] if hits else -1)
    # a search from a start inside the row
    late = torch.from_numpy((o0 + 3).astype(np.int32))
    got = pso.string_find_plain(to, tc, pat, late)
    for i in range(len(rows)):
        hits = [p for p in range(o0[i] + 3, o1[i] - len(needle) + 1)
                if m[p]]
        assert int(got[i]) == (hits[0] if hits else -1)
    # reverse and repeated: the k-th occurrence from either end
    for k, rev in ((2, False), (2, True), (3, True)):
        pat = pso.FindPattern([needle[:1]], repeat=k, reverse=rev)
        got = pso.string_find_plain(to, tc, pat)
        m1 = rse._match_positions(np, chars, needle[:1])
        for i in range(len(rows)):
            hits = [p for p in range(o0[i], o1[i]) if m1[p]]
            if rev:
                hits = hits[::-1]
            assert int(got[i]) == (hits[k - 1] if len(hits) >= k else -1)
    mask = pso.string_match_mask_plain(to, tc, needle)
    for i in range(len(rows)):
        for p in range(o0[i], o1[i]):
            want = bool(rse._match_positions(np, chars, needle)[p]) and \
                p + len(needle) <= o1[i]
            assert bool(mask[p]) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_utf8_cut_plain_matches_reference_char_starts(seed):
    rows, offs, chars = _random_strings(seed)
    to, tc = _torch_span(offs, chars)
    starts = rse._char_starts(np, chars)
    count, _, _ = pso.utf8_cut_plain(to, tc, pso.CUT_LENGTH)
    assert count.tolist() == [int(starts[offs[i]:offs[i + 1]].sum())
                              for i in range(len(rows))]
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.integers(-8, 12, len(rows)).astype(np.int64))
    ln = torch.from_numpy(rng.integers(-2, 9, len(rows)).astype(np.int64))
    _, b0, b1 = pso.utf8_cut_plain(to, tc, pso.CUT_SUBSTRING, pos, ln)
    for i, r in enumerate(rows):
        lead = [j for j in range(len(r)) if (r[j] & 0xC0) != 0x80]
        n = len(lead)
        p, l = int(pos[i]), int(ln[i])
        s = p - 1 if p > 0 else (n + p if p < 0 else 0)
        e = s + max(l, 0)
        sc = min(max(s, 0), n)
        ec = min(max(e, sc), n)
        cb = lambda c: lead[c] if c < n else len(r)  # noqa: E731
        assert (int(b0[i]) - offs[i], int(b1[i]) - offs[i]) == \
            (cb(sc), max(cb(ec), cb(sc)))
    # a literal pos and length cut as their columns do
    for p, l in ((1, 2), (-3, None), (0, 4), (5, -1)):
        col_l = None if l is None else torch.full((len(rows),), l)
        assert [x.tolist() for x in pso.utf8_cut_plain(
            to, tc, pso.CUT_SUBSTRING, p, l)[1:]] == \
            [x.tolist() for x in pso.utf8_cut_plain(
                to, tc, pso.CUT_SUBSTRING, torch.full((len(rows),), p),
                col_l)[1:]]
    for mode, fn in ((pso.CUT_TRIM, bytes.strip),
                     (pso.CUT_TRIM_LEFT, bytes.lstrip),
                     (pso.CUT_TRIM_RIGHT, bytes.rstrip)):
        _, b0, b1 = pso.utf8_cut_plain(to, tc, mode)
        for i, r in enumerate(rows):
            cut = bytes(chars[int(b0[i]):int(b1[i])])
            assert cut == fn(r, b" ")


@pytest.mark.parametrize("seed", [0, 1])
def test_string_map_plain_matches_reference_maps(seed):
    rows, offs, chars = _random_strings(seed, alphabet=b"aZ b\xc3\xa9Q z")
    to, tc = _torch_span(offs, chars)
    total = int(offs[-1])
    up = np.where((chars >= 97) & (chars <= 122), chars - 32, chars)
    lo = np.where((chars >= 65) & (chars <= 90), chars + 32, chars)
    assert pso.string_map_plain(to, tc, pso.MAP_UPPER)[:total].numpy() \
        .tolist() == up[:total].tolist()
    assert pso.string_map_plain(to, tc, pso.MAP_LOWER)[:total].numpy() \
        .tolist() == lo[:total].tolist()
    ic = pso.string_map_plain(to, tc, pso.MAP_INITCAP).numpy()
    rev = pso.string_map_plain(to, tc, pso.MAP_REVERSE).numpy()
    for i, r in enumerate(rows):
        words = r.split(b" ")
        want = b" ".join(w[:1].upper() + w[1:].lower() for w in words)
        want = bytes(c if c < 128 else c for c in want)
        assert bytes(ic[offs[i]:offs[i + 1]]) == want
        assert bytes(rev[offs[i]:offs[i + 1]]) == \
            r.decode("utf-8", "surrogateescape")[::-1].encode(
                "utf-8", "surrogateescape") or not r.isascii()
    assert not rev[total:].any() and not ic[total:].any()


def test_pack_rows_and_window_bytes_match_reference():
    rng = np.random.default_rng(3)
    mat = rng.integers(33, 127, (50, 7)).astype(np.uint8)
    lens = rng.integers(0, 8, 50).astype(np.int32)
    valid = rng.random(50) > 0.2
    r_offs, r_chars = rso.pack_rows(np, mat, lens, valid, 1024)
    p_offs, p_chars = pso.pack_rows(torch.from_numpy(mat),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(valid), 1024)
    assert p_offs.tolist() == r_offs.tolist()
    assert p_chars.tolist() == np.asarray(r_chars).tolist()
    _, offs, chars = _random_strings(4)
    rb, rl = rso.window_bytes(np, offs, chars, 24)
    pb, pl = pso.window_bytes(*_torch_span(offs, chars), 24)
    assert pb.tolist() == rb.tolist() and pl.tolist() == rl.tolist()


def test_string_kernels_take_their_plain_versions_on_cpu():
    before = (pso.string_find.launches, pso.utf8_cut.launches,
              pso.string_map.launches)
    test_unary_edges()
    test_search_edges("a")
    assert (pso.string_find.launches, pso.utf8_cut.launches,
            pso.string_map.launches) == before


# ---------------------------------------------------------------------------
# the shapes K19's and K21's byte tiles make hard, through the plain
# versions (what chip_smoke.py holds the kernels against)
# ---------------------------------------------------------------------------

def _span_of(rows):
    """(offsets, chars) of ``rows``, the chars zero-padded as a bucket."""
    offs = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    chars = np.frombuffer(b"".join(rows) + b"\0" * 64, np.uint8).copy()
    return offs, chars


def _tile_rows(shape):
    rng = np.random.default_rng(len(shape))
    if shape == "straddle":       # a token across two rows never matches
        return [b"xxab", b"cdyy", b"ab", b"cd", b"abc", b"d", b"a", b"bcd",
                b"zzspecial", b"requests", b"", b"abcd"]
    if shape == "row_end":        # matches ending at a row's last byte
        return [b"xxabcd", b"abcd", b"zz ab", b"ab", b"b", b"", b"qqq a",
                b"abcdabcd", b"cd"]
    if shape == "lengths":        # empty rows and 1, 15, 16, 17, 4096 bytes
        return [bytes(rng.choice(list(b"ab c"), size=k).tolist())
                for k in (0, 1, 15, 16, 17, 4096, 0, 0, 16, 1, 17, 15)]
    if shape == "overlap":        # fewer matches than asked, and runs
        return [b"aaaaa", b"aa", b"a", b"", b"aaa aaaa", b"baaab", b"aaaa",
                b"ab" * 9]
    return [b"axb", b"ab", b"a_b", b"xa", b"ax", b"a", b"", b"ba ab",
            b"aab"]                   # the wildcard's


_TILE_SHAPES = ("straddle", "row_end", "lengths", "overlap", "wildcard")


def _oracle_find(pattern, masks, o0, o1, start):
    """K19's greedy search of one row over the reference's match masks."""
    cur, hi, p = start, o1, -1
    for _ in range(pattern.repeat):
        for k, tok in enumerate(pattern.tokens):
            limit = hi - pattern.reserves[k] - len(tok)
            if limit < cur:
                return -1
            mode, m = pattern.modes[k], masks[k]
            if mode & pso.FIND_AT_START:
                if mode & pso.FIND_AT_END and cur != limit:
                    return -1
                p = cur if m[cur] else -1
            elif mode & pso.FIND_AT_END:
                p = limit if m[limit] else -1
            else:
                hits = [q for q in range(cur, limit + 1) if m[q]]
                p = -1 if not hits else hits[-1] if pattern.reverse \
                    else hits[0]
            if p < 0:
                return -1
            if pattern.reverse:
                hi = p
            else:
                cur = p + len(tok)
    return p


def _tile_patterns(shape):
    wc = ord("_")
    if shape == "wildcard":
        return [pso.FindPattern([t], wildcard=wc)
                for t in (b"a_b", b"_a", b"a_", b"_")] + [
            pse.like_pattern(b"a_%")[0], pse.like_pattern(b"%_b")[0]]
    if shape == "overlap":
        return [pso.FindPattern([t], repeat=k, reverse=rev)
                for t in (b"a", b"aa") for k in (1, 2, 3, 4)
                for rev in (False, True)]
    return [pso.FindPattern([b"abcd"]), pso.FindPattern([b"ab"]),
            pso.FindPattern([b"d"]), pso.FindPattern([b"ab", b"cd"]),
            pse.like_pattern(b"%special%requests%")[0],
            pse.like_pattern(b"%ab%")[0], pse.like_pattern(b"ab%")[0],
            pse.like_pattern(b"%cd")[0],
            pso.FindPattern([b"b"], repeat=2, reverse=True)]


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_string_find_plain_on_tile_shapes(shape, late):
    rows = _tile_rows(shape)
    offs, chars = _span_of(rows)
    to, tc = _torch_span(offs, chars)
    starts = offs[:-1] + (1 if late else 0)
    for pat in _tile_patterns(shape):
        masks = [rse._match_positions(np, chars, tok,
                                      -1 if pat.wildcard is None
                                      else pat.wildcard)
                 for tok in pat.tokens]
        got = pso.string_find_plain(
            to, tc, pat, torch.from_numpy(starts.astype(np.int32))
            if late else None)
        want = [_oracle_find(pat, masks, int(offs[i]), int(offs[i + 1]),
                             int(starts[i])) for i in range(len(rows))]
        assert got.tolist() == want, (pat.tokens, pat.repeat, pat.reverse)


@pytest.mark.parametrize("shape", _TILE_SHAPES)
def test_string_match_mask_plain_on_tile_shapes(shape):
    rows = _tile_rows(shape)
    offs, chars = _span_of(rows)
    to, tc = _torch_span(offs, chars)
    for needle in (b"ab", b"abcd", b"aa", b"a", b"cd"):
        m = rse._match_positions(np, chars, needle)
        got = pso.string_match_mask_plain(to, tc, needle).numpy()
        want = np.zeros(chars.shape[0], bool)
        for i in range(len(rows)):
            for p in range(offs[i], offs[i + 1] - len(needle) + 1):
                want[p] = m[p]
        assert got.tolist() == want.tolist(), needle


def _ref_map(fn, offs, chars, *args):
    """The reference's evaluator ``fn`` over the span (offs, chars)."""
    from spark_rapids_tpu import types as rtypes
    from spark_rapids_tpu.columnar.device import DeviceColumn as RCol
    from spark_rapids_tpu.expr.core import ColumnValue as RVal
    from spark_rapids_tpu.expr.core import EvalContext as REval

    class Given:
        def eval(self, ctx):
            return RVal(RCol(rtypes.STRING, data=chars, offsets=offs,
                             validity=np.ones(len(offs) - 1, bool)))
    ctx = REval(np, None)
    ctx.capacity = len(offs) - 1
    e = pytypes.SimpleNamespace(children=[Given()])
    return np.asarray(fn(e, ctx, *args).col.data)


@pytest.mark.parametrize("shape", ["letter_before", "space_before",
                                   "lengths", "straddle"])
def test_string_map_plain_on_tile_shapes_vs_reference(shape):
    if shape == "letter_before":     # the row before ends in a letter
        rows = [b"abc", b"def ghi", b"x", b"Yz", b"QQ rr", b"", b"a"]
    elif shape == "space_before":    # ... and in a space
        rows = [b"abc ", b"def ", b" x", b"y ", b"", b" ", b"zZ"]
    else:
        rows = _tile_rows(shape)
    offs, chars = _span_of(rows)
    to, tc = _torch_span(offs, chars)
    total = int(offs[-1])
    for mode, fn, args in ((pso.MAP_UPPER, rse._case_map, (True,)),
                           (pso.MAP_LOWER, rse._case_map, (False,)),
                           (pso.MAP_INITCAP, rse._eval_initcap, ())):
        got = pso.string_map_plain(to, tc, mode).numpy()
        want = _ref_map(fn, offs, chars, *args)
        assert got[:total].tolist() == want[:total].tolist(), mode
        assert not got[total:].any()


def _reverse_oracle(row: bytes) -> bytes:
    """Characters from each lead byte (or the row start) to the next, any
    run of continuation bytes kept with the byte before it; reversed."""
    cuts = [0] + [j for j in range(1, len(row)) if (row[j] & 0xC0) != 0x80]
    chars = [row[a:b] for a, b in zip(cuts, cuts[1:] + [len(row)])]
    return b"".join(chars[::-1]) if row else b""


@pytest.mark.parametrize("case", ["runs_of_4", "long_runs", "only_cont",
                                  "lead_then_runs", "valid_mixed"])
def test_reverse_plain_on_invalid_utf8(case):
    c = b"\x80"
    if case == "runs_of_4":
        rows = [b"a" + c * 4 + b"b", c * 4, b"x" + b"\xbf" * 5, b"ab"]
    elif case == "long_runs":
        rows = [b"q" + c * 300 + b"r" + c * 17, c * 33 + b"z", b"", b"s"]
    elif case == "only_cont":
        rows = [c * 4096, c, c * 16, c * 17, b""]
    elif case == "lead_then_runs":
        rows = [b"\xc3" + c * 6 + b"\xe4" + c * 2, b"\xf0" + c * 9, b"a"]
    else:
        rows = ["héllo wörld".encode(), "中文ab".encode(), b"abc",
                "é".encode() * 9]
    offs, chars = _span_of(rows)
    got = pso.string_map_plain(*_torch_span(offs, chars),
                               pso.MAP_REVERSE).numpy()
    for i, r in enumerate(rows):
        assert bytes(got[offs[i]:offs[i + 1]]) == _reverse_oracle(r)
    assert not got[int(offs[-1]):].any()
