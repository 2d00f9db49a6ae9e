#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from csrc/ with nvcc, holds each
against its plain PyTorch version at the main paths' shapes and at edge
cases (the join kernels K6, K4, K7 and K5 on 27 join cases and a hot
key, K7 and K5 on the shapes K5's merge-path tiles must get right; K3 on
both of its paths, the records and the direct reads, and the planned
one, also on a group-by of 9 columns with 17 sums, its two paths timed
in turns at q1's and q1x's shapes and around the plan's crossover), then
drives the main paths.
Bench q1, scan -> filter(v > -500000) -> group by k: sum(v), avg(f),
count(*) -> collect, over 2^25 rows: through the DataFrame API as one
batch and as 4 partitions, and at exec level as 8 batches of 4,194,304
rows (update -> concat -> merge -> evaluate).  Bench q2, the 2^25-row
fact table inner-joined USING k with the 100,000-row dimension -> group
by k: sum(w) -> collect, through the DataFrame API, and the hash join
alone at exec level.  Bench q6, q2 over a 4-partition fact table and a
2-partition dimension, through the DataFrame API: the plan rewrite
strips its exchanges (a broadcast hash join over the gathered probe
side, one COMPLETE aggregate).  Each result is compared with pyarrow on
the host.  Then the plan rewrite itself: q1 and q2 plan GPU-only with
the final download as their one transition; a conditional full join
falls back to the CPU engine between device operators, with the
reference's reason; and q1 under spark.rapids.sql.enabled=false (every
operator on the CPU, no kernel launched) equals the card's result.
Bench q3, the fact table sorted by (k, v) and collected whole, through
the DataFrame API over 1 and 4 partitions, equal to pyarrow's stable
sort row for row; a TopN, sort(v desc, k).limit(1000), against pyarrow;
three sort orders with nulls, NaN, -0.0 and +-inf against the CPU
engine; K8 (row gather), K9 (lane stats) and K10 (lane pack) against
their plain versions at q3's shapes, at K8's edges (both of its paths,
the single pass and the row records, around its blocks and the plan's
crossover) and on a fetch fuzz, and K8's two paths timed in turns over
a sweep of sizes;
every download split step by step against the per-lane copies it
replaced.  Bench q4, row_number and the running RANGE sum of v over
(partition by k order by v) on the fact table, through the DataFrame
API over 1 and 4 partitions, equal to a numpy oracle row for row, with
its stages (words, K2, K8, boundaries, K11, K12, the results, K13, the
mask, the download) and a trace; K11 (segmented scan), K12 (peer-run
ends) and K13 (row scatter) against their plain versions at q4's shapes
and on edge cases (K11 and K12 either side of their 2,048-, 4,096- and
8,192-row tiles, K12 also with its live rows ending there), K8 at q4's
four lanes on both paths, K13 on both of its paths
(single pass and binned by destination) around its buckets, tiles and
single-pass window; every
window function over 5 specs at 2^20 rows against the CPU engine.
q1x, the TPC-H Q1 shape on the fact table (filter, k % 3, CASE WHEN,
Q1's price arithmetic, group by two keys with sums, averages, count,
min and max, sort), over 1 and 4 partitions,
equal to a numpy oracle, with K3's min and max folds against their plain
version at q1x's shapes and on edge cases (NaN, -0.0, the int64 edges,
BOOLEAN, an all-null group, one group over 2^22 rows, tile edges, 27
ops); every expression of the flat surface at 2^20 rows on the card
against the CPU placement; the right, full, left_semi and left_anti
joins at 2^20 rows against pyarrow.  q3 both ways: the host-assisted
collect (the default: a row-id query, then a host take) and the direct
collect over 1 and 4 partitions, each equal to pyarrow's sort.  Bench q5,
bench's 4 parquet files (written to a temporary directory) -> filter
f < 0.5 -> group by k: sum(v), count, through the DataFrame API: cold
(the file-scan pin cleared) split into host decode, upload and the
rest, warm with the pin (no file may be read) and without it, and over
4 partitions (PERFILE, a GPU-only plan), each equal to pyarrow.  Bench
q7, filter(v > 0) -> parquet write, host-assisted (the keep mask only)
and direct: the footers must count the rows with v > 0 and the file
read back must equal fact.filter(v > 0).  q5 at 2^20 rows with the
parquet scan switched off: the scan on the CPU under GPU operators.
Strings: the fact table gains bench-scale string columns built from
numpy buffers (s, TPC-H's c_name of k, 18 bytes, 100,000 distinct; rf
and ls, Q1's one-byte flags; c, a 10-43 byte comment, 5 % null, some
multi-byte UTF-8) and the dimension its names.  K14 (string hashes),
K15 (murmur3 over bytes), K16 (span gather) and K17 (prefix words)
against their plain versions on edge cases (0 rows, all empty, all
null, a 1 MB string among short ones, 40 bytes of shared prefix,
multi-byte UTF-8, counts around the block and tile sizes, invalid
gather slots; K16 at every source alignment 0-15, on 16-byte rows, on
stretches that end mid-row and a 1 MB row over many stretches), then
qs1 (Q1 grouped by the string flags, 1 and 4 partitions, q1x's numpy
oracle under the mapping; K16 timed on the two flag columns through the
filter's kept rows), qs2 (q1 grouped by
s, pyarrow's group_by), qs3 (the fact joined to the dimension on s,
c riding on the probe side, pyarrow's join row for row) and qs4 (sort
by (s, v) carrying c, and its TopN, pyarrow's sort_by row for row),
each kernel call of those runs against its plain version, and at 2^20
rows the comparisons and IN on s and rf, c IS NULL, F.hash(s, k), a
window by s, MIN/MAX of c by rf and a parquet write of (s, c, v)
against the CPU engine or pyarrow.
The DataFrame surface (PR 17), each run cold and warm (median of 3),
equal to numpy or pyarrow: range(0, 2^25) grouped by id % 100000 over
1 and 4 partitions (a closed-form oracle) and a negative-step range
ending mid-batch; fact.filter(v > 0).union(fact.filter(v <= 0))
grouped by k (q1 without its filter) and its limit(150); distinct of
k over 1 and 4 partitions, of (k, v % 7) and of the string table's
(rf, ls, s), with every K3 call of an empty op set held against its
plain version; sample(0.1, seed=7) over 1 and 4 partitions (a numpy
copy of the mixer, bit for bit), sample(1.0) and sample(0.0);
repartition(8, k) then q1, and repartition(8).count(); the cache of
fact.filter(v > -500000) under q1 three times (materialize, split into
the K9/K10 fetch and the parquet encode; the cached scan, split into
decode and upload; after unpersist), a limit(5) run that must not
materialize it, and the whole string table's (s, c, v), 2^25 rows, through
the cache; count(), dtypes, to_pandas() and GroupedData's sum, count,
min, max and avg on q1's shape.
The flat types: K3's 128-bit sum and DECIMAL128 min and max
against the plain version on its planned path, the direct one and the
records (2^25 rows with TPC-H Q1's 6 groups and with 100,000,
DECIMAL(15,2) and DECIMAL(30,2) values whose adds carry out of the low
word, and edge shapes: no rows, one row, tile edges, an all-null group,
sums that wrap past 2^127), and through 8 exec batches and the merge of
their 128-bit buffers against pyarrow; K3 over orders of 1-65 runs on
the run path (tiles of input rows), forced there, in tiles of sorted
rows and on the records, exactly (a DECIMAL64 sum through its signs
beside DECIMAL128 ops, runs ending inside tiles, carries and min/max
ties across tiles, one 2^25-row group, 100,000 groups, no
contributor, 0 and 1 row); K1, K8, K13, K10 and K5 on int16 lanes
against their plain versions at 1-65,537 rows and at 2^25 (K5 at q2's
shapes), each timed beside its 4-byte lane; q1d, TPC-H Q1 over a 2^25
row lineitem with DATE and DECIMAL(15,2) columns as the reference keeps
it on its device (the sums on 128-bit buffers, min and max of a
decimal and a date, count; 1 and 4 partitions, every operator on the
GPU), and the Q1 text over its first 2^23 rows with its products and
averages on the CPU engine and the reference's placements, each equal
to an exact numpy and Python-int oracle; qn, a 2^25-row table of BYTE, SHORT, FLOAT, DATE,
TIMESTAMP and DECIMAL(9,2) columns (10 % null): a filter on the SHORT
and FLOAT columns, a group-by on (BYTE, DATE) with the sums, mins and
maxes of the others, a sort on (TIMESTAMP desc, FLOAT) and its TopN,
and a parquet write of its first 2^24 rows read back, each equal to
pyarrow or numpy.
The nested types: K18 (the child rows of gathered spans) against its
plain version on edge cases (0 rows, every slot invalid, every array
empty, a row of 2^24 elements beside 10^6 rows of one, one row of 2^22
alone, 10^6 empty rows, child totals around 1,024, 2,048 and 4,096, a
total filling whole merge tiles, a zero tail of 2^20 slots); then
TPC-H SF5's 7,500,000 orders with
their 1-7 lineitems nested inside (an array of structs), the
customer's nation and segment as a struct, the order's attributes as a
map and a 16-byte binary digest: qa1 a filter carrying every column
(1 and 4 partitions), qa2 element_at, [0], getField, struct() and
array(), qa3 a group-by on the struct (1 and 4 partitions), qa4 the
join to 750,000 customers carrying the array and the binary, qa5
qa1's two halves unioned under limit(1,000,000), a parquet round trip
through a pushed filter and the cache under qa1, each equal to its
pyarrow oracle by ``equals``; every K18 call of qa1 and qa4 against its
plain version; a sort carrying the array, a group-by on the binary and
a join carrying the map on the CPU with the reference's reasons.
The string functions: K19 (literal and LIKE search), K20 (UTF-8 cuts)
and K21 (byte maps) against their plain versions on a 2^20-row edge
column (empty rows, overlapping runs, a needle at a row's end, one row
of 2^20 bytes; LIKE patterns with '_' and '%' at either end, the k-th
match from either end, every cut and map mode); TPC-H's text predicates
over columns shaped like TPC-H's, made from the seed: qt1, Q13's
o_comment NOT LIKE '%special%requests%' then a count by customer; qt2,
Q14's and Q16's sum(CASE WHEN p_type LIKE 'PROMO%' THEN e ELSE 0 END)
where p_type NOT LIKE 'MEDIUM POLISHED%' and p_name contains 'green';
qt3, Q22's substring(c_phone, 1, 2) IN 7 codes grouped with a count and
a sum, all at 2^25 rows; qt4, a projection of 18 string functions and
casts to and from strings at 2^22 rows; each against pyarrow or numpy,
every K19-K21 call of them against its plain version exactly.
Dates, bitwise and the small leaves: K22 (the civil calendar's fields)
against its plain version bit for bit on every field code over the
int32 extremes, 0001-01-01, 9999-12-31, the 1900/2000/2100 leap rules,
timestamps of -1 us, months of +-(2^31 - 1), 1-2^20 rows from lanes 0-3
rows off their alignment, and each date expression over nulls against
the CPU engine; K22's year at qd1's call (2^25 DATE rows) timed beside
its bound and plain version; qd1, TPC-H Q9's year grouping over q1d's
lineitem, sum(l_extendedprice * (1 - l_discount)) and a count by
year(l_shipdate), over 1 and 4 partitions against numpy exactly; qd2,
every device rule of the slice (the date fields and arithmetic, the
bitwise ops and shifts, nanvl, inset, dropna's predicate, the markers,
rand and spark_partition_id over 4 partitions), a tumbling window
grouped and a scalar subquery in a filter, at 2^22 rows against the CPU
placement; every K22 call of qd1 and qd2 against its plain version.
The expression catalogue holds decimal %, div, pmod, greatest and least
(DECIMAL(10,2), (18,4), and div of DECIMAL(30,2)), and the DECIMAL(30,2)
ones the plan keeps on the CPU engine evaluated on the card.
Each phase's seconds are printed as it ends, and all of them before the
kernel line.
Launch counts are reset just before each main-path run and must be > 0
after it for every kernel of that path.
Needs one CUDA card; exits non-zero and prints no result without one,
or when any phase fails.
The last line is a JSON object.
"""

import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

ROWS = 1 << 25            # about TPC-H SF5 lineitem's row count
BATCH_ROWS = 4194304      # the largest DEFAULT_ROW_BUCKETS capacity
THRESHOLD = -(10**6) // 2  # bench.py q1's filter constant
SEED = 42                 # bench.py make_tables' seed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FLOAT_RTOL = 1e-9          # float sums add in another order than the oracle
DIM_ROWS = 100_000         # bench.py make_tables' dimension
HOT_COPIES = 10_000        # build rows of the hot key in K5's skew check
HOT_PROBE_ROWS = 1 << 20   # probe rows of that check, 1 % on the hot key
WIDE_ROWS = 1 << 20        # rows of the wide group-by check
WIDE_KEYS = 9              # its grouping columns: 18 key words
WIDE_SUMS = 17             # its sums: 17 K3 ops, two sets of launches
K3_PATHS = (None, "record", "direct", "run")  # K3's planned path, then each
PIN_KEY = "spark.rapids.sql.fileScan.pinDeviceBatches"
COLLECT_KEY = "spark.rapids.sql.collect.hostAssisted"
WRITE_KEY = "spark.rapids.sql.write.hostAssisted"
READER_KEY = "spark.rapids.sql.format.parquet.reader.type"


# ---- the string functions: TPC-H's text predicates -------------------------

TEXT_ROWS = 1 << 25            # qt1-qt3: TPC-H SF5 lineitem's rows
TEXT_PROJ_ROWS = 1 << 22       # qt4's projection
TEXT_EDGE_ROWS = 1 << 20       # K19-K21's edge cases
TEXT_CUSTOMERS = 750_000       # TPC-H SF5 customers (qt1's keys)
TEXT_SPECIAL = 0.03            # comments written "special ... requests"
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")   # Q22's country codes
P_TYPE_WORDS = ((b"STANDARD", b"SMALL", b"MEDIUM", b"LARGE", b"ECONOMY",
                 b"PROMO"),
                (b"ANODIZED", b"BURNISHED", b"PLATED", b"POLISHED",
                 b"BRUSHED"),
                (b"TIN", b"NICKEL", b"BRASS", b"STEEL", b"COPPER"))
COLOURS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
COMMENT_WORDS = (
    "furiously quickly carefully blithely slyly fluffily deposits packages "
    "accounts requests ideas pinto beans foxes theodolites instructions "
    "dependencies excuses platelets asymptotes courts dolphins multipliers "
    "warthogs frets dinos attainments somas patterns forges braids players "
    "final regular express ironic pending bold even silent unusual special "
    "sleep wake are cajole haggle nag use boost affix detect integrate "
    "about above after along among around at before beneath beside between "
    "the of and to").split()


def _word_stream(rng, nbytes):
    """uint8[nbytes]: words of COMMENT_WORDS separated by spaces."""
    vocab = [w.encode() + b" " for w in COMMENT_WORDS]
    lens = np.array([len(w) for w in vocab])
    ids = rng.integers(0, len(vocab), nbytes // 4)
    ends = np.cumsum(lens[ids])
    ids = ids[:int(np.searchsorted(ends, nbytes)) + 1]
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.repeat(starts[ids], lens[ids]) + (
        np.arange(int(lens[ids].sum())) -
        np.repeat(np.cumsum(lens[ids]) - lens[ids], lens[ids]))
    return flat[idx][:nbytes]


def _text_tables(n=None, seed=SEED):
    """TPC-H-shaped text columns at ``n`` rows, from the seed with numpy:
    orders (o_custkey, o_comment: 19-78 bytes of words, TEXT_SPECIAL of
    the rows holding "special ... requests", 1 % null), part (p_type: a
    three-word type; p_name: five colour words; e: an integer price in
    cents) and customer (c_phone "CC-NNN-NNN-NNNN", country codes 10-34;
    c_acctbal in cents)."""
    n = n or TEXT_ROWS
    rng = np.random.default_rng(seed + 31)
    lens = rng.integers(19, 79, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    base = _word_stream(rng, min(1 << 26, int(offs[-1])))
    reps = -(-int(offs[-1]) // base.shape[0])
    chars = np.tile(base, reps)[:int(offs[-1])].copy()
    special = np.flatnonzero(rng.random(n) < TEXT_SPECIAL)
    for j, b in enumerate(b"special "):
        chars[offs[special] + j] = b
    for j, b in enumerate(b" requests"):
        chars[offs[special + 1] - 9 + j] = b
    valid = rng.random(n) >= 0.01
    comment = pa.StringArray.from_buffers(
        n, pa.py_buffer(offs.astype(np.int32)), pa.py_buffer(chars),
        pa.array(valid).buffers()[1])
    orders = pa.table({"o_custkey": pa.array(
        rng.integers(0, TEXT_CUSTOMERS, n)), "o_comment": comment})
    types = pa.array([b" ".join((a, b, c)).decode()
                      for a in P_TYPE_WORDS[0] for b in P_TYPE_WORDS[1]
                      for c in P_TYPE_WORDS[2]])
    colours = pa.array(COLOURS)
    p_type = types.take(pa.array(rng.integers(0, len(types), n)))
    p_name = pc.binary_join_element_wise(
        *[colours.take(pa.array(rng.integers(0, len(COLOURS), n)))
          for _ in range(5)], " ")
    part = pa.table({"p_type": p_type, "p_name": p_name,
                     "e": pa.array(rng.integers(90_000, 10_500_000, n))})
    cc = rng.integers(10, 35, n)
    digits = rng.integers(0, 10, (n, 10)).astype(np.uint8) + 48
    mat = np.full((n, 15), ord("-"), np.uint8)
    mat[:, 0] = cc // 10 + 48
    mat[:, 1] = cc % 10 + 48
    mat[:, 3:6], mat[:, 7:10], mat[:, 11:15] = digits[:, :3], \
        digits[:, 3:6], digits[:, 6:]
    phone = pa.StringArray.from_buffers(
        n, pa.py_buffer(np.arange(0, 15 * n + 1, 15, dtype=np.int32)),
        pa.py_buffer(mat.reshape(-1)))
    customer = pa.table({"c_phone": phone, "c_acctbal": pa.array(
        rng.integers(-99_999, 999_999, n))})
    return orders, part, customer, cc


def _text_edge_column(torch, dev, rng):
    """(offsets, chars) of TEXT_EDGE_ROWS rows on the card: random rows of
    0-40 bytes over "ab_% é", empty rows, overlapping "aaaa" runs, a
    needle at a row's end, and one row of 2^20 bytes among them."""
    alphabet = np.frombuffer("ab_% é".encode(), np.uint8)
    n = TEXT_EDGE_ROWS
    lens = rng.integers(0, 41, n)
    lens[rng.random(n) < 0.05] = 0
    lens[n // 2] = MB_STRING
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    chars = alphabet[rng.integers(0, alphabet.shape[0], int(offs[-1]))]
    for r in range(7, n, 997):                          # overlapping runs
        chars[offs[r]:offs[r + 1]] = ord("a")
    for r in range(11, n, 1009):                        # a needle at the end
        if lens[r] >= 6:
            chars[offs[r + 1] - 6:offs[r + 1]] = np.frombuffer(b"needle",
                                                               np.uint8)
    chars[offs[n // 2 + 1] - 6:offs[n // 2 + 1]] = np.frombuffer(b"needle",
                                                                 np.uint8)
    return (torch.from_numpy(offs.astype(np.int32)).to(dev),
            torch.from_numpy(np.concatenate([chars, np.zeros(64, np.uint8)])
                             ).to(dev))


def _text_tile_column(torch, dev, rng, tile, shift):
    """(offsets, chars) at K19's and K21's tile size ``tile`` (a tile is
    at most that many rows and bytes; a row of at most ``tile`` bytes is
    staged with its tile): random rows of 0-40 bytes over "ab_% é" with
    overlapping "aaaaa" runs and a needle at a row's end; rows ending
    exactly at a multiple of ``tile`` bytes and one byte past it; a row
    of ``tile`` bytes; a row one byte longer (left to its warp); rows of
    1, 15, 16, 17 and 4,096 bytes; a row of MB_STRING bytes of "a" and
    one of 0x80 (continuation bytes only); runs of 100,000 and 60,000
    empty rows, mid-column and at its end, as a filter's padding leaves
    them.  The chars are a view ``shift`` bytes into their buffer, as a
    column's chars follow its offsets."""
    lens = list(rng.integers(0, 41, 3000))
    lens.append(tile - sum(lens) % tile)           # ends at a stretch's end
    lens += [0, 0, 5]
    lens.append(tile - sum(lens) % tile + 1)       # one byte past it
    lens.append(tile - sum(lens) % tile)           # to the next stretch
    lens.append(tile)                              # fills a stretch
    lens.append(tile + 1)                          # one byte longer
    lens += list(rng.integers(0, 41, 500)) + [MB_STRING]
    lens += list(rng.integers(0, 20, 500)) + [0] * 100_000 + [MB_STRING]
    lens += [1, 15, 16, 17, 4096, tile - 1] + list(rng.integers(0, 41, 500))
    lens += [0] * 60_000
    lens = np.array(lens, np.int64)
    offs = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    alphabet = np.frombuffer("ab_% é".encode(), np.uint8)
    chars = alphabet[rng.integers(0, alphabet.shape[0], int(offs[-1]))]
    big = np.flatnonzero(lens == MB_STRING)
    chars[offs[big[0]]:offs[big[0] + 1]] = ord("a")
    chars[offs[big[1]]:offs[big[1] + 1]] = 0x80
    for r in range(7, lens.shape[0], 89):          # overlapping runs
        if lens[r] < tile:
            chars[offs[r]:offs[r + 1]] = ord("a")
    for r in range(11, lens.shape[0], 97):         # a needle at the end
        if 6 <= lens[r] < tile:
            chars[offs[r + 1] - 6:offs[r + 1]] = np.frombuffer(b"needle",
                                                               np.uint8)
    buf = np.zeros(shift + chars.shape[0] + 64, np.uint8)
    buf[shift:shift + chars.shape[0]] = chars
    return (torch.from_numpy(offs.astype(np.int32)).to(dev),
            torch.from_numpy(buf).to(dev)[shift:])


def _text_tile_cases(torch, dev, sops, like_pattern):
    """K19 and K21 on the tile column (chars 4 and 7 bytes off alignment)
    against their plain versions, exactly: every TEXT_PATTERNS search and
    a LIKE pattern of more tokens than K19's bitmaps hold, each on every
    path that can take it (K19's bitmaps and per-row compare; rows longer
    than the tile go to their warp on both), from the row start and from
    inside the row; the mask mode; K21's byte pass (upper, lower,
    initcap) and its staged and long-row reverse.  Returns the checks of
    each path."""
    from spark_rapids_tpu_torch import kernels
    tile = sops.STRING_TILE_BYTES
    for name in ("string_find", "string_map"):
        if kernels.library(name).srt_tile_bytes() != tile:
            raise AssertionError(f"csrc/{name}.cu's tile is not "
                                 f"STRING_TILE_BYTES")
    if kernels.library("string_find").srt_max_tokens() != \
            sops.FIND_BITMAP_TOKENS:
        raise AssertionError("csrc/string_find.cu's kMaxTokens is not "
                             "FIND_BITMAP_TOKENS")
    rng = np.random.default_rng(SEED + 47)
    many = "%" + "%".join("ab" * (sops.FIND_BITMAP_TOKENS // 2 + 1)) + "%"
    pats = [(text, like_pattern(text.encode())[0])
            for text in ("%special%requests%", "a%", "%a", "%needle",
                         "a_b%", "%_a_%", many, "%é%a%")]
    pats += [(text, sops.FindPattern([text.encode()], modes=[mode]))
             for text, mode in (("aa", 0), ("needle", 0), ("é", 0),
                                ("ab", sops.FIND_AT_START),
                                ("ab", sops.FIND_AT_END))]
    pats += [(f"a x{k}{' reversed' * rev}",
              sops.FindPattern([b"a"], repeat=k, reverse=rev))
             for k, rev in ((2, False), (2, True), (3, True))]
    pats.append(("aa x2", sops.FindPattern([b"aa"], repeat=2)))
    checks = {}

    def same(got, want, what, path):
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from its plain version on "
                                 f"the tile column")
        checks[path] = checks.get(path, 0) + 1

    for shift in (4, 7):
        offs, chars = _text_tile_column(torch, dev, rng, tile, shift)
        cap = int(offs.shape[0]) - 1
        long_rows = int(((offs[1:] - offs[:-1]) > tile).sum())
        late = (offs[:-1].long() + torch.from_numpy(
            rng.integers(0, 20, cap)).to(dev)).to(torch.int32).contiguous()
        for text, pat in pats:
            paths = ["rows"] + (["bitmaps"] if sops.find_plan(pat) ==
                                "bitmaps" else [])
            for path in paths:
                for starts in (None, late):
                    same(sops.string_find(offs, chars, pat, starts, path=path),
                         sops.string_find_plain(offs, chars, pat, starts),
                         f"K19 {text!r} ({path})", f"K19 {path}")
        for needle in (b"a", b"ab", b"needle", b"aa"):
            same(sops.string_match_mask(offs, chars, needle),
                 sops.string_match_mask_plain(offs, chars, needle),
                 f"K19's mask {needle!r}", "K19 mask")
        for mode, path in ((sops.MAP_UPPER, "K21 byte pass"),
                           (sops.MAP_LOWER, "K21 byte pass"),
                           (sops.MAP_INITCAP, "K21 byte pass (initcap)"),
                           (sops.MAP_REVERSE, "K21 staged reverse")):
            same(sops.string_map(offs, chars, mode),
                 sops.string_map_plain(offs, chars, mode), f"K21 mode {mode}",
                 path)
        checks["rows past the tile (warp)"] = \
            checks.get("rows past the tile (warp)", 0) + long_rows
    torch.cuda.synchronize()
    return checks


TEXT_PATTERNS = (("%special%requests%", None), ("a%", None), ("%a", None),
                 ("needle", None), ("%needle", None), ("a_b%", None),
                 ("%_a_%", None), ("aa", 0), ("needle", 0), ("é", 0),
                 ("a", 1), ("a", 2), ("aa", 1), ("a", 3))


def _text_kernel_cases(torch, dev, sops, like_pattern):
    """K19, K20 and K21 on the edge column against their plain versions,
    exactly: LIKE patterns (``_`` and ``%`` at either end), contains /
    startswith / endswith, the k-th match from either end, windows that
    start inside the rows, the match mask; every cut mode with random
    positions; every map.  Returns the number of checks."""
    rng = np.random.default_rng(SEED + 41)
    offs, chars = _text_edge_column(torch, dev, rng)
    cap = int(offs.shape[0]) - 1
    o0 = offs[:-1]
    checks = 0

    def same(got, want, what):
        nonlocal checks
        if isinstance(got, tuple):
            ok = all((a is None and b is None) or torch.equal(a, b)
                     for a, b in zip(got, want))
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{what} differs from its plain version on "
                                 f"the edge column")
        checks += 1

    pats = []
    for text, mode in TEXT_PATTERNS:
        if mode is None:
            pat = like_pattern(text.encode())[0]
        elif text == "a" and mode in (1, 2, 3):
            pat = sops.FindPattern([b"a"], repeat=mode, reverse=mode == 2)
        else:
            pat = sops.FindPattern([text.encode()], modes=[mode])
        if pat is not None:
            pats.append((text, pat))
    for anchor in (sops.FIND_AT_START, sops.FIND_AT_END):
        pats.append((f"anchor {anchor}",
                     sops.FindPattern([b"ab"], modes=[anchor])))
    late = (o0.long() + torch.from_numpy(rng.integers(0, 20, cap)).to(dev)
            ).clamp(max=2**31 - 1).to(torch.int32).contiguous()
    for text, pat in pats:
        for starts in (None, late):
            same(sops.string_find(offs, chars, pat, starts),
                 sops.string_find_plain(offs, chars, pat, starts),
                 f"K19 {text!r}")
    for needle in (b"a", b"ab", b"needle", b"% "):
        same(sops.string_match_mask(offs, chars, needle),
             sops.string_match_mask_plain(offs, chars, needle),
             f"K19's mask {needle!r}")
    pos = torch.from_numpy(rng.integers(-50, 60, cap)).to(dev)
    ln = torch.from_numpy(rng.integers(-3, 70, cap)).to(dev)
    for mode in (sops.CUT_LENGTH, sops.CUT_TRIM, sops.CUT_TRIM_LEFT,
                 sops.CUT_TRIM_RIGHT):
        same(sops.utf8_cut(offs, chars, mode),
             sops.utf8_cut_plain(offs, chars, mode), f"K20 mode {mode}")
    for p, length in ((pos, ln), (pos, None), (1, 2), (3, None), (-4, ln),
                      (0, 5), (2, -1)):
        same(sops.utf8_cut(offs, chars, sops.CUT_SUBSTRING, p, length),
             sops.utf8_cut_plain(offs, chars, sops.CUT_SUBSTRING, p,
                                 length), "K20 substring")
    for mode in (sops.MAP_UPPER, sops.MAP_LOWER, sops.MAP_INITCAP,
                 sops.MAP_REVERSE):
        same(sops.string_map(offs, chars, mode),
             sops.string_map_plain(offs, chars, mode), f"K21 mode {mode}")
    torch.cuda.synchronize()
    return checks


def _check_text_captured(torch, cap, sops, what):
    """Every call a text query made of K19, K20 or K21, run again through
    the kernel and its plain version, exactly."""
    plain = {"string_find": sops.string_find_plain,
             "string_match_mask": sops.string_match_mask_plain,
             "utf8_cut": sops.utf8_cut_plain,
             "string_map": sops.string_map_plain}
    seen = []
    for name, args in cap.calls:
        got = cap.orig[name](*args)
        want = plain[name](*args)
        if isinstance(got, tuple):
            same = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want))
        else:
            same = torch.equal(got, want)
        rows = int(args[0].shape[0]) - 1
        if not same:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{what} ({rows} rows)")
        seen.append(f"{name} ({rows} rows)")
        del got, want
    if not seen:
        raise AssertionError(f"{what} made no K19-K21 call")
    return seen


def _text_call_row(torch, cap, name, cuda_ms, bound, median_ms, sops):
    """The kernel line's row of K19, K20 or K21 at a query's first call of
    it: median of 5 launches, the plain version, the bound.  The bound
    counts what the function needs: each byte of the rows read once (not
    the bucket's padding), the offsets, a start or a pos or length only
    where it is a column (a literal is a scalar), and the outputs the
    callers read (K19 the last token's position, K20 the count or the
    cut, K21 each row byte written once)."""
    args = next(a for n, a in cap.calls if n == name)
    fn, plain = cap.orig[name], getattr(sops, f"{name}_plain")
    offs = args[0]
    rows = int(offs.shape[0]) - 1
    nbytes = int(offs[-1])
    columns = sum(isinstance(a, torch.Tensor) for a in args[2:])
    path = None
    if name == "string_find":
        moved = nbytes + 4 * (rows + 1) + 4 * columns * rows + 4 * rows
        path = sops.find_plan(args[2])
    elif name == "utf8_cut":
        out = 4 if args[2] == sops.CUT_LENGTH else 8
        moved = nbytes + 4 * (rows + 1) + 8 * columns * rows + out * rows
    else:
        moved = 2 * nbytes + 4 * (rows + 1)
        path = {sops.MAP_UPPER: "byte pass (upper)",
                sops.MAP_LOWER: "byte pass (lower)",
                sops.MAP_INITCAP: "byte pass (initcap)",
                sops.MAP_REVERSE: "staged reverse"}[args[2]]
    extra = dict(rows=rows, row_bytes=nbytes, bytes_moved=moved)
    if path:
        extra["path"] = path
    return dict(ms=median_ms(lambda: fn(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=2),
                bound_ms=bound(moved), extra=extra)


def _text_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                 bound, path_run):
    """TPC-H's text predicates on the card: K19-K21 on edge cases against
    their plain versions; qt1 (Q13's filter: NOT LIKE
    '%special%requests%', then a count by customer), qt2 (Q14's and
    Q16's: sum(CASE WHEN p_type LIKE 'PROMO%' THEN e ELSE 0 END) and
    sum(e) where p_type NOT LIKE 'MEDIUM POLISHED%' and p_name contains
    'green'), qt3 (Q22's: substring(c_phone, 1, 2) IN 7 codes, grouped
    by it with count and sum) over TEXT_ROWS rows and qt4 (a projection
    of every string function kind and the casts) over TEXT_PROJ_ROWS,
    each through GpuSession against a pyarrow or numpy oracle; every
    K19-K21 call of them against its plain version; the kernel rows."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import Column, col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.expr import strings as se
    from spark_rapids_tpu_torch.expr.core import Literal
    from spark_rapids_tpu_torch.ops import strings as sops

    def median_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return sorted(out)[reps // 2]

    def ex(cls, *args):
        return Column(cls(*[a.expr if isinstance(a, Column) else Literal(a)
                            for a in args]))

    t_text = time.perf_counter()
    try:
        t1 = time.perf_counter()
        n = _text_kernel_cases(torch, dev, sops, se.like_pattern)
        print(f"K19-K21 edge cases ({TEXT_EDGE_ROWS} rows, empty rows, "
              f"overlaps, a needle at the end, one row of {MB_STRING} "
              f"bytes): {n} checks equal their plain versions exactly, "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("K19-K21 edge cases")
        traceback.print_exc()
    try:
        t1 = time.perf_counter()
        checks = _text_tile_cases(torch, dev, sops, se.like_pattern)
        print(f"K19, K21 tile edges ({sops.STRING_TILE_BYTES}-byte tiles, "
              f"chars off alignment): checks equal their plain versions "
              f"exactly by path: {checks}, "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("K19, K21 tile edges")
        traceback.print_exc()

    orders = part = customer = cc = None
    try:
        t1 = time.perf_counter()
        orders, part, customer, cc = _text_tables()
        print(f"text tables of {TEXT_ROWS} rows (o_comment "
              f"{orders['o_comment'].nbytes / 2**30:.2f} GiB): "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("text tables")
        traceback.print_exc()
        return
    session = GpuSession()
    queries = {}

    # qt1: Q13's filter
    try:
        t1 = time.perf_counter()
        keep = pc.invert(pc.match_like(orders["o_comment"],
                                       "%special%requests%"))
        keep = pc.fill_null(keep, False).to_numpy(zero_copy_only=False)
        want1 = np.bincount(orders["o_custkey"].to_numpy()[keep],
                            minlength=TEXT_CUSTOMERS)
        print(f"qt1 oracle: {int(keep.sum())} of {TEXT_ROWS} comments kept, "
              f"{time.perf_counter() - t1:.1f} s")
        d1 = session.create_dataframe(orders)

        def qt1():
            return d1.filter(~ex(se.Like, col("o_comment"),
                                 "%special%requests%")).group_by(
                col("o_custkey")).agg(F.count("*").alias("c")).collect()

        def check1(got, what):
            c = np.zeros(TEXT_CUSTOMERS, np.int64)
            c[got["o_custkey"].to_numpy()] = got["c"].to_numpy()
            if not np.array_equal(c, want1):
                raise AssertionError(f"{what} differs from numpy")
        queries["qt1"] = (qt1, check1, "qt1, Q13's NOT LIKE and a count by "
                                       "customer")
    except Exception:
        failures.append("qt1 oracle")
        traceback.print_exc()

    # qt2: Q14's and Q16's predicates
    try:
        t1 = time.perf_counter()
        pt = part["p_type"]
        sel = pc.and_(pc.invert(pc.match_like(pt, "MEDIUM POLISHED%")),
                      pc.match_substring(part["p_name"], "green"))
        sel = sel.to_numpy(zero_copy_only=False)
        promo = pc.match_like(pt, "PROMO%").to_numpy(zero_copy_only=False)
        e = part["e"].to_numpy()
        want2 = (int(e[sel & promo].sum()), int(e[sel].sum()))
        print(f"qt2 oracle: {int(sel.sum())} parts, "
              f"{time.perf_counter() - t1:.1f} s")
        d2 = session.create_dataframe(part)

        def qt2():
            return d2.filter(
                ~ex(se.Like, col("p_type"), "MEDIUM POLISHED%")
                & col("p_name").contains("green")).agg(
                F.sum(F.when(ex(se.Like, col("p_type"), "PROMO%"),
                             col("e")).otherwise(lit(0))).alias("promo"),
                F.sum(col("e")).alias("all")).collect()

        def check2(got, what):
            if (got["promo"][0].as_py(), got["all"][0].as_py()) != want2:
                raise AssertionError(f"{what}: {got.to_pydict()} != {want2}")
        queries["qt2"] = (qt2, check2, "qt2, Q14's and Q16's LIKE, NOT LIKE, "
                                       "contains and CASE WHEN")
    except Exception:
        failures.append("qt2 oracle")
        traceback.print_exc()

    # qt3: Q22's country codes
    try:
        t1 = time.perf_counter()
        codes = np.array([int(x) for x in Q22_CODES])
        inset = np.isin(cc, codes)
        bal = customer["c_acctbal"].to_numpy()
        want3 = {str(c): (int((cc[inset] == c).sum()),
                          int(bal[inset][cc[inset] == c].sum()))
                 for c in codes}
        print(f"qt3 oracle: {int(inset.sum())} customers, "
              f"{time.perf_counter() - t1:.1f} s")
        d3 = session.create_dataframe(customer)

        def qt3():
            code = F.substring(col("c_phone"), 1, 2)
            return d3.filter(code.isin(*Q22_CODES)).group_by(
                code.alias("cc")).agg(F.count("*").alias("n"),
                                      F.sum(col("c_acctbal")).alias("b")
                                      ).collect()

        def check3(got, what):
            have = {k: (a, b) for k, a, b in zip(
                got["cc"].to_pylist(), got["n"].to_pylist(),
                got["b"].to_pylist())}
            if have != want3:
                raise AssertionError(f"{what}: {have} != {want3}")
        queries["qt3"] = (qt3, check3, "qt3, Q22's substring IN 7 codes, "
                                       "grouped")
    except Exception:
        failures.append("qt3 oracle")
        traceback.print_exc()

    # qt4: one projection over every string function kind and the casts
    try:
        t1 = time.perf_counter()
        m = TEXT_PROJ_ROWS
        rng = np.random.default_rng(SEED + 43)
        ints = rng.integers(-2**31, 2**31, m).astype(np.int32)
        longs = rng.integers(-2**62, 2**62, m)
        days = rng.integers(-40_000, 40_000, m).astype(np.int32)
        cents = rng.integers(-10**11, 10**11, m)
        floats = np.round(rng.normal(0, 1e4, m), 2)
        t4 = pa.table({
            "s": part["p_type"].slice(0, m), "n": part["p_name"].slice(0, m),
            "c": orders["o_comment"].slice(0, m),
            "i": pa.array(ints), "l": pa.array(longs),
            "d": pa.array(days, pa.date32()),
            "dec": _decimal_array(cents, cents >> 63, 12, 2),
            "si": pa.array(ints).cast(pa.string()),
            "sf": pa.array(floats).cast(pa.string()),
            "sd": pa.array(days, pa.date32()).cast(pa.string())})
        want4 = {
            "u": pc.utf8_upper(t4["n"]), "lo": pc.utf8_lower(t4["s"]),
            "ic": pc.utf8_title(t4["s"]),
            "tr": pc.utf8_trim(t4["c"], " "),
            "lp": pc.utf8_slice_codeunits(pc.utf8_lpad(t4["s"], 25, "*"),
                                          0, 25),
            "cc": pc.binary_join_element_wise(t4["s"], t4["n"], "|"),
            "rv": pc.utf8_reverse(t4["n"]),
            "ln": pc.utf8_length(t4["c"]).cast(pa.int32()),
            "loc": pc.add(pc.find_substring(t4["n"], "e"), 1).cast(
                pa.int32()),
            "rp": pc.replace_substring(t4["n"], "green", "GREEN"),
            "cw": pc.if_else(pc.greater(t4["i"], 0), t4["s"], t4["n"]),
            "ci": t4["i"].cast(pa.string()), "cl": t4["l"].cast(pa.string()),
            "cd": t4["d"].cast(pa.string()),
            "cdec": t4["dec"].cast(pa.string()),
            "si2": t4["i"], "sd2": t4["d"]}
        print(f"qt4 table of {m} rows and its pyarrow oracles: "
              f"{time.perf_counter() - t1:.1f} s")
        d4 = session.create_dataframe(t4)

        def qt4():
            return d4.select(
                F.upper(col("n")).alias("u"), F.lower(col("s")).alias("lo"),
                ex(se.InitCap, col("s")).alias("ic"),
                ex(se.Trim, col("c")).alias("tr"),
                ex(se.StringLPad, col("s"), 25, "*").alias("lp"),
                F.concat(col("s"), lit("|"), col("n")).alias("cc"),
                ex(se.Reverse, col("n")).alias("rv"),
                F.length(col("c")).alias("ln"),
                ex(se.StringLocate, "e", col("n")).alias("loc"),
                ex(se.StringReplace, col("n"), "green", "GREEN").alias("rp"),
                F.when(col("i") > 0, col("s")).otherwise(col("n"))
                .alias("cw"),
                col("i").cast("string").alias("ci"),
                col("l").cast("string").alias("cl"),
                col("d").cast("string").alias("cd"),
                col("dec").cast("string").alias("cdec"),
                col("si").cast("int").alias("si2"),
                col("sf").cast("double").alias("sf2"),
                col("sd").cast("date").alias("sd2")).collect()

        def check4(got, what):
            for k, w in want4.items():
                g = got[k]
                if not g.cast(w.type).equals(w):
                    raise AssertionError(f"{what}: column {k} differs from "
                                         f"pyarrow")
            sf = got["sf2"].to_numpy()
            if not np.allclose(sf, floats, rtol=1e-15, atol=0):
                raise AssertionError(f"{what}: column sf2 differs from the "
                                     f"parsed floats")
        queries["qt4"] = (qt4, check4, f"qt4, a projection of 18 string "
                                       f"functions and casts over {m} rows")
    except Exception:
        failures.append("qt4 oracle")
        traceback.print_exc()

    placements = {}
    for run, (fn, check, what) in queries.items():
        try:
            path_run(run, fn, check, what)
            nodes = _placements(session.last_plan)
            placements[run] = nodes
            if nodes[0] != ("DeviceToHostExec", "cpu") or \
                    any(p != "gpu" for _, p in nodes[1:]):
                raise AssertionError(f"{what} placed {nodes}:\n"
                                     f"{session.last_explain}")
            with _Capture(sops, "string_find", "string_match_mask",
                          "utf8_cut", "string_map") as cap:
                fn()
            # the plain versions over qt1's comments take 12 GiB in one
            # piece: give them the allocator's cached blocks
            torch.cuda.empty_cache()
            seen = _check_text_captured(torch, cap, sops, what)
            print(f"{run}: GPU-placed {nodes}; {len(seen)} K19-K21 call(s) "
                  f"equal their plain versions exactly: "
                  + ", ".join(sorted(set(seen))))
            for name, key in (("string_find", "qt1"), ("utf8_cut", "qt3"),
                              ("string_map", "qt4")):
                if run != key:
                    continue
                row = _text_call_row(torch, cap, name, cuda_ms, bound,
                                     median_ms, sops)
                src = {"string_find": "string_find.cu",
                       "utf8_cut": "utf8_cut.cu",
                       "string_map": "string_map.cu"}[name]
                rep = {"string_find": "expr/strings.py:376",
                       "utf8_cut": "expr/strings.py:176",
                       "string_map": "expr/strings.py:71"}[name]
                kernel_rows[name] = dict(
                    source=f"spark_rapids_tpu_torch/csrc/{src}",
                    replaces=f"spark_rapids_tpu/{rep}", max_abs_err=0.0,
                    library_ms=None, **row)
                print(f"{name} at {run}'s call ({row['extra']['rows']} rows, "
                      f"{row['extra']['row_bytes']} bytes, path "
                      f"{row['extra'].get('path', '-')}): median "
                      f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms, "
                      f"plain {row['plain_ms']:.3f} ms; {card}")
            del cap
        except Exception:
            failures.append(run)
            traceback.print_exc()
    for name in ("string_find", "utf8_cut", "string_map"):
        print(f"{name} launches a run: " + ", ".join(
            f"{r} {launches[r][name]}" for r in queries if r in launches))
    del orders, part, customer, session, queries
    print(f"text phases: {time.perf_counter() - t_text:.1f} s")


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nodes(root):
    out = []
    root.foreach(out.append)
    return out


def _placements(root):
    out = []
    root.foreach(lambda e: out.append((type(e).__name__, e.placement)))
    return out


def _make_tables(n):
    """bench.py make_tables' fact and dimension tables, from the same
    seed (the dimension drawn after the fact, from the same generator)."""
    rng = np.random.default_rng(SEED)
    fact = pa.table({
        "k": pa.array(rng.integers(0, 100_000, n).astype(np.int64)),
        "v": pa.array(rng.integers(-(10**6), 10**6, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
    })
    dim = pa.table({
        "k": pa.array(np.arange(DIM_ROWS, dtype=np.int64)),
        "w": pa.array(rng.random(DIM_ROWS)),
    })
    return fact, dim


def _oracle(table):
    ft = table.filter(pc.greater(table["v"], THRESHOLD))
    return ft.group_by("k").aggregate(
        [("v", "sum"), ("f", "mean"), ("k", "count")]).sort_by("k")


def _check_q1(got, want, what):
    got = got.sort_by("k")
    if got.column_names != ["k", "sv", "af", "c"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{want.num_rows}")
    for mine, theirs in (("k", "k"), ("sv", "v_sum"), ("c", "k_count")):
        if not np.array_equal(got[mine].to_numpy(), want[theirs].to_numpy()):
            raise AssertionError(f"{what}: column {mine} differs")
    af, wf = got["af"].to_numpy(), want["f_mean"].to_numpy()
    if not np.all(np.isfinite(af)) or not np.allclose(af, wf, rtol=FLOAT_RTOL,
                                                      atol=0.0):
        raise AssertionError(f"{what}: avg differs by up to "
                             f"{np.max(np.abs(af - wf))}")


def _profile(torch, fn):
    """Wall time, device-busy time (union of kernel and copy intervals)
    and the top device kernels of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, per_name, named = [], {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        named.append((start, e.name[:48], (end - start) / 1e3))
        per_name[e.name] = per_name.get(e.name, 0.0) + (end - start) / 1e3
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is not None and start < last:
            start = last
        if end > start:
            busy += end - start
        last = end if last is None else max(last, end)
    busy /= 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    gathers = sum(ms for name, ms in per_name.items()
                  if "gather" in name or "index_elementwise" in name)
    return dict(wall_ms=wall, busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall),
                top=[(name[:60], ms) for name, ms in top],
                gather_ms=gathers,
                before_probe=list(itertools.takewhile(
                    lambda e: "probe_kernel" not in e[0],
                    [(name, ms) for _, name, ms in sorted(named)])))


def _k3_diff(torch, a, b, what):
    """Raises unless K3's result ``a`` equals its plain version's ``b``:
    groups, first rows, counts and int sums exactly, float sums to
    FLOAT_RTOL.  Returns the largest float difference."""
    if a[3] != b[3] or not torch.equal(a[0], b[0]):
        raise AssertionError(f"K3 groups or first rows differ {what}")
    err = 0.0
    for s, s_p, c, c_p in zip(a[1], b[1], a[2], b[2]):
        if not torch.equal(c, c_p):
            raise AssertionError(f"K3 counts differ {what}")
        if s is None:
            continue
        if s.dtype == torch.int64:
            if not torch.equal(s, s_p):
                raise AssertionError(f"K3 integer sums differ {what}")
            continue
        finite = torch.isfinite(s_p)
        if finite.any():
            err = max(err, float((s - s_p)[finite].abs().max()))
        if not torch.allclose(s, s_p, rtol=FLOAT_RTOL, atol=0.0,
                              equal_nan=True):
            raise AssertionError(f"K3 float sums differ {what} by {err}")
    return err


def _k3_same_bits(torch, a, b):
    """Two K3 results are the same bits (float sums compared as int64)."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return a[3] == b[3] and torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[2], b[2])) and all(
        (x is None and y is None) or torch.equal(bits(x), bits(y))
        for x, y in zip(a[1], b[1]))


def _k3_turns(torch, agg_mod, cuda_ms, args, card, what):
    """K3's planned path and the other one timed in turns (planned,
    other, other, planned) on ``args``; each must equal the plain version.
    Returns the kernel line's ``extra``: the paths' times, the plan's
    device-memory traffic of each path (a read through the order counted
    as the 32-byte sector it pulls) and its scratch."""
    k3 = agg_mod.segment_reduce_sorted
    want = agg_mod.segment_reduce_sorted_plain(*args)
    k3(*args)
    plan = k3.last_plan
    ops = args[6] if len(args) > 6 else [
        "sum" if v is not None else None for v in args[2]]
    other = "direct" if plan.packed else "record"
    for path in (None, other):
        _k3_minmax_diff(torch, k3(*args, path=path), want,
                        [op or "count" for op in ops],
                        f"{what}, path={path}")
    turns = [cuda_ms(lambda p=p: k3(*args, path=p))
             for p in (None, other) * 2]
    n = _k3_rows(args)
    record = max(s.record_bytes for s in plan.sets)
    print(f"K3 {what}: planned path {'records' if plan.packed else 'direct'}"
          f" ({record}-byte records, {plan.rows_per_thread} rows a thread, "
          f"{len(plan.sets)} set(s)); planned / other in turns "
          f"{', '.join(f'{x:.3f}' for x in turns)} ms; traffic: records "
          f"{plan.packed_bytes / max(n, 1):.1f} B a row "
          f"({plan.packed_bytes / 3.35e9:.3f} ms at 3.35 TB/s), direct "
          f"{plan.direct_bytes / max(n, 1):.1f} B a row "
          f"({plan.direct_bytes / 3.35e9:.3f} ms); scratch "
          f"{plan.scratch_bytes} bytes; {card}")
    return dict(path="record" if plan.packed else "direct",
                record_bytes=record, rows_per_thread=plan.rows_per_thread,
                planned_other_in_turns_ms=turns,
                record_traffic_bytes=plan.packed_bytes,
                direct_traffic_bytes=plan.direct_bytes,
                scratch_bytes=plan.scratch_bytes)


def _k3_rows(args):
    """A K3 call's rows: its order's, else its first lane's (a mask of
    every row is None)."""
    words, live, values, contribs = args[:4]
    order = args[5] if len(args) > 5 else None
    return next((int(x.shape[0]) for x in (order, *words, live, *values,
                                           *contribs) if x is not None), 0)


def _k3_path_name(plan):
    return ("plain" if plan is None else "record" if plan.packed else
            "run" if plan.run_path else "direct")


def _k3_traffic(plan):
    """The planned path's modelled device-memory bytes."""
    return plan.packed_bytes if plan.packed else plan.direct_bytes


def _edge_cases(torch, dev, carry, agg_mod):
    """Each kernel against its plain version on the card at shapes the
    full-size run does not reach: partial and single tiles, no rows,
    more lanes than one launch takes, extreme and tied keys, nulls,
    +-inf and NaN, dead rows, the ungrouped aggregate, groups that end
    at, before and after a tile edge.  Returns the number of cases
    checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def rand_bool(n, p):
        return torch.rand(n, generator=gen, device=dev) < p

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    cases = 0
    for n in (0, 1, 31, 4095, 4096, 4097, 8193, 100_003):
        # K1: every lane width, 20 lanes (two launches), some rows kept
        keep = rand_bool(n, 0.3)
        lanes = [rand_ints(n, -2**62, 2**62) for _ in range(6)]
        lanes += [rand_ints(n, -2**31, 2**31).to(torch.int32)
                  for _ in range(4)]
        lanes += [torch.rand(n, generator=gen, device=dev,
                             dtype=torch.float64) for _ in range(4)]
        lanes += [rand_bool(n, 0.5) for _ in range(6)]
        clear = [x.dtype == torch.bool for x in lanes]
        got, n_got = carry.compact_lanes(keep, lanes, clear)
        want, n_want = carry.compact_lanes_plain(keep, lanes, clear)
        if n_got != n_want or not all(torch.equal(a, b)
                                      for a, b in zip(got, want)):
            raise AssertionError(f"K1 differs at n={n}")
        # K2: three words -- ties, extremes, negatives
        words = [rand_ints(n, 0, 2),
                 extremes[rand_ints(n, 0, len(extremes))],
                 rand_ints(n, -5, 5)]
        if not torch.equal(carry.sort_order(words),
                           carry.sort_order_plain(words)):
            raise AssertionError(f"K2 differs at n={n}")
        # K3: keys with a null word read through the order, dead rows,
        # wrapping int sums, floats with +-inf and NaN; and the same rows
        # already in key order (no order)
        order = carry.sort_order_plain(words[:2])
        live = rand_bool(n, 0.85)
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        pick = torch.rand(n, generator=gen, device=dev)
        f = torch.where(pick < 0.02, float("inf"), f)
        f = torch.where((pick > 0.02) & (pick < 0.04), float("-inf"), f)
        f = torch.where((pick > 0.04) & (pick < 0.05), float("nan"), f)
        vals = [rand_ints(n, 2**61, 2**62), f, None]
        contribs = [live & rand_bool(n, 0.9) for _ in vals]
        idx = order.long()
        for global_agg in (False, True):
            for args in ((words[:2], live, vals, contribs, global_agg,
                          order),
                         ([w[idx] for w in words[:2]], live[idx],
                          [None if v is None else v[idx] for v in vals],
                          [c[idx] for c in contribs], global_agg, None)):
                want = agg_mod.segment_reduce_sorted_plain(*args)
                for path in K3_PATHS:
                    _k3_diff(torch, agg_mod.segment_reduce_sorted(
                        *args, path=path), want,
                        f"at n={n}, global={global_agg}, path={path}")
        cases += 1
    # K3 at its tile edges (4,096 rows on the direct path; 2,048 on the
    # record path with these ops' 32-byte records): groups of these sizes
    # in key order, rows shuffled; one group over rows 4000-8190; one
    # group over 100,003 rows that is not the ungrouped aggregate
    for sizes in ([4095], [4096], [4097], [8193], [4095, 4096, 4097, 8193, 7],
                  [4000, 4191, 100], [100_003], [2047, 2049, 2048]):
        n = sum(sizes)
        perm = torch.randperm(n, generator=gen, device=dev)
        key = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev))[perm]
        words = [torch.ones(n, dtype=torch.int64, device=dev), key * 7 - 3]
        order = carry.sort_order_plain(words)
        vals = [rand_ints(n, -2**62, 2**62),
                torch.rand(n, generator=gen, device=dev,
                           dtype=torch.float64), None]
        contribs = [rand_bool(n, 0.9) for _ in vals]
        args = (words, None, vals, contribs, False, order)
        want = agg_mod.segment_reduce_sorted_plain(*args)
        for path in K3_PATHS:
            a = agg_mod.segment_reduce_sorted(*args, path=path)
            _k3_diff(torch, a, want,
                     f"for groups of {sizes} rows, path={path}")
            if a[3] != len(sizes):
                raise AssertionError(f"K3 found {a[3]} groups in {sizes}")
        cases += 1
    return cases


def _k3_minmax_diff(torch, a, b, ops, what):
    """Raises unless K3's result ``a`` equals its plain version's ``b``
    with min and max ops among ``ops``: groups, first rows and counts
    exactly, every min and max bit for bit (float64 viewed as int64, so
    -0.0 differs from 0.0 and NaN payloads count), sums as
    ``_k3_diff``."""
    if a[3] != b[3] or not torch.equal(a[0], b[0]):
        raise AssertionError(f"K3 groups or first rows differ {what}")
    for k, op in enumerate(ops):
        if not torch.equal(a[2][k], b[2][k]):
            raise AssertionError(f"K3 counts of op {k} ({op}) differ {what}")
        if op not in ("min", "max"):
            continue
        x, y = a[1][k], b[1][k]
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        if not torch.equal(x, y):
            bad = int((x != y).nonzero()[0])
            raise AssertionError(f"K3 {op} of op {k} differs {what}: group "
                                 f"{bad} {a[1][k][bad].item()!r} vs "
                                 f"{b[1][k][bad].item()!r}")
    _k3_diff(torch, (a[0], [s for s, op in zip(a[1], ops)
                             if op not in ("min", "max")],
                     [c for c, op in zip(a[2], ops)
                      if op not in ("min", "max")], a[3]),
             (b[0], [s for s, op in zip(b[1], ops)
                     if op not in ("min", "max")],
              [c for c, op in zip(b[2], ops)
               if op not in ("min", "max")], b[3]), what)


def _k3_minmax_cases(torch, dev, carry, agg_mod):
    """K3's min and max folds against their plain version on the card:
    NaN (two payloads), +-inf and -0.0 beside 0.0 compared by bits,
    INT64_MIN and INT64_MAX, BOOLEAN lanes, an all-null group, a global
    min over no rows, one group over every tile (2^22 rows), group
    boundaries on and around tile boundaries, more than 16 ops (a second
    op set), with sums and counts in the same sets.  Returns the number
    of cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    nan2 = torch.tensor([0x7FF8000000000001], dtype=torch.int64).view(
        torch.float64).item()
    specials = torch.tensor([float("nan"), nan2, float("inf"),
                             float("-inf"), -0.0, 0.0, 1.0, -1.0, 5e-324],
                            dtype=torch.float64, device=dev)
    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1], device=dev)

    def lanes(n):
        """(values, ops): float, int and bool min/max lanes drawn from the
        specials, a float and an int sum, and a count."""
        pick = torch.randint(0, len(specials), (n,), generator=gen,
                             device=dev)
        f = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                        specials[pick],
                        torch.randint(-3, 3, (n,), generator=gen,
                                      device=dev).to(torch.float64))
        i = extremes[torch.randint(0, len(extremes), (n,), generator=gen,
                                   device=dev)]
        b = torch.randint(0, 2, (n,), generator=gen, device=dev)
        vals = [f, f, i, i, b, b, f, i, None]
        ops = ["min", "max", "min", "max", "min", "max", "sum", "sum", None]
        return vals, ops

    def check(words, n, vals, ops, global_agg, order, what, p=0.8):
        contribs = [torch.rand(n, generator=gen, device=dev) < p
                    for _ in vals]
        args = (words, None, vals, contribs, global_agg, order, ops)
        want = agg_mod.segment_reduce_sorted_plain(*args)
        for path in K3_PATHS:
            _k3_minmax_diff(torch, agg_mod.segment_reduce_sorted(
                *args, path=path), want, ops, f"{what}, path={path}")

    cases = 0
    for n in (0, 1, 31, 4095, 4096, 4097, 8193, 100_003):
        vals, ops = lanes(n)
        key = torch.randint(0, 5, (n,), generator=gen, device=dev)
        words = [torch.ones(n, dtype=torch.int64, device=dev), key]
        order = carry.sort_order_plain(words)
        for global_agg in (False, True):
            check(words, n, vals, ops, global_agg, order,
                  f"at n={n}, global={global_agg}")
            cases += 1
    # a group whose rows never contribute is null; so is a global min
    # over no rows (one group, count 0)
    n = 10_000
    vals, ops = lanes(n)
    key = torch.randint(0, 3, (n,), generator=gen, device=dev)
    words = [key]
    contribs = [(key != 1) for _ in vals]
    args = (words, None, vals, contribs, False, carry.sort_order_plain(words),
            ops)
    for path in K3_PATHS:
        got = agg_mod.segment_reduce_sorted(*args, path=path)
        _k3_minmax_diff(torch, got, agg_mod.segment_reduce_sorted_plain(
            *args), ops, f"with an all-null group, path={path}")
        if any(int(c[1]) != 0 for c in got[2]):
            raise AssertionError("K3 counted rows of the all-null group")
    empty = [torch.empty(0, dtype=torch.float64, device=dev)]
    for path in K3_PATHS:
        got = agg_mod.segment_reduce_sorted(
            [], None, empty, [torch.empty(0, dtype=torch.bool, device=dev)],
            True, None, ["min"], path=path)
        if got[3] != 1 or int(got[2][0][0]) != 0:
            raise AssertionError("K3's global min over no rows is not one "
                                 "null group")
    cases += 2
    # one group over every tile of 2^22 rows; groups that end on, before
    # and after a tile edge (4,096 rows on the direct path; 1,024 with
    # these ops' 64-byte records)
    for sizes in ([1 << 22], [4096, 4096, 1], [4095, 4097, 8192],
                  [4096 * 3, 5], [1024, 1023, 1025, 2048]):
        n = sum(sizes)
        perm = torch.randperm(n, generator=gen, device=dev)
        key = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev))[perm]
        vals, ops = lanes(n)
        check([key], n, vals, ops, False, carry.sort_order_plain([key]),
              f"for groups of {sizes} rows")
        cases += 1
    # more than 16 ops: 27, so the min and max folds run in two sets
    n = 50_000
    vals, ops = [], []
    for _ in range(3):
        v, o = lanes(n)
        vals += v
        ops += o
    key = torch.randint(0, 40, (n,), generator=gen, device=dev)
    check([key], n, vals, ops, False, carry.sort_order_plain([key]),
          f"with {len(ops)} ops")
    cases += 1
    return cases


def _wide_table(n):
    """WIDE_KEYS grouping columns of every key type (a few values each,
    some nulls) and WIDE_SUMS int and float columns to sum."""
    rng = np.random.default_rng(SEED + 5)
    cols = {}
    for i in range(WIDE_KEYS):
        kind = i % 4
        if kind == 0:
            vals = rng.integers(0, 3, n)
        elif kind == 1:
            vals = rng.integers(-1, 2, n).astype(np.int32)
        elif kind == 2:
            vals = rng.random(n) < 0.5
        else:
            vals = rng.choice([0.5, -1.5, 2.0], n)
        cols[f"k{i}"] = pa.array(vals, mask=rng.random(n) < 0.02)
    for j in range(WIDE_SUMS):
        vals = rng.random(n) if j % 3 == 2 else rng.integers(-10**6, 10**6, n)
        cols[f"v{j}"] = pa.array(vals, mask=rng.random(n) < 0.05)
    return pa.table(cols)


def _wide_group_by(torch, dev, carry, agg_mod, seg, batch_to_device,
                   session, F, col, rows=WIDE_ROWS):
    """A group-by of WIDE_KEYS columns with WIDE_SUMS sums, more key words
    and ops than one K3 launch set takes: K3 against its plain version,
    and the query through the session against pyarrow (keys and int sums
    exactly, float sums to FLOAT_RTOL).  K3 must launch in both."""
    table = _wide_table(rows)
    keys = [f"k{i}" for i in range(WIDE_KEYS)]
    batch = batch_to_device(pa.RecordBatch.from_arrays(
        [c.combine_chunks() for c in table.columns],
        names=table.column_names), dev)
    n = batch.num_rows
    words = [w for c in batch.columns[:WIDE_KEYS]
             for w in seg.key_words_for_column(agg_mod._prefix(c, n))]
    vals = [agg_mod._prefix(c, n) for c in batch.columns[WIDE_KEYS:]]
    sums, contribs, _, _, _ = agg_mod.k3_ops(vals, ["sum"] * WIDE_SUMS)
    args = (words, None, sums, contribs, False, carry.sort_order(words))
    k3 = agg_mod.segment_reduce_sorted
    want = agg_mod.segment_reduce_sorted_plain(*args)
    for path in K3_PATHS:
        before = k3.launches
        res = k3(*args, path=path)
        if dev.type == "cuda" and k3.launches <= before:
            raise AssertionError("K3 did not launch on the wide group-by")
        _k3_diff(torch, res, want, f"with {WIDE_KEYS} grouping columns and "
                 f"{WIDE_SUMS} sums, path={path}")
    before = k3.launches
    got = (session.create_dataframe(table)
           .group_by(*[col(k) for k in keys])
           .agg(*[F.sum(col(f"v{j}")).alias(f"s{j}")
                  for j in range(WIDE_SUMS)])).collect()
    if dev.type == "cuda" and k3.launches <= before:
        raise AssertionError("K3 did not launch on the wide group-by "
                             "through the session")
    want = table.group_by(keys).aggregate(
        [(f"v{j}", "sum") for j in range(WIDE_SUMS)])

    order_by = [(k, "ascending") for k in keys]
    got, want = got.sort_by(order_by), want.sort_by(order_by)
    if got.num_rows != want.num_rows or got.num_rows != res[3]:
        raise AssertionError(f"wide group-by: {got.num_rows} groups, "
                             f"pyarrow {want.num_rows}, K3 {res[3]}")
    for k in keys:
        if not got[k].combine_chunks().equals(want[k].combine_chunks()):
            raise AssertionError(f"wide group-by: key {k} differs")
    for j in range(WIDE_SUMS):
        a = got[f"s{j}"].combine_chunks()
        b = want[f"v{j}_sum"].combine_chunks()
        if not a.is_null().equals(b.is_null()):
            raise AssertionError(f"wide group-by: nulls of s{j} differ")
        a, b = a.drop_null().to_numpy(), b.drop_null().to_numpy()
        same = np.array_equal(a, b) if j % 3 != 2 else np.allclose(
            a, b, rtol=FLOAT_RTOL, atol=0.0)
        if not same:
            raise AssertionError(f"wide group-by: s{j} differs")
    print(f"K3 wide group-by: {rows} rows, {WIDE_KEYS} grouping columns "
          f"({len(words)} key words), {WIDE_SUMS} sums, {res[3]} groups: "
          f"K3 equals its plain version on both paths (the record path in "
          f"{len(k3.last_plan.sets)} sets) and the session's result equals "
          f"pyarrow's")


def _k2_edge_cases(torch, dev, carry, tile):
    """K2 against its plain version around its tile of ``tile`` rows:
    three words with ties and extremes, a word varying in all 64 bits,
    all-equal keys (the order must be the identity) and 12 words, each
    varying in two digits, so later words are read through the order.
    Returns the number of cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    cases = 0
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1):
        full = rand_ints(n, -2**63, 2**63 - 1)
        full[:2] = extremes[:2]
        for what, words in (
                ("three words", [rand_ints(n, 0, 2),
                                 extremes[rand_ints(n, 0, len(extremes))],
                                 rand_ints(n, -5, 5)]),
                ("a word varying in all 64 bits", [full]),
                ("all-equal keys",
                 [torch.full((n,), -7, dtype=torch.int64, device=dev)] * 2),
                ("12 words", [rand_ints(n, 0, 7) << (8 * (j % 7) + 6)
                              for j in range(12)])):
            order = carry.sort_order(words)
            if not torch.equal(order, carry.sort_order_plain(words)):
                raise AssertionError(f"K2 differs on {what} at n={n}")
            if what == "all-equal keys" and not torch.equal(
                    order, torch.arange(n, dtype=torch.int32, device=dev)):
                raise AssertionError(f"K2 moved equal keys at n={n}")
            cases += 1
    return cases


def _k2_passes(carry, words):
    """The passes K2 runs on ``words`` (its pass counter over one call),
    after checking them against the plan from the plain histogram."""
    carry.sort_order.passes = 0
    carry.sort_order(words)
    ran = carry.sort_order.passes
    n = int(words[0].shape[0])
    planned = len(carry.plan_passes(carry.varying_digits(
        carry.digit_histogram_plain(words), n)))
    if ran != planned:
        raise AssertionError(f"K2 ran {ran} passes, the plain histogram "
                             f"plans {planned}")
    return ran


def _same_expansion(torch, a, b):
    """Two results of expand_pairs are the same: indices, and every
    column's data bits and validity."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and all(
        torch.equal(bits(x.data), bits(y.data))
        and torch.equal(x.validity, y.validity)
        for x, y in zip(list(a[2]) + list(a[3]), list(b[2]) + list(b[3]))))


def _join_case(torch, jk, bucket_for, build_cols, n_b, probe_cols, n_p,
               what, nkeys=1, null_matches=False):
    """K6 on both sides' keys, K6 + K2 + K4 (count_matches), K7
    (expand_ends) and K5 (expand_pairs) against their plain versions on
    one build and probe side whose first ``nkeys`` columns are the key,
    for inner, left and full joins, at an output capacity equal to the
    total and at its capacity bucket.  Fails unless K6 launched (for each
    side with rows), K4 and K7 (where there are probe rows) and K5.
    Returns the inner total."""
    cap_b, cap_p = build_cols[0].capacity, probe_cols[0].capacity
    bkeys, pkeys = build_cols[:nkeys], probe_cols[:nkeys]
    for side, keys, cap in (("build", bkeys, cap_b), ("probe", pkeys, cap_p)):
        before = jk.combined_key_hash.launches
        got = jk.combined_key_hash(keys, cap, null_matches, side)
        if cap and jk.combined_key_hash.launches <= before:
            raise AssertionError(f"K6 (key_hash) did not launch on the "
                                 f"{side} side {what}")
        if not torch.equal(got, jk.combined_key_hash_plain(
                keys, cap, null_matches, side)):
            raise AssertionError(f"K6 (key_hash) differs on the {side} side "
                                 f"{what}")
    before = jk.join_probe.launches
    got = jk.count_matches(bkeys, n_b, pkeys, n_p, null_matches)
    if cap_p and jk.join_probe.launches <= before:
        raise AssertionError(f"K4 (join_probe) did not launch {what}")
    want = jk.count_matches_plain(bkeys, n_b, pkeys, n_p, null_matches)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"K6 + K2 + K4 (count_matches) differ {what}")
    order, lo, counts = got
    plive = torch.arange(cap_p, device=lo.device) < n_p
    inner = None
    for how in ("inner", "left", "full"):
        ends, total = _same_ends(torch, jk, counts, plive, how)
        inner = total if inner is None else inner
        for out_cap in sorted({max(total, 1), bucket_for(max(total, 1))}):
            args = (ends, lo, counts, order, total, out_cap, probe_cols,
                    build_cols)
            before = jk.expand_pairs.launches
            got = jk.expand_pairs(*args)
            if jk.expand_pairs.launches <= before:
                raise AssertionError(f"K5 (expand_pairs) did not launch "
                                     f"{what}, {how} join")
            if not _same_expansion(torch, got,
                                   jk.expand_pairs_plain(*args)):
                raise AssertionError(f"K5 (expand_pairs) differs {what}, "
                                     f"{how} join, capacity {out_cap}")
    return inner


def _join_edge_cases(torch, dev, jk, t, DeviceColumn, bucket_for):
    """K6, K4 and K5 against their plain versions on the card at shapes q2
    does not reach: empty and dead build and probe sides, all-null keys
    on either side, build keys repeated 1-64 times, half the probe keys
    missing, probe and output counts around the kernels' blocks of 256,
    keys at +-2^63; INT, BOOLEAN and DOUBLE keys (+-0.0, NaN, +-inf, a
    subnormal), keys of 2 and 3 columns, null keys on both sides with
    nulls matching or not, one key on every live build row, all-distinct
    keys, and a capacity far above the live rows.  Returns the number of
    cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def column(dtype, data, valid):
        return DeviceColumn(dtype, torch.where(
            valid, data, torch.zeros_like(data)), valid)

    def side(keys, null_frac=0.0, build=False):
        """Key column(s) (a tensor, or a list of (type, data) key columns),
        then payload columns."""
        if isinstance(keys, torch.Tensor):
            keys = [(t.LONG, keys)]
        n = int(keys[0][1].shape[0])
        cols = [column(dtype, data, torch.rand(
                    n, generator=gen, device=dev) >= null_frac)
                for dtype, data in keys]
        some = torch.rand(n, generator=gen, device=dev) >= 0.2
        cols.append(column(t.DOUBLE, torch.rand(
            n, generator=gen, device=dev, dtype=torch.float64), some))
        if not build:
            cols += [column(t.INT, rand_ints(n, -2**31, 2**31).to(
                         torch.int32), some),
                     column(t.BOOLEAN, torch.rand(
                         n, generator=gen, device=dev) < 0.5, some)]
        return cols

    extremes = torch.tensor([-2**63, 2**63 - 1, -1, 0, 1, 2**62],
                            device=dev)
    doubles = torch.tensor([0.0, -0.0, float("nan"), -float("nan"),
                            float("inf"), -float("inf"), 1e-310, -1.5, 2.5,
                            1e300], dtype=torch.float64, device=dev)
    many = torch.repeat_interleave(torch.arange(500, device=dev),
                                   rand_ints(500, 1, 65))
    many = many[torch.randperm(many.shape[0], generator=gen, device=dev)]
    uniq = torch.arange(1000, device=dev)

    def ints(n, hi):
        return (t.INT, rand_ints(n, -hi, hi).to(torch.int32))

    def bools(n):
        return (t.BOOLEAN, torch.rand(n, generator=gen, device=dev) < 0.5)

    def dbls(n):
        return (t.DOUBLE, doubles[rand_ints(n, 0, len(doubles))])

    def longs(n, hi):
        return (t.LONG, rand_ints(n, 0, hi))

    # (what, build columns, live build rows, probe columns, live probe
    # rows, key columns, nulls match)
    cases = [
        ("with no build rows", side(uniq[:0], build=True), 0,
         side(rand_ints(1000, 0, 1000), 0.1), 1000, 1, False),
        ("with 1,024 dead build rows",
         side(torch.arange(1024, device=dev), build=True), 0,
         side(rand_ints(1000, 0, 1000)), 1000, 1, False),
        ("with no probe rows", side(uniq, build=True), 1000,
         side(uniq[:0]), 0, 1, False),
        ("with 1,024 dead probe rows", side(uniq, build=True), 1000,
         side(rand_ints(1024, 0, 1000)), 0, 1, False),
        ("with all-null build keys", side(uniq, 1.0, build=True), 1000,
         side(rand_ints(3000, 0, 1000)), 3000, 1, False),
        ("with all-null probe keys", side(uniq, build=True), 1000,
         side(rand_ints(3000, 0, 1000), 1.0), 3000, 1, False),
        ("on build keys repeated 1-64 times", side(many, 0.05, build=True),
         int(many.shape[0]) - 7, side(rand_ints(5000, 0, 520), 0.05), 4990,
         1, False),
        ("with half the probe keys missing", side(uniq, build=True), 1000,
         side(rand_ints(5000, 0, 2000), 0.1), 5000, 1, False),
        ("on keys at +-2^63", side(extremes[rand_ints(300, 0, 6)], 0.1,
                                   build=True), 300,
         side(extremes[rand_ints(2000, 0, 6)], 0.1), 2000, 1, False),
    ]
    # probe and output counts at and around the blocks of 256
    for n in (1, 255, 256, 257, 511, 512, 513, 4097):
        cases.append((f"at {n} probe rows and pairs",
                      side(uniq, build=True), 1000,
                      side(rand_ints(n, 0, 1000)), n, 1, False))
    cases += [
        ("on INT keys", side([ints(2000, 300)], 0.05, build=True), 1990,
         side([ints(4000, 400)], 0.05), 4000, 1, False),
        ("on BOOLEAN keys", side([bools(50)], 0.1, build=True), 50,
         side([bools(3000)], 0.1), 2990, 1, False),
        ("on DOUBLE keys with +-0.0, NaN, +-inf and a subnormal",
         side([dbls(200)], 0.05, build=True), 200,
         side([dbls(3000)], 0.05), 3000, 1, False),
        ("on 2-column keys", side([longs(3000, 40), ints(3000, 5)], 0.02,
                                  build=True), 3000,
         side([longs(6000, 50), ints(6000, 6)], 0.02), 6000, 2, False),
        ("on 3-column keys",
         side([ints(1500, 4), dbls(1500), bools(1500)], 0.02, build=True),
         1500, side([ints(4000, 5), dbls(4000), bools(4000)], 0.02), 4000,
         3, False),
        ("on null keys of both sides, nulls not matching",
         side([longs(800, 60), dbls(800)], 0.2, build=True), 800,
         side([longs(3000, 70), dbls(3000)], 0.2), 3000, 2, False),
        ("on null keys of both sides, nulls matching",
         side([longs(800, 60), dbls(800)], 0.2, build=True), 800,
         side([longs(3000, 70), dbls(3000)], 0.2), 3000, 2, True),
        ("on one key on every live build row",
         side(torch.full((2048,), 7, device=dev), build=True), 2000,
         side(rand_ints(3000, 5, 9)), 3000, 1, False),
        ("on all-distinct build keys",
         side(torch.randperm(50_000, generator=gen, device=dev) * 3,
              build=True), 50_000,
         side(rand_ints(20_000, 0, 150_000)), 20_000, 1, False),
        ("at a capacity far above the live rows",
         side(rand_ints(65_536, 0, 100), build=True), 37,
         side(rand_ints(65_536, 0, 100)), 1000, 1, False),
    ]
    for what, bcols, n_b, pcols, n_p, nkeys, null_matches in cases:
        total = _join_case(torch, jk, bucket_for, bcols, n_b, pcols, n_p,
                           what, nkeys, null_matches)
        if what.startswith("at ") and "probe rows" in what and total != n_p:
            raise AssertionError(f"{total} pairs {what}")
    return len(cases)


def _hot_key(torch, dev, jk, t, DeviceColumn, bucket_for):
    """K4 and K5 on a hot key: HOT_COPIES build rows share one key that 1 %
    of HOT_PROBE_ROWS probe rows hit; the other build keys are
    0..99,999 once and the other probe rows hit them uniformly.  Checks K4
    and K5 against their plain versions; returns (pairs, output capacity,
    K5's arguments, K4's arguments)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    hot = DIM_ROWS
    bkeys = torch.cat([torch.arange(DIM_ROWS, device=dev),
                       torch.full((HOT_COPIES,), hot, device=dev)])
    nb = int(bkeys.shape[0])
    pkeys = torch.where(
        torch.rand(HOT_PROBE_ROWS, generator=gen, device=dev) < 0.01,
        torch.full((HOT_PROBE_ROWS,), hot, device=dev),
        torch.randint(0, DIM_ROWS, (HOT_PROBE_ROWS,), generator=gen,
                      device=dev))

    def col(dtype, data):
        return DeviceColumn(dtype, data, torch.ones(
            data.shape[0], dtype=torch.bool, device=dev))
    build = [col(t.LONG, bkeys), col(t.DOUBLE, torch.rand(
        nb, generator=gen, device=dev, dtype=torch.float64))]
    probe = [col(t.LONG, pkeys), col(t.LONG, torch.randint(
        -10**6, 10**6, (HOT_PROBE_ROWS,), generator=gen, device=dev)),
        col(t.DOUBLE, torch.rand(HOT_PROBE_ROWS, generator=gen, device=dev,
                                 dtype=torch.float64))]
    live_p = torch.ones(HOT_PROBE_ROWS, dtype=torch.bool, device=dev)
    side = jk.sort_build(jk.combined_key_hash(build[:1], nb, side="build"),
                         torch.ones(nb, dtype=torch.bool, device=dev))
    k4_args = (side, probe[:1], HOT_PROBE_ROWS)
    lo, counts = jk.join_probe(*k4_args)
    if not all(torch.equal(x, y) for x, y in zip(
            (lo, counts), jk.join_probe_keys_plain(side.sorted_hash,
                                                   *k4_args[1:]))):
        raise AssertionError("K4 differs from its plain version on the hot "
                             "key")
    ends, total = _same_ends(torch, jk, counts, live_p, "inner")
    out_cap = bucket_for(total)
    args = (ends, lo, counts, side.order, total, out_cap, probe, build)
    if not _same_expansion(torch, jk.expand_pairs(*args),
                           jk.expand_pairs_plain(*args)):
        raise AssertionError("K5 differs from its plain version on the hot "
                             "key")
    return total, out_cap, args, k4_args


def _same_ends(torch, jk, counts, live, how):
    """K7 against its plain version: the running sums and the total,
    exactly.  Fails unless K7 launched.  Returns (ends, total)."""
    before = jk.expand_ends.launches
    ends, total = jk.expand_ends(counts, live, how)
    if counts.shape[0] and jk.expand_ends.launches <= before:
        raise AssertionError(f"K7 (expand_ends) did not launch on "
                             f"{counts.shape[0]} rows, {how} join")
    want = jk.expand_ends_plain(counts, live, how)
    if not (torch.equal(ends, want[0]) and torch.equal(total, want[1])):
        raise AssertionError(f"K7 (expand_ends) differs on "
                             f"{counts.shape[0]} rows, {how} join")
    return ends, int(total)


def _expand_cases(torch, dev, jk, t, DeviceColumn, tile):
    """K7 and K5 against their plain versions on the shapes K5's merge-path
    tiles must get right, on counts made here (not by K4): K7 around its
    tile of 4,096 rows, with dead rows and all misses; K5 behind a run of
    zero-count rows longer than K5's tile of ``tile`` merge items, on one
    row with more pairs than a tile, at a capacity far above the total,
    and with 40 columns of every width, all in one launch.  Returns the
    number of cases checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rand_ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def columns(n, k):
        cols = []
        for i in range(k):
            kind = i % 4
            if kind == 0:
                dtype, data = t.LONG, rand_ints(n, -2**62, 2**62)
            elif kind == 1:
                dtype, data = t.INT, rand_ints(n, -2**31, 2**31).to(
                    torch.int32)
            elif kind == 2:
                dtype, data = t.BOOLEAN, torch.rand(
                    n, generator=gen, device=dev) < 0.5
            else:
                dtype, data = t.DOUBLE, torch.rand(
                    n, generator=gen, device=dev, dtype=torch.float64)
            valid = torch.rand(n, generator=gen, device=dev) >= 0.1
            cols.append(DeviceColumn(dtype, torch.where(
                valid, data, torch.zeros_like(data)), valid))
        return cols

    cases = 0
    for n in (1, 4095, 4096, 4097, 3 * 4096 + 5, 100_003):
        # matches, and all misses
        for counts in (rand_ints(n, 0, 4),
                       torch.zeros(n, dtype=torch.int64, device=dev)):
            live = torch.rand(n, generator=gen, device=dev) < 0.9
            for how in ("inner", "left", "full"):
                _same_ends(torch, jk, counts, live, how)
                cases += 1
    nb = 20_000
    order = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    zero_run = rand_ints(6 * tile, 0, 3)
    zero_run[tile // 3:tile // 3 + 3 * tile] = 0
    hot_row = rand_ints(3000, 0, 3)
    hot_row[1234] = 4 * tile
    for what, counts, extra, ncols in (
            ("behind a run of zero-count rows longer than a tile",
             zero_run, 0, 4),
            ("on one row with more pairs than a tile", hot_row, 0, 4),
            ("at a capacity far above the total", rand_ints(5000, 0, 3),
             7 * 5000, 4),
            ("with 40 columns", rand_ints(5000, 0, 4), 100, 20)):
        n = int(counts.shape[0])
        live = torch.rand(n, generator=gen, device=dev) < 0.95
        lo = rand_ints(n, 0, nb - int(counts.max())).to(torch.int32)
        probe, build = columns(n, ncols), columns(nb, ncols)
        for how in ("inner", "left"):
            ends, total = _same_ends(torch, jk, counts, live, how)
            out_cap = total + extra if total + extra else 1
            args = (ends, lo, counts, order, total, out_cap, probe, build)
            before = jk.expand_pairs.launches
            got = jk.expand_pairs(*args)
            if jk.expand_pairs.launches != before + 1:
                raise AssertionError(f"K5 (expand_pairs) did not launch once "
                                     f"{what}, {how} join")
            if not _same_expansion(torch, got, jk.expand_pairs_plain(*args)):
                raise AssertionError(f"K5 (expand_pairs) differs {what}, "
                                     f"{how} join")
            cases += 1
    return cases


def _same_lanes(torch, a, b):
    """Two lists of lanes hold the same bits."""
    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(a, b))


class _Capture:
    """While open, keeps the arguments of every call of the wrappers
    ``names`` of ``module`` (``calls``: name and positional arguments;
    ``kwargs``: each call's keywords); each call still launches its
    kernel.  A wrapper counts its launches through its module's name, so
    the spy carries a count that goes back to the wrapper on exit."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls, self.kwargs = \
            module, names, [], []

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            def spy(*args, _fn=fn, _n=n, **kwargs):
                self.calls.append((_n, args))
                self.kwargs.append(kwargs)
                return _fn(*args, **kwargs)
            spy.launches = 0
            setattr(self.module, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            if hasattr(fn, "launches"):
                fn.launches += getattr(self.module, n).launches
            setattr(self.module, n, fn)


def _check_captured(torch, cap, carry, gather_mod, fetch, what):
    """Every call a path made of K1, K8, K9 or K10, run again through the
    kernel and its plain version on the same inputs, bit for bit.
    Returns a description of each call."""
    seen = []
    for name, args in cap.calls:
        got = cap.orig[name](*args)
        if name == "compact_lanes":
            want = carry.compact_lanes_plain(*args)
            same = got[1] == want[1] and _same_lanes(torch, got[0], want[0])
            shape = (f"{int(args[0].shape[0])} rows, {got[1]} kept, "
                     f"{len(args[1])} lanes")
        elif name == "gather_rows":
            want = gather_mod.gather_rows_plain(*args)
            same = _same_lanes(torch, got, want)
            shape = (f"{int(args[0].shape[0])} rows, lanes "
                     f"{[str(x.dtype)[6:] for x in args[1]]}")
        elif name == "lane_stats":
            want = fetch.lane_stats_plain(*args)
            same = torch.equal(got, want)
            shape = (f"{args[1]} rows, lanes "
                     f"{[str(x.dtype)[6:] for x in args[0]]}")
        else:
            want = fetch.pack_lanes_plain(*args)
            same = torch.equal(got, want)
            shape = f"{args[3]} rows, plan {args[1]}"
        if not same:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {what} ({shape})")
        seen.append(f"{name} ({shape})")
        del got, want
    if not seen:
        raise AssertionError(f"{what} made no call to capture")
    return seen


def _row_lanes(torch, gen, dev, m, widths):
    """Lanes of ``m`` rows, one a width: int64, int32 or bool."""
    out = []
    for w in widths:
        if w == 8:
            out.append(torch.randint(-2**62, 2**62, (m,), generator=gen,
                                     device=dev))
        elif w == 4:
            out.append(torch.randint(-2**31, 2**31 - 1, (m,), generator=gen,
                                     device=dev, dtype=torch.int32))
        else:
            out.append(torch.rand(m, generator=gen, device=dev) < 0.5)
    return out


def _k8_crossover(gather, m, widths):
    """The fewest rows out of ``m`` that gather_plan sends through the
    records (``m`` rows of the lanes must outgrow L2)."""
    lo, hi = 1, 4 * m
    if not gather.gather_plan(hi, m, widths).packed:
        raise ValueError(f"K8's plan never packs {m} rows of {widths}")
    while lo < hi:
        mid = (lo + hi) // 2
        if gather.gather_plan(mid, m, widths).packed:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _k8_edge_cases(torch, dev, gather):
    """K8 on the single pass, the record path and the planned one against
    its plain version, bit for bit: no rows (no launch), one row, 255-257
    and 2^k +- 1 rows (its 256-row blocks), a random permutation, the
    identity, the reverse, every row reading one source row, orders with
    repeats over lanes 3x and 7x longer and over 7 rows, n either side of
    the plan's crossover (the record path packs the whole source), every
    lane-width mix (one lane of each width, 8+1, 4+8+1, 16 one-byte, 7 and
    8 eight-byte lanes: a full 64-byte record), q3's and q4's lanes, and
    17 and 40 lanes (chunks).  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    q3, q4 = [8, 1] * 3, [8, 1, 8, 1]
    mixes = ([8], [4], [1], [8, 1], [4, 8, 1], [1] * 16, [8] * 7, [8] * 8,
             q3, q4, [1, 4, 8] * 5 + [8, 4], [8, 4, 1] * 13 + [8])
    cases = []
    for n, m, kind in ((1, 1, "perm"), (255, 255, "perm"), (256, 256, "perm"),
                       (257, 257, "perm"), (4095, 4095, "perm"),
                       ((1 << 16) + 1, (1 << 16) + 1, "perm"),
                       ((1 << 20) - 1, (1 << 20) - 1, "perm"),
                       (100_003, 100_003, "identity"),
                       (100_003, 100_003, "reverse"),
                       (100_003, 100_003, "one row"),
                       (100_003, 300_009, "repeats"),
                       (100_003, 700_021, "repeats"),
                       (100_003, 7, "repeats")):
        for widths in mixes:
            cases.append((n, m, kind, widths))
    for widths in (q3, q4, [8, 1]):
        m = 1 << 24
        c = _k8_crossover(gather, m, widths)
        cases += [(c - 1, m, "repeats", widths), (c, m, "repeats", widths)]
    cases.append((0, 3, "perm", q3))
    for n, m, kind, widths in cases:
        if kind == "perm":
            order = torch.randperm(m, generator=gen, device=dev)[:n]
        elif kind == "identity":
            order = torch.arange(n, device=dev)
        elif kind == "reverse":
            order = torch.arange(n - 1, -1, -1, device=dev)
        elif kind == "one row":
            order = torch.full((n,), n // 2, device=dev)
        else:
            order = torch.randint(0, m, (n,), generator=gen, device=dev)
        order = order.to(torch.int32)
        ls = _row_lanes(torch, gen, dev, m, widths)
        want = gather.gather_rows_plain(order, ls)
        plan = gather.gather_plan(n, m, widths)
        for packed in (None, False, True):
            use = plan.packed if packed is None else packed
            before = gather.gather_rows.launches
            got = gather.gather_rows(order, ls, packed=packed)
            launched = gather.gather_rows.launches - before
            want_launches = len(gather.gather_chunks(widths, use)) if n \
                else 0
            if launched != want_launches:
                raise AssertionError(
                    f"K8 with {n} rows and {len(widths)} lanes "
                    f"(packed={packed}) launched {launched} times, not "
                    f"{want_launches}")
            if not _same_lanes(torch, got, want):
                raise AssertionError(
                    f"K8 differs from its plain version with {n} rows of "
                    f"{m}, lanes {widths}, {kind} order, packed={packed}")
    return len(cases)


def _k8_sweep(torch, dev, gather, cuda_ms):
    """The single pass and the record path timed in turns on q3's lanes:
    a permutation of n = m rows, 2^16 to 2^24 (the plan keeps the single
    pass up to 96 MiB of lanes, 3,728,270 rows), then n rows of m = 2^24
    around the plan's crossover (the record path packs all m)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q3 = [8, 1] * 3
    out = []
    for n, m in [(1 << k, 1 << k) for k in (16, 18, 20, 21, 22, 24)] + [
            (1 << 21, 1 << 24), (1 << 22, 1 << 24), (3 << 21, 1 << 24),
            (1 << 23, 1 << 24)]:
        order = torch.randperm(m, generator=gen, device=dev)[:n].to(
            torch.int32)
        ls = _row_lanes(torch, gen, dev, m, q3)
        times = [cuda_ms(lambda p=p: gather.gather_rows(order, ls, packed=p))
                 for p in (False, True, False, True)]
        out.append((n, m, gather.gather_plan(n, m, q3).packed, times))
        del order, ls
    return out


def _k3_sweep(torch, dev, carry, agg_mod, cuda_ms):
    """K3's direct path and its record path timed in turns (direct,
    records, direct, records) around the plan's crossover (96 MiB of
    distinct inputs): a sum of one float lane (q2's and q6's shape) and
    q1's two lanes and count, grouped by 100,000 keys through K2's order,
    2^22 to 2^24 rows; each result equals the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    out = []
    for n in (1 << 22, 6_000_000, 1 << 23, 12_000_000, 1 << 24):
        key = torch.randint(0, 100_000, (n,), generator=gen, device=dev)
        words = [torch.zeros(n, dtype=torch.int64, device=dev), key]
        order = carry.sort_order(words)
        f = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        v = torch.randint(-10**6, 10**6, (n,), generator=gen, device=dev)
        masks = [torch.rand(n, generator=gen, device=dev) < 0.95
                 for _ in range(3)]
        for what, args in (
                ("one lane", (words, None, [f], masks[:1], False, order)),
                ("q1's lanes", (words, None, [v, f, None], masks, False,
                                order))):
            want = agg_mod.segment_reduce_sorted_plain(*args)
            for path in ("direct", "record"):
                _k3_diff(torch, agg_mod.segment_reduce_sorted(
                    *args, path=path), want, f"sweep {what} n={n}")
            agg_mod.segment_reduce_sorted(*args)
            plan = agg_mod.segment_reduce_sorted.last_plan
            times = [cuda_ms(lambda p=p: agg_mod.segment_reduce_sorted(
                *args, path=p)) for p in ("direct", "record") * 2]
            inputs = n * (8 * len(plan.sets[0].lanes)
                          + len(plan.sets[0].masks))
            out.append((what, n, inputs, plan.packed, times))
        del key, words, order, f, v, masks, args, want
    return out


FUZZ_SPANS = (0, 2**8 - 1, 2**8, 2**16 - 1, 2**16, 2**32 - 1, 2**32)


def _fuzz_array(rng, n, kind):
    """One column of the fetch fuzz: nulls (none, some or all), BOOLEAN
    data lanes, INT and LONG at their extremes and at the narrowing
    boundaries of their span, DOUBLE with NaN, -0.0 and +-inf."""
    null_frac = float(rng.choice([0.0, 0.0, 0.1, 1.0]))
    mask = (rng.random(n) < null_frac) if null_frac else None
    if kind == "boolean":
        vals = rng.random(n) < float(rng.choice([0.5, 1.0]))
    elif kind == "int":
        vals = (rng.integers(-2**31, 2**31, n) if rng.random() < 0.3
                else rng.integers(-300, 300, n)).astype(np.int32)
    elif kind == "long_extremes":
        vals = rng.choice(np.array([-2**63, 2**63 - 1, 0, -1],
                                   dtype=np.int64), n)
    elif kind == "long_span":
        base = int(rng.integers(-2**40, 2**40))
        span = int(rng.choice(FUZZ_SPANS))
        vals = base + rng.integers(0, span + 1, n, dtype=np.int64)
        if n >= 2:
            vals[:2] = [base, base + span]
    elif kind == "long_wide":
        vals = rng.integers(-2**62, 2**62, n)
    else:
        vals = rng.normal(size=n)
        pick = rng.random(n)
        vals[pick < 0.05] = np.nan
        vals[(pick >= 0.05) & (pick < 0.1)] = -0.0
        vals[(pick >= 0.1) & (pick < 0.15)] = np.inf
        vals[(pick >= 0.15) & (pick < 0.2)] = -np.inf
    return pa.array(vals, mask=mask)


def _fetch_fuzz(torch, dev, fetch, batch_to_device, batch_to_arrow,
                move_batch, cases=48):
    """K9 and K10 against their plain versions, bit for bit, and
    fetch_batch against batch_to_arrow(move_batch(...)), on seeded
    batches of BOOLEAN, INT, LONG and DOUBLE columns: empty batches, row
    counts that are not a multiple of 8, all-null columns, values at
    +-2^63 and spans of exactly 2^8 - 1, 2^8, 2^16 - 1, 2^16, 2^32 - 1
    and 2^32.  Returns (cases, the row counts seen)."""
    kinds = ("boolean", "int", "long_extremes", "long_span", "long_wide",
             "double")
    sizes = []
    for seed in range(cases):
        rng = np.random.default_rng(SEED + 100 + seed)
        n = int(rng.choice([0, 1, 7, 9, 31, 33, 1023,
                            int(rng.integers(2, 200_000))]))
        picked = [kinds[seed % len(kinds)]] + [
            str(rng.choice(kinds)) for _ in range(int(rng.integers(0, 5)))]
        rb = pa.RecordBatch.from_pydict(
            {f"c{i}_{k}": _fuzz_array(rng, n, k)
             for i, k in enumerate(picked)})
        batch = batch_to_device(rb, dev)
        lanes = fetch.batch_lanes(batch)
        stats = fetch.lane_stats(lanes, n)
        if not torch.equal(stats, fetch.lane_stats_plain(lanes, n)):
            raise AssertionError(f"K9 differs from its plain version: "
                                 f"{picked}, {n} rows")
        plan, mins = fetch.build_plan(lanes, stats.tolist())
        packed = fetch.pack_lanes(lanes, plan, mins, n)
        if not torch.equal(packed, fetch.pack_lanes_plain(lanes, plan, mins,
                                                          n)):
            raise AssertionError(f"K10 differs from its plain version: "
                                 f"{picked}, {n} rows, plan {plan}")
        got = batch_to_arrow(fetch.fetch_batch(batch))
        want = batch_to_arrow(move_batch(batch, torch.device("cpu"),
                                         live_only=True))
        if not (got.schema == want.schema and all(
                _same_arrow(a, b) for a, b in zip(got.columns,
                                                  want.columns))):
            raise AssertionError(f"fetch_batch differs from move_batch: "
                                 f"{picked}, {n} rows, plan {plan}")
        sizes.append(n)
    return cases, sizes


def _same_arrow(a, b):
    """Two Arrow arrays hold the same values and nulls (NaN equal to
    NaN, -0.0 told from 0.0)."""
    if len(a) != len(b) or a.type != b.type:
        return False
    va = np.asarray(a.is_valid())
    if not np.array_equal(va, np.asarray(b.is_valid())):
        return False
    x = a.fill_null(False if pa.types.is_boolean(a.type) else 0)
    y = b.fill_null(False if pa.types.is_boolean(b.type) else 0)
    x, y = x.to_numpy(zero_copy_only=False), y.to_numpy(zero_copy_only=False)
    if x.dtype == np.float64:
        x, y = x.view(np.int64), y.view(np.int64)
    return np.array_equal(x, y)


def _write_parquet_input(fact, root, n_files=4):
    """bench.py write_parquet_input's layout: fact.slice(i * per, per) as
    part-NN.parquet under root/fact_pq, default row groups."""
    path = os.path.join(root, "fact_pq")
    os.makedirs(path, exist_ok=True)
    per = -(-fact.num_rows // n_files)
    for i in range(n_files):
        pq.write_table(fact.slice(i * per, per),
                       os.path.join(path, f"part-{i:02d}.parquet"))
    return path


def _q5_df(session, path, F, col):
    """bench.py q5: read the files, f < 0.5, group by k: sum(v), count."""
    return (session.read.parquet(path)
            .filter(col("f") < 0.5)
            .group_by(col("k"))
            .agg(F.sum(col("v")).alias("sv"), F.count("*").alias("c")))


def _q5_oracle(path):
    files = sorted(os.path.join(path, f) for f in os.listdir(path))
    t = pa.concat_tables([pq.read_table(f) for f in files])
    ft = t.filter(pc.less(t["f"], 0.5))
    return ft.group_by("k").aggregate(
        [("v", "sum"), ("k", "count")]).sort_by("k")


def _check_q5(got, want, what):
    got = got.sort_by("k")
    if got.column_names != ["k", "sv", "c"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{want.num_rows}")
    for mine, theirs in (("k", "k"), ("sv", "v_sum"), ("c", "k_count")):
        if not np.array_equal(got[mine].to_numpy(), want[theirs].to_numpy()):
            raise AssertionError(f"{what}: column {mine} differs")


def _footer_rows(out):
    """(rows the footers count, the parquet files) of a write's output."""
    files = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith(".parquet"))
    return sum(pq.ParquetFile(f).metadata.num_rows for f in files), files


class _FetchTap:
    """While open, records every packed fetch's transfer plan and the
    bytes of its packed buffer (wraps fetch.build_plan and fetch.layout,
    which count no launches)."""

    def __init__(self, fetch):
        self.fetch = fetch
        self.plans = []              # kept alive, so their ids stay unique
        self._sizes = {}

    @property
    def bytes(self):
        return sum(self._sizes.values())

    def __enter__(self):
        build, layout = self._orig = (self.fetch.build_plan,
                                      self.fetch.layout)

        def build_plan(lanes, stats, *offsets_lanes):
            out = build(lanes, stats, *offsets_lanes)
            self.plans.append(out[0])
            return out

        def layout_(lanes, plan, n):
            out = layout(lanes, plan, n)    # called again inside K10's
            self._sizes[id(plan)] = out[1]  # wrapper: count a plan once
            return out
        self.fetch.build_plan, self.fetch.layout = build_plan, layout_
        return self

    def __exit__(self, *exc):
        self.fetch.build_plan, self.fetch.layout = self._orig


class _ScanTap:
    """While open, times every file scan's host decode
    (FileScanExec._read_file) and upload (io/scan.py's batch_to_device,
    between synchronisations), and lists the files read."""

    def __init__(self, torch, scan_mod):
        self.torch = torch
        self.scan_mod = scan_mod
        self.files = []
        self.decode_ms = self.upload_ms = 0.0
        self.upload_bytes = 0

    def __enter__(self):
        cls = self.scan_mod.FileScanExec
        read, up = self._orig = (cls._read_file,
                                 self.scan_mod.batch_to_device)

        def _read_file(exec_, path):
            t0 = time.perf_counter()
            out = read(exec_, path)
            self.decode_ms += (time.perf_counter() - t0) * 1e3
            self.files.append(path)
            return out

        def batch_to_device(rb, device=None, capacity=None):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = up(rb, device, capacity)
            self.torch.cuda.synchronize()
            self.upload_ms += (time.perf_counter() - t0) * 1e3
            self.upload_bytes += rb.nbytes
            return out
        cls._read_file = _read_file
        self.scan_mod.batch_to_device = batch_to_device
        return self

    def __exit__(self, *exc):
        (self.scan_mod.FileScanExec._read_file,
         self.scan_mod.batch_to_device) = self._orig


def _same_table(got, want):
    """Same column names and, column by column, the same values and nulls
    in the same order."""
    return got.column_names == want.column_names and \
        got.num_rows == want.num_rows and all(
            _same_arrow(got[c].combine_chunks(), want[c].combine_chunks())
            for c in want.column_names)


def _orders_table(n):
    """The orders-and-nulls check's table: nulls in an INT column; NaN,
    -0.0, +-inf and nulls in a DOUBLE column; the row number."""
    rng = np.random.default_rng(SEED + 9)
    d = rng.normal(size=n)
    pick = rng.random(n)
    d[pick < 0.02] = np.nan
    d[(pick >= 0.02) & (pick < 0.04)] = -0.0
    d[(pick >= 0.04) & (pick < 0.06)] = 0.0
    d[(pick >= 0.06) & (pick < 0.08)] = np.inf
    d[(pick >= 0.08) & (pick < 0.1)] = -np.inf
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "d": pa.array(d, mask=rng.random(n) < 0.05),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })


def _download_split(torch, fetch, batch_to_arrow, move_batch, batch):
    """The download of one device batch, step by step (ms, the second of
    two passes): the former path (``moved``: one copy a lane, then
    Arrow), then the packed fetch's steps: K9 and the stats read, the
    plan and K10, the copy into the pinned staging buffer, the host
    rebuild and Arrow.  Returns (ms by step, packed bytes, plan)."""
    host = torch.device("cpu")
    n = batch.num_rows
    for _ in range(2):
        ms, st = {}, {}

        def copy():
            g = st["group"]
            buf = fetch.staging_buffer(batch.device, g.total)
            buf[:g.total].copy_(st["packed"], non_blocking=True)
            torch.cuda.synchronize()
            st["host"] = buf

        def stats_read():
            st["group"] = fetch._Group(batch.columns, n)
            st["stats"] = fetch.lane_stats(st["group"].lanes, n).tolist()

        def pack():
            st["group"].plan(st["stats"])
            st["packed"] = st["group"].pack()

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for name, step in (
                ("moved", lambda: batch_to_arrow(move_batch(
                    batch, host, live_only=True))),
                ("stats_read", stats_read),
                ("K10", pack),
                ("copy", copy),
                ("rebuild", lambda: st.update(out=type(batch)(
                    fetch._rebuild_columns(st["group"], st["host"], {}), n,
                    batch.names))),
                ("arrow", lambda: batch_to_arrow(st["out"]))):
            step()
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms[name] = (now - t1) * 1e3
            t1 = now
    return ms, st["group"].total, st["group"].plan_


def _split_line(ms):
    fetched = sum(v for k, v in ms.items() if k != "moved")
    return (" ".join(f"{k}={v:.2f}" for k, v in ms.items())
            + f" (packed fetch {fetched:.2f} against {ms['moved']:.2f})")


def _close(torch, a, b, rtol):
    """Float lanes equal to a relative ``rtol`` (of at least 1)."""
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.ones_like(a))
    return bool(((a - b).abs() <= rtol * scale).all())


def _same_scan(torch, got, want, what):
    """K11's result against its plain version's: positions, counts and
    int64 sums exactly, float64 sums to FLOAT_RTOL."""
    for name in ("seg_start", "run_start", "runs_cum"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and
                                          not torch.equal(a, b)):
            raise AssertionError(f"K11 {name} differs {what}")
    for i, (a, b) in enumerate(zip(got.counts, want.counts)):
        if not torch.equal(a, b):
            raise AssertionError(f"K11 count {i} differs {what}")
    err = 0.0
    for i, (a, b) in enumerate(zip(got.sums, want.sums)):
        if (a is None) != (b is None):
            raise AssertionError(f"K11 sum {i} given and missing {what}")
        if a is None:
            continue
        if a.dtype == torch.float64:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
            if not _close(torch, a, b, FLOAT_RTOL):
                raise AssertionError(f"K11 float sum {i} differs {what}")
        elif not torch.equal(a, b):
            raise AssertionError(f"K11 int sum {i} differs {what}")
    return err


def _window_flags(torch, dev, kind, n, seed):
    """Sorted-row flags for K11 and K12: (new_seg, new_run, n_live)."""
    gen = torch.Generator().manual_seed(seed)
    n_live = n
    rand = torch.rand(n, generator=gen)
    if kind == "one partition":            # spans every tile
        seg = torch.zeros(n, dtype=torch.bool)
        run = rand < 0.3
    elif kind == "all tied":               # one partition, one run
        seg = torch.zeros(n, dtype=torch.bool)
        run = seg.clone()
    elif kind == "own partitions":         # every row its own
        seg = torch.ones(n, dtype=torch.bool)
        run = seg.clone()
    else:
        seg = rand < 0.001
        run = seg | (torch.rand(n, generator=gen) < 0.3)
        if kind == "padded":               # padding rows at the tail
            n_live = n - n // 3 - 1
            seg[n_live:] = False
            run[n_live:] = False
    seg[0] = run[0] = n_live > 0
    return seg.to(dev), run.to(dev), n_live


def _window_kernel_cases(torch, dev, scan, gather):
    """K11, K12 and K13 against their plain versions on the edge cases:
    n = 1, n on either side of K11's tiles (2,048 rows with three or four
    pairs, 4,096 with two, 8,192 with one) and of K12's (8,192), one
    partition over every tile (2^22 rows, and at the tile edges), every
    row tied in one run, every row its own partition (also at the tile
    edges), padding rows at the tail, one to five pairs (more than a K11
    launch takes); K12 with its rows and its live rows on either side of
    a tile edge.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = 0
    edges = [n for t in (2048, 4096, 8192) for n in (t - 1, t + 1)]
    for kind, n in [("random", 1), ("random", 3 * 2048 + 5),
                    ("one partition", 1 << 22), ("all tied", 100_003),
                    ("own partitions", 100_003), ("padded", 100_003),
                    ("padded", 2048), ("random", 1 << 20)] + [
                        (k, n) for n in edges + [16_385]
                        for k in ("one partition", "own partitions")]:
        seg, run, n_live = _window_flags(torch, dev, kind, n, n + cases)
        live = torch.arange(n, device=dev) < n_live
        valid = (torch.rand(n, generator=gen, device=dev) < 0.9) & live
        ints = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev)
        floats = torch.rand(n, generator=gen, device=dev,
                            dtype=torch.float64) * 1e3
        what = f"({kind}, n={n})"
        for pairs, kw in (
                ([(ints, valid), (floats, valid), (None, valid)],
                 dict(run_start=True, runs_cum=True)),
                ([(ints, valid)], {}),
                ([(floats, valid), (ints, valid)],
                 dict(run_start=True)),
                ([(ints, valid)] * 3 + [(floats, valid), (None, valid)],
                 dict(runs_cum=True))):
            before = scan.segment_scan.launches
            got = scan.segment_scan(seg, run, pairs, **kw)
            if scan.segment_scan.launches - before != -(-len(pairs) // 4):
                raise AssertionError(f"K11 launches {what}")
            _same_scan(torch, got, scan.segment_scan_plain(seg, run, pairs,
                                                           **kw), what)
        for flags in ((seg, run), (None, run), (seg, None)):
            got = scan.run_ends(*flags, n_live)
            want = scan.run_ends_plain(*flags, n_live)
            for a, b in zip(got, want):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"K12 differs {what}")
        order = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        lanes = [ints, floats, valid, ints.to(torch.int32)]
        got = gather.scatter_rows(order, lanes)
        if not _same_lanes(torch, got,
                           gather.scatter_rows_plain(order, lanes)) or \
                not _same_lanes(torch, gather.gather_rows(order, got), lanes):
            raise AssertionError(f"K13 differs {what}")
        cases += 1
    # K12 at its 8,192-row tiles (taken from the array's end): the rows
    # and the live rows on either side of a tile edge
    for n in (8191, 8192, 8193, 16_384, 16_385, 3 * 8192 + 7):
        for n_live in sorted({n, n - 1, 8191, 8192, 8193, 16_384} &
                             set(range(1, n + 1))):
            seg, run, _ = _window_flags(torch, dev, "random", n, n + n_live)
            seg[n_live:] = False
            run[n_live:] = False
            for flags in ((seg, run), (None, run), (seg, None)):
                got = scan.run_ends(*flags, n_live)
                want = scan.run_ends_plain(*flags, n_live)
                for a, b in zip(got, want):
                    if (a is None) != (b is None) or (
                            a is not None and not torch.equal(a, b)):
                        raise AssertionError(
                            f"K12 differs at n={n}, n_live={n_live}")
            cases += 1
    return cases


K13_BINNED_FROM = (48 << 20) // 13 + 1  # q4's 13 B of lanes: binned from here


def _k13_cases(torch, dev, gather):
    """K13 on both of its paths (and the one its plan picks) against its
    plain version: n = 1, 255-257, either side of a bucket (512 / 513:
    the shift grows; 2^20 / 2^20 + 1) and of a 3,072-row tile, either
    side of the single-pass window at q4's lanes; random, identity and
    reversed orders; q4's lanes (int32, int64, bool), one int32 lane and
    16 mixed 1-, 4- and 8-byte lanes.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cases = 0
    for n in (1, 255, 256, 257, 512, 513, 3071, 3072, 3073, 1 << 20,
              (1 << 20) + 1, K13_BINNED_FROM - 1, K13_BINNED_FROM):
        for kind in ("random", "identity", "reversed"):
            if kind == "random":
                order = torch.randperm(n, generator=gen, device=dev)
            elif kind == "identity":
                order = torch.arange(n, device=dev)
            else:
                order = torch.arange(n - 1, -1, -1, device=dev)
            order = order.to(torch.int32)
            for widths in ((4, 8, 1), (4,), (1, 4, 8, 8, 4, 1) * 2 +
                           (8, 1, 4, 8)):
                lanes = _row_lanes(torch, gen, dev, n, widths)
                want = gather.scatter_rows_plain(order, lanes)
                for binned in (None, False, True):
                    before = gather.scatter_rows.launches
                    got = gather.scatter_rows(order, lanes, binned=binned)
                    if gather.scatter_rows.launches - before != 1:
                        raise AssertionError("K13 launches")
                    if not _same_lanes(torch, got, want):
                        raise AssertionError(
                            f"K13 differs (n={n}, {kind}, {len(widths)} "
                            f"lanes, binned={binned})")
                cases += 1
    return cases


def _k16_cases(torch, dev, sops):
    """K16's two launches against the plain versions bit for bit, at
    three caps (the total, 5 past it, three stretches and 7 bytes past
    it: the zero tail and a partial last chunk): every source alignment
    0-15 for rows of 1-40 bytes, rows of exactly 16 bytes, 100-byte rows
    (stretches end mid-row), a 1 MB row straddling 256 stretches, a run
    of 29,900 invalid slots (staged over several rounds), one-byte flags
    through a kept index, and n = 1.  Returns the cases run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def column(lens):
        offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=offs[1:])
        chars = torch.randint(0, 256, (max(int(offs[-1]), 1),),
                              generator=gen, device=dev, dtype=torch.uint8)
        return offs.to(torch.int32), chars

    def check(lens, idx, ok, what):
        offs, chars = column(lens)
        o, t, st = sops.gather_offsets(offs, idx, ok)
        o_p, t_p = sops.gather_offsets_plain(offs, idx, ok)
        if not (torch.equal(o, o_p) and torch.equal(t, t_p) and torch.equal(
                st, sops.span_starts_plain(offs, idx, ok))):
            raise AssertionError(f"K16's offsets differ ({what})")
        total = int(t)
        for cap in sorted({max(total, 1), total + 5, total + 3 * 4096 + 7}):
            got = sops.gather_chars(chars, st, o, total, cap)
            if not torch.equal(got, sops.gather_chars_plain(
                    offs, chars, idx, o_p, cap)):
                raise AssertionError(f"K16's copy differs ({what}, cap "
                                     f"{cap}, {total} bytes)")

    def rand_idx(rows, n):
        return torch.randint(0, rows, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)
    cases = 0
    for width in (1, 3, 7, 8, 15, 16, 17, 31, 40):
        for align in range(16):
            lens = torch.full((300,), width, dtype=torch.int64, device=dev)
            lens[0] = align      # every later row's source moves by align
            check(lens, rand_idx(300, 500),
                  torch.rand(500, generator=gen, device=dev) < 0.9,
                  f"{width}-byte rows, sources at {align} mod 16")
            cases += 1
    check(torch.full((10000,), 16, dtype=torch.int64, device=dev),
          torch.arange(10000, dtype=torch.int32, device=dev), ones(10000),
          "16-byte rows")
    check(torch.full((5000,), 100, dtype=torch.int64, device=dev),
          rand_idx(5000, 7000), ones(7000), "100-byte rows")
    lens = torch.randint(0, 30, (3000,), generator=gen, device=dev)
    lens[1234] = MB_STRING
    idx = rand_idx(3000, 4000)
    idx[::500] = 1234
    check(lens, idx, ones(4000), "a 1 MB row, 8 times")
    ok = ones(50000)
    ok[100:30000] = False
    check(torch.randint(1, 5, (50000,), generator=gen, device=dev),
          rand_idx(50000, 50000), ok, "a run of invalid slots")
    kept = (torch.rand(100000, generator=gen, device=dev) < 0.98).nonzero(
    ).flatten().to(torch.int32)
    flags = torch.ones(100000, dtype=torch.int64, device=dev)
    check(flags, kept, ones(kept.shape[0]), "one-byte flags")
    check(flags, kept[:1], ones(1), "n = 1")
    return cases + 6


def _q4_layout(torch, window_mod, EvalContext, wexec, batch):
    """The q4 WindowExec's sorted layout of ``batch``, with K11's and
    K12's results as the main path computes them, and the result lanes
    that K13 moves (rn, rs and rs's validity: rn's is the live mask).
    Returns (layout, K11 pairs, result lanes)."""
    ctx = EvalContext(batch)
    g_inputs, members = [], []
    for w in wexec.window_exprs:
        cols = [window_mod._eval_col(ctx, e) for e in wexec._input_exprs(w)]
        members.append((w, len(g_inputs), len(cols)))
        g_inputs += cols
    lay = wexec._build_layout(batch, ctx, wexec.window_exprs[0].spec,
                              g_inputs, carry_okeys=False)
    pair_of = wexec._scan(lay, members)
    lanes = []
    for w, s, c in members:
        d, v = wexec._compute_one(batch, w, lay, lay.input_sorted[s:s + c],
                                  pair_of)
        lanes += [d] if v is lay.live_s else [d, v]
    pairs = [(lay.input_sorted[0].data,
              lay.input_sorted[0].validity & lay.live_s)]
    return lay, pairs, lanes


def _q4_oracle(table):
    """q4's rn and rs in input order: a stable lexsort by (k, v);
    row_number the position within k plus one; the running sum within k
    read at the end of each (k, v) run.  Returns (rn, rs, tied rows,
    partitions)."""
    k, v = table["k"].to_numpy(), table["v"].to_numpy()
    n = len(k)
    # one stable argsort of (k, v) packed into one word: k below 2^20 and
    # v within +-2^20 (bench's ranges), checked
    if k.min() < 0 or k.max() >= 1 << 20 or np.abs(v).max() >= 1 << 20:
        raise AssertionError("q4 oracle: k or v outside its packing range")
    o = np.argsort((k << 21) | (v + (1 << 20)), kind="stable")
    ks, vs = k[o], v[o]
    pos = np.arange(n)
    new_k = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(new_k, pos, 0))
    cs = np.cumsum(vs)
    run = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    new_run = new_k | np.r_[True, vs[1:] != vs[:-1]]
    ends = np.where(np.r_[new_run[1:], True], pos, n)
    end = np.minimum.accumulate(ends[::-1])[::-1]
    rn, rs = np.empty(n, np.int32), np.empty(n, np.int64)
    rn[o] = pos - start + 1
    rs[o] = run[end]
    # rows tied with the row before on (k, v), and the partitions
    return rn, rs, int(np.sum(~new_run)), int(new_k.sum())


def _check_q4(got, table, rn, rs, what):
    if got.column_names != ["k", "v", "rn", "rs"]:
        raise AssertionError(f"{what}: columns {got.column_names}")
    if got.num_rows != table.num_rows or got.column("rn").null_count or \
            got.column("rs").null_count:
        raise AssertionError(f"{what}: {got.num_rows} rows or nulls")
    for name, want in (("k", table["k"].to_numpy()),
                       ("v", table["v"].to_numpy()), ("rn", rn),
                       ("rs", rs)):
        if not np.array_equal(got.column(name).to_numpy(), want):
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"numpy oracle")


def _window_oracle_table(n):
    """The CPU-engine window check's table: nulls in the partition key,
    the order key and the values, a float column."""
    rng = np.random.default_rng(SEED + 10)
    return pa.table({
        "k": pa.array(rng.integers(0, 2000, n).astype(np.int64),
                      mask=rng.random(n) < 0.02),
        "o": pa.array(rng.integers(-500, 500, n).astype(np.int64),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-(10**6), 10**6, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.random(n)),
    })


def _window_oracle_query(df, F, col, W):
    """Every window function of the slice over three specs: ranks, lead
    and lag, whole-partition sum and avg, bounded ROWS and RANGE sums,
    counts, min and max, a descending order."""
    w = W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
    wd = W.WindowBuilder().partition_by(col("k")).order_by(
        col("o").desc(), col("f"))
    whole = W.WindowBuilder().partition_by(col("k"))
    rows = (W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
            .rows_between(-3, 2))
    rng = (W.WindowBuilder().partition_by(col("k")).order_by(col("o"))
           .range_between(-20, 10))
    return df.select(
        col("k"), col("o"), col("v"), col("f"),
        F.rank().over(w).alias("rk"), F.dense_rank().over(w).alias("drk"),
        F.percent_rank().over(w).alias("pr"),
        F.cume_dist().over(w).alias("cd"), F.ntile(4).over(w).alias("nt"),
        F.lead(col("v")).over(wd).alias("ld"),
        F.lag(col("f"), 2).over(wd).alias("lg"),
        F.row_number().over(wd).alias("rnd"),
        F.sum(col("v")).over(whole).alias("ts"),
        F.avg(col("f")).over(whole).alias("ta"),
        F.sum(col("v")).over(rows).alias("rws"),
        F.count(col("v")).over(rows).alias("rwc"),
        F.max(col("f")).over(rows).alias("rwx"),
        F.sum(col("v")).over(rng).alias("rgs"),
        F.count(col("v")).over(rng).alias("rgc"),
        F.min(col("v")).over(rng).alias("rgn"),
        F.max(col("v")).over(rng).alias("rgx"))


def _same_window_tables(got, want):
    """Column by column: everything but doubles exactly, doubles to
    FLOAT_RTOL; the same nulls."""
    if got.column_names != want.column_names or got.num_rows != want.num_rows:
        return False
    for c in want.column_names:
        a, b = got[c].combine_chunks(), want[c].combine_chunks()
        if not a.is_valid().equals(b.is_valid()):
            return False
        if pa.types.is_floating(a.type):
            x = a.fill_null(0).to_numpy()
            y = b.fill_null(0).to_numpy()
            if not np.allclose(x, y, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
                return False
        elif not a.equals(b):
            return False
    return True


def _q1x_df(session, table, parts, F, col, lit):
    """The TPC-H Q1 shape on the fact table: a filter on f and v, a
    projection with a remainder, CASE WHEN and Q1's price arithmetic,
    then by (rf, ls): three sums, two averages, count(*), and the min and
    max of disc and v, sorted."""
    fact = session.create_dataframe(table, num_partitions=parts)
    return (fact.filter((col("f") <= 0.98) & col("v").is_not_null())
            .select((col("k") % 3).alias("rf"),
                    F.when(col("v") > 0, lit(1)).otherwise(lit(0))
                    .alias("ls"),
                    col("v"), col("f"),
                    (col("v") * (lit(1.0) - col("f"))).alias("disc"),
                    (col("v") * (lit(1.0) - col("f"))
                     * (lit(1.0) + col("f") / lit(10))).alias("charge"))
            .group_by("rf", "ls")
            .agg(F.sum("v"), F.sum("disc"), F.sum("charge"), F.avg("v"),
                 F.avg("f"), F.count("*"), F.min("disc"), F.max("disc"),
                 F.min("v"), F.max("v"))
            .sort("rf", "ls"))


def _q1x_oracle(table):
    """q1x in numpy: per (rf, ls) in order, the ten aggregates."""
    k = table["k"].to_numpy()
    v = table["v"].to_numpy()
    f = table["f"].to_numpy()
    keep = f <= 0.98
    k, v, f = k[keep], v[keep], f[keep]
    disc = v.astype(np.float64) * (1.0 - f)
    charge = disc * (1.0 + f / 10.0)
    gid = (k % 3) * 2 + (v > 0)
    rows = []
    for g in range(6):
        m = gid == g
        vv, dd = v[m], disc[m]
        rows.append(dict(rf=g // 2, ls=g % 2, sv=int(vv.sum()),
                         sd=float(dd.sum()), sc=float(charge[m].sum()),
                         av=float(vv.sum()) / len(vv), af=float(f[m].mean()),
                         c=int(m.sum()), mind=float(dd.min()),
                         maxd=float(dd.max()), minv=int(vv.min()),
                         maxv=int(vv.max())))
    return rows


def _check_q1x(got, want, what):
    """Keys, integer sums, counts and every min and max exactly (doubles
    by bits); float sums and averages to FLOAT_RTOL."""
    if got.num_rows != len(want):
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{len(want)}")
    cols = got.columns
    names = ["rf", "ls", "sv", "sd", "sc", "av", "af", "c", "mind", "maxd",
             "minv", "maxv"]
    exact = {"rf", "ls", "sv", "c", "minv", "maxv", "mind", "maxd"}
    for i, name in enumerate(names):
        mine = cols[i].to_pylist()
        theirs = [r[name] for r in want]
        if name in exact:
            if mine != theirs or (name in ("mind", "maxd") and [
                    np.float64(x).view(np.int64) for x in mine] != [
                    np.float64(x).view(np.int64) for x in theirs]):
                raise AssertionError(f"{what}: column {name} "
                                     f"({got.column_names[i]}) {mine} vs "
                                     f"{theirs}")
        elif not np.allclose(mine, theirs, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"{what}: column {name} differs by up to "
                                 f"{np.max(np.abs(np.subtract(mine, theirs)))}")


CATALOGUE_ROWS = 1 << 20


def _catalogue_table(n):
    """Columns for every new expression: a, b LONG with INT64_MIN, -1 and
    0 divisors; i INT with INT32_MIN; d, e DOUBLE with NaN, +-inf, -0.0,
    1e19 and 9.3e18; x BOOLEAN; p, q DECIMAL(10,2), r, u DECIMAL(18,4)
    and g, z DECIMAL(30,2) (g past 2^64 in a quarter of its rows), q, u
    and z with zero divisors; nulls in each."""
    rng = np.random.default_rng(SEED + 21)

    def mask(p=0.05):
        return rng.random(n) < p
    a = rng.integers(-(10**12), 10**12, n)
    a[rng.random(n) < 0.05] = -2**63
    b = rng.integers(-4, 5, n)
    b[rng.random(n) < 0.05] = -2**63
    i = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    i[rng.random(n) < 0.03] = -2**31
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e19, -1e19,
                         9.3e18, 0.5, -0.5, 2.5, -2.5])
    d = rng.normal(0.0, 1e3, n)
    pick = rng.random(n) < 0.3
    d[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    e = rng.normal(0.0, 10.0, n)
    e[rng.random(n) < 0.05] = 0.0

    def dec(lo_bound, precision, scale, divisor=False, wide=False):
        lo = rng.integers(-lo_bound, lo_bound, n)
        if divisor:
            lo[rng.random(n) < 0.05] = 0
        hi = lo >> 63
        if wide:           # values past 2^64 in a quarter of the rows
            big = rng.random(n) < 0.25
            hi = np.where(big, rng.integers(-2**30, 2**30, n), hi)
        return _decimal_array(lo, hi, precision, scale, ~mask())
    return pa.table({
        "a": pa.array(a, mask=mask()), "b": pa.array(b, mask=mask()),
        "i": pa.array(i, mask=mask()), "d": pa.array(d, mask=mask()),
        "e": pa.array(e, mask=mask()),
        "x": pa.array(rng.random(n) < 0.5, mask=mask()),
        "p": dec(10**9, 10, 2), "q": dec(10**4, 10, 2, divisor=True),
        "r": dec(10**17, 18, 4), "u": dec(10**9, 18, 4, divisor=True),
        "g": dec(2**62, 30, 2, wide=True),
        "z": dec(10**6, 30, 2, divisor=True)})


def _catalogue_columns(F, col, lit, ar, mx, cond, Column):
    """Every expression this port brings, over _catalogue_table."""
    def node(cls, *args):
        return Column(cls(*[a.expr for a in args]))
    a, b, i, d, e, x, p, q, r, u, g, z = (col(c) for c in "abidexpqrugz")
    cols = {
        "mod_dec": p % q, "pmod_dec": node(ar.Pmod, p, q),
        "idiv_dec": node(ar.IntegralDivide, p, q), "mod_dec18": r % u,
        "pmod_dec18": node(ar.Pmod, r, u),
        "idiv_dec18": node(ar.IntegralDivide, r, u),
        "idiv_dec30": node(ar.IntegralDivide, g, z),
        "greatest_dec": F.greatest(p, q), "least_dec18": F.least(r, u),
        "add": a + b, "sub": i - b, "mul": a * b, "mul_d": d * e,
        "div": a / b, "div_d": d / e, "idiv": node(ar.IntegralDivide, a, b),
        "mod": a % b, "mod_i": i % b, "mod_d": d % e,
        "pmod": node(ar.Pmod, a, b), "pmod_d": node(ar.Pmod, d, e),
        "neg": -a, "pos": node(ar.UnaryPositive, i), "abs": F.abs(a),
        "abs_d": F.abs(d), "greatest": F.greatest(d, e, lit(0.0)),
        "least": F.least(a, b), "eqns": d.eq_null_safe(e),
        "isnull": d.is_null(), "isnotnull": a.is_not_null(),
        "isnan": F.isnan(d), "in": b.isin(1, -1, None),
        "in_d": d.isin(float("nan"), 0.0),
        "if": node(cond.If, x, a, b),
        "case": F.when(d > 0, d).when(x, lit(None)).otherwise(e),
        "coalesce": F.coalesce(d, e, lit(1.5)), "nvl": node(cond.Nvl, a, b),
        "nullif": node(cond.NullIf, b, lit(0)),
        "log": F.log(d), "log2": F.log2(e), "log10": F.log10(d),
        "log1p": F.log1p(e), "logb": F.log(e, d), "pow": F.pow(e, lit(3)),
        "atan2": F.atan2(d, e), "floor": F.floor(d), "ceil": F.ceil(d),
        "signum": F.signum(d), "round": F.round(d, 1),
        "round_i": F.round(i, -2), "bround": F.bround(d, 1),
        "d2l": d.cast("long"), "d2i": d.cast("int"), "l2i": a.cast("int"),
        "i2d": i.cast("double"), "b2l": x.cast("long"),
        "d2b": d.cast("boolean"), "n2i": lit(None).cast("int"),
    }
    for name in ("sqrt", "exp", "expm1", "sin", "cos", "tan", "cot", "asin",
                 "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
                 "atanh", "cbrt", "rint", "degrees", "radians"):
        cols[name] = getattr(F, name)(e)
    return [c.alias(name) for name, c in cols.items()]


def _decimal128_on_card(torch, dev, ct, batch_to_device, EvalContext, ar,
                        t):
    """%, pmod, greatest, least and div of the catalogue's DECIMAL(30,2)
    columns g and z, evaluated on the card (the plan keeps the first four
    on the CPU engine, as the reference's rules do) against the same
    expressions on the CPU: both words and the validity.  Returns the
    count."""
    from spark_rapids_tpu_torch.expr.core import BoundReference as B
    rb = pa.RecordBatch.from_arrays(
        [ct.column("g").combine_chunks(), ct.column("z").combine_chunks()],
        names=["g", "z"])
    card, host = batch_to_device(rb, dev), batch_to_device(rb, "cpu")
    dt = t.DecimalType(30, 2)
    g, z = B(0, dt), B(1, dt)
    exprs = [ar.Remainder(g, z), ar.Pmod(g, z), ar.Greatest(g, z),
             ar.Least(g, z), ar.IntegralDivide(g, z)]
    for e in exprs:
        a, b = e.eval(EvalContext(card)).col, e.eval(EvalContext(host)).col
        if not (torch.equal(a.data.cpu(), b.data) and
                torch.equal(a.validity.cpu(), b.validity) and
                (a.data_hi is None) == (b.data_hi is None) and
                (a.data_hi is None or
                 torch.equal(a.data_hi.cpu(), b.data_hi))):
            raise AssertionError(f"{e.sql()} over DECIMAL(30,2) on the card "
                                 f"differs from the CPU engine")
    return len(exprs)


def _same_catalogue(got, want, rtol):
    """The card's catalogue against the CPU's: integers and booleans
    exactly, doubles by bits or, for a finite pair, to ``rtol`` (libm's
    last bit may differ between the host and the card).  Returns (the
    columns that differ, the largest relative double difference)."""
    bad, worst = [], 0.0
    for name in want.column_names:
        g, w = got[name], want[name]
        if g.type != w.type or g.null_count != w.null_count or not \
                g.is_null().equals(w.is_null()):
            bad.append(name)
            continue
        gn = g.fill_null(False if pa.types.is_boolean(g.type) else 0) \
            .to_numpy()
        wn = w.fill_null(False if pa.types.is_boolean(w.type) else 0) \
            .to_numpy()
        if not pa.types.is_floating(g.type):
            if not np.array_equal(gn, wn):
                bad.append(name)
            continue
        same = gn.view(np.int64) == wn.view(np.int64)
        both_nan = np.isnan(gn) & np.isnan(wn)
        finite = np.isfinite(gn) & np.isfinite(wn)
        with np.errstate(invalid="ignore", over="ignore"):
            rel = np.abs(gn - wn) / np.maximum(np.abs(wn), 1e-300)
        close = finite & (rel <= rtol)
        if not np.all(same | both_nan | close):
            bad.append(name)
        if finite.any():
            worst = max(worst, float(np.max(np.where(finite, rel, 0.0))))
    return bad, worst


def _join_table_pairs(table, dim):
    """A 2^20-row fact slice and a dimension that misses a third of its
    keys and holds keys the fact does not."""
    fact = table.slice(0, 1 << 20).select(["k", "v"])
    keys = np.arange(33_000, 133_000, dtype=np.int64)
    rng = np.random.default_rng(SEED + 31)
    right = pa.table({"k": pa.array(keys),
                      "w": pa.array(rng.random(len(keys)))})
    return fact, right


def _sorted_rows(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


# ---------------------------------------------------------------------------
# the string phase: columns, queries, oracles and kernel cases
# ---------------------------------------------------------------------------

STRING_SMALL = 1 << 20     # rows of the string checks after qs1-qs4
MB_STRING = 1 << 20        # the long string among short ones


def _strings_from(lengths, chars, valid=None):
    """A large_string array from numpy lengths and bytes, through Arrow's
    buffers (no Python str objects); ``valid`` marks the non-null rows."""
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    bitmap = None if valid is None else pa.py_buffer(
        np.packbits(valid, bitorder="little"))
    return pa.LargeStringArray.from_buffers(
        len(lengths), pa.py_buffer(offs), pa.py_buffer(chars), bitmap,
        0 if valid is None else int((~valid).sum()))


def _customer_names(keys):
    """TPC-H c_name, "Customer#%09d" % key: 18 bytes a row."""
    n = len(keys)
    out = np.empty((n, 18), dtype=np.uint8)
    out[:, :9] = np.frombuffer(b"Customer#", dtype=np.uint8)
    k = keys.astype(np.int64)
    for d in range(9):
        out[:, 17 - d] = ord("0") + (k // 10**d) % 10
    return _strings_from(np.full(n, 18, np.int64), out.reshape(-1))


def _one_byte(codes, letters):
    """One letter a row: ``letters[codes[i]]``."""
    chars = np.frombuffer(letters, dtype=np.uint8)[codes]
    return _strings_from(np.ones(len(codes), np.int64), chars)


def _comments(rng, n):
    """TPC-H l_comment-sized text: 10-43 random lowercase bytes a row, 5 %
    of the rows null (empty), 1 % with a two-byte UTF-8 letter (é) at the
    start of the row."""
    lengths = rng.integers(10, 44, n)
    valid = rng.random(n) >= 0.05
    lengths = np.where(valid, lengths, 0)
    chars = rng.integers(ord("a"), ord("z") + 1, int(lengths.sum()),
                         dtype=np.uint8)
    starts = np.cumsum(lengths) - lengths
    accent = valid & (rng.random(n) < 0.01)
    chars[starts[accent]] = 0xC3
    chars[starts[accent] + 1] = 0xA9
    return _strings_from(lengths, chars, valid)


def _string_tables(table, dim):
    """bench's fact and dimension with the string columns: s (c_name of
    the key: 100,000 distinct, FK into the dimension's PK), rf and ls
    (TPC-H Q1's flags, "ARN"[k % 3] and "FO"[v > 0]) and c (a comment);
    the fact also gets its row id."""
    k = table["k"].to_numpy()
    v = table["v"].to_numpy()
    rng = np.random.default_rng(SEED)
    fact = pa.table({
        "id": pa.array(np.arange(len(k), dtype=np.int64)),
        "k": table["k"], "v": table["v"], "f": table["f"],
        "s": _customer_names(k),
        "rf": _one_byte(k % 3, b"ARN"),
        "ls": _one_byte((v > 0).astype(np.int64), b"FO"),
        "c": _comments(rng, len(k))})
    dk = dim["k"].to_numpy()
    sdim = pa.table({"s": _customer_names(dk), "w": dim["w"]})
    return fact, sdim


def _qs1_df(session, fact, parts, F, col, lit):
    """q1x grouped by the string flags rf and ls, then sorted."""
    df = session.create_dataframe(fact.select(["rf", "ls", "v", "f"]),
                                  num_partitions=parts)
    return (df.filter((col("f") <= 0.98) & col("v").is_not_null())
            .select(col("rf"), col("ls"), col("v"), col("f"),
                    (col("v") * (lit(1.0) - col("f"))).alias("disc"),
                    (col("v") * (lit(1.0) - col("f"))
                     * (lit(1.0) + col("f") / lit(10))).alias("charge"))
            .group_by("rf", "ls")
            .agg(F.sum("v"), F.sum("disc"), F.sum("charge"), F.avg("v"),
                 F.avg("f"), F.count("*"), F.min("disc"), F.max("disc"),
                 F.min("v"), F.max("v"))
            .sort("rf", "ls"))


def _qs1_oracle(q1x_rows):
    """q1x's numpy oracle under the flags' mapping, in the flags' order."""
    rows = [dict(r, rf="ARN"[r["rf"]], ls="FO"[r["ls"]]) for r in q1x_rows]
    return sorted(rows, key=lambda r: (r["rf"], r["ls"]))


def _qs2_df(session, fact, F, col):
    """q1 keyed by the customer name s."""
    return (session.create_dataframe(fact.select(["s", "v", "f"]))
            .filter(col("v") > THRESHOLD)
            .group_by(col("s"))
            .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                 F.count("*").alias("c")))


def _qs2_oracle(fact):
    ft = fact.filter(pc.greater(fact["v"], THRESHOLD))
    return ft.group_by("s").aggregate(
        [("v", "sum"), ("f", "mean"), ("s", "count")]).sort_by("s")


def _check_qs2(got, want, what):
    got = got.sort_by("s")
    if got.column_names != ["s", "sv", "af", "c"] or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.column_names}, {got.num_rows} "
                             f"groups, oracle {want.num_rows}")
    for mine, theirs in (("s", "s"), ("sv", "v_sum"), ("c", "s_count")):
        if not got[mine].combine_chunks().equals(
                want[theirs].combine_chunks()):
            raise AssertionError(f"{what}: column {mine} differs")
    af, wf = got["af"].to_numpy(), want["f_mean"].to_numpy()
    if not np.allclose(af, wf, rtol=FLOAT_RTOL, atol=0.0):
        raise AssertionError(f"{what}: avg differs")


def _qs3_df(session, fact, sdim):
    """The fact joined to the dimension on the customer name (FK -> PK),
    the comment c riding along on the probe side."""
    return session.create_dataframe(fact.select(["id", "s", "c"])).join(
        session.create_dataframe(sdim), on="s", how="inner")


def _by_id(t):
    ids = t["id"].to_numpy()
    return t.take(pa.array(np.argsort(ids, kind="stable")))


def _qs4_df(session, fact, col):
    """q3 keyed by (s, v), carrying the comment."""
    return session.create_dataframe(fact.select(["s", "v", "c"])).sort(
        col("s"), col("v"))


def _same_strings_table(got, want):
    """Equal column by column, strings byte for byte."""
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        return False
    return all(got[c].combine_chunks().equals(want[c].combine_chunks())
               for c in want.column_names)


def _string_edge_arrays(rng):
    """Edge cases for K14-K17, each an Arrow string array."""
    def rand(n, lo=0, hi=20, p_null=0.1):
        lengths = rng.integers(lo, hi + 1, n)
        valid = rng.random(n) >= p_null
        lengths = np.where(valid, lengths, 0)
        chars = rng.integers(ord("a"), ord("z") + 1, int(lengths.sum()),
                             dtype=np.uint8)
        return _strings_from(lengths, chars, valid)
    shared = np.frombuffer(b"q" * 40, dtype=np.uint8)
    sp_len = np.array([41, 41, 40, 33, 32, 45])
    sp_chars = np.concatenate([np.concatenate([shared, np.frombuffer(
        bytes([97 + i]) * (L - 40), dtype=np.uint8)]) if L > 40 else
        shared[:L] for i, L in enumerate(sp_len)])
    utf = "é中\U0001F600".encode("utf-8")
    mb_len = np.full(300, len(utf), np.int64)
    long_len = rng.integers(0, 30, 2000)
    long_len[777] = MB_STRING
    long_chars = rng.integers(0, 256, int(long_len.sum()), dtype=np.uint8)
    return {
        "0 rows": _strings_from(np.zeros(0, np.int64),
                                np.zeros(0, np.uint8)),
        "all empty": _strings_from(np.zeros(5000, np.int64),
                                   np.zeros(0, np.uint8)),
        "all null": _strings_from(np.zeros(3000, np.int64),
                                  np.zeros(0, np.uint8),
                                  np.zeros(3000, dtype=bool)),
        "1 MB among short": _strings_from(long_len, long_chars),
        "32+ bytes shared": _strings_from(sp_len, sp_chars),
        "multi-byte": _strings_from(mb_len, np.tile(np.frombuffer(
            utf, dtype=np.uint8), 300)),
        "255 rows": rand(255), "256 rows": rand(256), "257 rows": rand(257),
        "4095 rows": rand(4095, 0, 90), "4096 rows": rand(4096, 0, 90),
        "4097 rows": rand(4097, 0, 90), "9000 rows, 70 B": rand(9000, 60, 80),
    }


def _string_kernel_check(torch, sops, hashfns, offsets, chars, rng, what,
                         n_out=None):
    """K14, K15, K16 and K17 on one span column, each against its plain
    version bit for bit; K16 over a random selection with invalid slots.
    Returns the number of checks."""
    cap = int(offsets.shape[0]) - 1
    got = sops.string_hashes(offsets, chars, join_word=True)
    want = sops.string_hashes_plain(offsets, chars, join_word=True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K14 differs from its plain version ({what})")
    got, want = sops.order_keys(offsets, chars), \
        sops.order_keys_plain(offsets, chars)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K17 differs from its plain version ({what})")
    seed = torch.from_numpy(rng.integers(0, 2**32, cap, dtype=np.int64)
                            ).to(offsets.device)
    valid = torch.from_numpy(rng.random(cap) < 0.9).to(offsets.device)
    got = hashfns.hash_bytes(offsets, chars, seed, valid)
    want = hashfns.hash_bytes_plain(offsets, chars, seed, valid)
    if not torch.equal(got, want):
        raise AssertionError(f"K15 differs from its plain version ({what})")
    m = n_out if n_out is not None else max(cap, 1) + 37
    idx = torch.from_numpy(rng.integers(-3, max(cap, 1) + 3, m
                                        ).astype(np.int32)).to(offsets.device)
    ok = torch.from_numpy(rng.random(m) < 0.8).to(offsets.device)
    ok &= (idx >= 0) & (idx < cap)       # an invalid slot: out of range too
    got = sops.gather_strings(offsets, chars, idx, ok)
    o, total = sops.gather_offsets_plain(offsets, idx, ok)
    want = (o, sops.gather_chars_plain(offsets, chars, idx, o,
                                       int(got[1].shape[0])))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K16 differs from its plain version ({what})")
    return 4


def _check_string_captured(torch, cap, sops, hashfns, what):
    """Every call a string path made of K14, K15, K16 or K17, run again
    through the kernel and its plain version, bit for bit."""
    seen = []
    for name, args in cap.calls:
        got = cap.orig[name](*args)
        if name == "string_hashes":
            want = sops.string_hashes_plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "order_keys":
            want = sops.order_keys_plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "gather_offsets":
            want = sops.gather_offsets_plain(*args) + (
                sops.span_starts_plain(*args),)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
        elif name == "gather_chars":
            want = sops.copy_spans_plain(*args[:3], args[4])
            same = torch.equal(got, want)
        else:
            want = hashfns.hash_bytes_plain(*args)
            same = torch.equal(got, want)
        rows = int(args[0].shape[0]) - 1 if name != "gather_chars" else \
            int(args[1].shape[0])
        if not same:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {what} ({rows} rows)")
        seen.append(f"{name} ({rows} rows)")
        del got, want
    if not seen:
        raise AssertionError(f"{what} made no call to capture")
    return seen


SAMPLE_FRACTION = 0.1      # the surface phase's sample(0.1, seed=7)
SAMPLE_SEED = 7
RANGE_MOD = 100_000        # range's k = id % 100000, bench's key count


def _range_oracle(n, mod):
    """k, sum(v) and count of range(0, n) grouped by k = id % mod with
    v = 3 id - 2^24, in closed form: group k holds ids k + j mod."""
    k = np.arange(mod, dtype=np.int64)
    c = (n - k + mod - 1) // mod
    ids = c * k + mod * c * (c - 1) // 2
    return k, 3 * ids - (1 << 24) * c, c


def _check_grouped(got, want, what):
    """``got`` sorted by its first column equals the numpy columns
    ``want`` (in key order) exactly."""
    got = got.sort_by(got.column_names[0])
    if got.num_rows != len(want[0]):
        raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                             f"{len(want[0])}")
    for name, w in zip(got.column_names, want):
        if not np.array_equal(got[name].to_numpy(), w):
            raise AssertionError(f"{what}: column {name} differs")


def _keep_mask_np(n, row_offset, pid, seed, fraction):
    """The sample's keep decisions in numpy uint32: the reference's
    SampleExec._keep_mask, copied."""
    idx = np.arange(n, dtype=np.uint32) + np.uint32(row_offset)
    h = idx ^ np.uint32((seed * 0x9E3779B9 + pid * 0x85EBCA6B) & 0xFFFFFFFF)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return (h & np.uint32(0xFFFFFF)).astype(np.float64) / float(1 << 24) \
        < fraction


def _sample_oracle(table, parts):
    """k, sum(v), count of the sampled rows: a LocalScanExec partition
    p holds rows [p per, (p + 1) per), one batch, row offset 0."""
    n = table.num_rows
    per = -(-n // parts)
    keep = np.concatenate([
        _keep_mask_np(min(per, n - p * per), 0, p, SAMPLE_SEED,
                      SAMPLE_FRACTION) for p in range(parts)])
    kept = table.filter(pa.array(keep))
    g = kept.group_by("k").aggregate([("v", "sum"), ("k", "count")]) \
        .sort_by("k")
    return (g["k"].to_numpy(), g["v_sum"].to_numpy(),
            g["k_count"].to_numpy()), int(keep.sum())


def _bincount_keys(codes, size):
    """The distinct values of ``codes`` in [0, size), ascending."""
    return np.flatnonzero(np.bincount(codes, minlength=size))


def _k3_no_op_check(torch, cap, agg_mod, what):
    """Every captured K3 call with an empty op set, again through the
    kernel and its plain version: the same group count and first rows."""
    calls = 0
    for _, args in cap.calls:
        if args[2]:
            continue
        got = cap.orig["segment_reduce_sorted"](*args)
        want = agg_mod.segment_reduce_sorted_plain(*args)
        if got[3] != want[3] or not torch.equal(got[0], want[0]):
            raise AssertionError(f"K3 with no op differs from its plain "
                                 f"version at {what}")
        calls += 1
    if not calls:
        raise AssertionError(f"{what} made no K3 call with no op")
    return calls


# ---------------------------------------------------------------------------
# the flat types: q1d, q1 and qn, K3's 128-bit folds, 2-byte lanes
# ---------------------------------------------------------------------------

Q1_CUTOFF = 10471          # date '1998-09-02' in days since 1970-01-01
Q1_DAY0, Q1_DAY1 = 8036, 10561   # 1992-01-02 and 1998-12-01
# the reference's placements of the TPC-H Q1 text (the CPU probe that
# tests/test_torch_decimal.py pins), "Tpu" read as "Gpu"
Q1_PLACEMENTS = [
    ("DeviceToHostExec", "cpu"), ("CoalesceBatchesExec", "gpu"),
    ("SortExec", "gpu"), ("HostToDeviceExec", "gpu"),
    ("CpuHashAggregateExec", "cpu"), ("ProjectExec", "cpu"),
    ("DeviceToHostExec", "cpu"), ("FilterExec", "gpu"),
    ("LocalScanExec", "gpu")]
SHORT_ROWS = (1, 2, 3, 255, 257, 6143, 6145, 65535, 65537)
# the Q1 text's rows: its CPU engine stages (the int128 products and
# pyarrow's decimal group-by) took 26-35 s over 2^25 rows on the H100's
# host, 18.4 s over 2^24 and 25 s (cold and warm) over 2^23; it runs over
# 2^22 to leave the script's time limit room for the later phases
Q1_TEXT_ROWS = ROWS // 8
# qn's rows and its parquet round trip (20.3 s at 2^25 rows): cut from
# 2^25 and 2^24 to make room for the date phases
QN_ROWS = ROWS // 2
QN_WRITE_ROWS = ROWS // 8


def _decimal_array(lo, hi, precision, scale, valid=None):
    """A decimal128 array from numpy int64 low and high words."""
    n = len(lo)
    bitmap = None if valid is None else pa.py_buffer(
        np.packbits(valid, bitorder="little"))
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), n,
        [bitmap, pa.py_buffer(np.stack([lo, hi], 1).astype(np.int64)
                              .tobytes())],
        0 if valid is None else int((~valid).sum()))


def _lineitem(n, seed=SEED):
    """A TPC-H lineitem of n rows in TPC-H's value ranges: DECIMAL(15,2)
    quantity (1-50), extended price (up to 104,949.50), discount
    (0.00-0.10) and tax (0.00-0.08), the two one-letter flags and the
    ship date (1992-01-02 to 1998-12-01).  Returns (table, the unscaled
    numpy columns and the flags' codes)."""
    rng = np.random.default_rng(seed)
    raw = dict(qty=rng.integers(1, 51, n) * 100,
               price=rng.integers(90000, 10494951, n),
               disc=rng.integers(0, 11, n), tax=rng.integers(0, 9, n),
               ship=rng.integers(Q1_DAY0, Q1_DAY1 + 1, n).astype(np.int32),
               rf=rng.integers(0, 3, n), ls=rng.integers(0, 2, n))
    zero = np.zeros(n, np.int64)
    table = pa.table({
        "l_quantity": _decimal_array(raw["qty"], zero, 15, 2),
        "l_extendedprice": _decimal_array(raw["price"], zero, 15, 2),
        "l_discount": _decimal_array(raw["disc"], zero, 15, 2),
        "l_tax": _decimal_array(raw["tax"], zero, 15, 2),
        "l_returnflag": _one_byte(raw["rf"], b"ANR"),
        "l_linestatus": _one_byte(raw["ls"], b"FO"),
        "l_shipdate": pa.Array.from_buffers(
            pa.date32(), n, [None, pa.py_buffer(raw["ship"])])})
    return table, raw


def _q1d_df(session, table, parts, F, col, lit):
    import datetime
    return (session.create_dataframe(table, num_partitions=parts)
            .filter(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(col("l_discount")).alias("sum_disc"),
                 F.min(col("l_extendedprice")).alias("min_price"),
                 F.max(col("l_extendedprice")).alias("max_price"),
                 F.min(col("l_shipdate")).alias("min_ship"),
                 F.max(col("l_shipdate")).alias("max_ship"),
                 F.count("*").alias("count_order"))
            .sort(col("l_returnflag"), col("l_linestatus")))


def _q1_df(session, table, F, col, lit):
    """The TPC-H Q1 text: the two products projected, then the
    aggregate with its averages (the CPU engine's, as the reference
    places it)."""
    import datetime
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1) - disc)
    return (session.create_dataframe(table)
            .filter(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .select(col("l_returnflag"), col("l_linestatus"),
                    col("l_quantity"), price, disc,
                    disc_price.alias("disc_price"),
                    (disc_price * (lit(1) + col("l_tax"))).alias("charge"))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(price).alias("sum_base_price"),
                 F.sum(col("disc_price")).alias("sum_disc_price"),
                 F.sum(col("charge")).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(price).alias("avg_price"),
                 F.avg(disc).alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .sort(col("l_returnflag"), col("l_linestatus")))


def _half_up(num, den):
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def _q1_oracles(raw):
    """q1d's and q1's rows from numpy on the unscaled int64 columns (every
    per-group sum fits int64 at 2^25 rows) and Python ints: the sums
    exact, each average HALF_UP at its input's scale (the reference's CPU
    engine, pyarrow's decimal mean), as decimals."""
    import decimal
    D = decimal.Decimal
    keep = raw["ship"] <= Q1_CUTOFF
    group = raw["rf"] * 2 + raw["ls"]       # A < N < R, F < O
    disc_price = raw["price"] * (100 - raw["disc"])
    charge = disc_price * (100 + raw["tax"])
    q1d, q1 = [], []
    for g in range(6):
        m = keep & (group == g)
        cnt = int(m.sum())
        if not cnt:
            continue
        s = {k: int(raw[k][m].sum()) for k in ("qty", "price", "disc")}
        q1d.append(dict(
            sum_qty=D(s["qty"]).scaleb(-2),
            sum_base_price=D(s["price"]).scaleb(-2),
            sum_disc=D(s["disc"]).scaleb(-2),
            min_price=D(int(raw["price"][m].min())).scaleb(-2),
            max_price=D(int(raw["price"][m].max())).scaleb(-2),
            min_ship=int(raw["ship"][m].min()),
            max_ship=int(raw["ship"][m].max()), count_order=cnt))
        q1.append(dict(
            sum_qty=D(s["qty"]).scaleb(-2),
            sum_base_price=D(s["price"]).scaleb(-2),
            sum_disc_price=D(int(disc_price[m].sum())).scaleb(-4),
            sum_charge=D(int(charge[m].sum())).scaleb(-6),
            avg_qty=D(_half_up(s["qty"], cnt)).scaleb(-2),
            avg_price=D(_half_up(s["price"], cnt)).scaleb(-2),
            avg_disc=D(_half_up(s["disc"], cnt)).scaleb(-2),
            count_order=cnt))
    return q1d, q1


def _check_rows(got, want, what):
    """``got`` (an Arrow table) holds ``want``'s rows, exactly."""
    import datetime
    epoch = datetime.date(1970, 1, 1)
    if got.num_rows != len(want):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(want)}")
    for name in want[0]:
        mine = got.column(name).to_pylist()
        if mine and isinstance(mine[0], datetime.date):
            mine = [(d - epoch).days for d in mine]
        theirs = [r[name] for r in want]
        if mine != theirs:
            raise AssertionError(f"{what}: column {name} {mine} != "
                                 f"{theirs}")


def _decimal_table(n, seed=SEED):
    """n rows of a key k (1,000 groups), a DECIMAL(15,2) d15 and a
    DECIMAL(30,2) d30 whose high words are non-zero and whose low words
    carry when added, each 10 % null."""
    rng = np.random.default_rng(seed + 2)
    lo15 = rng.integers(-10**13, 10**13, n)
    lo30 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    hi30 = rng.integers(-2**34, 2**34, n)
    v15, v30 = rng.random(n) >= 0.1, rng.random(n) >= 0.1
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        "d15": _decimal_array(lo15, lo15 >> 63, 15, 2, v15),
        "d30": _decimal_array(lo30, hi30, 30, 2, v30)})


def _check_decimal_groups(got, want, what):
    """The exec's rows equal pyarrow's group-by (sums, min, max as
    decimals, counts) group for group."""
    rows = {r["k"]: r for r in got.to_pylist()}
    for w in want.to_pylist():
        r = rows.pop(w["k"], None)
        if r is None or (r["s15"], r["s30"], r["mn"], r["mx"], r["c"]) != (
                w["d15_sum"], w["d30_sum"], w["d30_min"], w["d30_max"],
                w["k_count"]):
            raise AssertionError(f"{what}: group {w['k']} {r} != {w}")
    if rows:
        raise AssertionError(f"{what}: {len(rows)} groups pyarrow lacks")


def _narrow_table(n, seed=SEED):
    """qn's table: BYTE, SHORT, FLOAT, DATE (30 days), TIMESTAMP (us,
    UTC) and DECIMAL(9,2) columns, each 10 % null, with a row id."""
    rng = np.random.default_rng(seed + 1)

    def valid():
        return rng.random(n) >= 0.1

    vals = dict(b=rng.integers(-128, 128, n).astype(np.int8),
                s=rng.integers(-32768, 32768, n).astype(np.int16),
                f=(rng.standard_normal(n) * 100).astype(np.float32),
                dt=rng.integers(10000, 10030, n).astype(np.int32),
                ts=rng.integers(-2**50, 2**50, n),
                dec=rng.integers(-(10**9) + 1, 10**9, n))
    masks = {k: valid() for k in vals}
    cols = {"rid": pa.array(np.arange(n, dtype=np.int64))}
    for k, v in vals.items():
        if k == "dec":
            cols[k] = _decimal_array(v, v >> 63, 9, 2, masks[k])
            continue
        typ = {"dt": pa.date32(), "ts": pa.timestamp("us", tz="UTC")}.get(
            k, pa.from_numpy_dtype(v.dtype))
        cols[k] = pa.Array.from_buffers(
            typ, n, [pa.py_buffer(np.packbits(masks[k], bitorder="little")),
                     pa.py_buffer(v)], int((~masks[k]).sum()))
    return pa.table(cols), vals, masks


def _qn_sort_oracle(vals, masks):
    """The row order of sort(ts desc, f): ts descending with nulls last,
    then f ascending with nulls first, then input order (pyarrow's
    stable sort over four derived keys)."""
    keys = pa.table({
        "ts_null": ~masks["ts"], "ts": np.where(masks["ts"], -vals["ts"], 0),
        "f_valid": masks["f"],
        "f": np.where(masks["f"], vals["f"].astype(np.float64), 0.0)})
    return pc.sort_indices(keys, sort_keys=[
        (k, "ascending") for k in keys.column_names]).to_numpy()


def _qn_group_oracle(table):
    """pyarrow's group_by over (b, dt): the sums of s, f (as float64) and
    dec, the min and max of s, f, ts and dec, and the count; rows as
    dicts keyed by (b, dt)."""
    t2 = table.append_column("f64", table["f"].cast(pa.float64()))
    res = pa.TableGroupBy(t2, ["b", "dt"], use_threads=False).aggregate(
        [("s", "sum"), ("s", "min"), ("s", "max"), ("f64", "sum"),
         ("f", "min"), ("f", "max"), ("ts", "min"), ("ts", "max"),
         ("dec", "sum"), ("dec", "min"), ("dec", "max"), ("rid", "count")])
    return {(r["b"], r["dt"]): r for r in res.to_pylist()}


def _check_qn_groups(got, want, what):
    rows = {(r["b"], r["dt"]): r for r in got.to_pylist()}
    if rows.keys() != want.keys():
        raise AssertionError(f"{what}: {len(rows)} groups, oracle "
                             f"{len(want)}")
    exact = [("ss", "s_sum"), ("mns", "s_min"), ("mxs", "s_max"),
             ("mnf", "f_min"), ("mxf", "f_max"), ("mnt", "ts_min"),
             ("mxt", "ts_max"), ("sd", "dec_sum"), ("mnd", "dec_min"),
             ("mxd", "dec_max"), ("c", "rid_count")]
    for key, r in rows.items():
        w = want[key]
        for mine, theirs in exact:
            if r[mine] != w[theirs]:
                raise AssertionError(f"{what}: group {key} {mine} "
                                     f"{r[mine]} != {w[theirs]}")
        a, b = r["sf"], w["f64_sum"]
        if (a is None) != (b is None) or (
                a is not None and abs(a - b) > 1e-9 * max(abs(b), 1.0)):
            raise AssertionError(f"{what}: group {key} sum(f) {a} != {b}")


def _short_lane_cases(torch, dev, carry, gather, fetch, jk, t,
                      DeviceColumn, bucket_for, cuda_ms, rows):
    """K1, K8, K10, K13 and K5 on int16 lanes against their plain versions,
    exactly: at SHORT_ROWS and at ``rows`` (K5 at q2's shapes), every path
    of K8 and K13; returns (cases, the 2-byte and 4-byte times of each
    kernel at ``rows``, and each 2-byte row's plain time, bound and
    library call)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases, times = 0, {}

    def short(n):
        return torch.randint(-2**15, 2**15, (n,), generator=gen,
                             device=dev, dtype=torch.int16)

    def same(a, b, what):
        nonlocal cases
        cases += 1
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what} differs from its plain version")

    for n in SHORT_ROWS + (rows,):
        lane = short(n)
        keep = torch.rand(n, generator=gen, device=dev) < 0.6
        valid = torch.rand(n, generator=gen, device=dev) < 0.9
        lanes, clear = [lane, valid], [False, True]
        got, k = carry.compact_lanes(keep, lanes, clear)
        want, k_p = carry.compact_lanes_plain(keep, lanes, clear)
        if k != k_p:
            raise AssertionError(f"K1 kept {k} vs {k_p} of {n} int16 rows")
        same(got, want, f"K1 on {n} int16 rows")
        order = torch.randint(0, n, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        for packed in (False, True):
            same(gather.gather_rows(order, [lane, valid], packed=packed),
                 gather.gather_rows_plain(order, [lane, valid]),
                 f"K8 (packed={packed}) on {n} int16 rows")
        for binned in (False, True):
            same(gather.scatter_rows(perm, [lane, valid], binned=binned),
                 gather.scatter_rows_plain(perm, [lane, valid]),
                 f"K13 (binned={binned}) on {n} int16 rows")
        stats = fetch.lane_stats([lane, valid], n).tolist()
        plan, mins = fetch.build_plan([lane, valid], stats)
        if plan[0] != ("none",):
            raise AssertionError(f"the fetch plans {plan[0]} for an int16 "
                                 f"lane; it moves as it is")
        same([fetch.pack_lanes([lane, valid], plan, mins, n)],
             [fetch.pack_lanes_plain([lane, valid], plan, mins, n)],
             f"K10 on {n} int16 rows")
    # the 2-byte variants beside the 4-byte ones at the full rows; each
    # 2-byte row's plain version, bound (each byte once) and library call
    n = rows
    lane16 = short(n)
    lane32 = lane16.to(torch.int32)
    keep = torch.rand(n, generator=gen, device=dev) < 0.6
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    for w, lane in ((2, lane16), (4, lane32)):
        times[f"K1_{w}B"] = cuda_ms(lambda: carry.compact_lanes(
            keep, [lane], [False]))
        times[f"K8_{w}B"] = cuda_ms(lambda: gather.gather_rows(perm, [lane]))
        times[f"K13_{w}B"] = cuda_ms(lambda: gather.scatter_rows(perm,
                                                                 [lane]))
        times[f"K10_{w}B"] = cuda_ms(lambda: fetch.pack_lanes(
            [lane], [("none",)], [0], n))
    idx = perm.to(torch.int64)
    info = {
        "K1": dict(plain_ms=cuda_ms(lambda: carry.compact_lanes_plain(
            keep, [lane16], [False]), reps=1),
            bound_ms=5 * n / HBM_BYTES_PER_S * 1e3,
            library_ms=cuda_ms(lambda: lane16[keep])),
        "K8": dict(plain_ms=cuda_ms(lambda: gather.gather_rows_plain(
            perm, [lane16]), reps=1),
            bound_ms=8 * n / HBM_BYTES_PER_S * 1e3,
            library_ms=cuda_ms(lambda: lane16.index_select(0, idx))),
        "K13": dict(plain_ms=cuda_ms(lambda: gather.scatter_rows_plain(
            perm, [lane16]), reps=1),
            bound_ms=8 * n / HBM_BYTES_PER_S * 1e3,
            library_ms=cuda_ms(lambda: torch.empty_like(lane16).index_copy_(
                0, idx, lane16))),
        "K10": dict(plain_ms=cuda_ms(lambda: fetch.pack_lanes_plain(
            [lane16], [("none",)], [0], n), reps=1),
            bound_ms=4 * n / HBM_BYTES_PER_S * 1e3, library_ms=None)}
    # K5 on q2's shapes: 100,000 unique build keys, the fact's probe keys
    n_b = DIM_ROWS
    bk = torch.randperm(n_b, generator=gen, device=dev)
    pk = torch.randint(0, 2 * n_b, (n,), generator=gen, device=dev)
    for w in (2, 4):
        dt = torch.int16 if w == 2 else torch.int32

        def cols(keys, m):
            cap = bucket_for(m)
            data = torch.zeros(cap, dtype=torch.int64, device=dev)
            data[:m] = keys
            live = torch.arange(cap, device=dev) < m
            pay = torch.zeros(cap, dtype=dt, device=dev)
            pay[:m] = short(m).to(dt)
            return [DeviceColumn(t.LONG, data, live),
                    DeviceColumn(t.SHORT if w == 2 else t.INT, pay, live)]
        bcols, pcols = cols(bk, n_b), cols(pk, n)
        if w == 2:
            _join_case(torch, jk, bucket_for, bcols, n_b, pcols, n,
                       f"with int16 payloads at {n} probe rows")
            cases += 1
            for m_b, m_p in ((1, 1), (2, 3), (3, 2)):
                _join_case(torch, jk, bucket_for, cols(bk[:m_b], m_b),
                           m_b, cols(pk[:m_p] % max(m_b, 1), m_p), m_p,
                           f"with int16 payloads, {m_b} x {m_p} rows")
                cases += 1
        order, lo, counts = jk.count_matches(bcols[:1], n_b, pcols[:1], n)
        plive = torch.arange(pcols[0].capacity, device=dev) < n
        ends, total = jk.expand_ends(counts, plive, "inner")
        total = int(total)
        args = (ends, lo, counts, order, total, bucket_for(total), pcols,
                bcols)
        times[f"K5_{w}B"] = cuda_ms(lambda: jk.expand_pairs(*args))
        if w == 2:
            out = jk.expand_pairs(*args)
            moved = sum(x.nbytes for x in (ends, lo, counts, order)) + sum(
                c.data.nbytes + c.validity.nbytes for c in pcols + bcols) + \
                out[0].nbytes + out[1].nbytes + sum(
                    c.data.nbytes + c.validity.nbytes
                    for c in list(out[2]) + list(out[3]))
            info["K5"] = dict(plain_ms=cuda_ms(
                lambda: jk.expand_pairs_plain(*args), reps=1),
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, library_ms=None)
    for v in info.values():
        v["rows"] = n
    return cases, times, info


K3_128_OPS = ["sum", "sum", "min", "max", "sum"]


def _k3_128_args(torch, dev, carry, gen, n, ngroups, global_agg=False):
    """The synthetic 128-bit K3 call's arguments over n rows in ngroups
    groups (two key words), drawn from ``gen``: a sum of DECIMAL(15,2)
    values over their materialised (lo, sign) pair, and the sum, min and
    max of DECIMAL(30,2) ones (high words non-zero, low words near 2^64
    so the adds carry), 10 % null, and a count.  Returns (positional
    arguments, values_hi)."""

    def values(n):
        lo15 = torch.randint(-10**13, 10**13, (n,), generator=gen,
                             device=dev)
        hi30 = torch.randint(-2**34, 2**34, (n,), generator=gen, device=dev)
        lo30 = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen,
                             device=dev)
        near = torch.rand(n, generator=gen, device=dev) < 0.3
        lo30 = torch.where(near, -torch.randint(1, 1000, (n,),
                                                generator=gen, device=dev),
                           lo30)       # 2^64 - x: every add carries
        valid = torch.rand(n, generator=gen, device=dev) < 0.9
        z = torch.zeros_like(lo15)
        return (torch.where(valid, lo15, z), torch.where(valid, lo15 >> 63,
                                                         z),
                torch.where(valid, lo30, z), torch.where(valid, hi30, z),
                valid)

    def args(n, ngroups, global_agg=False):
        lo15, hi15, lo30, hi30, valid = values(n)
        keys = torch.randint(0, ngroups, (n,), generator=gen, device=dev)
        words = [] if global_agg else [keys // 2, keys % 2]
        order = carry.sort_order(words) if words else None
        return (words, None, [lo15, lo30, lo30, lo30, None],
                [valid] * 5, global_agg, order, K3_128_OPS), \
            [hi15, hi30, hi30, hi30, None]

    return args(n, ngroups, global_agg)


def _k3_128_cases(torch, dev, agg_mod, carry, cuda_ms, rows):
    """K3's 128-bit sum and DECIMAL128 min/max against the plain version,
    exactly, on the planned path, the direct one and the records: at
    ``rows`` rows with q1d's 6 groups and with 100,000, DECIMAL(15,2)
    values (sign-extended high words) and DECIMAL(30,2) ones (high words
    non-zero, low words near 2^64 so the adds carry), 10 % null; and at
    edge shapes (no rows, one row, an all-null group, tile edges, wrap
    past 2^127).  Returns (cases, the times at ``rows`` rows and 6
    groups: planned, direct, records, plain, and the bound of that
    synthetic call), which the kernel line keeps beside q1d's own call
    (``_k3_call_row``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    k3 = agg_mod.segment_reduce_sorted
    cases = 0

    def check(a, b, what):
        nonlocal cases
        cases += 1
        if a[3] != b[3] or not torch.equal(a[0], b[0]):
            raise AssertionError(f"K3 128-bit groups differ {what}")
        for x, y, c, d in zip(a[1], b[1], a[2], b[2]):
            if not torch.equal(c, d):
                raise AssertionError(f"K3 128-bit counts differ {what}")
            if x is None:
                continue
            if not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])):
                raise AssertionError(f"K3 128-bit results differ {what}")

    def args(n, ngroups, global_agg=False):
        return _k3_128_args(torch, dev, carry, gen, n, ngroups, global_agg)

    row = None
    for n, ngroups in ((rows, 6), (rows, 100_000)):
        a, his = args(n, ngroups)
        want = agg_mod.segment_reduce_sorted_plain(*a, values_hi=his)
        for path in K3_PATHS:
            check(k3(*a, path=path, values_hi=his), want,
                  f"at {n} rows, {ngroups} groups, path={path}")
        if ngroups == 6:
            k3(*a, values_hi=his)
            planned = k3.last_plan      # None for the plain version
            row = dict(
                ms=cuda_ms(lambda: k3(*a, values_hi=his)),
                plain_ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
                    *a, values_hi=his), reps=1),
                # each input once: order, 2 key words, 4 lanes, 1 mask
                bound_ms=n * (4 + 16 + 32 + 1) / HBM_BYTES_PER_S * 1e3,
                path="plain" if planned is None else
                "record" if planned.packed else
                "run" if planned.run_path else "direct",
                direct_ms=cuda_ms(lambda: k3(*a, path="direct",
                                             values_hi=his)),
                record_ms=cuda_ms(lambda: k3(*a, path="record",
                                             values_hi=his)))
    # edge shapes
    for n, ngroups, glob in ((0, 1, False), (0, 1, True), (1, 1, False),
                             (1, 1, True), (2047, 3, False),
                             (2048, 1, False), (2049, 7, False),
                             (8191, 2, True), (8193, 40, False),
                             (65537, 1000, False)):
        a, his = args(n, ngroups, glob)
        want = agg_mod.segment_reduce_sorted_plain(*a, values_hi=his)
        for path in K3_PATHS:
            check(k3(*a, path=path, values_hi=his), want,
                  f"at {n} rows, {ngroups} groups, global={glob}, "
                  f"path={path}")
    # an all-null group and sums that wrap past 2^127
    n = 5000
    big = torch.full((n,), -1, dtype=torch.int64, device=dev)   # 2^64 - 1
    hi = torch.full((n,), 2**62, dtype=torch.int64, device=dev)
    keys = torch.arange(n, device=dev) % 3
    valid = keys != 1
    for path in K3_PATHS:
        a = ([keys], None, [big, big, big], [valid] * 3, False,
             carry.sort_order([keys]), ["sum", "min", "max"])
        check(k3(*a, path=path, values_hi=[hi, hi, hi]),
              agg_mod.segment_reduce_sorted_plain(
                  *a, values_hi=[hi, hi, hi]),
              f"wrapping sums and an all-null group, path={path}")
    return cases, row


def _k3_run_cases(torch, dev, agg_mod, carry):
    """K3 over orders of few runs, where the direct path takes the run
    path (tiles of input rows split by the runs), against the plain
    version exactly on each of ``K3_PATHS``: the planned path, the
    records, tiles of sorted rows, and the run path forced (whatever the
    inputs' size).  One op set
    holds a DECIMAL64 sum read through its signs (SIGN), a DECIMAL128 sum,
    min and max, an int64 sum, a float min and max (-0.0 beside 0.0, so
    the earliest row of a tie shows in the bits), an int64 min and a
    count.  Shapes: 1, 2, 6, 64 and 65 runs (65 is past the run path),
    runs that end inside tiles, carries out of the low word within and
    across tiles, ties across tiles, one group of 2^25 rows, 100,000
    groups, rows with no contributor, 0 rows and 1 row.  Returns the
    number of cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    k3 = agg_mod.segment_reduce_sorted
    ops = ["sum", "sum", "min", "max", "sum", "min", "max", "min", "sum"]
    cases = 0

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    def args(n, ngroups, ties=False, valid_frac=0.9):
        d64 = rand(n, -3, 3) if ties else rand(n, -10**13, 10**13)
        hi = rand(n, -1, 1) if ties else rand(n, -2**34, 2**34)
        lo = torch.where(rand(n, 0, 10) < 3, -rand(n, 1, 1000),
                         rand(n, -2**63, 2**63 - 1))   # 2^64 - x: carries
        if ties:
            lo = rand(n, -2, 2)
        f = torch.tensor([-0.0, 0.0, 1.0, -1.0], dtype=torch.float64,
                         device=dev)[rand(n, 0, 2 if ties else 4)]
        valid = torch.rand(n, generator=gen, device=dev) < valid_frac
        keys = rand(n, 0, ngroups)
        order = carry.sort_order([keys])
        return ([keys], None, [d64, lo, lo, lo, d64, f, f, d64, None],
                [valid] * 9, False, order, ops), \
            [agg_mod.SIGN, hi, hi, hi, None, None, None, None, None]

    def check(a, b, what):
        nonlocal cases
        cases += 1
        if a[3] != b[3] or not torch.equal(a[0], b[0]):
            raise AssertionError(f"K3 groups or first rows differ {what}")
        for k, (x, y) in enumerate(zip(a[1], b[1])):
            if not torch.equal(a[2][k], b[2][k]):
                raise AssertionError(f"K3 counts of op {k} differ {what}")
            for u, w in ([] if x is None else zip(x, y)
                         if isinstance(x, tuple) else [(x, y)]):
                if u.dtype == torch.float64:
                    u, w = u.view(torch.int64), w.view(torch.int64)
                if not torch.equal(u, w):
                    raise AssertionError(f"K3 op {k} differs {what}")

    shapes = [(300_000, g, False, 0.9) for g in (1, 2, 6, 64, 65)] + [
        (10_007, 3, False, 0.9),        # runs that end inside tiles
        (1 << 20, 1, False, 1.0),       # carries within and across tiles
        (1 << 20, 3, True, 0.9),        # ties across tiles
        (1 << 25, 1, False, 0.9),       # one group of 2^25 rows
        (1 << 22, 100_000, False, 0.9),
        (100_000, 4, False, 0.0),       # no contributor
        (0, 1, False, 0.9), (1, 1, False, 0.9)]
    for n, ngroups, ties, frac in shapes:
        a, his = args(n, ngroups, ties, frac)
        want = agg_mod.segment_reduce_sorted_plain(*a, values_hi=his)
        for path in K3_PATHS:
            got = k3(*a, path=path, values_hi=his)
            check(got, want, f"at {n} rows, {ngroups} groups, ties={ties}, "
                             f"path={path}")
            if path == "run" and n > 1 and ngroups <= 64 \
                    and not k3.last_plan.run_path:
                raise AssertionError(f"K3 did not take the run path over "
                                     f"{n} rows in {ngroups} runs")
        del a, his, want
    # the positional kinds (first, last) where each group spans two of the
    # order's runs: the order sorts by (key, a flag), as the canonical
    # merge's sorts by buffer words after the key, so along a group the
    # input rows rise, fall back, and rise again; and beside every kind
    # of the run path's op set.  Each over its column's validity, over a
    # mask of every row, over every row with no mask (derived from the
    # groups' bounds: first_any, last_any, count(*)), and over a mask
    # that leaves out every row of a third of the groups; groups that
    # span tiles (6 and 32 groups) and one-row groups; rows before the
    # first start (live flags off for the first sorted rows); and the
    # ungrouped aggregate.  Each shape again without the value ops: no set
    # reads a value lane, so tiles of sorted rows take the light fold.
    pos_ops = ["first", "last", "first", "last", "sum", "min", "sum",
               "first", "last", "sum", "first", "last"]
    for n, ngroups, frac, live_rows, glob in (
            (300_000, 6, 0.5, 0, False), (1 << 22, 32, 0.05, 0, False),
            (10_007, 3, 0.9, 0, False), (100_000, 4, 0.0, 0, False),
            (100_000, 100_000, 0.5, 0, False), (300_000, 6, 0.5, 9, False),
            (300_000, 1, 0.5, 0, True), (1, 1, 1.0, 0, False),
            (2049, 2, 0.3, 0, False), (4097, 3, 0.3, 5, False)):
        keys = rand(n, 0, ngroups)
        flag = rand(n, 0, 2)
        words = [] if glob else [keys, flag]
        order = carry.sort_order(words) if words else None
        valid = torch.rand(n, generator=gen, device=dev) < frac
        every = torch.ones(n, dtype=torch.bool, device=dev)
        holes = valid & (keys % 3 != 0)
        live = None
        if live_rows:
            live = torch.ones(n, dtype=torch.bool, device=dev)
            live[order[:live_rows].long()] = False
        d64 = rand(n, -10**13, 10**13)
        a = ([] if glob else [keys], live,
             [None, None, None, None, d64, d64, None, None, None, None,
              None, None],
             [valid, valid, every, every, valid, valid, valid, None, None,
              None, holes, holes], glob, order, pos_ops)
        light = [k for k, v in enumerate(a[2]) if v is None]
        for b in (a, (a[0], a[1], [a[2][k] for k in light],
                      [a[3][k] for k in light], glob, order,
                      [pos_ops[k] for k in light])):
            want = agg_mod.segment_reduce_sorted_plain(*b)
            for path in K3_PATHS:
                got = k3(*b, path=path)
                check(got, want, f"(first/last) at {n} rows, {ngroups} "
                                 f"groups over {2 * ngroups} runs, live off "
                                 f"for {live_rows}, global={glob}, "
                                 f"{len(b[6])} ops, path={path}")
                if path == "run" and not glob and 1 < n and ngroups <= 32 \
                        and not k3.last_plan.run_path:
                    raise AssertionError(f"K3 did not take the run path "
                                         f"over {n} rows in {2 * ngroups} "
                                         f"runs")
            del want
        del a, b
    return cases


def _k3_call_row(torch, agg_mod, cap, cuda_ms, what):
    """Every K3 call a path made (captured by ``cap``), run again through
    the kernel and its plain version on the same inputs and compared
    exactly: groups, first rows, counts, and every result word (a 128-bit
    op's low and high words, a float viewed as int64).  Returns the
    kernel line's row for the first call: its time, the plain version's,
    and its bound, the bytes the call must move once: the order, each key
    word that varies (all of them where the call passes no ``varying``
    hint: K2's histogram tells K3 which words it may skip), the live
    flags, each distinct value lane and contributor mask, and each
    group's first row, results and counts."""
    orig = cap.orig["segment_reduce_sorted"]
    plain = agg_mod.segment_reduce_sorted_plain
    row = None
    for (_, args), kw in zip(cap.calls, cap.kwargs):
        got, want = orig(*args, **kw), plain(*args, **kw)
        if got[3] != want[3] or not torch.equal(got[0], want[0]):
            raise AssertionError(f"K3 groups or first rows differ at {what}")
        for s, sp, c, cp in zip(got[1], want[1], got[2], want[2]):
            if not torch.equal(c, cp):
                raise AssertionError(f"K3 counts differ at {what}")
            for x, y in ([] if s is None else zip(s, sp)
                         if isinstance(s, tuple) else [(s, sp)]):
                if x.dtype == torch.float64:
                    x, y = x.view(torch.int64), y.view(torch.int64)
                if not torch.equal(x, y):
                    raise AssertionError(f"K3 results differ at {what}")
        if row is not None:
            continue
        words, live, values, contribs, _, order, ops = args[:7]
        varying = kw.get("varying")
        if varying is None or len(varying) != len(words):
            varying = [True] * len(words)
        his = kw.get("values_hi") or [None] * len(values)
        lanes = {agg_mod._storage(x): x.nbytes
                 for x in [*values, *his]
                 if x is not None and x is not agg_mod.SIGN}
        masks = {agg_mod._storage(c): c.nbytes for c in contribs
                 if c is not None}
        # a positional op writes its int32 pick, another its value
        per_group = 4 + sum(
            8 + (4 if op in ("first", "last") else 8 * (v is not None))
            + 8 * (h is not None) for v, h, op in zip(
                values, his, ops or ["sum"] * len(values)))
        moved = (0 if order is None else order.nbytes) + \
            sum(w.nbytes for w, f in zip(words, varying) if f) + \
            (0 if live is None else live.nbytes) + \
            sum(lanes.values()) + sum(masks.values()) + got[3] * per_group
        n = _k3_rows(args)
        plan = orig.last_plan
        row = dict(ms=cuda_ms(lambda: orig(*args, **kw)),
                   plain_ms=cuda_ms(lambda: plain(*args, **kw), reps=1),
                   bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                   extra=dict(rows=n, groups=got[3], key_words=len(words),
                              varying_words=sum(map(bool, varying)),
                              ops=list(ops), lanes=len(lanes),
                              ops_128=sum(h is not None for h in his),
                              bytes_a_row=round(moved / max(n, 1), 2),
                              path=_k3_path_name(plan),
                              traffic_bytes_a_row=round(
                                  _k3_traffic(plan) / max(n, 1), 2)))
        del got, want
    if row is None:
        raise AssertionError(f"{what} made no K3 call to capture")
    return row


# ---------------------------------------------------------------------------
# dates, bitwise and the small leaves: K22, qd1 and qd2
# ---------------------------------------------------------------------------

QD2_ROWS = 1 << 22            # qd2, every rule of the slice at once
K22_SIZES = (1, 3, 4, 5, 1023, 1025, 1 << 20)
K22_DAYS = (-2**31, -2**31 + 1, 2**31 - 1, 2**31 - 2, -2_000_000_001,
            2_000_000_001, -1, 0, 1, -719_162, 2_932_896, -25_508, -25_509,
            10_956, 47_540, 47_541, -865_565, -1_011_662, -719_468,
            -865_564, -719_469)      # 0001-01-01, 9999-12-31, 1900-02-28/
#                                      03-01, 2000-02-29, 2100-02-28/03-01,
#                                      the floor of Hinnant's era
K22_MICROS = (-1, 0, 1, -86_400_000_000, -86_400_000_001,
              86_400_000_000 - 1, -2**63, 2**63 - 1, -3_600_000_000,
              3_599_999_999, -60_000_001)


def _k22_lanes(torch, dev, n, seed):
    """(days int32, micros int64, months int32) on the card: uniform over
    the whole int32 range, over 0001-01-01..9999-12-31, and the trouble
    spots; months mostly small, with +-(2^31 - 1)."""
    rng = np.random.default_rng(seed)
    days = np.where(rng.random(n) < 0.5,
                    rng.integers(-2**31, 2**31, n, dtype=np.int64),
                    rng.integers(-719_162, 2_932_897, n)).astype(np.int32)
    micros = np.where(rng.random(n) < 0.5,
                      rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                      rng.integers(-2**55, 2**55, n, dtype=np.int64))
    months = np.where(rng.random(n) < 0.8, rng.integers(-40, 41, n),
                      rng.integers(-2**31 + 1, 2**31, n)).astype(np.int32)
    k = min(n, len(K22_DAYS))
    days[:k] = K22_DAYS[:k]
    micros[:min(n, len(K22_MICROS))] = K22_MICROS[:min(n, len(K22_MICROS))]
    months[:min(n, 2)] = [2**31 - 1, -(2**31 - 1)][:min(n, 2)]
    return (torch.from_numpy(days).to(dev), torch.from_numpy(micros).to(dev),
            torch.from_numpy(months).to(dev))


def _k22_cases(torch, dev, dates):
    """Every field code of K22 against ``date_fields_plain``, bit for bit,
    over days and timestamps with the calendar's trouble spots, at row
    counts 1, 3, 4, 5, 1023, 1025 and 2^20, from lanes 0-3 rows off their
    16-byte alignment (the months at another offset than the days), with
    the months as a column (+-(2^31 - 1) among them) and as a literal.
    Returns the number of checks."""
    checks = 0
    for n in K22_SIZES:
        days, micros, months = _k22_lanes(torch, dev, n + 4, SEED + n)
        for shift in ((0, 1, 2, 3) if n < (1 << 20) else (0, 3)):
            d = days[shift:shift + n]
            t = micros[shift % 2:shift % 2 + n]
            k = months[(shift + 1) % 4:(shift + 1) % 4 + n]
            for field in dates.FIELDS:
                calls = []
                if field != "add_months":
                    calls.append((t, "timestamp", field, None))
                if field not in ("hour", "minute", "second"):
                    calls.append((d, "date", field, None))
                if field == "add_months":
                    calls = [(d, "date", field, k), (d, "date", field, -13),
                             (d, "date", field, 2**31 - 1)]
                for lane, kind, f, arg in calls:
                    got = dates.date_fields(lane, kind, f, arg)
                    want = dates.date_fields_plain(lane, kind, f, arg)
                    if not torch.equal(got, want):
                        bad = int((got != want).nonzero()[0, 0])
                        raise AssertionError(
                            f"K22 {f} of a {kind} lane differs from its "
                            f"plain version ({n} rows, {shift} off "
                            f"alignment): row {bad}, lane "
                            f"{int(lane[bad])}, kernel {int(got[bad])}, "
                            f"plain {int(want[bad])}")
                    checks += 1
    torch.cuda.synchronize()
    return checks


def _k22_null_cases(torch, dev, DeviceBatch, DeviceColumn, EvalContext,
                    move_batch, t, dte, lit):
    """Each date expression over columns with nulls (and months of
    +-(2^31 - 1), null months) on the card against the same expression on
    the CPU engine: the data and the validity.  Returns the count."""
    from spark_rapids_tpu_torch.expr.core import BoundReference as B
    rng = np.random.default_rng(SEED + 23)
    n = 4099
    days, micros, months = (x.cpu() for x in _k22_lanes(torch, "cpu", n,
                                                        SEED + 24))
    cols = []
    for data, dt in ((days, t.DATE), (micros, t.TIMESTAMP), (months, t.INT)):
        valid = torch.from_numpy(rng.random(n) >= 0.1)
        cols.append(DeviceColumn(dt, torch.where(valid, data,
                                                 torch.zeros_like(data)),
                                 valid))
    host = DeviceBatch(cols, n, ["d", "t", "k"])
    card = move_batch(host, dev)
    d, ts, k = B(0, t.DATE), B(1, t.TIMESTAMP), B(2, t.INT)
    exprs = [cls(c) for cls in (dte.Year, dte.Month, dte.DayOfMonth,
                                dte.Quarter, dte.DayOfWeek, dte.WeekDay,
                                dte.DayOfYear, dte.LastDay)
             for c in (d, ts)]
    exprs += [cls(c) for cls in (dte.Hour, dte.Minute, dte.Second)
              for c in (d, ts)]
    exprs += [dte.AddMonths(d, k), dte.AddMonths(ts, k),
              dte.AddMonths(d, lit(-1).expr)]
    exprs += [dte.TruncDate(c, f) for c in (d, ts)
              for f in ("year", "month", "quarter", "week")]
    for e in exprs:
        a = e.eval(EvalContext(card)).col
        b = e.eval(EvalContext(host)).col
        if not (torch.equal(a.data.cpu(), b.data) and
                torch.equal(a.validity.cpu(), b.validity)):
            raise AssertionError(f"{e.sql()} on the card differs from the "
                                 f"CPU engine")
    return len(exprs)


def _qd_oracle(raw):
    """qd1's rows from numpy: per ship year, the exact sum of
    l_extendedprice * (1 - l_discount) at scale 4 (int64 at 2^25 rows)
    and the count."""
    import decimal
    D = decimal.Decimal
    years = raw["ship"].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    revenue = raw["price"] * (100 - raw["disc"])
    rows = []
    for y in np.unique(years):
        m = years == y
        rows.append(dict(l_year=int(y),
                         revenue=D(int(revenue[m].sum())).scaleb(-4),
                         n=int(m.sum())))
    return rows


def _qd1_df(session, table, parts, F, col, lit):
    """TPC-H Q9's year grouping over lineitem alone.  The casts hold the
    values (prices below 10^6, discounts below 1) and keep the product
    within 18 digits (DECIMAL(17,4)), where both packages' rules place it
    on the device; Q9's DECIMAL(15,2) product, DECIMAL(32,4), stays on
    the CPU engine in both."""
    import decimal
    price = col("l_extendedprice").cast("decimal(12,2)")
    disc = col("l_discount").cast("decimal(3,2)")
    return (session.create_dataframe(table, num_partitions=parts)
            .group_by(F.year(col("l_shipdate")).alias("l_year"))
            .agg(F.sum(price * (lit(decimal.Decimal(1)) - disc))
                 .alias("revenue"), F.count("*").alias("n"))
            .sort(col("l_year")))


def _qd2_table(n, seed=SEED):
    """qd2's columns: d DATE over 0001-01-01..9999-12-31, t TIMESTAMP of
    +-2^55 microseconds (years 828-3111, before 1970 too), w TIMESTAMP
    over 30 days of 2024 (the window's), b, h, i, l BYTE, SHORT, INT,
    LONG with negatives, s shift distances 0-200, k months (-40..40 and
    +-(2^31 - 1)), x, y DOUBLE with NaN, -0.0 and +-inf, m DECIMAL(9,2);
    5 % null each."""
    rng = np.random.default_rng(seed + 31)

    def mask():
        return rng.random(n) < 0.05
    x = rng.normal(0, 100, n)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])
    pick = rng.random(n) < 0.2
    x[pick] = specials[rng.integers(0, 5, int(pick.sum()))]
    k = rng.integers(-40, 41, n)
    k[rng.random(n) < 0.01] = 2**31 - 1
    k[rng.random(n) < 0.01] = -(2**31 - 1)
    w0 = 19_723 * 86_400_000_000            # 2024-01-01
    cols = {
        "d": pa.array(rng.integers(-719_162, 2_932_897, n).astype(np.int32),
                      pa.date32(), mask=mask()),
        "t": pa.array(rng.integers(-2**55, 2**55, n, dtype=np.int64),
                      pa.timestamp("us", tz="UTC"), mask=mask()),
        "w": pa.array(w0 + rng.integers(0, 30 * 86_400_000_000, n,
                                        dtype=np.int64),
                      pa.timestamp("us", tz="UTC")),
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                      mask=mask()),
        "h": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16),
                      mask=mask()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=mask()),
        "l": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                      mask=mask()),
        "s": pa.array(rng.integers(0, 201, n).astype(np.int32), mask=mask()),
        "k": pa.array(k.astype(np.int32), mask=mask()),
        "x": pa.array(x, mask=mask()),
        "y": pa.array(rng.normal(0, 1, n), mask=mask()),
        "m": _decimal_array(rng.integers(-10**9 + 1, 10**9, n),
                            np.zeros(n, np.int64), 9, 2, ~mask())}
    return pa.table(cols)


def _qd2_columns(F, col, lit, Column, t, dte, bw, mt, mx, Param):
    """Every rule of the slice that runs on the device, over _qd2_table
    (DateFormatClass, DateAddInterval and InputFileName stay on the CPU
    engine by their rules)."""
    import datetime

    def node(cls, *args):
        return Column(cls(*[a.expr if isinstance(a, Column) else a
                            for a in args]))
    d, ts, b, h, i, l, s, k, x, y, m = (col(c) for c in "dtbhilskxym")
    cols = {f"{c.__name__}_{n}": node(c, v) for c in (
        dte.Year, dte.Month, dte.DayOfMonth, dte.Quarter, dte.DayOfWeek,
        dte.WeekDay, dte.DayOfYear, dte.LastDay) for n, v in (("d", d),
                                                              ("t", ts))}
    cols.update({f"{c.__name__}": node(c, ts) for c in (
        dte.Hour, dte.Minute, dte.Second)})
    cols.update({f"trunc_{f}": node(dte.TruncDate, d, f) for f in (
        "year", "month", "quarter", "week")})
    cols.update(
        add_months=node(dte.AddMonths, d, k),
        add_months_1=node(dte.AddMonths, d, lit(1)),
        date_add=node(dte.DateAdd, d, lit(30)),
        date_sub=node(dte.DateSub, d, i),
        date_diff=node(dte.DateDiff, d, lit(datetime.date(2000, 1, 1))),
        to_unix=node(dte.ToUnixTimestamp, ts),
        unix_d=node(dte.UnixTimestamp, d),
        from_unix=node(dte.FromUnixTime, i),
        time_add=node(dte.TimeAdd, ts, 90_061_000_001),
        precise=node(mt.PreciseTimestampConversion, ts, t.TIMESTAMP, t.LONG),
        and_bh=F.bitwise_and(b, h), or_il=F.bitwise_or(i, l),
        xor_hi=F.bitwise_xor(h, i), not_l=F.bitwise_not(l),
        not_b=F.bitwise_not(b))
    for name, v in (("b", b), ("h", h), ("i", i), ("l", l)):
        cols[f"shl_{name}"] = F.shiftleft(v, s)
        cols[f"shr_{name}"] = F.shiftright(v, s)
        cols[f"shru_{name}"] = F.shiftrightunsigned(v, s)
    cols.update(
        nanvl=node(mt.NaNvl, x, y),
        inset=node(mt.InSet, b, (1, 2, -3, None)),
        atleast=node(mt.AtLeastNNonNulls, 2, [x.expr, y.expr, d.expr]),
        known=node(mt.KnownNotNull, l),
        normalized=node(mt.KnownFloatingPointNormalized,
                        node(mx.NormalizeNaNAndZero, x)),
        normalize=node(mx.NormalizeNaNAndZero, x),
        unscaled=node(mt.UnscaledValue, m),
        block_start=Column(mt.InputFileBlockStart()),
        block_length=Column(mt.InputFileBlockLength()),
        param=l + Column(Param(0, t.LONG, 7)),
        rand=F.rand(42), pid=F.spark_partition_id())
    return [c.alias(n) for n, c in cols.items()]


def _date_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                 bound, path_run, li_table, li_raw):
    """K22 on edge cases and at qd1's call; qd1 over 1 and 4 partitions
    against numpy; qd2, every device rule of the slice at 2^22 rows,
    against the CPU placement."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import Column, col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        DeviceColumn,
                                                        move_batch)
    from spark_rapids_tpu_torch.expr import bitwise as bw
    from spark_rapids_tpu_torch.expr import datetime_expr as dte
    from spark_rapids_tpu_torch.expr import mathexpr as mx
    from spark_rapids_tpu_torch.expr import misc_tail as mt
    from spark_rapids_tpu_torch.expr.core import EvalContext
    from spark_rapids_tpu_torch.expr.params import ParamLiteral
    from spark_rapids_tpu_torch.ops import dates
    t_dates = time.perf_counter()

    def check_calls(cap, what):
        """Every K22 call of a run again through the kernel and its plain
        version, bit for bit."""
        for _, args in cap.calls:
            if not torch.equal(cap.orig["date_fields"](*args),
                               dates.date_fields_plain(*args)):
                raise AssertionError(f"K22 {args[2]} differs from its "
                                     f"plain version at {what}")
        if not cap.calls:
            raise AssertionError(f"{what} made no K22 call")
        return len(cap.calls)

    try:
        t1 = time.perf_counter()
        n_cases = _k22_cases(torch, dev, dates)
        n_nulls = _k22_null_cases(torch, dev, DeviceBatch, DeviceColumn,
                                  EvalContext, move_batch, t, dte, lit)
        print(f"K22 edge cases: {n_cases} calls equal date_fields_plain bit "
              f"for bit ({len(dates.FIELDS)} field codes; {K22_SIZES} rows; "
              f"0-3 rows off alignment; int32 extremes, 0001-01-01, "
              f"9999-12-31, 1900/2000/2100 leap rules, -1 us; months "
              f"+-(2^31 - 1) as a column and a literal); {n_nulls} date "
              f"expressions over nulls equal the CPU engine; "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("K22 edge cases")
        traceback.print_exc()

    try:
        ship = torch.from_numpy(li_raw["ship"]).to(dev)
        n = int(ship.shape[0])
        if not torch.equal(dates.date_fields(ship, "date", "year"),
                           dates.date_fields_plain(ship, "date", "year")):
            raise AssertionError("K22 year differs at qd1's call")
        moved = 8 * n
        kernel_rows["date_fields"] = dict(
            source="spark_rapids_tpu_torch/csrc/date_fields.cu",
            replaces="spark_rapids_tpu/expr/datetime_expr.py:84",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: dates.date_fields(ship, "date", "year")),
            plain_ms=cuda_ms(lambda: dates.date_fields_plain(
                ship, "date", "year"), reps=2),
            bound_ms=bound(moved), library_ms=None,
            extra=dict(rows=n, field="year", bytes_moved=moved))
        r = kernel_rows["date_fields"]
        for field, kind, lane, arg in (
                ("month", "date", ship, None),
                ("add_months", "date", ship, -13),
                ("hour", "timestamp", ship.to(torch.int64) * 86_400_000_007,
                 None)):
            r["extra"][f"{field}_ms"] = cuda_ms(
                lambda: dates.date_fields(lane, kind, field, arg))
        print(f"K22 at qd1's call (year of {n} DATE rows): "
              f"{r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({moved} "
              f"bytes), plain {r['plain_ms']:.3f} ms, library none; month "
              f"{r['extra']['month_ms']:.3f}, add_months "
              f"{r['extra']['add_months_ms']:.3f}, hour of a timestamp lane "
              f"{r['extra']['hour_ms']:.3f} ms; {card}")
        del ship
    except Exception:
        failures.append("K22 at qd1's call")
        traceback.print_exc()

    try:
        t1 = time.perf_counter()
        want = _qd_oracle(li_raw)
        print(f"qd1 numpy oracle: {len(want)} years, "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            sd = GpuSession()
            dfd = _qd1_df(sd, li_table, parts, F, col, lit)
            what = f"qd1 over {parts} partition(s)"
            path_run("qd1" if parts == 1 else "qd1_4", dfd.collect,
                     lambda got, w: _check_rows(got, want, w), what)
            with _Capture(dates, "date_fields") as cap:
                dfd.collect()
            calls = check_calls(cap, what)
            nodes = _placements(sd.last_plan)
            if nodes[0] != ("DeviceToHostExec", "cpu") or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sd.last_explain:
                raise AssertionError(f"{what} placed {nodes}:\n"
                                     f"{sd.last_explain}")
            print(f"{what}: {calls} K22 call(s) equal the plain version; "
                  f"placements {nodes}")
    except Exception:
        failures.append("qd1")
        traceback.print_exc()

    try:
        t1 = time.perf_counter()
        table = _qd2_table(QD2_ROWS)
        cols = _qd2_columns(F, col, lit, Column, t, dte, bw, mt, mx,
                            ParamLiteral)
        cpu = GpuSession(conf={"spark.rapids.sql.enabled": False})
        gpu = GpuSession()
        print(f"qd2 table of {QD2_ROWS} rows, {len(cols)} columns: "
              f"{time.perf_counter() - t1:.1f} s")

        def avg_l(df):
            return F.scalar_subquery(df.agg(F.avg(col("l")).alias("a")))
        queries = {
            "qd2": lambda s: s.create_dataframe(
                table, num_partitions=4).select(*cols),
            "qd2_window": lambda s: s.create_dataframe(
                table, num_partitions=4).group_by(
                F.window(col("w"), "1 hour").alias("win")).agg(
                F.count("*").alias("c"), F.sum(col("i")).alias("si")).select(
                col("win").getField("start").alias("start"),
                col("win").getField("end").alias("end"), col("c"),
                col("si")),
            "qd2_subquery": lambda s: (lambda df: df.filter(
                col("l") > avg_l(df)).group_by(
                F.year(col("d")).alias("y")).agg(
                F.count("*").alias("c"), F.max(col("l")).alias("ml")))(
                s.create_dataframe(table, num_partitions=4))}
        for run, q in queries.items():
            t1 = time.perf_counter()
            want = q(cpu).collect()
            cpu_s = time.perf_counter() - t1
            if any(p != "cpu" for _, p in _placements(cpu.last_plan)):
                raise AssertionError(f"{run}: the CPU placement put an "
                                     f"operator on the GPU")
            if run != "qd2":
                want = want.sort_by([(want.column_names[0], "ascending")])

            def check(got, w, want=want, run=run):
                if run != "qd2":
                    got = got.sort_by([(got.column_names[0], "ascending")])
                bad, _ = _same_catalogue(got, want, 0.0)
                if bad:
                    raise AssertionError(f"{w}: {bad} differ from the CPU "
                                         f"placement")
            path_run(run, q(gpu).collect, check,
                     f"{run} ({QD2_ROWS} rows, 4 partitions) against the "
                     f"CPU placement ({cpu_s:.1f} s)", reps=1)
            nodes = _placements(gpu.last_plan)
            if any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in gpu.last_explain:
                raise AssertionError(f"{run} placed {nodes}:\n"
                                     f"{gpu.last_explain}")
            if run == "qd2":
                with _Capture(dates, "date_fields") as cap:
                    q(gpu).collect()
                print(f"qd2: {check_calls(cap, run)} K22 calls equal the "
                      f"plain version; {len(nodes)} operators on the GPU")
        del table
    except Exception:
        failures.append("qd2")
        traceback.print_exc()
    # give the allocator's cached blocks back: the text phases' plain
    # versions take 12 GiB in one piece over qt1's comments
    torch.cuda.empty_cache()
    print(f"date phases: {time.perf_counter() - t_dates:.1f} s")


# ---------------------------------------------------------------------------
# the aggregates: K3's positional kinds, K23 frame_pick, qg1-qg4
# ---------------------------------------------------------------------------

QG1_ROWS = 1 << 25            # inventory rows
QG1_WAREHOUSES = 10           # TPC-DS SF10's warehouses
QG1_ITEMS = 51_000            # half of SF10's 102,000 items stocked
QG1_NULLS = 0.05              # inv_quantity_on_hand nulls
QG2_PARTS = 4                 # qg2's partitions: no customer crosses one
QG2_NULLS = 0.10              # o_totalprice nulled
PRIORITIES = (b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
              b"5-LOW")       # TPC-H's o_orderpriority
QG4_NULLS = 0.10              # rows of q4's f nulled for the picked column
QG4_RANGE = 10_000            # RANGE BETWEEN 10,000 PRECEDING AND FOLLOWING


def _qg1_table(n, seed=SEED):
    """TPC-DS inventory at SF10's shape joined to its date's month: 10
    warehouses, 51,000 stocked items, months 1-12, quantity on hand INT
    0-1000 with 5 % nulls.  Returns (table, raw numpy columns)."""
    rng = np.random.default_rng(seed + 24)
    raw = dict(w=rng.integers(1, QG1_WAREHOUSES + 1, n).astype(np.int32),
               i=rng.integers(1, QG1_ITEMS + 1, n).astype(np.int32),
               m=rng.integers(1, 13, n).astype(np.int32),
               q=rng.integers(0, 1001, n).astype(np.int32),
               valid=rng.random(n) >= QG1_NULLS)
    table = pa.table({
        "inv_warehouse_sk": pa.array(raw["w"]),
        "inv_item_sk": pa.array(raw["i"]),
        "d_moy": pa.array(raw["m"]),
        "inv_quantity_on_hand": pa.array(raw["q"], mask=~raw["valid"])})
    return table, raw


def _qg1_df(session, table, parts, F, col, lit):
    """TPC-DS Q39's inner aggregate: the moments of the quantity on hand
    by (warehouse, item, month), then HAVING stddev / mean > 1."""
    return (session.create_dataframe(table, num_partitions=parts)
            .group_by(col("inv_warehouse_sk"), col("inv_item_sk"),
                      col("d_moy"))
            .agg(F.stddev_samp(col("inv_quantity_on_hand")).alias("sd"),
                 F.avg(col("inv_quantity_on_hand")).alias("mean"),
                 F.var_samp(col("inv_quantity_on_hand")).alias("vs"),
                 F.var_pop(col("inv_quantity_on_hand")).alias("vp"),
                 F.stddev_pop(col("inv_quantity_on_hand")).alias("sp"),
                 F.count(col("inv_quantity_on_hand")).alias("n"))
            .filter(col("sd") / col("mean") > lit(1.0)))


def _qg1_oracle(raw):
    """Per group (count, sum, sum of squares) by numpy, exact in float64
    (integers below 2^53), and the same formulas: M2 = sumsq - sum^2 / n
    clamped at 0.  Returns (key, n, the five results, cov)."""
    key = ((raw["w"].astype(np.int64) - 1) * QG1_ITEMS
           + raw["i"] - 1) * 12 + raw["m"] - 1
    size = QG1_WAREHOUSES * QG1_ITEMS * 12
    uniq = np.flatnonzero(np.bincount(key, minlength=size))
    q = np.where(raw["valid"], raw["q"], 0).astype(np.float64)
    cnt = np.bincount(key, weights=raw["valid"].astype(np.float64),
                      minlength=size)[uniq]
    s = np.bincount(key, weights=q, minlength=size)[uniq]
    ss = np.bincount(key, weights=q * q, minlength=size)[uniq]
    with np.errstate(divide="ignore", invalid="ignore"):
        m2 = np.maximum(ss - np.where(cnt > 0, s * s / np.maximum(cnt, 1), 0),
                        0.0)
        vs = np.where(cnt > 1, m2 / np.maximum(cnt - 1, 1), np.nan)
        vp = np.where(cnt > 0, m2 / np.maximum(cnt, 1), np.nan)
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
        cov = np.sqrt(vs) / mean
    return dict(key=uniq, n=cnt.astype(np.int64), sd=np.sqrt(vs), mean=mean,
                vs=vs, vp=vp, sp=np.sqrt(vp), cov=cov, ss=ss)


def _check_qg1(got, want, what):
    """The groups with stddev / mean > 1, their counts exactly and their
    moments to a relative 1e-9: a moment is a difference of sums, so a
    group's tolerance also allows 1e-12 of its sum of squares.  A group
    whose ratio lies within 1e-9 of 1 may fall either side."""
    key = ((got["inv_warehouse_sk"].to_numpy().astype(np.int64) - 1)
           * QG1_ITEMS + got["inv_item_sk"].to_numpy() - 1) * 12 + \
        got["d_moy"].to_numpy() - 1
    o = np.argsort(key)
    key = key[o]
    with np.errstate(invalid="ignore"):
        keep = want["cov"] > 1.0
        near = np.abs(want["cov"] - 1.0) <= 1e-9
    at = np.searchsorted(want["key"], key)
    if len(key) and (at.max() >= len(want["key"])
                     or not np.array_equal(want["key"][at], key)):
        raise AssertionError(f"{what}: a group the data does not hold")
    if np.any(~keep[at] & ~near[at]) or \
            np.count_nonzero(keep & ~near) != np.count_nonzero(
                keep[at] & ~near[at]):
        raise AssertionError(f"{what}: HAVING kept other groups "
                             f"({len(key)} against {int(keep.sum())})")
    if not np.array_equal(got["n"].to_numpy()[o], want["n"][at]):
        raise AssertionError(f"{what}: counts differ")
    for name in ("sd", "mean", "vs", "vp", "sp"):
        g = got[name].to_numpy(zero_copy_only=False)[o].astype(np.float64)
        w = want[name][at]
        slack = 1e-9 * np.abs(w) + 1e-12 * want["ss"][at]
        if np.any(np.isnan(g) != np.isnan(w)) or \
                np.any(np.abs(np.nan_to_num(g) - np.nan_to_num(w)) > slack):
            raise AssertionError(f"{what}: {name} differs")
    return len(key)


def _qg2_table(seed=SEED, parts=QG2_PARTS):
    """qa's TPC-H SF5 orders as a flat table (o_orderkey, o_custkey,
    o_orderdate and o_totalprice in qa's ranges; o_orderpriority, TPC-H's
    five strings; 10 % of o_totalprice null), stored by customer, each
    customer's orders in orderkey order; a customer whose orders cross a
    boundary of ``parts`` partitions takes a new key for those past it,
    so no group's partials meet in a merge and each group's first, last
    and list follow the rows' order.  Returns (table, raw columns in
    table order)."""
    n, customers = NESTED_ORDERS, NESTED_CUSTOMERS
    rng = np.random.default_rng(seed + 25)
    keys = np.arange(n, dtype=np.int64)
    cust = rng.integers(1, customers + 1, n)
    date = rng.integers(8035, 10441, n).astype(np.int32)
    price = np.round(rng.random(n) * 5e5, 2)
    pvalid = rng.random(n) >= QG2_NULLS
    prio = rng.integers(0, len(PRIORITIES), n)
    o = np.argsort(cust, kind="stable")
    raw = dict(key=((keys // 8) * 32 + keys % 8 + 1)[o], cust=cust[o].copy(),
               date=date[o], price=price[o], pvalid=pvalid[o], prio=prio[o])
    per = -(-n // parts)
    spans = []
    for j in range(1, parts):
        b = j * per
        if b < n and raw["cust"][b] == raw["cust"][b - 1]:
            spans.append((b, int(np.searchsorted(raw["cust"], raw["cust"][b],
                                                 side="right")), j))
    for b, end, j in spans:
        raw["cust"][b:end] = customers + j
    table = pa.table({
        "o_orderkey": pa.array(raw["key"]),
        "o_custkey": pa.array(raw["cust"]),
        "o_orderdate": pa.array(raw["date"]).cast(pa.date32()),
        "o_totalprice": pa.array(raw["price"], mask=~raw["pvalid"]),
        "o_orderpriority": _pick_bytes(raw["prio"], PRIORITIES,
                                       large=False)})
    return table, raw


def _qg2_df(session, table, parts, F, col):
    """The latest and the history per customer."""
    return (session.create_dataframe(table, num_partitions=parts)
            .group_by(col("o_custkey"))
            .agg(F.first(col("o_orderdate")).alias("first_date"),
                 F.last(col("o_totalprice"), True).alias("last_price"),
                 F.collect_list(col("o_orderkey")).alias("orders"),
                 F.collect_set(col("o_orderpriority")).alias("priorities"),
                 F.count("*").alias("n")))


def _qg2_oracle(raw):
    """Per customer, in the rows' order: the first date, the last non-null
    price, the order keys, the set of priorities (a bit a priority) and
    the count."""
    o = np.argsort(raw["cust"], kind="stable")
    cust = raw["cust"][o]
    n = len(cust)
    starts = np.flatnonzero(np.r_[True, cust[1:] != cust[:-1]])
    pos = np.arange(n)
    last = np.maximum.reduceat(np.where(raw["pvalid"][o], pos, -1), starts)
    return dict(cust=cust[starts], date=raw["date"][o][starts],
                price=np.where(last >= 0, raw["price"][o][np.maximum(last, 0)],
                               np.nan), price_valid=last >= 0,
                offsets=np.r_[starts, n], keys=raw["key"][o],
                prio=np.bitwise_or.reduceat(1 << raw["prio"][o], starts),
                n=np.diff(np.r_[starts, n]))


def _check_qg2(got, want, what):
    got = got.sort_by("o_custkey")
    if not np.array_equal(got["o_custkey"].to_numpy(), want["cust"]):
        raise AssertionError(f"{what}: customers differ")
    dates = got["first_date"].combine_chunks().cast(pa.int32()).to_numpy(
        zero_copy_only=False)
    if not np.array_equal(dates, want["date"]) or \
            not np.array_equal(got["n"].to_numpy(), want["n"]):
        raise AssertionError(f"{what}: first dates or counts differ")
    price = got["last_price"].combine_chunks()
    pv = ~price.is_null().to_numpy(zero_copy_only=False)
    pz = price.fill_null(0.0).to_numpy()
    if not np.array_equal(pv, want["price_valid"]) or not np.array_equal(
            pz[pv], want["price"][pv]):
        raise AssertionError(f"{what}: last non-null prices differ")
    orders = got["orders"].combine_chunks()
    if not np.array_equal(orders.offsets.to_numpy() - orders.offsets[0].as_py(),
                          want["offsets"]) or \
            not np.array_equal(orders.flatten().to_numpy(), want["keys"]):
        raise AssertionError(f"{what}: collect_list differs")
    prios = got["priorities"].combine_chunks()
    codes = pc.index_in(prios.flatten(), value_set=pa.array(
        PRIORITIES, pa.string())).to_numpy(zero_copy_only=False)
    offs = prios.offsets.to_numpy() - prios.offsets[0].as_py()
    lens = np.diff(offs)
    if np.any(lens == 0) or np.any(codes < 0):
        raise AssertionError(f"{what}: a set is empty or holds no priority")
    mask = np.bitwise_or.reduceat(1 << codes.astype(np.int64), offs[:-1])
    pop = np.array([bin(x).count("1") for x in range(32)])[mask]
    if not np.array_equal(mask, want["prio"]) or not np.array_equal(
            pop, lens):
        raise AssertionError(f"{what}: collect_set differs (or repeats)")
    return got.num_rows


def _qg3_years(raw):
    """The ship dates' years, by a search over the days of each 1 January
    (TPC-H's dates lie in 1992-1998)."""
    jan1 = np.array([np.datetime64(f"{y}-01-01", "D").astype(np.int64)
                     for y in range(1990, 2001)])
    return 1990 + np.searchsorted(jan1, raw["ship"], side="right") - 1


def _qg3_pct_oracle(raw, p=0.5):
    """approx_percentile(l_extendedprice, p) by (returnflag, linestatus):
    each group's sorted prices at rank ceil(p n) - 1 (unscaled)."""
    key = raw["rf"] * 2 + raw["ls"]
    out = {}
    for g in np.unique(key):
        vals = raw["price"][key == g]
        at = max(math.ceil(p * len(vals)) - 1, 0)
        out[(int(g) // 2, int(g) % 2)] = int(np.partition(vals, at)[at])
    return out


def _qg3_pivot_df(session, table, parts, F, col):
    return (session.create_dataframe(table, num_partitions=parts)
            .group_by(F.year(col("l_shipdate")).alias("y"))
            .pivot(col("l_returnflag"), ["A", "N", "R"])
            .agg(F.first(col("l_quantity")).alias("fq"),
                 F.sum(col("l_extendedprice")).alias("sp")))


def _coalesced_slices(n, parts):
    """The batches an aggregate over ``parts`` partitions of n rows sees:
    the partitions in order, joined until a batch holds the coalesce's
    target rows (``exec/basic.py:TARGET_ROWS``)."""
    from spark_rapids_tpu_torch.exec.basic import TARGET_ROWS
    per = -(-n // parts)
    out, start, pending = [], 0, 0
    for j in range(parts):
        pending += max(0, min(per, n - j * per))
        if pending >= TARGET_ROWS or j == parts - 1:
            out.append(slice(start, start + pending))
            start, pending = start + pending, 0
    return out


def _qg3_pivot_oracle(raw, parts):
    """Per year and flag: the first quantity (unscaled) and the sum of
    prices.  Where the aggregate sees several batches, the canonical
    merge orders each year's partials by their buffers (A's first, A's
    sum, N's first, ..., a null first) and each first is the first
    non-null one in that order."""
    years = _qg3_years(raw)
    n = len(years)
    y0 = int(years.min())
    nyears = int(years.max()) - y0 + 1
    cells = (years - y0) * 3 + raw["rf"]          # (year, flag)
    partials = []
    for sl in _coalesced_slices(n, parts):
        c = cells[sl]
        has = np.bincount(c, minlength=nyears * 3) > 0
        # each cell's first row: in the first rows for all but rare cells
        head, at = np.unique(c[:1 << 16], return_index=True)
        first = np.zeros(nyears * 3, np.int64)
        first[head] = at
        for cell in np.flatnonzero(has & ~np.isin(np.arange(nyears * 3),
                                                  head)):
            first[cell] = int(np.argmax(c == cell))
        qty = np.where(has, raw["qty"][sl][first], 0)
        # prices below 2^24 over at most 2^25 rows: exact in float64
        total = np.bincount(c, weights=raw["price"][sl],
                            minlength=nyears * 3).astype(np.int64)
        partials.append((has, qty, total))
    out = {}
    for y in range(nyears):
        if not any(h[y * 3:y * 3 + 3].any() for h, _, _ in partials):
            continue
        rows = sorted(tuple(x for f in range(3) for x in (
            (1, int(q[y * 3 + f])) if h[y * 3 + f] else (0, 0),
            (1, int(tot[y * 3 + f])) if h[y * 3 + f] else (0, 0)))
            for h, q, tot in partials)
        merged = []
        for f in range(3):
            firsts = [r[2 * f][1] for r in rows if r[2 * f][0]]
            sums = [r[2 * f + 1][1] for r in rows if r[2 * f + 1][0]]
            merged += [firsts[0] if firsts else None,
                       sum(sums) if sums else None]
        out[y0 + y] = merged
    return out


def _check_qg3_pivot(got, want, what):
    got = got.sort_by("y")
    names = [f"{v}_{a}" for v in "ANR" for a in ("fq", "sp")]
    if got.column_names != ["y"] + names:
        raise AssertionError(f"{what}: columns {got.column_names}")
    for row in got.to_pylist():
        vals = [None if row[c] is None else int(row[c].scaleb(2))
                for c in names]
        if vals != want.get(row["y"]):
            raise AssertionError(f"{what}: year {row['y']}: {vals} against "
                                 f"{want.get(row['y'])}")
    if got.num_rows != len(want):
        raise AssertionError(f"{what}: {got.num_rows} years")


def _qg4_table(fact, seed=SEED):
    """Bench's fact table with x: f with 10 % of its rows nulled."""
    rng = np.random.default_rng(seed + 26)
    valid = rng.random(fact.num_rows) >= QG4_NULLS
    return fact.append_column("x", pa.array(fact["f"].to_numpy(),
                                            mask=~valid)), valid


def _qg4_df(session, table, parts, F, col, W):
    wb = lambda: W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
    return session.create_dataframe(table, num_partitions=parts).select(
        col("k"), col("v"),
        F.last(col("x"), True).over(wb().rows_between(
            W.Window.unboundedPreceding, 0)).alias("ffill"),
        F.first(col("x")).over(wb().rows_between(-6, 0)).alias("f6"),
        F.last(col("x")).over(wb().rows_between(
            W.Window.unboundedPreceding,
            W.Window.unboundedFollowing)).alias("lall"),
        F.first(col("x"), True).over(wb().range_between(
            -QG4_RANGE, QG4_RANGE)).alias("frng"))


def _qg4_oracle(table, valid):
    """qg4's four columns in input order by numpy: the rows sorted by (k,
    v, input row), then per sorted row the pick of each frame.  Returns
    {name: values, -1.0 where null}."""
    k, v = table["k"].to_numpy(), table["v"].to_numpy()
    n = len(k)
    # (k, v) in 38 bits and the row in 25: one sort of distinct words is
    # the stable order (bench's ranges, checked)
    if k.min() < 0 or k.max() >= 1 << 17 or np.abs(v).max() >= 1 << 20 \
            or n > 1 << 25:
        raise AssertionError("qg4 oracle: k, v or n outside its packing")
    keyed = np.sort((((k << 21) | (v + (1 << 20))) << 25) | np.arange(n))
    o = keyed & ((1 << 25) - 1)
    ws = keyed >> 25
    del keyed
    xs, ok = table["f"].to_numpy()[o], valid[o]
    pos = np.arange(n)
    new_k = np.r_[True, (ws[1:] >> 21) != (ws[:-1] >> 21)]
    start = np.maximum.accumulate(np.where(new_k, pos, 0))
    end = np.minimum.accumulate(np.where(np.r_[new_k[1:], True], pos, n)
                                [::-1])[::-1]
    before = np.maximum.accumulate(np.where(ok, pos, -1))
    after = np.minimum.accumulate(np.where(ok, pos, n)[::-1])[::-1]
    lo = np.searchsorted(ws, ws - QG4_RANGE, side="left")
    hi = np.searchsorted(ws, ws + QG4_RANGE, side="right") - 1
    j = after[np.minimum(lo, n - 1)]
    picks = {"ffill": (before, before >= start),
             "f6": (np.maximum(pos - 6, start), None),
             "lall": (end, None),
             "frng": (j, j <= hi)}
    out = {}
    for name, (idx, inside) in picks.items():
        idx = np.clip(idx, 0, n - 1)
        got_valid = ok[idx] if inside is None else inside & ok[idx]
        vals = np.empty(n)
        # f lies in [0, 1): -1 stands for a null
        vals[o] = np.where(got_valid, xs[idx], -1.0)
        out[name] = vals
    return out


def _check_qg4(got, want, what):
    for name, vals in want.items():
        if not np.array_equal(got[name].combine_chunks().fill_null(
                -1.0).to_numpy(), vals):
            raise AssertionError(f"{what}: {name} differs from numpy")


def _k23_cases(torch, dev, scan):
    """K23 against its plain version on edge shapes, bit for bit where the
    flag is set (and the flags everywhere): 1 row, around a 32-row word
    (31, 32, 33 rows) and a tile (8,191, 8,192, 8,193 rows), and 2^20 +
    5; no valid row, all valid, 10 % valid, valid only at a tile's or a
    word's first and last rows, all-null partitions, all-null stretches
    across several tiles; frames empty (hi < lo), of one row, whole
    partitions, bounds on word and tile edges, beyond the last valid row
    and outside [0, n); each bound given or the row itself; first and
    last, nulls ignored and counted; every live row, and the live rows
    cut at two thirds.  Where nulls are ignored and the frame lets the
    scan pick at the row itself (last with no hi, first with no lo), the
    fused plan (one launch) and the bitmap plan both.  Returns the
    number of calls."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    calls = 0
    for n in (1, 2, 31, 32, 33, 8191, 8192, 8193, 3 * 8192 + 1,
              (1 << 20) + 5):
        pos = torch.arange(n, device=dev)
        rnd = torch.rand(n, generator=gen, device=dev)
        # partitions of about 50 rows: ids[i] is row i's, first_of its
        # first rows
        new = torch.rand(n, generator=gen, device=dev) < 0.02
        new[0] = True
        ids = torch.cumsum(new.to(torch.int64), 0) - 1
        first_of = torch.nonzero(new).flatten()
        part_null = (ids % 3) == 0             # every third partition
        valids = {"none": torch.zeros(n, dtype=torch.bool, device=dev),
                  "all": torch.ones(n, dtype=torch.bool, device=dev),
                  "tenth": rnd < 0.1,
                  "tile_edges": (pos % 8192 == 0) | (pos % 8192 == 8191),
                  "word_edges": (pos % 32 == 0) | (pos % 32 == 31),
                  "null_parts": (rnd < 0.5) & ~part_null,
                  "null_tiles": pos % 30_000 == 17}
        seg = first_of[ids]
        seg_end = torch.cat([first_of[1:] - 1, torch.full(
            (1,), n - 1, device=dev)])[ids]
        lo = torch.randint(-3, n + 3, (n,), generator=gen, device=dev)
        span = torch.randint(-3, 40, (n,), generator=gen, device=dev)
        word, tile = pos // 32 * 32, pos // 8192 * 8192
        frames = {
            "random": (lo, lo + span),
            "one_row": (pos, pos),
            "empty": (pos + 1, pos),
            "whole": (seg, seg_end),
            "running": (seg, None),
            "following": (None, torch.minimum(pos + 50, seg_end)),
            "word_edges": (word - 1 + (pos % 2), word + 32 - (pos % 2)),
            "tile_edges": (tile - 1 + (pos % 2), tile + 8192 - (pos % 2)),
            "far": (pos - 70_000, pos + 70_000),
            "past_end": (torch.full_like(pos, n + 7), torch.full_like(
                pos, n + 9)),
            "rows": (None, None)}
        lives = (None,) if n < 31 else (None, n * 2 // 3)
        for vname, valid in valids.items():
            for fname, (a, b) in frames.items():
                a = None if a is None else a.to(torch.int32)
                b = None if b is None else b.to(torch.int32)
                for last, ign, n_live in itertools.product(
                        (False, True), (False, True), lives):
                    want = scan.frame_pick_plain(valid, a, b, last, ign,
                                                 n_live)
                    # the planned launch, and the bitmap plan of a frame
                    # that fuses
                    for plan in scan._frame_pick_plans(a, b, last, ign):
                        got = scan._frame_pick_launch(valid, a, b, last, ign,
                                                      n_live, plan)
                        calls += 1
                        if not torch.equal(got[1], want[1]) or \
                                not torch.equal(got[0][want[1]],
                                                want[0][want[1]]):
                            raise AssertionError(
                                f"K23 differs from its plain version: {n} "
                                f"rows, valid {vname}, frame {fname}, "
                                f"last={last}, ignore_nulls={ign}, "
                                f"n_live={n_live}, plan {plan}")
    return calls


def _k3_positional_paths(torch, agg_mod, cap, paths, what):
    """Every K3 call of a run (captured by ``cap``) again on each forced
    path of ``paths``, against the plain version exactly; the run path
    where the call's order has at most 64 increasing runs, and there it
    must be taken."""
    orig = cap.orig["segment_reduce_sorted"]
    plain = agg_mod.segment_reduce_sorted_plain
    n = 0
    for (_, args), kw in zip(cap.calls, cap.kwargs):
        if not any(op in ("first", "last") for op in (args[6] or [])):
            continue
        order = args[5]
        runs = 1 if order is None else 1 + int(
            (order[1:] < order[:-1]).sum())
        want = plain(*args, **kw)
        for path in paths:
            if path == "run" and (runs > 64 or args[4]):
                continue
            got = orig(*args, **{**kw, "path": path})
            _k3_diff_exact(torch, got, want, f"{what}, path={path}")
            if path == "run" and not orig.last_plan.run_path:
                raise AssertionError(f"K3 at {what} did not take the run "
                                     f"path")
            n += 1
    if not n:
        raise AssertionError(f"{what} made no K3 call with first or last")
    return n


def _k3_diff_exact(torch, got, want, what):
    if got[3] != want[3] or not torch.equal(got[0], want[0]):
        raise AssertionError(f"K3 groups or first rows differ at {what}")
    for s, sp, c, cp in zip(got[1], want[1], got[2], want[2]):
        if not torch.equal(c, cp):
            raise AssertionError(f"K3 counts differ at {what}")
        for x, y in ([] if s is None else zip(s, sp)
                     if isinstance(s, tuple) else [(s, sp)]):
            if x.dtype == torch.float64:
                x, y = x.view(torch.int64), y.view(torch.int64)
            if not torch.equal(x, y):
                raise AssertionError(f"K3 results differ at {what}")


def _agg_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                bound, path_run, li_table, li_raw, fact):
    """ROADMAP item 4c on the card: K3's positional kinds on their edge
    cases and at qg2's and qg3's calls on every path; K23 on its edge
    cases and at qg4's calls; qg1 (TPC-DS Q39's moments), qg2 (first,
    last, collect_list and collect_set per customer), qg3 (a median and
    a pivot over q1d's lineitem) and qg4 (first and last over four
    frames at q4's shape), each over 1 and 4 partitions against numpy,
    with its aggregate or window on the GPU."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec import window as window_mod
    from spark_rapids_tpu_torch.expr import window as W
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import scan
    from spark_rapids_tpu_torch.ops import segmented as seg
    t_aggs = time.perf_counter()

    def placed(session, exec_name, what):
        nodes = _placements(session.last_plan)
        if (exec_name, "gpu") not in nodes or "!" in session.last_explain:
            raise AssertionError(f"{what} placed {nodes}:\n"
                                 f"{session.last_explain}")
        return nodes

    try:
        t1 = time.perf_counter()
        n_k23 = _k23_cases(torch, dev, scan)
        print(f"K23 edge cases: {n_k23} calls equal the plain version "
              f"(K3's first and last over groups that span two runs: the "
              f"run cases of the flat types' phase); "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("K23 edge cases")
        traceback.print_exc()

    # ---- qg1: TPC-DS Q39's moments ---------------------------------------
    try:
        t1 = time.perf_counter()
        inv, inv_raw = _qg1_table(QG1_ROWS)
        want = _qg1_oracle(inv_raw)
        print(f"qg1 inventory of {QG1_ROWS} rows, {len(want['key'])} groups, "
              f"its numpy oracle: {time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            s = GpuSession()
            df = _qg1_df(s, inv, parts, F, col, lit)
            what = f"qg1 over {parts} partition(s)"
            got = path_run("qg1" if parts == 1 else "qg1_4", df.collect,
                           lambda got, w: _check_qg1(got, want, w), what)
            placed(s, "GpuHashAggregateExec", what)
            print(f"{what}: {got.num_rows} groups with stddev / mean > 1")
        del inv, inv_raw, want
    except Exception:
        failures.append("qg1")
        traceback.print_exc()

    # ---- qg2: the latest and the history per customer --------------------
    try:
        t1 = time.perf_counter()
        orders, o_raw = _qg2_table()
        want = _qg2_oracle(o_raw)
        print(f"qg2 orders: {orders.num_rows} rows, {len(want['cust'])} "
              f"customers, its numpy oracle: "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, QG2_PARTS):
            s = GpuSession()
            df = _qg2_df(s, orders, parts, F, col)
            what = f"qg2 over {parts} partition(s)"
            path_run("qg2" if parts == 1 else "qg2_4", df.collect,
                     lambda got, w: _check_qg2(got, want, w), what)
            placed(s, "GpuHashAggregateExec", what)
            with _Capture(agg_mod, "segment_reduce_sorted") as cap:
                df.collect()
            n_paths = _k3_positional_paths(torch, agg_mod, cap, K3_PATHS,
                                           what)
            if parts == 1:
                row = _k3_call_row(torch, agg_mod, cap, cuda_ms, what)
                args, kw = cap.calls[0][1], cap.kwargs[0]
                words, order = args[0], args[5]
                n = _k3_rows(args)
                idx = order.to(torch.int64)
                sw = [w.index_select(0, idx) for w in words]
                live = torch.ones(n, dtype=torch.bool, device=dev)
                ids = seg.segment_ids(seg.segment_boundaries(sw, live)).to(
                    torch.int64)
                g = row["extra"]["groups"]
                pos = torch.arange(n, device=dev)
                row["library_ms"] = cuda_ms(lambda: torch.full(
                    (g,), n, dtype=torch.int64, device=dev).scatter_reduce_(
                    0, ids, pos, "amin"))
                row["extra"]["library_call"] = \
                    "scatter_reduce_(amin) of the positions"
                kernel_rows["segment_reduce_sorted_first_last"] = dict(
                    source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
                    replaces="spark_rapids_tpu/ops/segmented.py:251",
                    max_abs_err=0.0, **row)
                del sw, ids, pos, live
                print(f"K3 at {what}: {len(cap.calls)} call(s) equal the "
                      f"plain version, {n_paths} more on the planned and "
                      f"each forced path; the first {row['ms']:.3f} ms "
                      f"({row['extra']['path']}), plain "
                      f"{row['plain_ms']:.3f}, library "
                      f"{row['library_ms']:.3f}, bound "
                      f"{row['bound_ms']:.3f} ({row['extra']}); {card}")
        del orders, o_raw, want
    except Exception:
        failures.append("qg2")
        traceback.print_exc()

    # ---- qg3: a median and a crosstab over q1d's lineitem ----------------
    try:
        t1 = time.perf_counter()
        pct_want = _qg3_pct_oracle(li_raw)
        piv_want = {p: _qg3_pivot_oracle(li_raw, p) for p in (1, 4)}
        print(f"qg3 numpy oracles: {time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            s = GpuSession()
            df = (s.create_dataframe(li_table, num_partitions=parts)
                  .group_by(col("l_returnflag"), col("l_linestatus"))
                  .agg(F.approx_percentile(col("l_extendedprice"), 0.5)
                       .alias("median")))

            def check_pct(got, w):
                rows = {(r["l_returnflag"], r["l_linestatus"]):
                        int(r["median"].scaleb(2)) for r in got.to_pylist()}
                flags = {("ANR"[a], "FO"[b]): v
                         for (a, b), v in pct_want.items()}
                if rows != flags:
                    raise AssertionError(f"{w}: {rows} against {flags}")
            what = f"qg3 median over {parts} partition(s)"
            path_run("qg3_pct" if parts == 1 else "qg3_pct_4", df.collect,
                     check_pct, what)
            placed(s, "GpuHashAggregateExec", what)
            s = GpuSession()
            df = _qg3_pivot_df(s, li_table, parts, F, col)
            what = f"qg3 pivot over {parts} partition(s)"
            path_run("qg3_pivot" if parts == 1 else "qg3_pivot_4",
                     df.collect, lambda got, w, p=parts: _check_qg3_pivot(
                         got, piv_want[p], w), what)
            placed(s, "GpuHashAggregateExec", what)
            with _Capture(agg_mod, "segment_reduce_sorted") as cap:
                df.collect()
            print(f"K3 at {what}: "
                  f"{_k3_positional_paths(torch, agg_mod, cap, K3_PATHS, what)}"
                  f" call(s) with first equal the plain version on the "
                  f"planned and each forced path")
    except Exception:
        failures.append("qg3")
        traceback.print_exc()

    # ---- qg4: first and last over four frames at q4's shape --------------
    try:
        t1 = time.perf_counter()
        tab4, valid4 = _qg4_table(fact)
        want = _qg4_oracle(tab4, valid4)
        print(f"qg4 numpy oracle: {tab4.num_rows} rows, "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            s = GpuSession()
            df = _qg4_df(s, tab4, parts, F, col, W)
            what = f"qg4 over {parts} partition(s)"
            path_run("qg4" if parts == 1 else "qg4_4", df.collect,
                     lambda got, w: _check_qg4(got, want, w), what)
            placed(s, "WindowExec", what)
            with _Capture(window_mod, "frame_pick") as cap:
                df.collect()
            orig = cap.orig["frame_pick"]
            for _, args in cap.calls:
                got = orig(*args)
                ref = scan.frame_pick_plain(*args)
                if not torch.equal(got[1], ref[1]) or not torch.equal(
                        got[0][ref[1]], ref[0][ref[1]]):
                    raise AssertionError(f"K23 differs from its plain "
                                         f"version at {what}")
            if len(cap.calls) != 4:
                raise AssertionError(f"{what} made {len(cap.calls)} K23 "
                                     f"calls, not 4")
            if parts > 1:
                continue
            rows = []
            for _, args in cap.calls:
                valid, lo, hi, last, ign, n_live = args
                n = int(valid.shape[0])
                moved = n * (1 + 4 * (lo is not None) + 4 * (hi is not None)
                             + 4 + 1)
                live_valid = valid & (torch.arange(n, device=dev) < n_live)
                cpre = torch.zeros(n + 1, dtype=torch.int64, device=dev)
                cpre[1:] = torch.cumsum(live_valid.to(torch.int64), 0)
                at = torch.arange(n, device=dev) if lo is None else \
                    lo.to(torch.int64).clamp(0, n - 1)
                target = cpre[at] + 1
                rows.append(dict(
                    ms=cuda_ms(lambda: orig(*args)),
                    plain_ms=cuda_ms(lambda: scan.frame_pick_plain(*args),
                                     reps=2),
                    library_ms=cuda_ms(lambda: torch.searchsorted(
                        cpre, target)),
                    bound_ms=bound(moved),
                    extra=dict(rows=n, last=bool(last),
                               ignore_nulls=bool(ign),
                               lo=lo is not None, hi=hi is not None,
                               plan=scan.frame_pick_plan(lo, hi, last, ign),
                               bytes_moved=moved)))
            first = rows[0]
            first["extra"]["calls"] = [
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in {**r["extra"], "ms": r["ms"],
                              "bound_ms": r["bound_ms"],
                              "plain_ms": r["plain_ms"]}.items()}
                for r in rows]
            first["extra"]["library_call"] = \
                "torch.searchsorted over the valid-count prefix (nearest)"
            kernel_rows["frame_pick"] = dict(
                source="spark_rapids_tpu_torch/csrc/frame_pick.cu",
                replaces="spark_rapids_tpu/exec/window.py:338",
                max_abs_err=0.0, **first)
            print(f"K23 at {what}: 4 calls equal the plain version; "
                  + "; ".join(f"{'last' if r['extra']['last'] else 'first'}"
                              f"{' ignoring nulls' if r['extra']['ignore_nulls'] else ''}"
                              f" {r['ms']:.3f} ms (bound {r['bound_ms']:.3f}, "
                              f"plain {r['plain_ms']:.3f}, searchsorted "
                              f"{r['library_ms']:.3f})" for r in rows)
                  + f"; {card}")
        del tab4, valid4, want
    except Exception:
        failures.append("qg4")
        traceback.print_exc()
    torch.cuda.empty_cache()
    print(f"aggregate phases: {time.perf_counter() - t_aggs:.1f} s")


# ---------------------------------------------------------------------------
# the nested types: TPC-H's orders with their lineitems nested inside
# ---------------------------------------------------------------------------

NESTED_ORDERS = 7_500_000     # TPC-H SF5 orders (1.5M a scale factor)
NESTED_CUSTOMERS = 750_000    # TPC-H SF5 customers
QA_CUTOFF_DAYS = 9204         # 1995-03-15, days since the epoch
QA_LIMIT = 1_000_000
SEGMENTS = (b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"HOUSEHOLD",
            b"MACHINERY")     # TPC-H c_mktsegment
TAG_KEYS = (b"o_orderpriority", b"o_shippriority", b"o_clerk")


def _spans_of(lengths):
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    return offs


def _pick_bytes(codes, words, large=True, binary=False, valid=None):
    """A (large) string or binary array whose row i is ``words[codes[i]]``
    (a null where ``valid`` is False, with no bytes), built from numpy
    buffers."""
    lens = np.array([len(w) for w in words], dtype=np.int64)[codes]
    if valid is not None:
        lens = np.where(valid, lens, 0)
    offs = _spans_of(lens)
    width = max(len(w) for w in words)
    table = np.zeros((len(words), width), dtype=np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
    mask = np.arange(width) < lens[:, None]
    chars = table[codes][mask]
    typ = (pa.large_binary() if binary else pa.large_string()) if large \
        else (pa.binary() if binary else pa.string())
    bitmap = None if valid is None else pa.py_buffer(
        np.packbits(valid, bitorder="little"))
    return pa.Array.from_buffers(typ, len(codes), [
        bitmap, pa.py_buffer(offs if large else offs.astype(np.int32)),
        pa.py_buffer(chars)],
        null_count=0 if valid is None else int((~valid).sum()))


def _nested_orders(n=NESTED_ORDERS, customers=NESTED_CUSTOMERS, seed=SEED):
    """TPC-H's orders with each order's lineitems nested inside it, from
    ``seed`` with numpy, built through Arrow's buffers: 1-7 lines an
    order drawn uniformly (TPC-H 4.2.3), the lines an array of structs
    (l_partkey, l_quantity 1-50, l_extendedprice, l_discount 0.00-0.10
    with 5 % null, l_shipdate), the whole array null in 1 % of rows (a
    null array spans no lines); the customer's nation and segment as a
    struct, null in 1 % of rows with its children holding values there;
    the order's attributes as a map of 1-3 entries (o_orderpriority
    1-5, o_shippriority 0, o_clerk 1-5,000); a 16-byte binary digest,
    null in 2 % of rows.  Returns (orders, customer), the customer
    table (c_custkey, c_acctbal) keyed 1..``customers``."""
    rng = np.random.default_rng(seed + 19)
    lines_null = rng.random(n) < 0.01
    nl = np.where(lines_null, 0, rng.integers(1, 8, n))
    loff = _spans_of(nl)
    m = int(loff[-1])
    disc_valid = rng.random(m) >= 0.05
    line = pa.StructArray.from_arrays([
        pa.array(rng.integers(1, 1_000_001, m)),
        pa.array(rng.integers(1, 51, m)),
        pa.array(np.round(rng.random(m) * 1e5, 2)),
        pa.array(np.where(disc_valid, rng.integers(0, 11, m) / 100.0, 0.0),
                 mask=~disc_valid),
        pa.array(rng.integers(8036, 10563, m).astype(np.int32)).cast(
            pa.date32())],
        names=["l_partkey", "l_quantity", "l_extendedprice", "l_discount",
               "l_shipdate"])
    lines = pa.LargeListArray.from_arrays(pa.array(loff), line,
                                          mask=pa.array(lines_null))
    cust_null = rng.random(n) < 0.01
    cust = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 25, n).astype(np.int32)),
         _pick_bytes(rng.integers(0, len(SEGMENTS), n), SEGMENTS)],
        names=["c_nationkey", "c_mktsegment"], mask=pa.array(cust_null))
    nt = rng.integers(1, 4, n)
    toff = _spans_of(nt).astype(np.int32)
    which = np.arange(int(toff[-1])) - np.repeat(toff[:-1], nt)
    vals = np.where(which == 0, rng.integers(1, 6, len(which)),
                    np.where(which == 1, 0,
                             rng.integers(1, 5001, len(which))))
    tags = pa.MapArray.from_arrays(
        pa.array(toff), _pick_bytes(which, TAG_KEYS), pa.array(vals))
    dig_valid = rng.random(n) >= 0.02
    dig = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    dlen = np.where(dig_valid, 16, 0)
    digest = pa.Array.from_buffers(pa.large_binary(), n, [
        pa.py_buffer(np.packbits(dig_valid, bitorder="little")),
        pa.py_buffer(_spans_of(dlen)),
        pa.py_buffer(dig[dig_valid].reshape(-1))],
        null_count=int((~dig_valid).sum()))
    keys = np.arange(n, dtype=np.int64)
    orders = pa.table({
        "o_orderkey": pa.array((keys // 8) * 32 + keys % 8 + 1),
        "o_custkey": pa.array(rng.integers(1, customers + 1, n)),
        "o_orderdate": pa.array(rng.integers(8035, 10441, n).astype(
            np.int32)).cast(pa.date32()),
        "o_totalprice": pa.array(np.round(rng.random(n) * 5e5, 2)),
        "o_cust": cust, "o_lines": lines, "o_tags": tags,
        "o_digest": digest})
    customer = pa.table({
        "c_custkey": pa.array(np.arange(1, customers + 1, dtype=np.int64)),
        "c_acctbal": pa.array(np.round(rng.random(customers) * 11000 - 1000,
                                       2))})
    return orders, customer


def _qa2_oracle(orders):
    """qa2 by pyarrow: element_at(o_lines, 1).l_quantity, o_lines[0],
    o_cust.c_mktsegment, struct(o_orderkey, o_totalprice) and
    array(o_orderkey, o_custkey)."""
    lines = orders["o_lines"].combine_chunks()
    first = pc.list_element(lines, 0)
    n = orders.num_rows
    both = np.empty(2 * n, dtype=np.int64)
    both[0::2] = orders["o_orderkey"].to_numpy()
    both[1::2] = orders["o_custkey"].to_numpy()
    return pa.table({
        "o_orderkey": orders["o_orderkey"],
        "q1": pc.struct_field(first, "l_quantity"),
        "l0": first,
        "seg": pc.struct_field(orders["o_cust"].combine_chunks(),
                               "c_mktsegment"),
        "st": pa.StructArray.from_arrays(
            [orders["o_orderkey"].combine_chunks(),
             orders["o_totalprice"].combine_chunks()],
            names=["o_orderkey", "o_totalprice"]),
        "ar": pa.LargeListArray.from_arrays(
            pa.array(np.arange(n + 1, dtype=np.int64) * 2),
            pa.array(both))})


def _qa3_oracle(orders):
    """qa3 by pyarrow: the struct key flattened to its fields and a null
    flag, so the null structs group together whatever their children
    hold; {key: (count, sum)}, the null key as None."""
    cust = orders["o_cust"].combine_chunks()
    flat = pa.table({"n": pc.struct_field(cust, 0),
                     "s": pc.struct_field(cust, 1),
                     "null": pc.is_null(cust),
                     "p": orders["o_totalprice"]})
    res = flat.group_by(["n", "s", "null"]).aggregate([("p", "count"),
                                                       ("p", "sum")])
    return {None if r["null"] else (r["n"], r["s"]):
            (r["p_count"], r["p_sum"]) for r in res.to_pylist()}


def _check_qa3(got, want, what):
    rows = {}
    for r in got.to_pylist():
        k = None if r["o_cust"] is None else (r["o_cust"]["c_nationkey"],
                                              r["o_cust"]["c_mktsegment"])
        rows[k] = (r["c"], r["s"])
    if rows.keys() != want.keys():
        raise AssertionError(f"{what}: {len(rows)} groups, want "
                             f"{len(want)}")
    for k, (c, s) in rows.items():
        wc, ws = want[k]
        if c != wc or abs(s - ws) > FLOAT_RTOL * abs(ws):
            raise AssertionError(f"{what}: group {k} is ({c}, {s}), want "
                                 f"({wc}, {ws})")


def _by_orderkey(t):
    """The table's rows in o_orderkey order (unique keys)."""
    return t.take(pc.sort_indices(t["o_orderkey"]))


def _k18_case_inputs(torch, dev, sops):
    """K18's edge cases as (what, starts, new_offsets, total, child_cap):
    0 rows, every slot invalid, every array empty, one row of 2^24
    elements beside 10^6 rows of one, 10^6 empty rows between two rows
    of one and after a row of 3,000, child totals of 0, 1, around 1,024
    and 2,048 and 4,096, one row of 2^22 elements alone (over 2,048
    merge tiles), 2,048 rows of 2 (three whole merge tiles), a zero tail
    of 2^20 slots past the total, random spans, a sparse column of 4M
    rows (1 % hold elements, half the slots invalid)."""
    out = []

    def add(what, lengths, valid=None, cap=None):
        lengths = np.asarray(lengths, dtype=np.int64)
        offs = torch.from_numpy(_spans_of(lengths).astype(np.int32)).to(dev)
        n = len(lengths)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        vld = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
            else torch.from_numpy(np.asarray(valid)).to(dev)
        new_offs, total, starts = sops.gather_offsets(offs, idx, vld)
        total = int(total)
        out.append((what, starts, new_offs, total,
                    cap if cap is not None else max(total, 1) + 5))
    add("0 rows", np.zeros(0))
    add("all slots invalid", np.full(5000, 3), np.zeros(5000, bool))
    add("all arrays empty", np.zeros(70_000))
    add("2^24 elements beside 10^6 rows of one",
        np.concatenate([[1 << 24], np.ones(1_000_000)]))
    add("10^6 empty rows between two rows of one",
        np.concatenate([[1], np.zeros(1_000_000), [1]]))
    for total in (0, 1, 1023, 1024, 1025, 2047, 2048, 2049, 4096):
        add(f"child total {total}", [total], cap=total + 3)
    add("one row of 2^22 elements", [1 << 22])
    add("10^6 empty rows after a row of 3,000",
        np.concatenate([[3000], np.zeros(1_000_000)]))
    # 2,048 rows of 2: 6,144 merge items, three whole tiles
    add("a total that is a multiple of the tile", np.full(2048, 2),
        cap=4096)
    add("a zero tail of 2^20 slots past the total", np.full(1000, 3),
        cap=(1 << 20) + 3000)
    rng = np.random.default_rng(SEED)
    add("random spans, 30 % empty",
        rng.integers(0, 9, 300_000) * (rng.random(300_000) < 0.7))
    add("4M rows, 99 % empty or null",
        rng.integers(1, 9, 4_000_000) * (rng.random(4_000_000) < 0.01),
        rng.random(4_000_000) < 0.5)
    return out


def _nested_phases(torch, dev, card, launches, kernel_rows, failures,
                   cuda_ms, bound, path_run):
    """The nested types on the card: K18 against its plain version on
    edge cases; qa1-qa5 over TPC-H's orders with their lineitems nested
    inside (``_nested_orders``), each through GpuSession against its
    oracle with ``equals`` on Arrow data; every K18 call of qa1 and qa4
    against its plain version; the fallbacks with the reference's
    reasons; K18's kernel row, at qa1's call on ``o_lines``."""
    import datetime
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.io.cached_batch import CacheManager
    from spark_rapids_tpu_torch.ops import gather as gather_mod
    from spark_rapids_tpu_torch.ops import strings as sops

    t_nested = time.perf_counter()
    try:
        cases = _k18_case_inputs(torch, dev, sops)
        for what, starts, offs, total, cap in cases:
            got = gather_mod.span_rows(starts, offs, total, cap)
            want = gather_mod.span_rows_plain(starts, offs, total, cap)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K18 differs from its plain version: "
                                     f"{what}")
            if what.startswith(("10^6 empty", "4M rows")):
                # the skewed stretches: each thread's work must stay flat
                args = (starts, offs, total, cap)
                print(f"K18 on {what} ({int(starts.shape[0])} rows, "
                      f"{total} child rows): "
                      f"{cuda_ms(lambda: gather_mod.span_rows(*args)):.3f}"
                      f" ms, plain "
                      f"{cuda_ms(lambda: gather_mod.span_rows_plain(*args), reps=1):.3f}"
                      f" ms; {card}")
        print(f"K18 span_rows: {len(cases)} edge cases equal their plain "
              f"version exactly ({', '.join(c[0] for c in cases)})")
        del cases
    except Exception:
        failures.append("K18 edge cases")
        traceback.print_exc()

    cutoff = datetime.date(1970, 1, 1) + datetime.timedelta(
        days=QA_CUTOFF_DAYS)
    try:
        t1 = time.perf_counter()
        orders, customer = _nested_orders()
        lines = orders["o_lines"].combine_chunks()
        print(f"nested orders: {orders.num_rows} orders, "
              f"{len(lines.values)} lines, "
              f"{len(orders['o_tags'].combine_chunks().keys)} tag entries, "
              f"{orders.nbytes / 2**30:.2f} GiB in Arrow; "
              f"{time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        qa1_want = orders.filter(pc.less(orders["o_orderdate"],
                                         pa.scalar(cutoff, pa.date32())))
        qa2_want = _qa2_oracle(orders)
        qa3_want = _qa3_oracle(orders)
        keys = customer["c_custkey"].to_numpy()
        pos = np.searchsorted(keys, orders["o_custkey"].to_numpy())
        qa4_want = orders.select(["o_orderkey", "o_custkey", "o_lines",
                                  "o_digest"]).append_column(
            "c_acctbal", customer["c_acctbal"].take(pa.array(pos)))
        print(f"qa oracles: qa1 {qa1_want.num_rows} rows, qa3 "
              f"{len(qa3_want)} groups, qa4 {qa4_want.num_rows} rows; "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("nested orders")
        traceback.print_exc()
        return

    def equal_to(want, order_by_key=False):
        def check(got, what):
            g = _by_orderkey(got) if order_by_key else got
            if not g.equals(want):
                bad = [c for c in want.column_names
                       if c not in g.column_names or not g[c].equals(want[c])]
                raise AssertionError(f"{what} differs from its oracle "
                                     f"({got.num_rows} rows, want "
                                     f"{want.num_rows}; columns {bad})")
        return check

    k18_caps = {}
    session = GpuSession()
    before = torch.cuda.memory_allocated()
    df1 = session.create_dataframe(orders)
    df4 = session.create_dataframe(orders, num_partitions=4)
    dcust = session.create_dataframe(customer)

    def qa1(df):
        return df.filter(col("o_orderdate") < lit(cutoff))
    try:
        for parts, df in ((1, df1), (4, df4)):
            run = "qa1" if parts == 1 else "qa1_4"
            path_run(run, qa1(df).collect, equal_to(qa1_want),
                     f"qa1 filter o_orderdate < {cutoff} carrying every "
                     f"column over {parts} partition(s)")
            if parts == 1:
                print(f"nested orders on the card: "
                      f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f}"
                      f" GiB uploaded")
                with _Capture(gather_mod, "span_rows") as cap:
                    qa1(df).collect()
                k18_caps["qa1"] = cap
    except Exception:
        failures.append("qa1 (nested filter)")
        traceback.print_exc()
    try:
        path_run("qa2", df1.select(
            col("o_orderkey"),
            F.element_at(col("o_lines"), 1).getField("l_quantity").alias(
                "q1"),
            col("o_lines")[0].alias("l0"),
            col("o_cust").getField("c_mktsegment").alias("seg"),
            F.struct(col("o_orderkey"), col("o_totalprice")).alias("st"),
            F.array(col("o_orderkey"), col("o_custkey")).alias("ar")).collect,
            equal_to(qa2_want), "qa2 the accessors (element_at, [0], "
            "getField, struct(), array())")
    except Exception:
        failures.append("qa2 (accessors)")
        traceback.print_exc()
    try:
        for parts, df in ((1, df1), (4, df4)):
            run = "qa3" if parts == 1 else "qa3_4"
            path_run(run, df.group_by(col("o_cust")).agg(
                F.count("*").alias("c"),
                F.sum(col("o_totalprice")).alias("s")).collect,
                lambda got, w: _check_qa3(got, qa3_want, w),
                f"qa3 group by o_cust: count, sum over {parts} "
                f"partition(s) ({len(qa3_want)} groups)")
    except Exception:
        failures.append("qa3 (struct group keys)")
        traceback.print_exc()
    try:
        qa4 = df1.select("o_orderkey", "o_custkey", "o_lines",
                         "o_digest").join(
            dcust, on=(col("o_custkey") == col("c_custkey"))).select(
            "o_orderkey", "o_custkey", "o_lines", "o_digest", "c_acctbal")
        path_run("qa4", qa4.collect, equal_to(qa4_want, True),
                 "qa4 orders joined to customer on custkey carrying o_lines "
                 "and o_digest")
        with _Capture(gather_mod, "span_rows") as cap:
            qa4.collect()
        k18_caps["qa4"] = cap
    except Exception:
        failures.append("qa4 (nested join payload)")
        traceback.print_exc()
    try:
        un = qa1(df1).union(df1.filter(col("o_orderdate") >= lit(cutoff)))
        union_want = pa.concat_tables([qa1_want, orders.filter(
            pc.greater_equal(orders["o_orderdate"],
                             pa.scalar(cutoff, pa.date32())))]).slice(
            0, QA_LIMIT)
        path_run("qa5_union", un.limit(QA_LIMIT).collect,
                 equal_to(union_want),
                 f"qa5 qa1's two halves unioned, limit({QA_LIMIT})")
        out_dir = tempfile.mkdtemp(prefix="qa5_parquet_")
        try:
            t1 = time.perf_counter()
            qa1(df1).write.mode("overwrite").parquet(out_dir)
            write_ms = (time.perf_counter() - t1) * 1e3
            path_run("qa5_parquet", lambda: qa1(session.read.parquet(
                out_dir)).collect(), equal_to(_by_orderkey(qa1_want), True),
                f"qa5 parquet read of qa1's result with the filter pushed "
                f"(written in {write_ms:.1f} ms)", reps=1)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        cached = qa1(df1).cache()
        try:
            path_run("qa5_cache", cached.collect, equal_to(qa1_want),
                     "qa5 the cache under qa1 (cold: its write; warm: its "
                     "scan)")
        finally:
            cached.unpersist()
            CacheManager.clear()
    except Exception:
        failures.append("qa5 (union, limit, parquet, cache)")
        traceback.print_exc()

    # the fallbacks, with the reference's reasons, on the first 100,000
    try:
        small = orders.slice(0, 100_000)
        sf = GpuSession()
        dfs = sf.create_dataframe(small)
        checks = (
            ("a sort on o_orderdate carrying o_lines",
             lambda: dfs.select("o_orderkey", "o_orderdate", "o_lines").sort(
                 col("o_orderdate"), col("o_orderkey")),
             "!Exec <SortExec> cannot run on GPU because output column "
             "o_lines: array<struct<l_partkey:bigint,l_quantity:bigint,"
             "l_extendedprice:double,l_discount:double,l_shipdate:date>> is "
             "not supported",
             lambda got: got.equals(small.select(
                 ["o_orderkey", "o_orderdate", "o_lines"]).sort_by(
                 [("o_orderdate", "ascending"),
                  ("o_orderkey", "ascending")]))),
            ("a group-by on o_digest",
             lambda: dfs.group_by(col("o_digest")).agg(
                 F.count("*").alias("c")),
             "!Exec <CpuHashAggregateExec> cannot run on GPU because output "
             "column o_digest: binary is not supported",
             lambda got: got.num_rows == pc.count_distinct(
                 small["o_digest"], mode="all").as_py()),
            ("a join carrying o_tags",
             lambda: dfs.select("o_orderkey", "o_custkey", "o_tags").join(
                 sf.create_dataframe(customer),
                 on=(col("o_custkey") == col("c_custkey"))),
             "!Exec <CpuJoinExec> cannot run on GPU because join payload "
             "type map<string,bigint> (varlen nested in varlen) not sized "
             "for duplicating gathers",
             lambda got: _by_orderkey(got)["o_tags"].equals(
                 small["o_tags"])))
        for what, q, reason, ok in checks:
            got = q().collect()
            lines_ = [ln.strip() for ln in sf.last_explain.splitlines()]
            if reason not in lines_:
                raise AssertionError(f"{what}: the explain lacks the "
                                     f"reference's reason:\n"
                                     f"{sf.last_explain}")
            if not ok(got):
                raise AssertionError(f"{what}: result differs")
            print(f"fallback, {what}: {reason.split(' because ')[0][1:]}, "
                  f"the reference's reason; result equal")
        del small, dfs, sf
    except Exception:
        failures.append("nested fallbacks")
        traceback.print_exc()

    # every K18 call of qa1 and qa4 against its plain version; the kernel
    # row at qa1's call on o_lines (its largest)
    try:
        for key, cap in k18_caps.items():
            for _, args in cap.calls:
                got = cap.orig["span_rows"](*args)
                if not torch.equal(got, gather_mod.span_rows_plain(*args)):
                    raise AssertionError(f"K18 differs at {key}'s call of "
                                         f"{int(args[0].shape[0])} rows")
            print(f"K18 at {key}: {len(cap.calls)} calls equal their plain "
                  f"version exactly (child totals "
                  f"{[a[2] for _, a in cap.calls]})")
        for key in ("qa1", "qa4"):
            if key not in k18_caps or not k18_caps[key].calls:
                raise AssertionError(f"no K18 call captured at {key}")
            _, args = max(k18_caps[key].calls, key=lambda c: c[1][2])
            starts, offs, total, cap_ = args
            n = int(starts.shape[0])
            ms = cuda_ms(lambda: gather_mod.span_rows(*args))
            plain_ms = cuda_ms(lambda: gather_mod.span_rows_plain(*args),
                               reps=1)
            # 4 B written a child slot, the start and the new offset read
            # once for each row that holds a slot (padding, null and empty
            # rows hold none), and the last offset
            held = int((offs[1:] > offs[:-1]).sum())
            bound_ms = bound(4 * cap_ + 8 * held + 4)
            print(f"K18 span_rows at {key}'s call ({n} rows, {held} holding "
                  f"{total} child rows, {cap_} slots): {ms:.3f} ms, bound {bound_ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms; launches a run: "
                  + ", ".join(f"{r} {launches[r]['span_rows']}"
                              for r in launches if r.startswith("qa"))
                  + f"; {card}")
            if key == "qa1":
                kernel_rows["span_rows"] = dict(
                    source="spark_rapids_tpu_torch/csrc/span_rows.cu",
                    replaces="spark_rapids_tpu/ops/gather.py:20",
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, library_ms=None,
                    extra=dict(rows=n, rows_holding_slots=held,
                               child_rows=total,
                               launches_by_run={
                                   r: launches[r]["span_rows"]
                                   for r in launches if r.startswith("qa")}))
            else:
                kernel_rows["span_rows"]["extra"].update(
                    qa4_ms=ms, qa4_bound_ms=bound_ms, qa4_plain_ms=plain_ms)
    except Exception:
        failures.append("K18 at qa1 and qa4")
        traceback.print_exc()
    del df1, df4, dcust, session
    print(f"nested phases: {time.perf_counter() - t_nested:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "spark_rapids_tpu_torch")):
        print("chip_smoke: the spark_rapids_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.column import Column, col, lit
    from spark_rapids_tpu_torch.api.session import GpuSession
    from spark_rapids_tpu_torch.columnar import fetch
    from spark_rapids_tpu_torch.columnar.device import (DEFAULT_CHAR_BUCKETS,
                                                        DeviceBatch,
                                                        DeviceColumn,
                                                        batch_to_arrow,
                                                        batch_to_device,
                                                        bucket_for,
                                                        move_batch)
    from spark_rapids_tpu_torch.exec import aggregate as agg_mod
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec import basic as basic_mod
    from spark_rapids_tpu_torch.exec.basic import FilterExec, LocalScanExec
    from spark_rapids_tpu_torch.exec.filter_common import keep_flags
    from spark_rapids_tpu_torch.expr.aggregates import (
        COMPLETE, AggregateExpression, Average, Count, Sum)
    from spark_rapids_tpu_torch.expr.core import AttributeReference as A
    from spark_rapids_tpu_torch.expr.core import EvalContext
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.exec import window as window_mod
    from spark_rapids_tpu_torch.expr import arithmetic as ar_mod
    from spark_rapids_tpu_torch.expr import conditional as cond_mod
    from spark_rapids_tpu_torch.expr import mathexpr as mx_mod
    from spark_rapids_tpu_torch.expr import window as W
    from spark_rapids_tpu_torch.io import scan as io_scan
    from spark_rapids_tpu_torch.ops import carry
    from spark_rapids_tpu_torch.ops import gather as gather_mod
    from spark_rapids_tpu_torch.ops import join_kernels as jk
    from spark_rapids_tpu_torch.ops import scan as scan_mod
    from spark_rapids_tpu_torch.ops import segmented as seg
    from spark_rapids_tpu_torch.ops import strings as sops
    from spark_rapids_tpu_torch.expr import hashfns as hashfns_mod
    from spark_rapids_tpu_torch.ops import dates as dates_mod
    from spark_rapids_tpu_torch.plan import host_assist

    t_start = time.perf_counter()
    phase_secs = []
    phase_t = [t_start]

    def phase_done(name):
        """Print the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_secs.append((name, now - phase_t[0]))
        print(f"phase {name}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    dev = torch.device("cuda")
    host = torch.device("cpu")
    failures = []
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.get_num_threads()} host threads")

    t0 = time.perf_counter()
    secs = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in kernels.SOURCES:
        log = kernels.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

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

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    table, dim = _make_tables(ROWS)
    want = _oracle(table)
    q1_want = want      # later phases reuse the name want
    t1 = time.perf_counter()
    joined = table.join(dim, "k", join_type="inner")
    q2_want = joined.group_by("k").aggregate([("w", "sum")]).sort_by("k")
    print(f"pyarrow q2 oracle: {joined.num_rows} joined rows, "
          f"{q2_want.num_rows} groups, {time.perf_counter() - t1:.1f} s")
    filt_expr = (col("v") > THRESHOLD).expr
    aggs = [AggregateExpression(Sum(A("v")), "sv"),
            AggregateExpression(Average(A("f")), "af"),
            AggregateExpression(Count(None), "c")]

    # ---- kernel phase: each kernel against its plain version ----------
    kernel_rows = {}
    try:
        scan = LocalScanExec(table)
        filt = FilterExec(filt_expr, scan)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE, filt)
        batch = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        cap = batch.capacity
        keep = keep_flags(batch, filt._bound.eval(EvalContext(batch)))
        lanes, clear = [], []
        for c in batch.columns:
            lanes += [c.data, c.validity]
            clear += [False, True]
        outs, n_kept = carry.compact_lanes(keep, lanes, clear)
        outs_p, n_plain = carry.compact_lanes_plain(keep, lanes, clear)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(outs, outs_p))
        if n_kept != n_plain or not all(torch.equal(a, b)
                                        for a, b in zip(outs, outs_p)):
            raise AssertionError(f"K1 differs from its plain version "
                                 f"(kept {n_kept} vs {n_plain})")
        lane_bytes = sum(x.element_size() for x in lanes) * cap
        kernel_rows["compact_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/compact.cu",
            replaces="spark_rapids_tpu/ops/carry.py:151",
            max_abs_err=err,
            ms=cuda_ms(lambda: carry.compact_lanes(keep, lanes, clear)),
            plain_ms=cuda_ms(lambda: carry.compact_lanes_plain(keep, lanes,
                                                               clear)),
            library_ms=cuda_ms(lambda: [x[keep] for x in lanes]),
            bound_ms=bound(cap + 2 * lane_bytes))
        print(f"K1 compact_rows: rows {cap}, kept {n_kept}, exact")

        filtered = filt._compute(batch)
        n = filtered.num_rows
        key_cols, val_cols, every = agg._update_columns(filtered)
        words = seg.key_words_for_column(agg_mod._prefix(key_cols[0], n))
        order = carry.sort_order(words)
        order_p = carry.sort_order_plain(words)
        if not torch.equal(order, order_p):
            raise AssertionError("K2 differs from its plain version")
        k2_passes = _k2_passes(carry, words)
        kernel_rows["sort_order"] = dict(
            source="spark_rapids_tpu_torch/csrc/onesweep.cu",
            replaces="spark_rapids_tpu/ops/carry.py:80",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: carry.sort_order(words)),
            plain_ms=cuda_ms(lambda: carry.sort_order_plain(words)),
            # the null word is constant here: one stable sort of the value
            # word gives the same order
            library_ms=cuda_ms(lambda: torch.sort(words[-1], stable=True)),
            bound_ms=bound(8 * len(words) * n + 4 * n))
        print(f"K2 sort_order: rows {n}, words {len(words)}, passes "
              f"{k2_passes}, exact, "
              f"{kernel_rows['sort_order']['ms']:.3f} ms, library "
              f"{kernel_rows['sort_order']['library_ms']:.3f} ms")

        # K2 at the canonical merge's shape: the word list the 8-batch run
        # sorts once it has concatenated the batches' partial results
        merge_agg = GpuHashAggregateExec(
            [A("k")], aggs, COMPLETE,
            FilterExec(filt_expr, LocalScanExec(table,
                                                batch_rows=BATCH_ROWS)))
        merge_words = []
        canonical = merge_agg._canonical_order

        def capture(b):
            merge_words[:] = [w for c in b.columns for w in
                              seg.key_words_for_column(
                                  agg_mod._prefix(c, b.num_rows))]
            return canonical(b)

        merge_agg._canonical_order = capture
        merge_agg.execute_collect(ExecContext(dev))
        if not merge_words:
            raise AssertionError("the 8-batch run made no canonical merge")
        if not torch.equal(carry.sort_order(merge_words),
                           carry.sort_order_plain(merge_words)):
            raise AssertionError("K2 differs at the merge's shape")
        m_passes = _k2_passes(carry, merge_words)
        m_ms = cuda_ms(lambda: carry.sort_order(merge_words))
        m_plain = cuda_ms(lambda: carry.sort_order_plain(merge_words))
        print(f"K2 at the canonical merge's shape: rows "
              f"{merge_words[0].shape[0]}, words {len(merge_words)}, passes "
              f"{m_passes}, exact, {m_ms:.3f} ms, plain {m_plain:.3f} ms")
        del merge_agg, merge_words

        # K3 reads every lane in input order, through K2's order
        vals = [agg_mod._prefix(v, n) for v in val_cols]
        sum_lanes, contribs, _, _, _ = agg_mod.k3_ops(
            vals, agg._update_ops, None, every)
        k3_args = (words, None, sum_lanes, contribs, False, order)
        res = agg_mod.segment_reduce_sorted(*k3_args)
        k3_err = _k3_diff(torch, res, agg_mod.segment_reduce_sorted_plain(
            *k3_args), "at q1's shapes")
        groups = res[3]
        # group ids in input order, for the library yardstick: one
        # index_add_ of each float lane into its group
        sorted_ids = torch.cumsum(seg.segment_boundaries(
            [w.index_select(0, order) for w in words],
            torch.ones(n, dtype=torch.bool, device=dev)), 0) - 1
        ids = torch.empty_like(sorted_ids).index_put_(
            (order.long(),), sorted_ids)
        float_lanes = [x for x in sum_lanes
                       if x is not None and x.dtype == torch.float64]
        distinct = {x.data_ptr(): x for x in sum_lanes + contribs
                    if x is not None}
        in_bytes = (4 + 8 * len(words)) * n + sum(
            x.element_size() * n for x in distinct.values())
        out_bytes = groups * (4 + 8 * len(sum_lanes)
                              + 8 * sum(x is not None for x in sum_lanes))
        k3_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted(*k3_args))
        k3_extra = _k3_turns(torch, agg_mod, cuda_ms, k3_args, card,
                             "at q1's shapes")
        kernel_rows["segment_reduce_sorted"] = dict(
            source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
            replaces="spark_rapids_tpu/exec/aggregate.py:50",
            max_abs_err=k3_err,
            ms=k3_ms,
            plain_ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
                *k3_args)),
            library_ms=cuda_ms(lambda: [torch.zeros(
                groups, dtype=torch.float64, device=dev).index_add_(
                0, ids, x) for x in float_lanes]),
            bound_ms=bound(in_bytes + out_bytes), extra=k3_extra)
        print(f"K3 segment_reduce_sorted: rows {n}, groups {groups}, ints "
              f"exact, float max abs err {k3_err:.3g}, {k3_ms:.3f} ms, "
              f"bound {kernel_rows['segment_reduce_sorted']['bound_ms']:.3f}"
              f" ms ({in_bytes + out_bytes} bytes)")

        # a hot key: 40 % of the rows in one group
        gen = torch.Generator(device=dev).manual_seed(SEED)
        hot_keys = torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.4,
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.randint(0, 100_000, (n,), generator=gen, device=dev))
        hot_words = [words[0], hot_keys]
        hot_args = (hot_words, None, sum_lanes, contribs, False,
                    carry.sort_order(hot_words))
        hot_plain = agg_mod.segment_reduce_sorted_plain(*hot_args)
        for path in K3_PATHS:
            hot = agg_mod.segment_reduce_sorted(*hot_args, path=path)
            _k3_diff(torch, hot, hot_plain, f"on a hot key, path={path}")
        hot = agg_mod.segment_reduce_sorted(*hot_args)
        hot_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted(*hot_args))
        hot_plain_ms = cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
            *hot_args))
        ratio = hot_ms / k3_ms
        print(f"K3 hot key: rows {n}, groups {hot[3]}, largest group "
              f"{int(hot[2][-1].max())} rows: {hot_ms:.3f} ms, plain "
              f"{hot_plain_ms:.3f} ms; uniform keys {k3_ms:.3f} ms; hot / "
              f"uniform {ratio:.3f}")
        if ratio > 2.0:
            raise AssertionError(f"K3 on a hot key takes {ratio:.2f}x its "
                                 "time on uniform keys (at most 2x)")
        # the same input gives the same bits on every run, on either path
        for what, args in (("q1", k3_args), ("hot key", hot_args)):
            for path in K3_PATHS[1:]:
                first = agg_mod.segment_reduce_sorted(*args, path=path)
                for _ in range(2):
                    if not _k3_same_bits(torch, agg_mod.segment_reduce_sorted(
                            *args, path=path), first):
                        raise AssertionError(f"K3 is not deterministic on "
                                             f"{what}, path={path}")
        print("K3 deterministic: on q1 and on the hot key, each path gives "
              "the same bits three runs in a row")
        del first
        del batch, filtered, outs, outs_p, lanes, keep, vals, ids
        del key_cols, val_cols, hot_args, k3_args, sorted_ids
    except Exception:
        failures.append("kernel phase")
        traceback.print_exc()

    try:
        cases = _edge_cases(torch, dev, carry, agg_mod)
        print(f"edge cases: K1, K2, K3 equal their plain versions at "
              f"{cases} sizes from 0 to 100,003 rows")
        cases = _k3_minmax_cases(torch, dev, carry, agg_mod)
        print(f"K3 min/max edge cases: {cases} cases equal the plain "
              f"version, every min and max bit for bit (NaN with two "
              f"payloads, +-inf, -0.0 beside 0.0, INT64_MIN and INT64_MAX, "
              f"BOOLEAN lanes, an all-null group, a global min over no "
              f"rows, one group over 2^22 rows, group ends on tile edges, "
              f"27 ops in two launch sets)")
        tile = kernels.library("onesweep").srt_tile_rows()
        cases = _k2_edge_cases(torch, dev, carry, tile)
        print(f"K2 edge cases: {cases} cases equal the plain version around "
              f"its tile of {tile} rows")
    except Exception:
        failures.append("edge cases")
        traceback.print_exc()

    phase_done("kernel phase: each kernel against its plain version")
    # ---- kernel phase, q2: K6, K4 and K5 against their plain versions --
    q2_pairs = None
    try:
        def upload(tbl):
            return batch_to_device(pa.RecordBatch.from_arrays(
                [c.combine_chunks() for c in tbl.columns],
                names=tbl.column_names), dev)
        fact_b, dim_b = upload(table), upload(dim)
        cap_b, cap_p = dim_b.capacity, fact_b.capacity
        n_b, n_p = dim_b.num_rows, fact_b.num_rows
        bkeys, pkeys = dim_b.columns[:1], fact_b.columns[:1]
        blive = torch.arange(cap_b, device=dev) < n_b
        plive = torch.arange(cap_p, device=dev) < n_p
        # K6 hashes the build side on the main path; the probe side's
        # hashes are checked too, and the probe below is held against
        # them
        bh = jk.combined_key_hash(bkeys, cap_b, side="build")
        ph = jk.combined_key_hash(pkeys, cap_p, side="probe")
        for what, mine, plain in (
                ("build", bh, jk.combined_key_hash_plain(bkeys, cap_b,
                                                         side="build")),
                ("probe", ph, jk.combined_key_hash_plain(pkeys, cap_p,
                                                         side="probe"))):
            if not torch.equal(mine, plain):
                raise AssertionError(f"K6 differs from its plain version on "
                                     f"the {what} side at q2's shapes")
        # per row: the 8 B key, its 1 B validity, the 8 B hash
        k6_bytes = 17 * cap_b
        kernel_rows["key_hash"] = dict(
            source="spark_rapids_tpu_torch/csrc/key_hash.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:43",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.combined_key_hash(bkeys, cap_b,
                                                    side="build")),
            plain_ms=cuda_ms(lambda: jk.combined_key_hash_plain(
                bkeys, cap_b, side="build")),
            # no single PyTorch call computes the hash
            library_ms=None,
            bound_ms=bound(k6_bytes))
        k6_probe_ms = cuda_ms(lambda: jk.combined_key_hash(pkeys, cap_p,
                                                           side="probe"))
        k6_probe_plain_ms = cuda_ms(lambda: jk.combined_key_hash_plain(
            pkeys, cap_p, side="probe"))
        r = kernel_rows["key_hash"]
        print(f"K6 key_hash: build side {cap_b} rows, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k6_bytes} bytes); probe side "
              f"{cap_p} rows (hashed inside K4 on the main path), exact, "
              f"{k6_probe_ms:.3f} ms, plain {k6_probe_plain_ms:.3f} ms, "
              f"bound {bound(17 * cap_p):.3f} ms")

        # K2 and K4's table once per build side, the fused K4 per probe
        # batch
        side = jk.sort_build(bh, blive)
        lo, counts = jk.join_probe(side, pkeys, n_p)
        order = side.order
        for what, plain in (
                ("its plain version",
                 jk.join_probe_keys_plain(side.sorted_hash, pkeys, n_p)),
                ("the searches on K6's probe hashes",
                 jk.join_probe_plain(side.sorted_hash, ph, plive))):
            if not (torch.equal(lo, plain[0]) and torch.equal(counts,
                                                              plain[1])):
                raise AssertionError(f"K4 differs from {what} at q2's "
                                     "shapes")
        if not all(torch.equal(x, y) for x, y in zip(
                (order, lo, counts),
                jk.count_matches_plain(bkeys, n_b, pkeys, n_p))):
            raise AssertionError("K6 + K2 + K4 (count_matches) differ from "
                                 "their plain versions at q2's shapes")

        def k4():
            # the table (one launch a build side) and the probe
            table = jk.hash_table(side.sorted_hash)
            return jk.join_probe(jk.BuildSide(order, side.sorted_hash,
                                              table), pkeys, n_p)
        for _ in range(3):
            if not all(torch.equal(x, y) for x, y in zip(k4(), (lo, counts))):
                raise AssertionError("K4 is not deterministic: a rebuilt "
                                     "table gives other bits")
        print("K4 deterministic: three runs, each with its table rebuilt, "
              "give the same bits")
        slots = int(side.table.shape[0]) // 2
        sw = side.sorted_hash ^ -2**63

        def library():
            # the path K4 replaces: the torch hash composition on the
            # probe side, then two searchsorted
            pw = jk.combined_key_hash_plain(pkeys, cap_p,
                                            side="probe") ^ -2**63
            return (torch.searchsorted(sw, pw),
                    torch.searchsorted(sw, pw, right=True))
        # per probe row: the 8 B key and 1 B validity in, lo 4 B and count
        # 8 B out; per build row its sorted hash 8 B; per slot 16 B
        k4_bytes = 21 * cap_p + 8 * cap_b + 16 * slots
        kernel_rows["join_probe"] = dict(
            source="spark_rapids_tpu_torch/csrc/join_probe.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:73",
            max_abs_err=0.0,
            ms=cuda_ms(k4),
            plain_ms=cuda_ms(lambda: jk.join_probe_keys_plain(
                side.sorted_hash, pkeys, n_p)),
            library_ms=cuda_ms(library),
            bound_ms=bound(k4_bytes),
            table_ms=cuda_ms(lambda: jk.hash_table(side.sorted_hash)),
            probe_ms=cuda_ms(lambda: jk.join_probe(side, pkeys, n_p)),
            probe_rows=cap_p)
        r = kernel_rows["join_probe"]
        print(f"K4 join_probe: probe rows {n_p} (capacity {cap_p}), build "
              f"rows {n_b} (capacity {cap_b}), {slots} slots, exact, "
              f"{r['ms']:.3f} ms (table {r['table_ms']:.3f}, probe "
              f"{r['probe_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
              f"ms ({k4_bytes} bytes)")

        # K7: the running sums of the effective counts, and their total
        ends, q2_pairs = _same_ends(torch, jk, counts, plive, "inner")
        eff = jk.effective_counts(counts, plive, "inner")
        # per probe row: the count 8 B and the live flag 1 B in, the end
        # 8 B out
        k7_bytes = 17 * cap_p
        kernel_rows["expand_ends"] = dict(
            source="spark_rapids_tpu_torch/csrc/expand_ends.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:138",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.expand_ends(counts, plive, "inner")),
            plain_ms=cuda_ms(lambda: jk.expand_ends_plain(counts, plive,
                                                          "inner")),
            # the nearest single call: the scan alone, over effective
            # counts already computed
            library_ms=cuda_ms(lambda: torch.cumsum(eff, 0)),
            bound_ms=bound(k7_bytes))
        r = kernel_rows["expand_ends"]
        print(f"K7 expand_ends: probe rows {n_p} (capacity {cap_p}), total "
              f"{q2_pairs}, exact, {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library (torch.cumsum of the "
              f"effective counts alone) {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k7_bytes} bytes)")
        out_cap = bucket_for(q2_pairs)
        k5_args = (ends, lo, counts, order, q2_pairs, out_cap,
                   fact_b.columns, dim_b.columns)
        res = jk.expand_pairs(*k5_args)
        if not _same_expansion(torch, res, jk.expand_pairs_plain(*k5_args)):
            raise AssertionError("K5 differs from its plain version at q2's "
                                 "shapes")
        bsel = res[1][:q2_pairs].long()
        probe_lanes = [x for c in fact_b.columns for x in (c.data, c.validity)]
        build_lanes = [x for c in dim_b.columns for x in (c.data, c.validity)]

        def library():
            rows = torch.repeat_interleave(torch.arange(cap_p, device=dev),
                                           eff, output_size=q2_pairs)
            return ([x.index_select(0, rows) for x in probe_lanes]
                    + [x.index_select(0, bsel) for x in build_lanes])

        def lane_bytes(lanes, n):
            return sum(x.element_size() for x in lanes) * n
        # in: ends 8 B, lo 4 B, counts 8 B and the probe lanes per probe
        # row, order 4 B and the build lanes per build row; out: the two
        # int32 indices and every lane per output position
        k5_bytes = (20 * cap_p + lane_bytes(probe_lanes, cap_p) + 4 * cap_b
                    + lane_bytes(build_lanes, cap_b) + 8 * out_cap
                    + lane_bytes(probe_lanes + build_lanes, out_cap))
        kernel_rows["expand_pairs"] = dict(
            source="spark_rapids_tpu_torch/csrc/join_expand.cu",
            replaces="spark_rapids_tpu/ops/join_kernels.py:130",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: jk.expand_pairs(*k5_args)),
            plain_ms=cuda_ms(lambda: jk.expand_pairs_plain(*k5_args)),
            library_ms=cuda_ms(library),
            bound_ms=bound(k5_bytes))
        r = kernel_rows["expand_pairs"]
        print(f"K5 expand_pairs: probe rows {n_p} (capacity {cap_p}), build "
              f"rows {n_b} (capacity {cap_b}), pairs {q2_pairs}, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({k5_bytes} bytes)")
        del fact_b, dim_b, bh, ph, side, order, lo, counts, sw, eff, ends
        del res, bsel, probe_lanes, build_lanes, k5_args, bkeys, pkeys
    except Exception:
        failures.append("kernel phase (q2)")
        traceback.print_exc()

    try:
        hot_pairs, hot_cap, hot_args, hot_k4 = _hot_key(
            torch, dev, jk, t, DeviceColumn, bucket_for)
        hot_ms = cuda_ms(lambda: jk.expand_pairs(*hot_args))
        hot_k4_ms = cuda_ms(lambda: jk.join_probe(*hot_k4))
        # the same draw at q2's probe size, so the launch's fixed cost does
        # not decide the time a row
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        big = [DeviceColumn(t.LONG, torch.where(
            torch.rand(ROWS, generator=gen, device=dev) < 0.01,
            torch.full((ROWS,), DIM_ROWS, device=dev),
            torch.randint(0, DIM_ROWS, (ROWS,), generator=gen, device=dev)),
            torch.ones(ROWS, dtype=torch.bool, device=dev))]
        hot_side = hot_k4[0]
        if not all(torch.equal(x, y) for x, y in zip(
                jk.join_probe(hot_side, big, ROWS),
                jk.join_probe_keys_plain(hot_side.sorted_hash, big, ROWS))):
            raise AssertionError(f"K4 differs from its plain version on the "
                                 f"hot key at {ROWS} probe rows")
        big_k4_ms = cuda_ms(lambda: jk.join_probe(hot_side, big, ROWS))
        del hot_args, hot_k4, hot_side, big
        uniform_ms = kernel_rows["expand_pairs"]["ms"]
        ratio = (hot_ms / hot_pairs) / (uniform_ms / q2_pairs)
        print(f"K5 hot key: {HOT_PROBE_ROWS} probe rows, 1 % on a key with "
              f"{HOT_COPIES} build rows: {hot_pairs} pairs (capacity "
              f"{hot_cap}), exact, {hot_ms:.3f} ms, "
              f"{hot_ms / hot_pairs * 1e6:.3f} ns a pair; uniform (q2) "
              f"{uniform_ms / q2_pairs * 1e6:.3f} ns a pair; hot / uniform "
              f"{ratio:.3f}")
        if ratio > 2.0:
            raise AssertionError(f"K5 on a hot key takes {ratio:.2f}x its "
                                 "time a pair on uniform keys (at most 2x)")
        r = kernel_rows["join_probe"]
        uniform_row = r["probe_ms"] / r["probe_rows"]
        for rows, ms in ((HOT_PROBE_ROWS, hot_k4_ms), (ROWS, big_k4_ms)):
            print(f"K4 hot key: {rows} probe rows, 1 % on the hot key, "
                  f"exact, probe {ms:.3f} ms, {ms / rows * 1e6:.4f} ns a "
                  f"probe row; uniform (q2) {uniform_row * 1e6:.4f} ns a "
                  f"probe row; hot / uniform "
                  f"{ms / rows / uniform_row:.3f}")
    except Exception:
        failures.append("hot key (K4, K5)")
        traceback.print_exc()

    try:
        cases = _join_edge_cases(torch, dev, jk, t, DeviceColumn, bucket_for)
        print(f"join edge cases: K6, K6 + K2 + K4 and K5 (inner, left, full) "
              f"equal their plain versions in {cases} cases, each launching "
              f"K6, K4 (with probe rows) and K5")
    except Exception:
        failures.append("join edge cases")
        traceback.print_exc()

    try:
        tile = kernels.library("join_expand").srt_tile_rows()
        cases = _expand_cases(torch, dev, jk, t, DeviceColumn, tile)
        print(f"K7 and K5 tiling cases: {cases} cases equal their plain "
              f"versions (K7 around its tile of "
              f"{kernels.library('expand_ends').srt_tile_rows()} rows; K5 "
              f"around its tile of {tile} merge items, with 40 columns)")
    except Exception:
        failures.append("K7 and K5 tiling cases")
        traceback.print_exc()

    try:
        _wide_group_by(torch, dev, carry, agg_mod, seg, batch_to_device,
                       GpuSession(), F, col)
    except Exception:
        failures.append("K3 wide group-by")
        traceback.print_exc()

    phase_done("kernel phase, q2: K6, K4 and K5 against their plain versions")
    # ---- kernel phase, q3: K2 on the sort words, K8, K9 and K10 --------
    q3_orders = [(A("k"), True, True), (A("v"), True, True)]
    try:
        q3_in = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        n3 = q3_in.num_rows
        words3 = SortExec(q3_orders, LocalScanExec(table)).sort_words(q3_in)
        order3 = carry.sort_order(words3)
        if not torch.equal(order3, carry.sort_order_plain(words3)):
            raise AssertionError("K2 differs from its plain version on q3's "
                                 "sort words")
        q3_passes = _k2_passes(carry, words3)
        print(f"K2 on q3's sort words: rows {n3}, words {len(words3)} "
              f"(padding, k's null word, k, v's null word, v), passes "
              f"{q3_passes}, exact, "
              f"{cuda_ms(lambda: carry.sort_order(words3)):.3f} ms")
        lanes3 = fetch.batch_lanes(q3_in)
        sorted3 = gather_mod.gather_rows(order3, lanes3)
        if not _same_lanes(torch, sorted3,
                           gather_mod.gather_rows_plain(order3, lanes3)):
            raise AssertionError("K8 differs from its plain version at q3's "
                                 "shapes")
        widths3 = [x.element_size() for x in lanes3]
        plan8 = gather_mod.gather_plan(n3, n3, widths3)
        for packed in (False, True):
            if not _same_lanes(torch, gather_mod.gather_rows(
                    order3, lanes3, packed=packed), sorted3):
                raise AssertionError(f"K8 (packed={packed}) differs from "
                                     f"its plain version at q3's shapes")
        k8_bytes = 4 * n3 + 2 * n3 * sum(widths3)
        idx3 = order3.to(torch.int64)
        # the planned path and the other one, in turns
        turns8 = [cuda_ms(lambda p=p: gather_mod.gather_rows(
            order3, lanes3, packed=p))
            for p in (plan8.packed, not plan8.packed) * 2]
        kernel_rows["gather_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/gather_rows.cu",
            replaces="spark_rapids_tpu/ops/carry.py:80",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: gather_mod.gather_rows(order3, lanes3)),
            plain_ms=cuda_ms(lambda: gather_mod.gather_rows_plain(order3,
                                                                  lanes3)),
            library_ms=cuda_ms(lambda: [x.index_select(0, idx3)
                                        for x in lanes3]),
            bound_ms=bound(k8_bytes),
            extra=dict(packed=plan8.packed,
                       scratch_bytes=plan8.scratch_bytes,
                       single_pass_bytes=plan8.single_bytes,
                       record_path_bytes=plan8.packed_bytes,
                       planned_other_in_turns_ms=turns8))
        r = kernel_rows["gather_rows"]
        print(f"K8 gather_rows: rows {n3}, {len(lanes3)} lanes, exact on "
              f"both paths; {'record path' if plan8.packed else 'single pass'}"
              f" {r['ms']:.3f} ms; planned / other in turns "
              f"{', '.join(f'{x:.3f}' for x in turns8)} ms; device-memory "
              f"bytes with a random read as its 32-byte sector: single pass "
              f"{plan8.single_bytes} ({plan8.single_bytes / n3:.0f} B a row, "
              f"{bound(plan8.single_bytes):.3f} ms), record path "
              f"{plan8.packed_bytes} ({plan8.packed_bytes / n3:.0f} B a row, "
              f"{bound(plan8.packed_bytes):.3f} ms); scratch "
              f"{plan8.scratch_bytes} bytes; plain {r['plain_ms']:.3f} ms, "
              f"library (index_select of each lane) {r['library_ms']:.3f} "
              f"ms, bound {r['bound_ms']:.3f} ms ({k8_bytes} bytes); {card}")

        # K9 and K10 on the sorted batch, the one q3's download fetches
        stats3 = fetch.lane_stats(sorted3, n3)
        if not torch.equal(stats3, fetch.lane_stats_plain(sorted3, n3)):
            raise AssertionError("K9 differs from its plain version at q3's "
                                 "shapes")
        reduced = [x for x in sorted3
                   if fetch.lane_kind(x) != fetch.KIND_OTHER]
        k9_bytes = n3 * sum(x.element_size() for x in reduced) \
            + 16 * len(sorted3)

        def k9_library():
            return [torch.all(x) if x.dtype == torch.bool else
                    torch.aminmax(x) for x in reduced]
        kernel_rows["lane_stats"] = dict(
            source="spark_rapids_tpu_torch/csrc/fetch_pack.cu",
            replaces="spark_rapids_tpu/columnar/fetch.py:158",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: fetch.lane_stats(sorted3, n3)),
            plain_ms=cuda_ms(lambda: fetch.lane_stats_plain(sorted3, n3)),
            library_ms=cuda_ms(k9_library),
            bound_ms=bound(k9_bytes))
        r = kernel_rows["lane_stats"]
        print(f"K9 lane_stats: rows {n3}, {len(sorted3)} lanes "
              f"({len(reduced)} reduced), stats {stats3.tolist()}, exact, "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(aminmax and all of each lane) {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({k9_bytes} bytes)")
        plan3, mins3 = fetch.build_plan(sorted3, stats3.tolist())
        packed3 = fetch.pack_lanes(sorted3, plan3, mins3, n3)
        if not torch.equal(packed3, fetch.pack_lanes_plain(sorted3, plan3,
                                                           mins3, n3)):
            raise AssertionError("K10 differs from its plain version at "
                                 "q3's shapes")
        kept = [x for x, st in zip(sorted3, plan3) if st[0] != "skip"]
        k10_bytes = n3 * sum(x.element_size() for x in kept) + \
            packed3.numel()
        kernel_rows["pack_lanes"] = dict(
            source="spark_rapids_tpu_torch/csrc/fetch_pack.cu",
            replaces="spark_rapids_tpu/columnar/fetch.py:346",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: fetch.pack_lanes(sorted3, plan3, mins3, n3)),
            plain_ms=cuda_ms(lambda: fetch.pack_lanes_plain(
                sorted3, plan3, mins3, n3)),
            # no single PyTorch call packs the lanes
            library_ms=None,
            bound_ms=bound(k10_bytes))
        r = kernel_rows["pack_lanes"]
        full = sum(x.element_size() for x in sorted3) * n3
        print(f"K10 pack_lanes: rows {n3}, plan {plan3}, {packed3.numel()} "
              f"bytes packed of {full} in the lanes, exact, {r['ms']:.3f} "
              f"ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k10_bytes} bytes)")
        sorted_batch = DeviceBatch(
            [DeviceColumn(c.dtype, sorted3[2 * i], sorted3[2 * i + 1])
             for i, c in enumerate(q3_in.columns)], n3, q3_in.names)
        got = batch_to_arrow(fetch.fetch_batch(sorted_batch))
        want3 = batch_to_arrow(move_batch(sorted_batch, host,
                                          live_only=True))
        if not all(_same_arrow(a, b) for a, b in zip(got.columns,
                                                     want3.columns)):
            raise AssertionError("fetch_batch differs from move_batch at "
                                 "q3's shapes")
        print("fetch_batch at q3's shapes equals batch_to_arrow(move_batch"
              "(...)) column for column")
        del q3_in, words3, order3, lanes3, sorted3, packed3, sorted_batch
        del got, want3, idx3, reduced, kept
    except Exception:
        failures.append("kernel phase (q3)")
        traceback.print_exc()

    try:
        cases = _k8_edge_cases(torch, dev, gather_mod)
        print(f"K8 edge cases: {cases} cases equal the plain version bit for "
              f"bit on the single pass, the record path and the planned one "
              f"(no rows and no launch, one row, 255-257 and 2^k +- 1 rows, "
              f"permutation, identity, reverse, one source row, repeats "
              f"over longer and shorter lanes, either side of the plan's "
              f"crossover; 12 lane-width mixes from one lane to 40)")
        cases, sizes = _fetch_fuzz(torch, dev, fetch, batch_to_device,
                                   batch_to_arrow, move_batch)
        print(f"fetch fuzz: K9 and K10 equal their plain versions bit for "
              f"bit and fetch_batch equals batch_to_arrow(move_batch(...)) "
              f"in {cases} seeded batches of {min(sizes)} to {max(sizes)} "
              f"rows ({sum(1 for x in sizes if x % 8)} not a multiple of 8)")
    except Exception:
        failures.append("K8, K9 and K10 edge cases")
        traceback.print_exc()

    try:
        sweep3 = _k3_sweep(torch, dev, carry, agg_mod, cuda_ms)
        print("K3 direct path / record path (ms, in turns): " + "; ".join(
            f"{what}, {n} rows, {inputs / 2**20:.0f} MiB of inputs (plan: "
            f"{'records' if p else 'direct'}) {a:.4f} / {b:.4f}, "
            f"{c:.4f} / {d:.4f}"
            for what, n, inputs, p, (a, b, c, d) in sweep3) + f"; {card}")
    except Exception:
        failures.append("K3 sweep")
        traceback.print_exc()

    try:
        sweep8 = _k8_sweep(torch, dev, gather_mod, cuda_ms)
        print("K8 single pass / record path on q3's lanes (ms, in "
              "turns): " + "; ".join(
                  f"{n} of {m} rows (plan: {'record' if p else 'single'}) "
                  f"{a:.4f} / {b:.4f}, {c:.4f} / {d:.4f}"
                  for n, m, p, (a, b, c, d) in sweep8) + f"; {card}")
    except Exception:
        failures.append("K8 sweep")
        traceback.print_exc()

    phase_done("kernel phase, q3: K2 on the sort words, K8, K9 and K10")
    # ---- kernel phase, q4: K11, K12 and K13 at q4's shapes ------------
    def q4_exec(child):
        spec = W.WindowBuilder().partition_by(col("k")).order_by(
            col("v")).spec
        return window_mod.WindowExec(
            [W.WindowExpression(W.RowNumber(), spec, "rn"),
             W.WindowExpression(Sum(A("v")), spec, "rs")], child)

    try:
        q4_in = batch_to_device(pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names), dev)
        n4 = q4_in.num_rows
        lay, pairs4, lanes4 = _q4_layout(torch, window_mod, EvalContext,
                                         q4_exec(LocalScanExec(table)), q4_in)
        # K11 as q4 launches it: seg_start, v's running sum and count
        _same_scan(torch, scan_mod.segment_scan(lay.new_seg, None, pairs4),
                   scan_mod.segment_scan_plain(lay.new_seg, None, pairs4),
                   "at q4's shapes")
        # every output, and a float lane (f in the layout's order)
        f4 = gather_mod.gather_rows(lay.order, [q4_in.columns[2].data])[0]
        full = [pairs4[0], (f4, pairs4[0][1]), (None, pairs4[0][1])]
        k11_err = _same_scan(
            torch, scan_mod.segment_scan(lay.new_seg, lay.new_run, full,
                                         run_start=True, runs_cum=True),
            scan_mod.segment_scan_plain(lay.new_seg, lay.new_run, full,
                                        run_start=True, runs_cum=True),
            "at q4's shapes, every output")
        # flags 1 B, value 8 B, valid 1 B read; seg_start 4 B, sum 8 B,
        # count 4 B written, a row
        k11_bytes = n4 * (1 + 8 + 1 + 4 + 8 + 4)
        sum_lane = pairs4[0][0]
        kernel_rows["segment_scan"] = dict(
            source="spark_rapids_tpu_torch/csrc/window_scan.cu",
            replaces="spark_rapids_tpu/exec/window.py:46",
            max_abs_err=k11_err,
            ms=cuda_ms(lambda: scan_mod.segment_scan(lay.new_seg, None,
                                                     pairs4)),
            plain_ms=cuda_ms(lambda: scan_mod.segment_scan_plain(
                lay.new_seg, None, pairs4)),
            library_ms=cuda_ms(lambda: torch.cumsum(sum_lane, 0)),
            bound_ms=bound(k11_bytes))
        r = kernel_rows["segment_scan"]
        print(f"K11 segment_scan: rows {n4}, {int(lay.new_seg.sum())} "
              f"partitions, {int(lay.new_run.sum())} runs; q4's launch "
              f"(seg_start, one int64 pair: tiles of 8,192 rows, "
              f"{-(-n4 // 8192)} tiles) exact; every output with a "
              f"float lane: ints exact, float max abs err {k11_err:.3g}; "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(torch.cumsum of the sum lane) {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({k11_bytes} bytes); {card}")
        # K11 with one to four pairs at q4's shape (tiles of 8,192,
        # 4,096, 2,048 and 2,048 rows)
        run4 = lay.new_run
        sets11 = [(None, pairs4, {}),
                  (run4, [pairs4[0], full[1]], dict(run_start=True)),
                  (run4, full, dict(run_start=True, runs_cum=True)),
                  (run4, full + [pairs4[0]], dict(runs_cum=True))]
        for a in sets11[1:]:
            _same_scan(torch, scan_mod.segment_scan(lay.new_seg, a[0], a[1],
                                                    **a[2]),
                       scan_mod.segment_scan_plain(lay.new_seg, a[0], a[1],
                                                   **a[2]),
                       f"at q4's shapes, {len(a[1])} pairs")
        pairs_ms = [cuda_ms(lambda a=a: scan_mod.segment_scan(
            lay.new_seg, a[0], a[1], **a[2])) for a in sets11]
        kernel_rows["segment_scan"]["extra"] = dict(
            one_to_four_pairs_ms=pairs_ms)
        print(f"K11 at q4's shape with 1, 2, 3 and 4 pairs (and run "
              f"outputs from 2): {', '.join(f'{x:.3f}' for x in pairs_ms)}"
              f" ms, each equal to the plain version; {card}")
        # K8 as q4's window moves its inputs: k and v with their validity
        lanes8 = [x for c in q4_in.columns[:2] for x in (c.data, c.validity)]
        want8 = gather_mod.gather_rows_plain(lay.order, lanes8)
        plan84 = gather_mod.gather_plan(n4, n4, [x.element_size()
                                                  for x in lanes8])
        for packed in (None, False, True):
            if not _same_lanes(torch, gather_mod.gather_rows(
                    lay.order, lanes8, packed=packed), want8):
                raise AssertionError(f"K8 (packed={packed}) differs from "
                                     f"its plain version at q4's shapes")
        turns84 = [cuda_ms(lambda p=p: gather_mod.gather_rows(
            lay.order, lanes8, packed=p))
            for p in (plan84.packed, not plan84.packed) * 2]
        if "gather_rows" in kernel_rows:
            kernel_rows["gather_rows"]["extra"].update(
                q4_planned_other_in_turns_ms=turns84,
                q4_scratch_bytes=plan84.scratch_bytes)
        print(f"K8 at q4's four lanes (k, v and their validity through the "
              f"window's order): exact on both paths; "
              f"{'record path' if plan84.packed else 'single pass'} / the "
              f"other in turns {', '.join(f'{x:.3f}' for x in turns84)} ms;"
              f" scratch {plan84.scratch_bytes} bytes; {card}")
        del lanes8, want8
        # K12 as q4 launches it: the end of each row's peer run
        for flags in ((None, lay.new_run), (lay.new_seg, lay.new_run)):
            ends = scan_mod.run_ends(*flags, lay.n_live)
            ends_plain = scan_mod.run_ends_plain(*flags, lay.n_live)
            if not all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(ends, ends_plain)):
                raise AssertionError("K12 differs from its plain version at "
                                     "q4's shapes")
        pos4 = torch.arange(n4, dtype=torch.int32, device=dev)
        ends_in = torch.where(
            torch.cat([lay.new_run[1:], torch.ones(1, dtype=torch.bool,
                                                   device=dev)]),
            pos4, torch.full_like(pos4, 2**31 - 1))
        k12_bytes = n4 * (1 + 4)
        kernel_rows["run_ends"] = dict(
            source="spark_rapids_tpu_torch/csrc/window_scan.cu",
            replaces="spark_rapids_tpu/exec/window.py:54",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: scan_mod.run_ends(None, lay.new_run,
                                                 lay.n_live)),
            plain_ms=cuda_ms(lambda: scan_mod.run_ends_plain(
                None, lay.new_run, lay.n_live)),
            library_ms=cuda_ms(lambda: torch.flip(torch.cummin(
                torch.flip(ends_in, [0]), 0).values, [0])),
            bound_ms=bound(k12_bytes))
        r = kernel_rows["run_ends"]
        print(f"K12 run_ends: rows {n4}, run_end (and seg_end) exact; "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
              f"(flip, cummin, flip) {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({k12_bytes} bytes)")
        # K13: rn and rs with their validity back to input order
        back = gather_mod.scatter_rows(lay.order, lanes4)
        if not _same_lanes(torch, back, gather_mod.scatter_rows_plain(
                lay.order, lanes4)):
            raise AssertionError("K13 differs from its plain version at "
                                 "q4's shapes")
        idx4 = lay.order.to(torch.int64)
        outs4 = [torch.empty_like(x) for x in lanes4]
        k13_bytes = 4 * n4 + 2 * n4 * sum(x.element_size() for x in lanes4)
        plan4 = gather_mod.scatter_plan(
            n4, [x.element_size() for x in lanes4])
        if not _same_lanes(torch, gather_mod.scatter_rows(
                lay.order, lanes4, binned=not plan4.binned), back):
            raise AssertionError("K13's other path differs at q4's shapes")
        kernel_rows["scatter_rows"] = dict(
            source="spark_rapids_tpu_torch/csrc/scatter_rows.cu",
            replaces="spark_rapids_tpu/exec/window.py:517",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: gather_mod.scatter_rows(lay.order, lanes4)),
            plain_ms=cuda_ms(lambda: gather_mod.scatter_rows_plain(
                lay.order, lanes4)),
            library_ms=cuda_ms(lambda: [o.index_copy_(0, idx4, x)
                                        for o, x in zip(outs4, lanes4)]),
            bound_ms=bound(k13_bytes),
            extra=dict(binned=plan4.binned, shift=plan4.shift,
                       scratch_bytes=plan4.scratch_bytes,
                       other_path_ms=cuda_ms(lambda: gather_mod.scatter_rows(
                           lay.order, lanes4, binned=not plan4.binned))))
        r = kernel_rows["scatter_rows"]
        print(f"K13 scatter_rows: rows {n4}, {len(lanes4)} lanes "
              f"({', '.join(str(x.dtype) for x in lanes4)}), exact on both "
              f"paths; {'binned' if plan4.binned else 'single pass'} "
              f"(256 buckets of 2^{plan4.shift} destinations, "
              f"{plan4.scratch_bytes} bytes of scratch) {r['ms']:.3f} ms, "
              f"the {'single pass' if plan4.binned else 'binned path'} "
              f"{r['extra']['other_path_ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library (index_copy_ of each lane) "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({k13_bytes} bytes); {card}")
        del q4_in, lay, pairs4, lanes4, f4, full, sum_lane, back, idx4
        del run4, sets11, a
        del outs4, pos4, ends_in, ends, ends_plain
    except Exception:
        failures.append("kernel phase (q4)")
        traceback.print_exc()

    try:
        # where the single pass stops winning: q4's lanes at sizes around
        # the 48 MiB window (2^22 rows write 52 MiB)
        gen13 = torch.Generator(device=dev).manual_seed(SEED + 14)
        sweep = []
        for n in (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24):
            order = torch.randperm(n, generator=gen13, device=dev).to(
                torch.int32)
            lanes = [torch.randint(-2**31, 2**31 - 1, (n,), generator=gen13,
                                   device=dev, dtype=torch.int32),
                     torch.randint(-2**62, 2**62, (n,), generator=gen13,
                                   device=dev),
                     torch.rand(n, generator=gen13, device=dev) < 0.5]
            sweep.append((n, *(cuda_ms(lambda: gather_mod.scatter_rows(
                order, lanes, binned=b)) for b in (False, True, False,
                                                   True))))
            del order, lanes
        print("K13 single pass / binned at q4's lanes (ms, in turns): " +
              "; ".join(f"{n} rows {a:.3f} / {b:.3f}, {c:.3f} / {d:.3f}"
                        for n, a, b, c, d in sweep) + f"; {card}")
    except Exception:
        failures.append("K13 window sweep")
        traceback.print_exc()

    try:
        cases = _k13_cases(torch, dev, gather_mod)
        print(f"K13 edge cases: {cases} cases equal the plain version on "
              f"the single pass, the binned path and the planned one (n = "
              f"1, 255-257, 512 and 513, 3,071-3,073, 2^20 and 2^20 + 1, "
              f"{K13_BINNED_FROM - 1} and {K13_BINNED_FROM} (the single "
              f"pass's last n at q4's lanes and the binned path's first); "
              f"random, identity and reversed orders; q4's lanes, one "
              f"int32 lane, 16 mixed lanes)")
    except Exception:
        failures.append("K13 edge cases")
        traceback.print_exc()

    try:
        cases = _window_kernel_cases(torch, dev, scan_mod, gather_mod)
        print(f"K11, K12 and K13 edge cases: {cases} cases equal the plain "
              f"versions (ints exactly, floats to {FLOAT_RTOL:g}): n = 1, "
              f"n either side of the 2,048-, 4,096- and 8,192-row tiles, "
              f"one partition over 2^22 rows and over the tile edges, all "
              f"rows tied, every row its own partition, padding at the "
              f"tail, one, two, three and five pairs")
    except Exception:
        failures.append("K11, K12 and K13 edge cases")
        traceback.print_exc()

    try:
        # each wrapper's time for one row: its launch floor, beside which
        # the rows of K6, K12 and K15 are read
        one = torch.ones(1, dtype=torch.bool, device=dev)
        key1 = DeviceColumn(t.LONG, torch.zeros(1, dtype=torch.int64,
                                                device=dev), one)
        offs1 = torch.tensor([0, 3], dtype=torch.int32, device=dev)
        chars1 = torch.tensor([97, 98, 99], dtype=torch.uint8, device=dev)
        seed1 = torch.full((1,), 42, dtype=torch.int64, device=dev)
        floors = {
            "K6 key_hash": cuda_ms(lambda: jk.combined_key_hash([key1], 1)),
            "K12 run_ends": cuda_ms(lambda: scan_mod.run_ends(one, None,
                                                              1)),
            "K15 hash_bytes": cuda_ms(lambda: hashfns_mod.hash_bytes(
                offs1, chars1, seed1))}
        print("launch floor, one row through each wrapper (ms): " +
              ", ".join(f"{k} {v:.4f}" for k, v in floors.items()) +
              f"; {card}")
        del one, key1, offs1, chars1, seed1
    except Exception:
        failures.append("launch floor")
        traceback.print_exc()

    phase_done("kernel phase, q4: K11, K12 and K13 at q4's shapes")
    # ---- main path: DataFrame API, one batch -------------------------
    wrappers = {"compact_rows": carry.compact_lanes,
                "sort_order": carry.sort_order,
                "segment_reduce_sorted": agg_mod.segment_reduce_sorted,
                "key_hash": jk.combined_key_hash,
                "hash_table": jk.hash_table,
                "join_probe": jk.join_probe,
                "expand_ends": jk.expand_ends,
                "expand_pairs": jk.expand_pairs,
                "gather_rows": gather_mod.gather_rows,
                "lane_stats": fetch.lane_stats,
                "pack_lanes": fetch.pack_lanes,
                "segment_scan": scan_mod.segment_scan,
                "run_ends": scan_mod.run_ends,
                "scatter_rows": gather_mod.scatter_rows,
                "string_hashes": sops.string_hashes,
                "hash_bytes": hashfns_mod.hash_bytes,
                "gather_strings": sops.gather_strings,
                "order_keys": sops.order_keys,
                "span_rows": gather_mod.span_rows,
                "string_find": sops.string_find,
                "utf8_cut": sops.utf8_cut,
                "string_map": sops.string_map,
                "date_fields": dates_mod.date_fields,
                "frame_pick": scan_mod.frame_pick}

    def download_fetched(b):
        return batch_to_arrow(fetch.fetch_batch(b))

    def count_reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    launches = {}
    try:
        session = GpuSession()
        df = (session.create_dataframe(table)
              .filter(col("v") > THRESHOLD)
              .group_by(col("k"))
              .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                   F.count("*").alias("c")))
        t1 = time.perf_counter()
        cold = df.collect()
        cold_wall = time.perf_counter() - t1
        _check_q1(cold, want, "DataFrame q1 (cold)")
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["dataframe"] = counts()
        _check_q1(got, want, "DataFrame q1")
        print(f"main path DataFrame q1 (1 batch of {ROWS} rows): cold wall "
              f"{cold_wall * 1e3:.1f} ms (upload included); warm wall "
              f"{wall * 1e3:.1f} ms (batch kept on the device), "
              f"{ROWS / wall / 1e6:.1f} M rows/s, {got.num_rows} groups, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches['dataframe']}")
    except Exception:
        failures.append("main path (DataFrame)")
        traceback.print_exc()

    phase_done("main path: DataFrame API, one batch")
    # ---- where the time goes: one batch, stage by stage ---------------
    try:
        scan = LocalScanExec(table)
        filt = FilterExec(filt_expr, scan)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE, filt)
        rb = pa.RecordBatch.from_arrays(
            [c.combine_chunks() for c in table.columns],
            names=table.column_names)
        for _ in range(2):                 # the second pass is reported
            stages, val = {}, None
            t1 = time.perf_counter()
            for name, step in (
                    ("upload", lambda _: batch_to_device(rb, dev)),
                    ("filter", filt._compute),
                    ("update", agg._update_batch),
                    ("evaluate", agg._evaluate_batch),
                    ("download", download_fetched)):
                val = step(val)
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("stages (ms): " + " ".join(f"{k}={v:.2f}"
                                         for k, v in stages.items()))
        evaluated = agg._evaluate_batch(agg._update_batch(filt._compute(
            batch_to_device(rb, dev))))
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, evaluated)
        print(f"q1 download (ms): {_split_line(split)}; {nbytes} bytes "
              f"packed, plan {plan}")
        del val, evaluated
        trace = _profile(torch, df.collect)
        print(f"trace of a warm DataFrame q1: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"])
              + f"; torch gather kernels {trace['gather_ms']:.3f} ms")
    except Exception:
        failures.append("stage split")
        traceback.print_exc()

    phase_done("where the time goes: one batch, stage by stage")
    # ---- main path: exec level, 8 batches ------------------------------
    try:
        scan = LocalScanExec(table, batch_rows=BATCH_ROWS)
        agg = GpuHashAggregateExec([A("k")], aggs, COMPLETE,
                                   FilterExec(filt_expr, scan))
        _check_q1(agg.execute_collect(ExecContext(dev)), want,
                  "exec q1 (cold)")
        count_reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = agg.execute_collect(ExecContext(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["batches"] = counts()
        _check_q1(got, want, "exec q1 (8 batches)")
        print(f"main path exec q1 ({ROWS // BATCH_ROWS} batches of "
              f"{BATCH_ROWS} rows): warm wall {wall * 1e3:.1f} ms, "
              f"{ROWS / wall / 1e6:.1f} M rows/s, launches "
              f"{launches['batches']}")
    except Exception:
        failures.append("main path (8 batches)")
        traceback.print_exc()

    phase_done("main path: exec level, 8 batches")
    # ---- main path: q2 through the DataFrame API ----------------------
    def check_q2(got, what):
        got = got.sort_by("k")
        if got.column_names != ["k", "sw"]:
            raise AssertionError(f"{what}: columns {got.column_names}")
        if got.num_rows != q2_want.num_rows or not np.array_equal(
                got["k"].to_numpy(), q2_want["k"].to_numpy()):
            raise AssertionError(f"{what}: {got.num_rows} groups, oracle "
                                 f"{q2_want.num_rows}, or other keys")
        sw, ww = got["sw"].to_numpy(), q2_want["w_sum"].to_numpy()
        if not np.all(np.isfinite(sw)) or not np.allclose(
                sw, ww, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"{what}: sum(w) differs by up to "
                                 f"{np.max(np.abs(sw - ww))}")

    q2_session = q2df = None
    try:
        q2_session = GpuSession()
        q2df = (q2_session.create_dataframe(table)
                .join(q2_session.create_dataframe(dim), on="k", how="inner")
                .group_by(col("k"))
                .agg(F.sum(col("w")).alias("sw")))
        t1 = time.perf_counter()
        check_q2(q2df.collect(), "DataFrame q2 (cold)")
        cold_wall = time.perf_counter() - t1
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q2df.collect()
        torch.cuda.synchronize()
        launches["q2"] = counts()
        check_q2(got, "DataFrame q2")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q2df.collect()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        print(f"main path DataFrame q2 ({ROWS} fact rows joined with "
              f"{DIM_ROWS} dimension rows, then grouped by k): cold wall "
              f"{cold_wall * 1e3:.1f} ms (upload included); warm wall median "
              f"of 3 {sorted(walls)[1]:.1f} ms ({', '.join(f'{w:.1f}' for w in walls)}), "
              f"{ROWS / sorted(walls)[1] / 1e3:.1f} M fact rows/s, "
              f"{got.num_rows} groups, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches['q2']}")
        # the hash join alone, at exec level
        join = HashJoinExec([A("k")], [A("k")], "inner", None,
                            LocalScanExec(table), LocalScanExec(dim))
        out = join.execute_collect(ExecContext(dev))
        if out.num_rows != joined.num_rows:
            raise AssertionError(f"exec-level join: {out.num_rows} rows, "
                                 f"pyarrow {joined.num_rows}")
        if pc.sum(out["v"]).as_py() != pc.sum(joined["v"]).as_py():
            raise AssertionError("exec-level join: sum(v) differs")
        sw_got, sw_want = pc.sum(out["w"]).as_py(), pc.sum(joined["w"]).as_py()
        if not np.isclose(sw_got, sw_want, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"exec-level join: sum(w) {sw_got} vs "
                                 f"{sw_want}")
        print(f"exec-level HashJoinExec inner: {out.num_rows} rows, sum(v) "
              f"exact, sum(w) within {FLOAT_RTOL:g}")
        del out, join
    except Exception:
        failures.append("main path (q2)")
        traceback.print_exc()

    phase_done("main path: q2 through the DataFrame API")
    # ---- where q2's time goes: stage by stage, and a trace -------------
    try:
        by_name = {}
        q2_session.last_plan.foreach(
            lambda e: by_name.setdefault(type(e).__name__, e))
        agg_q2 = by_name["GpuHashAggregateExec"]
        project = by_name["ProjectExec"]
        join = by_name["HashJoinExec"]
        ctx = ExecContext(dev)
        probe = next(iter(join.children[0].execute_partition(0, ctx)))
        build = join._collect_build(ctx)
        for _ in range(2):                 # the second pass is reported
            stages, st = {}, {}
            t1 = time.perf_counter()

            def count():
                st["order"], st["lo"], st["counts"], st["plive"] = \
                    join._count(st["side"], probe)

            def expand():
                st["out"], _ = join._expand(build, probe, st["order"],
                                            st["lo"], st["counts"],
                                            st["plive"], "inner")

            for name, step in (
                    ("hash", lambda: st.update(
                        hashes=join._hash_keys(build))),
                    ("build", lambda: st.update(
                        side=jk.sort_build(*st["hashes"]))),
                    ("count", count),
                    ("expand", expand),
                    ("project", lambda: st.update(
                        out=project._compute(st["out"]))),
                    ("update", lambda: st.update(
                        out=agg_q2._update_batch(st["out"]))),
                    ("evaluate", lambda: st.update(
                        out=agg_q2._evaluate_batch(st["out"]))),
                    ("download", lambda: st.update(
                        ev=st["out"], out=download_fetched(st["out"])))):
                step()
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        print("q2 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items()))
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, st["ev"])
        print(f"q2 download (ms): {_split_line(split)}; {nbytes} bytes "
              f"packed, plan {plan}")
        del st, probe, build
        trace = _profile(torch, q2df.collect)
        print(f"trace of a warm DataFrame q2: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        before = trace["before_probe"]
        print(f"q2 trace, device work before K4's probe in launch order: "
              f"{len(before)} items, {sum(ms for _, ms in before):.3f} ms, "
              f"the longest {max((ms for _, ms in before), default=0):.3f} "
              f"ms: " + ", ".join(f"{n}={ms:.3f}" for n, ms in before))
    except Exception:
        failures.append("q2 stage split")
        traceback.print_exc()

    phase_done("where q2's time goes: stage by stage, and a trace")
    # ---- main path: q6 (4-partition fact, 2-partition dimension) -----
    q6_plan = ["DeviceToHostExec", "CoalesceBatchesExec",
               "GpuHashAggregateExec", "CoalesceBatchesExec", "ProjectExec",
               "BroadcastHashJoinExec", "CoalesceBatchesExec",
               "GatherPartitionsExec", "LocalScanExec",
               "BroadcastExchangeExec", "LocalScanExec"]
    try:
        q6_session = GpuSession()
        q6df = (q6_session.create_dataframe(table, num_partitions=4)
                .join(q6_session.create_dataframe(dim, num_partitions=2),
                      on="k", how="inner")
                .group_by(col("k"))
                .agg(F.sum(col("w")).alias("sw")))
        t1 = time.perf_counter()
        check_q2(q6df.collect(), "DataFrame q6 (cold)")
        cold_wall = time.perf_counter() - t1
        nodes = _placements(q6_session.last_plan)
        if [n for n, _ in nodes] != q6_plan:
            raise AssertionError(f"q6 planned {[n for n, _ in nodes]}")
        if nodes[0][1] != "cpu" or any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"q6 placements {nodes}")
        if "!" in q6_session.last_explain:
            raise AssertionError("q6 explain has a CPU fallback:\n"
                                 + q6_session.last_explain)
        print("q6 converted plan (* = GPU):\n"
              + q6_session.last_plan.tree_string())
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q6df.collect()
        torch.cuda.synchronize()
        launches["q6"] = counts()
        check_q2(got, "DataFrame q6")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q6df.collect()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        print(f"main path DataFrame q6 ({ROWS} fact rows in 4 partitions "
              f"joined with {DIM_ROWS} dimension rows in 2, then grouped "
              f"by k): cold wall {cold_wall * 1e3:.1f} ms (upload "
              f"included); warm walls {', '.join(f'{w:.1f}' for w in walls)}"
              f" ms, median {sorted(walls)[1]:.1f}, {got.num_rows} groups, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"probe batches {launches['q6']['join_probe']}, launches "
              f"{launches['q6']}")
        # each probe batch's round: K4's count, the host read, K7 and K5
        by_name = {}
        q6_session.last_plan.foreach(
            lambda e: by_name.setdefault(type(e).__name__, e))
        join = by_name["BroadcastHashJoinExec"]
        ctx = ExecContext(dev, q6_session.conf)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probes = list(join.children[0].execute_partition(0, ctx))
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t1) * 1e3
        build = join._collect_build(ctx)
        side = jk.sort_build(*join._hash_keys(build))
        rounds = []
        for _ in range(2):                 # the second pass is reported
            rounds = []
            for probe in probes:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                order, lo, cnts, plive = join._count(side, probe)
                out, _ = join._expand(build, probe, order, lo, cnts, plive,
                                      "inner")
                torch.cuda.synchronize()
                rounds.append((probe.num_rows, out.num_rows,
                               (time.perf_counter() - t1) * 1e3))
                del out
        print(f"q6 probe side: {len(probes)} coalesced batches from 4 "
              f"partitions in {gather_ms:.2f} ms (gather and coalesce of the "
              f"device-resident partitions, target "
              f"{basic_mod.TARGET_ROWS} rows); rounds "
              f"(count -> host read -> expand): "
              + ", ".join(f"{p} probe rows -> {o} rows {ms:.2f} ms"
                          for p, o, ms in rounds))
        del probes, build, side, join, by_name
        trace = _profile(torch, q6df.collect)
        print(f"trace of a warm DataFrame q6: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q6df, q6_session
    except Exception:
        failures.append("main path (q6)")
        traceback.print_exc()

    phase_done("main path: q6 (4-partition fact, 2-partition dimension)")
    # ---- main path: q1 over 4 partitions --------------------------------
    try:
        s4 = GpuSession()
        df4 = (s4.create_dataframe(table, num_partitions=4)
               .filter(col("v") > THRESHOLD)
               .group_by(col("k"))
               .agg(F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
                    F.count("*").alias("c")))
        _check_q1(df4.collect(), want, "DataFrame q1, 4 partitions (cold)")
        nodes = _placements(s4.last_plan)
        if nodes[0] != ("DeviceToHostExec", "cpu") or \
                any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"q1 over 4 partitions placed {nodes}")
        count_reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = df4.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["q1_4"] = counts()
        _check_q1(got, want, "DataFrame q1, 4 partitions")
        print(f"main path DataFrame q1 (4 partitions of {ROWS // 4} rows): "
              f"warm wall {wall * 1e3:.1f} ms, plan "
              f"{[n for n, _ in nodes]}, launches {launches['q1_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q1, 4 partitions)")
        traceback.print_exc()

    def timed_walls(fn, reps=3):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        return walls

    phase_done("main path: q1 over 4 partitions")
    # ---- main path: q1x, the TPC-H Q1 shape, one partition and four ---
    q1x_want = None
    try:
        t1 = time.perf_counter()
        q1x_want = _q1x_oracle(table)
        print(f"numpy q1x oracle: {sum(r['c'] for r in q1x_want)} rows "
              f"kept in 6 groups of {min(r['c'] for r in q1x_want)} to "
              f"{max(r['c'] for r in q1x_want)} rows, "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            sx = GpuSession()
            dfx = _q1x_df(sx, table, parts, F, col, lit)
            t1 = time.perf_counter()
            _check_q1x(dfx.collect(), q1x_want,
                       f"q1x over {parts} partitions (cold)")
            cold_wall = time.perf_counter() - t1
            nodes = _placements(sx.last_plan)
            if nodes[0] != ("DeviceToHostExec", "cpu") or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sx.last_explain:
                raise AssertionError(f"q1x over {parts} partitions placed "
                                     f"{nodes}:\n{sx.last_explain}")
            run = "q1x" if parts == 1 else "q1x_4"
            count_reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            got = dfx.collect()
            torch.cuda.synchronize()
            launches[run] = counts()
            _check_q1x(got, q1x_want, f"q1x over {parts} partitions")
            walls = timed_walls(dfx.collect)
            trace = _profile(torch, dfx.collect)
            print(f"main path DataFrame q1x ({ROWS} rows in {parts} "
                  f"partition(s): filter f <= 0.98 and v is not null, "
                  f"project k % 3, CASE WHEN, Q1's price arithmetic, group "
                  f"by (rf, ls): 3 sums, 2 averages, count, min and max of "
                  f"disc and v, sort): plan {[n for n, _ in nodes]}, "
                  f"GPU-only; equals the numpy oracle (ints, counts, min "
                  f"and max exactly, float sums and averages to "
                  f"{FLOAT_RTOL:g}); cold wall {cold_wall * 1e3:.1f} ms; "
                  f"warm walls {', '.join(f'{w:.1f}' for w in walls)} ms, "
                  f"median {sorted(walls)[1]:.1f}; peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {launches[run]}; {card}")
            print(f"trace of a warm q1x over {parts} partition(s): wall "
                  f"{trace['wall_ms']:.2f} ms, device busy "
                  f"{trace['busy_ms']:.2f} ms, idle share "
                  f"{trace['idle_share']:.3f}; top kernels (ms): "
                  + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"])
                  + f"; {card}")
            if parts == 1:
                # K3 with the min and max ops at q1x's shapes: the
                # aggregate's update over the projected batch
                by_name = {}
                sx.last_plan.foreach(
                    lambda e: by_name.setdefault(type(e).__name__, e))
                aggx = by_name["GpuHashAggregateExec"]
                ctx = ExecContext(dev, sx.conf)
                inx = next(iter(aggx.children[0].execute_partition(0, ctx)))
                nx = inx.num_rows
                kx, vx, ex = aggx._update_columns(inx)
                wx = [w for c in kx for w in seg.key_words_for_column(
                    agg_mod._prefix(c, nx))]
                ox = carry.sort_order(wx)
                lx, cx, opsx, _, _ = agg_mod.k3_ops(
                    [agg_mod._prefix(c, nx) for c in vx], aggx._update_ops,
                    None, ex)
                x_args = (wx, None, lx, cx, False, ox, opsx)
                res = agg_mod.segment_reduce_sorted(*x_args)
                plain = agg_mod.segment_reduce_sorted_plain(*x_args)
                x_err = 0.0
                _k3_minmax_diff(torch, res, plain, opsx, "at q1x's shapes")
                for sv_, sp_, op in zip(res[1], plain[1], opsx):
                    if op == "sum" and sv_ is not None and \
                            sv_.dtype == torch.float64:
                        x_err = max(x_err, float((sv_ - sp_).abs().max()))
                mm = [k for k, op in enumerate(opsx) if op in ("min", "max")]
                ids_sorted = torch.cumsum(seg.segment_boundaries(
                    [w.index_select(0, ox) for w in wx],
                    torch.ones(nx, dtype=torch.bool, device=dev)), 0) - 1
                idsx = torch.empty_like(ids_sorted).index_put_(
                    (ox.long(),), ids_sorted)
                gx = res[3]

                def mm_library():
                    return [torch.full((gx,), 0, dtype=lx[k].dtype,
                                       device=dev).scatter_reduce_(
                        0, idsx, lx[k], "amin" if opsx[k] == "min"
                        else "amax", include_self=False) for k in mm]
                distinct = {x.data_ptr(): x for x in lx + cx
                            if x is not None}
                in_bytes = (4 + 8 * len(wx)) * nx + sum(
                    x.element_size() * nx for x in distinct.values())
                out_bytes = gx * (4 + 8 * len(lx)
                                  + 8 * sum(x is not None for x in lx))
                kernel_rows["segment_reduce_sorted_minmax"] = dict(
                    source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
                    replaces="spark_rapids_tpu/ops/segmented.py:251",
                    max_abs_err=x_err,
                    ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted(
                        *x_args)),
                    plain_ms=cuda_ms(
                        lambda: agg_mod.segment_reduce_sorted_plain(
                            *x_args)),
                    library_ms=cuda_ms(mm_library),
                    bound_ms=bound(in_bytes + out_bytes),
                    extra=_k3_turns(torch, agg_mod, cuda_ms, x_args, card,
                                    "with min/max at q1x's shapes"))
                r = kernel_rows["segment_reduce_sorted_minmax"]
                print(f"K3 with min/max at q1x's shapes: rows {nx}, groups "
                      f"{gx}, {len(opsx)} ops ({', '.join(opsx)}), key "
                      f"words {len(wx)}; min and max bit for bit, float "
                      f"sums max abs err {x_err:.3g}; {r['ms']:.3f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, library "
                      f"(scatter_reduce amin/amax of the {len(mm)} min/max "
                      f"lanes) {r['library_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.3f} ms ({in_bytes + out_bytes} "
                      f"bytes); {card}")
                del by_name, aggx, inx, kx, vx, wx, ox, lx, cx, res, plain
                del ids_sorted, idsx, distinct
            del dfx, sx, got
    except Exception:
        failures.append("main path (q1x)")
        traceback.print_exc()
    q1x_want = None

    phase_done("main path: q1x, the TPC-H Q1 shape, one partition and four")
    # ---- main path: q3, the global sort, through the DataFrame API -----

    q3_want = None
    try:
        t1 = time.perf_counter()
        q3_want = table.sort_by([("k", "ascending"), ("v", "ascending")])
        ks, vs = q3_want["k"].to_numpy(), q3_want["v"].to_numpy()
        ties = int(np.sum((ks[1:] == ks[:-1]) & (vs[1:] == vs[:-1])))
        print(f"pyarrow q3 oracle: {q3_want.num_rows} rows sorted by (k, v) "
              f"in {time.perf_counter() - t1:.1f} s; {ties} rows tie with "
              f"the row before on (k, v), so f's order checks stability")
        del ks, vs
        # the direct collect (every lane fetched); the host-assisted
        # collect, the default, is the "q3 both ways" phase below
        q3_session = GpuSession(conf={COLLECT_KEY: False})
        q3df = q3_session.create_dataframe(table).sort(col("k"), col("v"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = q3df.collect()
        cold_wall = time.perf_counter() - t1
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3 (cold) differs from pyarrow's "
                                 "sort")
        nodes = _placements(q3_session.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("SortExec", "gpu"),
                     ("LocalScanExec", "gpu")] or \
                "!" in q3_session.last_explain:
            raise AssertionError(f"q3 planned {nodes}:\n"
                                 + q3_session.last_explain)
        count_reset()
        carry.sort_order.passes = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q3df.collect()
        torch.cuda.synchronize()
        launches["q3"] = counts()
        q3_run_passes = carry.sort_order.passes
        peak = torch.cuda.max_memory_allocated()
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3 differs from pyarrow's sort")
        for name, want_n in (("lane_stats", 1), ("pack_lanes", 1)):
            if launches["q3"][name] != want_n:
                raise AssertionError(f"{name} launched "
                                     f"{launches['q3'][name]} times on q3, "
                                     f"not {want_n}")
        del got
        walls = timed_walls(q3df.collect)
        wall = sorted(walls)[1]
        print(f"main path DataFrame q3, direct collect ({ROWS} rows, sort "
              f"by k, v -> collect): plan {[n for n, _ in nodes]}, GPU-only, one "
              f"DeviceToHostExec; equals pyarrow's sort exactly (k, v, f); "
              f"cold wall {cold_wall * 1e3:.1f} ms (upload included); warm "
              f"walls {', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{wall:.1f}, {ROWS / wall / 1e3:.1f} M rows/s; peak "
              f"{peak / 2**30:.2f} GiB; K2 passes {q3_run_passes}; launches "
              f"{launches['q3']}")

        # where q3's time goes: stage by stage, then a trace
        scan3 = LocalScanExec(table)
        sorter = SortExec(q3_orders, scan3)
        batch3 = next(scan3.execute_partition(0, ExecContext(dev)))
        for _ in range(2):                 # the second pass is reported
            stages, st = {}, {}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for name, step in (
                    ("words", lambda: st.update(
                        words=sorter.sort_words(batch3))),
                    ("K2", lambda: st.update(
                        order=carry.sort_order(st["words"]))),
                    ("K8", lambda: st.update(lanes=gather_mod.gather_rows(
                        st["order"], fetch.batch_lanes(batch3))))):
                step()
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t1) * 1e3
                t1 = now
        sorted3 = DeviceBatch(
            [DeviceColumn(c.dtype, st["lanes"][2 * i], st["lanes"][2 * i + 1])
             for i, c in enumerate(batch3.columns)], batch3.num_rows,
            batch3.names)
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, sorted3)
        # the host rebuild's floor: fresh host pages for the three lanes
        t1 = time.perf_counter()
        touched = [torch.empty(batch3.num_rows, dtype=c.data.dtype).fill_(0)
                   for c in batch3.columns]
        touch_ms = (time.perf_counter() - t1) * 1e3
        full = sum(x.element_size() for x in fetch.batch_lanes(batch3)) \
            * batch3.num_rows
        print("q3 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items())
              + f"; download {_split_line(split)}; packed {nbytes} of "
              f"{full} lane bytes, copy {nbytes / split['copy'] / 1e6:.1f} "
              f"GB/s; plan {plan}; first touch of {len(touched)} fresh "
              f"host lanes of {batch3.num_rows} rows {touch_ms:.2f} ms")
        del st, batch3, scan3, sorter, touched, sorted3
        trace = _profile(torch, q3df.collect)
        print(f"trace of a warm DataFrame q3 (direct collect): wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q3df, q3_session
    except Exception:
        failures.append("main path (q3)")
        traceback.print_exc()

    phase_done("main path: q3, the global sort, through the DataFrame API")
    # ---- main path: q3 over 4 partitions -------------------------------
    try:
        if q3_want is None:
            raise AssertionError("no q3 oracle")
        s4 = GpuSession(conf={COLLECT_KEY: False})
        df4 = s4.create_dataframe(table, num_partitions=4).sort(col("k"),
                                                                col("v"))
        if not _same_table(df4.collect(), q3_want):
            raise AssertionError("DataFrame q3, 4 partitions (cold) differs "
                                 "from pyarrow's sort")
        nodes = _placements(s4.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("SortExec", "gpu"),
                     ("GatherPartitionsExec", "gpu"),
                     ("LocalScanExec", "gpu")] or "!" in s4.last_explain:
            raise AssertionError(f"q3 over 4 partitions planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = df4.collect()
        torch.cuda.synchronize()
        launches["q3_4"] = counts()
        if not _same_table(got, q3_want):
            raise AssertionError("DataFrame q3, 4 partitions, differs from "
                                 "pyarrow's sort")
        del got
        walls = timed_walls(df4.collect)
        print(f"main path DataFrame q3, direct collect (4 partitions of "
              f"{ROWS // 4} rows): "
              f"range exchange stripped, plan {[n for n, _ in nodes]}; "
              f"equals pyarrow's sort; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q3_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q3, 4 partitions)")
        traceback.print_exc()

    phase_done("main path: q3 over 4 partitions")
    # ---- q3 both ways: the host-assisted collect and the direct --------
    try:
        if q3_want is None:
            raise AssertionError("no q3 oracle")
        for parts in (1, 4):
            tag = "" if parts == 1 else f"_{parts}"
            sd = GpuSession(conf={COLLECT_KEY: False})
            sa = GpuSession(conf={COLLECT_KEY: True})
            dfd = sd.create_dataframe(table, num_partitions=parts).sort(
                col("k"), col("v"))
            dfa = sa.create_dataframe(table, num_partitions=parts).sort(
                col("k"), col("v"))
            for way, df_ in (("direct", dfd), ("host-assisted", dfa)):
                with _Capture(carry, "gather_rows") as cap8, \
                        _Capture(fetch, "lane_stats", "pack_lanes") as cap9:
                    if not _same_table(df_.collect(), q3_want):   # cold
                        raise AssertionError(f"q3 over {parts} partitions, "
                                             f"{way} (cold), differs from "
                                             f"pyarrow's sort")
            # the assisted run's K8 (k, v, rid), K9 and K10 (the rid
            # lane) against their plain versions on the same inputs
            seen = []
            for cap in (cap8, cap9):
                seen += _check_captured(torch, cap, carry, gather_mod, fetch,
                                        f"q3 host-assisted x{parts}")
            del cap8, cap9
            print(f"q3 host-assisted over {parts} partition(s), kernels on "
                  f"the path's own inputs, each exact against its plain "
                  f"version: {'; '.join(seen)}")
            count_reset()
            torch.cuda.synchronize()
            with _FetchTap(fetch) as tap:
                got = dfa.collect()
            torch.cuda.synchronize()
            launches["q3_assisted" + tag] = counts()
            if not _same_table(got, q3_want):
                raise AssertionError(f"q3 over {parts} partitions, "
                                     f"host-assisted, differs from "
                                     f"pyarrow's sort")
            del got
            nodes = [n for n, _ in _placements(sa.last_plan)]
            want_nodes = ["DeviceToHostExec", "CoalesceBatchesExec",
                          "ProjectExec", "SortExec"] + (
                ["GatherPartitionsExec"] if parts > 1 else []) + [
                "ProjectExec", "LocalScanExec"]
            if nodes != want_nodes or "!" in sa.last_explain or \
                    "__rid__" not in sa.last_plan.tree_string():
                raise AssertionError(f"the row-id query over {parts} "
                                     f"partitions planned {nodes}")
            (plan,) = tap.plans
            rid_bytes = {"narrow": plan[0][-1], "none": 8}[plan[0][0]]
            if rid_bytes != (4 if parts == 1 else 8):
                raise AssertionError(f"the rid lane travels as {plan[0]}")
            # in turns: direct, assisted, assisted, direct
            walls_d = timed_walls(dfd.collect, 2)
            walls_a = timed_walls(dfa.collect, 3)
            walls_d += timed_walls(dfd.collect, 1)
            # the assisted collect split: the row-id query (device and
            # the rid lane's fetch), then the host take
            split = []
            inner = sa.execute

            def timed_execute(lp):
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out = inner(lp)
                split.append((time.perf_counter() - t2) * 1e3)
                return out
            sa.execute = timed_execute
            takes = []
            for _ in range(2):
                split.clear()
                t1 = time.perf_counter()
                got = host_assist.try_host_assisted_collect(sa, dfa._lp)
                takes.append((split[0], (time.perf_counter() - t1) * 1e3
                              - split[0]))
                if not _same_table(got, q3_want):
                    raise AssertionError("the split run differs")
                del got
            del sa.execute
            trace = _profile(torch, dfa.collect)
            print(f"q3 both ways over {parts} partition(s) ({ROWS} rows): "
                  f"both equal pyarrow's sort exactly; direct warm walls "
                  f"{', '.join(f'{w:.1f}' for w in walls_d)} ms, median "
                  f"{sorted(walls_d)[1]:.1f}; host-assisted "
                  f"{', '.join(f'{w:.1f}' for w in walls_a)} ms, median "
                  f"{sorted(walls_a)[1]:.1f} (two split runs: row-id "
                  f"query + host take "
                  + ", ".join(f"{q:.1f} + {tk:.1f}" for q, tk in takes)
                  + " ms); "
                  f"rid lane {rid_bytes} bytes a row ({plan[0]}), "
                  f"{tap.bytes} bytes fetched; plan {nodes}; trace: busy "
                  f"{trace['busy_ms']:.2f} ms, idle share "
                  f"{trace['idle_share']:.3f}; launches "
                  f"{launches['q3_assisted' + tag]}")
            del dfd, dfa, sd, sa
    except Exception:
        failures.append("q3 both ways")
        traceback.print_exc()
    q3_want = None

    phase_done("q3 both ways: the host-assisted collect and the direct")
    # ---- main path: q5, four parquet files -> filter -> group by k ----
    q5_root = tempfile.mkdtemp(prefix="chip_smoke_q5_")
    try:
        t1 = time.perf_counter()
        q5_path = _write_parquet_input(table, q5_root)
        write_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        q5_want = _q5_oracle(q5_path)
        on_disk = sum(os.path.getsize(os.path.join(q5_path, f))
                      for f in os.listdir(q5_path))
        print(f"q5 input: 4 parquet files of {ROWS // 4} rows written in "
              f"{write_s:.1f} s ({on_disk} bytes); "
              f"pyarrow oracle {q5_want.num_rows} groups in "
              f"{time.perf_counter() - t1:.1f} s")
        s5 = GpuSession()
        q5df = _q5_df(s5, q5_path, F, col)
        q5df.explain()
        nodes = _placements(s5.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"), ("FilterExec", "gpu"),
                     ("FileScanExec", "gpu")] or "!" in s5.last_explain:
            raise AssertionError(f"q5 planned {nodes}")
        scan5 = [e for e in _nodes(s5.last_plan)
                 if type(e).__name__ == "FileScanExec"][0]
        if scan5.reader_type != "COALESCING" or scan5.num_partitions != 1:
            raise AssertionError(f"q5's scan is {scan5.describe()}")
        # cold: the pin cleared, split into decode, upload and the rest
        io_scan.clear_filescan_pin()
        torch.cuda.synchronize()
        with _ScanTap(torch, io_scan) as cold_tap:
            t1 = time.perf_counter()
            got = q5df.collect()
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t1) * 1e3
        _check_q5(got, q5_want, "q5 (cold)")
        if len(cold_tap.files) != 4:
            raise AssertionError(f"the cold q5 read {cold_tap.files}")
        io_scan.clear_filescan_pin()
        cold_trace = _profile(torch, q5df.collect)
        # warm, pinned: reads no file
        count_reset()
        torch.cuda.synchronize()
        with _ScanTap(torch, io_scan) as warm_tap:
            got = q5df.collect()
            torch.cuda.synchronize()
            launches["q5"] = counts()
            _check_q5(got, q5_want, "q5 (warm, pinned)")
            walls = timed_walls(q5df.collect)
        if warm_tap.files:
            raise AssertionError(f"the warm pinned q5 read "
                                 f"{warm_tap.files}")
        trace = _profile(torch, q5df.collect)
        # the pin off: every run decodes and uploads
        soff = GpuSession(conf={PIN_KEY: False})
        q5off = _q5_df(soff, q5_path, F, col)
        with _Capture(carry, "compact_lanes") as cap1:
            _check_q5(q5off.collect(), q5_want, "q5 (pin off)")
        # K1 on the batch the host pushdown left, against its plain version
        seen = _check_captured(torch, cap1, carry, gather_mod, fetch, "q5")
        del cap1
        print(f"q5 K1 on the path's own input, exact against its plain "
              f"version: {'; '.join(seen)}")
        with _ScanTap(torch, io_scan) as off_tap:
            walls_off = timed_walls(q5off.collect)
        if len(off_tap.files) != 12:
            raise AssertionError(f"q5 with the pin off read "
                                 f"{len(off_tap.files)} files in 3 runs")
        print(f"main path q5 ({ROWS} rows in 4 parquet files, COALESCING, "
              f"one partition): equals pyarrow exactly; cold wall "
              f"{cold:.1f} ms = host decode {cold_tap.decode_ms:.1f} "
              f"(the pushed f < 0.5 filters rows on the host) + upload "
              f"{cold_tap.upload_ms:.1f} ({cold_tap.upload_bytes} bytes "
              f"of Arrow) + the rest "
              f"{cold - cold_tap.decode_ms - cold_tap.upload_ms:.1f}; cold "
              f"trace wall {cold_trace['wall_ms']:.1f} ms, device busy "
              f"{cold_trace['busy_ms']:.2f}, idle share "
              f"{cold_trace['idle_share']:.3f}; warm pinned walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}, no file read; busy "
              f"{trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"][:6])
              + f"; pin off walls {', '.join(f'{w:.1f}' for w in walls_off)}"
              f" ms, median {sorted(walls_off)[1]:.1f} (decode "
              f"{off_tap.decode_ms / 3:.1f}, upload "
              f"{off_tap.upload_ms / 3:.1f} a run); launches "
              f"{launches['q5']}")
        del q5df, q5off, s5, soff, got
        io_scan.clear_filescan_pin()
        # PERFILE: 4 partitions; the hash exchange stripped
        sp = GpuSession(conf={READER_KEY: "PERFILE"})
        q5p = _q5_df(sp, q5_path, F, col)
        _check_q5(q5p.collect(), q5_want, "q5 PERFILE (cold)")
        nodes = _placements(sp.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GatherPartitionsExec", "gpu"), ("FilterExec", "gpu"),
                     ("FileScanExec", "gpu")] or "!" in sp.last_explain:
            raise AssertionError(f"q5 PERFILE planned {nodes}")
        count_reset()
        got = q5p.collect()
        launches["q5_4"] = counts()
        _check_q5(got, q5_want, "q5 PERFILE")
        walls = timed_walls(q5p.collect)
        print(f"main path q5 PERFILE (4 partitions): GPU-only plan "
              f"{[n for n, _ in nodes]}, the hash exchange stripped; equals "
              f"pyarrow; warm pinned walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q5_4']}")
        del q5p, sp, got
    except Exception:
        failures.append("main path (q5)")
        traceback.print_exc()
    finally:
        io_scan.clear_filescan_pin()
        shutil.rmtree(q5_root, ignore_errors=True)

    phase_done("main path: q5, four parquet files -> filter -> group by k")
    # ---- main path: q7, filter(v > 0) -> parquet write ------------------
    q7_root = tempfile.mkdtemp(prefix="chip_smoke_q7_")
    try:
        want7 = table.filter(pc.greater(table["v"], 0))
        out7 = os.path.join(q7_root, "out")
        ways = {}
        for assisted in (True, False):
            s7 = GpuSession(conf={WRITE_KEY: assisted})
            fdf = s7.create_dataframe(table)

            def write():
                fdf.filter(col("v") > 0).write.mode("overwrite").parquet(
                    out7)
            way = "host-assisted" if assisted else "direct"
            with _Capture(fetch, "lane_stats", "pack_lanes") as cap9:
                write()                             # cold: the upload
            # K9 and K10 on the path's own lanes (the assisted way's
            # bit-packed keep mask) against their plain versions
            seen = _check_captured(torch, cap9, carry, gather_mod, fetch,
                                   f"q7 {way}")
            del cap9
            print(f"q7 {way}, kernels on the path's own inputs, each exact "
                  f"against its plain version: {'; '.join(seen)}")
            count_reset()
            torch.cuda.synchronize()
            with _FetchTap(fetch) as tap:
                write()
            torch.cuda.synchronize()
            run = "q7" if assisted else "q7_direct"
            launches[run] = counts()
            for check in ("checked", "last timed"):
                rows, files = _footer_rows(out7)
                if rows != want7.num_rows or len(files) != 1:
                    raise AssertionError(
                        f"q7 {way} ({check} run): footers count {rows} rows "
                        f"in {len(files)} files, not {want7.num_rows} in 1")
                if not _same_table(pq.read_table(files[0]), want7):
                    raise AssertionError(f"q7 {way} ({check} run) reads "
                                         f"back unlike fact.filter(v > 0)")
                if check == "checked":
                    walls = timed_walls(write)
            if assisted and "__keep__" not in s7.last_plan.tree_string():
                raise AssertionError("the assisted write ran no mask plan")
            # split: the rows to write (mask and host filter, or the
            # device filter and the payload's fetch), then the encode
            writer = fdf.filter(col("v") > 0).write.mode("overwrite")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows7 = writer._collect()
            t2 = time.perf_counter()
            writer._write_one(rows7, q7_root, "parquet")
            split = ((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3)
            del rows7
            ways[way] = (walls, tap.bytes, tap.plans, split)
            del fdf, s7
        print(f"main path q7 ({ROWS} rows, filter(v > 0) -> parquet, "
              f"{want7.num_rows} rows written): footers and read-back equal "
              f"fact.filter(v > 0) both ways; "
              + "; ".join(f"{way}: warm walls "
                          f"{', '.join(f'{w:.1f}' for w in walls)} ms, "
                          f"median {sorted(walls)[1]:.1f} (split: the rows "
                          f"{rows_ms:.1f} + the parquet encode "
                          f"{encode_ms:.1f}), {nbytes} bytes fetched "
                          f"(plan {plans})"
                          for way, (walls, nbytes, plans,
                                    (rows_ms, encode_ms)) in ways.items())
              + f"; launches {launches['q7']} (host-assisted), "
              f"{launches['q7_direct']} (direct)")
    except Exception:
        failures.append("main path (q7)")
        traceback.print_exc()
    finally:
        shutil.rmtree(q7_root, ignore_errors=True)

    phase_done("main path: q7, filter(v > 0) -> parquet write")
    # ---- a scan left on the CPU: format.parquet.enabled=false ----------
    cpu_root = tempfile.mkdtemp(prefix="chip_smoke_cpu_scan_")
    try:
        small_path = _write_parquet_input(table.slice(0, 1 << 20), cpu_root)
        sc = GpuSession(conf={"spark.rapids.sql.format.parquet.enabled":
                              False})
        count_reset()
        got = _q5_df(sc, small_path, F, col).collect()
        c = counts()
        _check_q5(got, _q5_oracle(small_path), "q5 with the scan on the CPU")
        nodes = _placements(sc.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"),
                     ("GpuHashAggregateExec", "gpu"), ("FilterExec", "gpu"),
                     ("HostToDeviceExec", "gpu"), ("FileScanExec", "cpu")] \
                or "parquet scan disabled by config" not in sc.last_explain:
            raise AssertionError(f"q5 with the scan off planned {nodes}:\n"
                                 + sc.last_explain)
        for name in ("compact_rows", "sort_order", "segment_reduce_sorted"):
            if c[name] < 1:
                raise AssertionError(f"{name} not launched above the CPU "
                                     f"scan")
        if io_scan._FILESCAN_PIN:
            raise AssertionError("a CPU-placed scan pinned its batches")
        print(f"q5 at {1 << 20} rows with format.parquet.enabled=false: the "
              f"scan CPU-placed ('parquet scan disabled by config'), a "
              f"HostToDeviceExec above it, the rest on the GPU; equals "
              f"pyarrow; launches {c}")
        del sc, got
    except Exception:
        failures.append("CPU-placed scan")
        traceback.print_exc()
    finally:
        shutil.rmtree(cpu_root, ignore_errors=True)

    phase_done("a scan left on the CPU: format.parquet.enabled=false")
    # ---- main path: q4, the window, through the DataFrame API --------
    q4_want = None

    def q4_df(session, parts):
        w = W.WindowBuilder().partition_by(col("k")).order_by(col("v"))
        return session.create_dataframe(table, num_partitions=parts).select(
            col("k"), col("v"), F.row_number().over(w).alias("rn"),
            F.sum(col("v")).over(w).alias("rs"))

    try:
        t1 = time.perf_counter()
        q4_rn, q4_rs, q4_ties, q4_parts = _q4_oracle(table)
        q4_want = (q4_rn, q4_rs)
        print(f"numpy q4 oracle: {table.num_rows} rows, {q4_parts} "
              f"partitions (about {table.num_rows // q4_parts} rows each), "
              f"{q4_ties} rows tie with the row before on (k, v) and share "
              f"its running sum, {time.perf_counter() - t1:.1f} s")
        q4_session = GpuSession()
        q4df = q4_df(q4_session, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = q4df.collect()
        cold_wall = time.perf_counter() - t1
        _check_q4(got, table, q4_rn, q4_rs, "DataFrame q4 (cold)")
        nodes = _placements(q4_session.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("ProjectExec", "gpu"),
                     ("WindowExec", "gpu"), ("LocalScanExec", "gpu")] or \
                "!" in q4_session.last_explain:
            raise AssertionError(f"q4 planned {nodes}:\n"
                                 + q4_session.last_explain)
        count_reset()
        carry.sort_order.passes = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = q4df.collect()
        torch.cuda.synchronize()
        launches["q4"] = counts()
        q4_run_passes = carry.sort_order.passes
        peak = torch.cuda.max_memory_allocated()
        _check_q4(got, table, q4_rn, q4_rs, "DataFrame q4")
        for name in ("sort_order", "gather_rows", "segment_scan", "run_ends",
                     "scatter_rows", "lane_stats", "pack_lanes"):
            if launches["q4"][name] != 1:
                raise AssertionError(f"{name} launched "
                                     f"{launches['q4'][name]} times on q4, "
                                     f"not once")
        del got
        walls = timed_walls(q4df.collect)
        wall = sorted(walls)[1]
        print(f"main path DataFrame q4 ({ROWS} rows, row_number and the "
              f"running RANGE sum of v over (partition by k order by v) -> "
              f"collect): plan {[n for n, _ in nodes]}, GPU-only, one "
              f"DeviceToHostExec; rn and rs equal the numpy oracle row for "
              f"row; cold wall {cold_wall * 1e3:.1f} ms (upload included); "
              f"warm walls {', '.join(f'{w:.1f}' for w in walls)} ms, "
              f"median {wall:.1f}, {ROWS / wall / 1e3:.1f} M rows/s; peak "
              f"{peak / 2**30:.2f} GiB; K2 passes {q4_run_passes}; launches "
              f"{launches['q4']}")

        # where q4's time goes: the window stage by stage, then the
        # download of the projected result, then a trace
        scan4 = LocalScanExec(table)
        wexec4 = q4_exec(scan4)
        batch4 = next(scan4.execute_partition(0, ExecContext(dev)))
        for _ in range(2):                 # the second pass is reported
            stages = {}
            torch.cuda.synchronize()
            clock = [time.perf_counter()]

            def mark(stage):
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[stage] = stages.get(stage, 0.0) + \
                    (now - clock[0]) * 1e3
                clock[0] = now
            out4 = wexec4._compute(batch4, mark)
        proj4 = DeviceBatch([out4.columns[i] for i in (0, 1, 3, 4)],
                            out4.num_rows, ["k", "v", "rn", "rs"])
        split, nbytes, plan = _download_split(torch, fetch, batch_to_arrow,
                                              move_batch, proj4)
        print("q4 stages (ms): " + " ".join(f"{k}={v:.2f}"
                                            for k, v in stages.items())
              + f"; download {_split_line(split)}; packed {nbytes} bytes, "
              f"copy {nbytes / split['copy'] / 1e6:.1f} GB/s; plan {plan}")
        del out4, proj4, batch4, scan4, wexec4
        trace = _profile(torch, q4df.collect)
        print(f"trace of a warm DataFrame q4: wall {trace['wall_ms']:.2f} ms, "
              f"device busy {trace['busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.3f}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"]))
        del q4df, q4_session
    except Exception:
        failures.append("main path (q4)")
        traceback.print_exc()

    phase_done("main path: q4, the window, through the DataFrame API")
    # ---- main path: q4 over 4 partitions -------------------------------
    try:
        if q4_want is None:
            raise AssertionError("no q4 oracle")
        s4 = GpuSession()
        df4 = q4_df(s4, 4)
        _check_q4(df4.collect(), table, *q4_want,
                  "DataFrame q4, 4 partitions (cold)")
        nodes = _placements(s4.last_plan)
        if nodes != [("DeviceToHostExec", "cpu"),
                     ("CoalesceBatchesExec", "gpu"), ("ProjectExec", "gpu"),
                     ("WindowExec", "gpu"), ("GatherPartitionsExec", "gpu"),
                     ("LocalScanExec", "gpu")] or "!" in s4.last_explain:
            raise AssertionError(f"q4 over 4 partitions planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = df4.collect()
        torch.cuda.synchronize()
        launches["q4_4"] = counts()
        _check_q4(got, table, *q4_want, "DataFrame q4, 4 partitions")
        del got
        walls = timed_walls(df4.collect)
        print(f"main path DataFrame q4 (4 partitions of {ROWS // 4} rows): "
              f"hash exchange stripped, plan {[n for n, _ in nodes]}; rn and "
              f"rs equal the numpy oracle; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches {launches['q4_4']}")
        del df4, s4
    except Exception:
        failures.append("main path (q4, 4 partitions)")
        traceback.print_exc()
    q4_want = None

    phase_done("main path: q4 over 4 partitions")
    # ---- TopN: sort(v desc, k).limit(1000) -------------------------------
    try:
        t1 = time.perf_counter()
        topn_want = table.sort_by([("v", "descending"),
                                   ("k", "ascending")]).slice(0, 1000)
        oracle_s = time.perf_counter() - t1
        st_ = GpuSession()
        tdf = st_.create_dataframe(table).sort(col("v").desc(),
                                               col("k")).limit(1000)
        if not _same_table(tdf.collect(), topn_want):
            raise AssertionError("TopN (cold) differs from pyarrow")
        nodes = _placements(st_.last_plan)
        if [n for n, _ in nodes] != [
                "DeviceToHostExec", "CoalesceBatchesExec", "GlobalLimitExec",
                "SortExec", "LocalLimitExec", "SortExec", "LocalScanExec"] \
                or any(p != "gpu" for _, p in nodes[1:]):
            raise AssertionError(f"TopN planned {nodes}")
        count_reset()
        torch.cuda.synchronize()
        got = tdf.collect()
        torch.cuda.synchronize()
        launches["topn"] = counts()
        if not _same_table(got, topn_want):
            raise AssertionError("TopN differs from pyarrow")
        walls = timed_walls(tdf.collect)
        print(f"TopN sort(v desc, k).limit(1000) over {ROWS} rows: plan "
              f"{[n for n, _ in nodes]}; equals pyarrow's first 1000 rows "
              f"(oracle {oracle_s:.1f} s); warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms; launches "
              f"{launches['topn']}")
        del tdf, st_, got, topn_want
    except Exception:
        failures.append("TopN")
        traceback.print_exc()

    phase_done("TopN: sort(v desc, k).limit(1000)")
    # ---- orders and nulls: the card against the CPU engine ---------------
    try:
        ot = _orders_table(1 << 20)
        orders = {
            "desc": lambda c: [c("i").desc(), c("d").desc()],
            "asc_nulls_last": lambda c: [c("d").asc_nulls_last(), c("i")],
            "desc_nulls_first": lambda c: [c("d").desc_nulls_first(),
                                           c("i").desc_nulls_first()]}
        cpu_engine = GpuSession(conf={"spark.rapids.sql.enabled": False})
        for name, fn in orders.items():
            count_reset()
            oracle = cpu_engine.create_dataframe(
                ot, num_partitions=4).order_by(*fn(col)).collect()
            if any(counts().values()):
                raise AssertionError(f"the CPU engine launched {counts()}")
            nodes = _placements(cpu_engine.last_plan)
            if any(p != "cpu" for _, p in nodes) or \
                    ("ShuffleExchangeExec", "cpu") not in nodes:
                raise AssertionError(f"CPU engine planned {nodes}")
            for parts, assisted in itertools.product((1, 4), (False, True)):
                count_reset()
                got = GpuSession(conf={COLLECT_KEY: assisted}) \
                    .create_dataframe(ot, num_partitions=parts) \
                    .order_by(*fn(col)).collect()
                if counts()["gather_rows"] < 1:
                    raise AssertionError("the card's sort launched no K8")
                if not _same_table(got, oracle):
                    raise AssertionError(f"order {name} over {parts} "
                                         f"partitions (host-assisted "
                                         f"collect {assisted}) differs "
                                         f"from the CPU engine")
        # pyarrow where its rules agree with Spark's: an INT key with
        # nulls, the row number breaking ties
        for fn, keys, place in (
                (lambda c: [c("i").asc_nulls_last(), c("row")],
                 [("i", "ascending"), ("row", "ascending")], "at_end"),
                (lambda c: [c("i").desc_nulls_first(), c("row")],
                 [("i", "descending"), ("row", "ascending")], "at_start")):
            for assisted in (False, True):
                got = GpuSession(conf={COLLECT_KEY: assisted}) \
                    .create_dataframe(ot).order_by(*fn(col)).collect()
                if not _same_table(got, ot.sort_by(keys,
                                                   null_placement=place)):
                    raise AssertionError(f"{keys} nulls {place} (host-"
                                         f"assisted collect {assisted}) "
                                         f"differs from pyarrow")
        print(f"orders and nulls over {ot.num_rows} rows (nulls in an INT "
              f"column; NaN, -0.0, +-inf and nulls in a DOUBLE column): "
              f"{', '.join(orders)} on the card over 1 and 4 partitions, "
              f"direct and host-assisted collects, equal the CPU engine (every operator on the CPU, the range "
              f"exchange on the host, no kernel launched); INT ascending "
              f"nulls last and descending nulls first equal pyarrow")
        del ot, oracle, got
    except Exception:
        failures.append("orders and nulls")
        traceback.print_exc()

    phase_done("orders and nulls: the card against the CPU engine")
    # ---- the plan rewrite: placements and planning time, one partition --
    try:
        for name, sess, frame in (("q1", session, df),
                                  ("q2", q2_session, q2df)):
            plan = sess.prepare_plan(frame._lp)
            nodes = _placements(plan)
            moves = [n for n, _ in nodes
                     if n in ("HostToDeviceExec", "DeviceToHostExec")]
            if nodes[0][0] != "DeviceToHostExec" or moves != \
                    ["DeviceToHostExec"] or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sess.last_explain:
                raise AssertionError(f"{name} placed {nodes}")
            ms = []
            for _ in range(21):
                t1 = time.perf_counter()
                sess.prepare_plan(frame._lp)
                ms.append((time.perf_counter() - t1) * 1e3)
            print(f"{name} plan: GPU-only, one transition (the final "
                  f"DeviceToHostExec), {len(nodes)} operators; planning "
                  f"(plan + tag + convert + transitions) median of 21 "
                  f"{sorted(ms)[10]:.3f} ms host, min {min(ms):.3f}")
        # the guards: a GPU aggregate over a CPU-placed filter and scan is
        # refused before it runs, and raises on its first batch
        guard = GpuHashAggregateExec(
            [A("k")], aggs, COMPLETE,
            FilterExec(filt_expr, LocalScanExec(table.slice(0, 1024))))
        guard.children[0].foreach(lambda e: setattr(e, "placement", "cpu"))
        for what, call, err in (
                ("collect", lambda: guard.execute_collect(ExecContext(dev)),
                 ValueError),
                ("first batch", lambda: next(guard.execute_partition(
                    0, ExecContext(dev))), RuntimeError)):
            try:
                call()
            except err:
                continue
            raise AssertionError(f"GPU aggregate over CPU-placed children: "
                                 f"{what} did not raise")
        print("placement guards: a GPU aggregate over a CPU-placed filter "
              "and scan is refused at collect and raises on its first batch")
    except Exception:
        failures.append("plan placements (q1, q2)")
        traceback.print_exc()

    phase_done("the plan rewrite: placements and planning time, one partition")
    # ---- the plan rewrite: CPU fallback between device operators ------
    try:
        fb_rows = 1 << 16
        fb_fact = table.slice(0, fb_rows)
        fb_dim = dim.rename_columns(["k2", "w"])

        def fb_query(s, how, cond_extra):
            return (s.create_dataframe(fb_fact)
                    .filter(col("v") > THRESHOLD)
                    .join(s.create_dataframe(fb_dim),
                          on=(col("k") == col("k2")) & cond_extra(),
                          how=how)
                    .group_by(col("k"))
                    .agg(F.sum(col("v")).alias("sv"),
                         F.count("*").alias("c")))

        full = fb_query(GpuSession(), "full", lambda: col("w") > 0.5)
        text = full.session.explain(full._lp)
        nodes = _placements(full.session.last_plan)
        reason = ("!Exec <CpuJoinExec> cannot run on GPU because "
                  "conditional full join is not supported on GPU")
        want_nodes = [("DeviceToHostExec", "cpu"),
                      ("CoalesceBatchesExec", "gpu"),
                      ("GpuHashAggregateExec", "gpu"),
                      ("HostToDeviceExec", "gpu"), ("CpuJoinExec", "cpu"),
                      ("DeviceToHostExec", "cpu"), ("FilterExec", "gpu"),
                      ("LocalScanExec", "gpu"), ("DeviceToHostExec", "cpu"),
                      ("LocalScanExec", "gpu")]
        if nodes != want_nodes or reason not in [
                ln.strip() for ln in text.splitlines()]:
            raise AssertionError(f"conditional full join placed {nodes}:\n"
                                 + text)
        errors = []
        for conf in ({}, {"spark.rapids.sql.enabled": False}):
            try:
                fb_query(GpuSession(conf=conf), "full",
                         lambda: col("w") > 0.5).collect()
                errors.append(None)
            except NotImplementedError as e:
                errors.append(str(e))
        if errors != ["conditional full join on CPU engine"] * 2:
            raise AssertionError(f"conditional full join: {errors}")
        # a fallback that runs: the CPU join engine disabled for the GPU
        inner = fb_query(GpuSession(
            conf={"spark.rapids.sql.exec.CpuJoinExec": False}), "inner",
            lambda: col("w") > 0.5)
        count_reset()
        got = inner.collect().sort_by("k")
        fb_launches = counts()
        nodes = _placements(inner.session.last_plan)
        if ("CpuJoinExec", "cpu") not in nodes or \
                "CpuJoinExec has been disabled by config" not in \
                inner.session.last_explain:
            raise AssertionError(f"disabled CpuJoinExec placed {nodes}")
        oracle = fb_query(GpuSession(conf={"spark.rapids.sql.enabled":
                                           False}), "inner",
                          lambda: col("w") > 0.5).collect().sort_by("k")
        if not got.equals(oracle):
            raise AssertionError("the CPU join between device operators "
                                 "differs from the CPU engine")
        print(f"fallback: a conditional full join at {fb_rows} fact rows "
              f"plans on CpuJoinExec between HostToDevice and DeviceToHost "
              f"transitions (filter and aggregate on the GPU) with the "
              f"reason '{reason[1:]}', and raises "
              f"'{errors[0]}' as under spark.rapids.sql.enabled=false (the "
              f"reference's CPU engine raises the same); an inner "
              f"conditional join with CpuJoinExec disabled runs on the CPU "
              f"engine between device operators ({got.num_rows} groups, "
              f"launches {fb_launches}) and equals the CPU engine's result")
    except Exception:
        failures.append("fallback")
        traceback.print_exc()

    phase_done("the plan rewrite: CPU fallback between device operators")
    # ---- the CPU oracle: q1 under spark.rapids.sql.enabled=false ------
    try:
        small = table.slice(0, 1 << 20)

        def q1_df(s):
            return (s.create_dataframe(small)
                    .filter(col("v") > THRESHOLD)
                    .group_by(col("k"))
                    .agg(F.sum(col("v")).alias("sv"),
                         F.avg(col("f")).alias("af"),
                         F.count("*").alias("c")))
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        t1 = time.perf_counter()
        oracle = q1_df(cpu_session).collect()
        cpu_wall = time.perf_counter() - t1
        if any(counts().values()):
            raise AssertionError(f"the CPU engine launched {counts()}")
        nodes = _placements(cpu_session.last_plan)
        if any(p != "cpu" for _, p in nodes):
            raise AssertionError(f"oracle placed {nodes}")
        on_card = q1_df(GpuSession()).collect()
        _check_q1(on_card, _oracle(small), "q1 on the card, 2^20 rows")
        _check_q1(oracle, _oracle(small), "q1 on the CPU engine, 2^20 rows")
        on_card, oracle = on_card.sort_by("k"), oracle.sort_by("k")
        for c in ("k", "sv", "c"):
            if not on_card[c].equals(oracle[c]):
                raise AssertionError(f"oracle column {c} differs")
        if not np.allclose(on_card["af"].to_numpy(), oracle["af"].to_numpy(),
                           rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError("oracle avg differs")
        print(f"oracle: q1 at {small.num_rows} rows under "
              f"spark.rapids.sql.enabled=false ({[n for n, _ in nodes]}, "
              f"every operator on the CPU, no kernel launched, "
              f"{cpu_wall * 1e3:.1f} ms) equals the card's result (keys, "
              f"sums and counts exactly, avg to {FLOAT_RTOL:g})")
    except Exception:
        failures.append("CPU oracle")
        traceback.print_exc()

    phase_done("the CPU oracle: q1 under spark.rapids.sql.enabled=false")
    # ---- the CPU oracle: every window function at 2^20 rows ----------
    try:
        wt = _window_oracle_table(1 << 20)
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        t1 = time.perf_counter()
        oracle = _window_oracle_query(cpu_session.create_dataframe(wt), F,
                                      col, W).collect()
        cpu_wall = time.perf_counter() - t1
        if any(counts().values()):
            raise AssertionError(f"the CPU engine launched {counts()}")
        nodes = _placements(cpu_session.last_plan)
        if any(p != "cpu" for _, p in nodes):
            raise AssertionError(f"window oracle placed {nodes}")
        card_session = GpuSession()
        count_reset()
        on_card = _window_oracle_query(card_session.create_dataframe(wt), F,
                                       col, W).collect()
        card_nodes = _placements(card_session.last_plan)
        if [p for _, p in card_nodes][1:] != ["gpu"] * (len(card_nodes) - 1) \
                or "!" in card_session.last_explain:
            raise AssertionError(f"window functions planned {card_nodes}")
        for name in ("segment_scan", "run_ends", "scatter_rows"):
            if counts()[name] <= 0:
                raise AssertionError(f"{name} not launched by the window "
                                     f"functions")
        if not _same_window_tables(on_card, oracle):
            bad = [c for c in oracle.column_names if not _same_window_tables(
                on_card.select([c]), oracle.select([c]))]
            raise AssertionError(f"the card's window functions differ from "
                                 f"the CPU engine in {bad}")
        print(f"window oracle: {wt.num_rows} rows, nulls in k, o and v; "
              f"rank, dense_rank, percent_rank, cume_dist, ntile, lead, "
              f"lag, row_number over a descending order, whole-partition "
              f"sum and avg, bounded ROWS sum, count and max, bounded RANGE "
              f"sum, count, min and max ({len(oracle.column_names) - 4} "
              f"columns over 5 specs): the card equals the CPU engine "
              f"(spark.rapids.sql.enabled=false, every operator on the CPU, "
              f"no kernel launched, {cpu_wall:.1f} s), ints exactly, floats "
              f"to {FLOAT_RTOL:g}")
        del wt, oracle, on_card
    except Exception:
        failures.append("window oracle")
        traceback.print_exc()


    phase_done("the CPU oracle: every window function at 2^20 rows")
    # ---- the expression catalogue: the card against the CPU ----------
    try:
        ct = _catalogue_table(CATALOGUE_ROWS)
        cols = _catalogue_columns(F, col, lit, ar_mod, mx_mod, cond_mod,
                                  Column)
        cpu_session = GpuSession(conf={"spark.rapids.sql.enabled": False})
        count_reset()
        oracle = cpu_session.create_dataframe(ct).select(*cols).collect()
        if any(counts().values()) or any(
                p != "cpu" for _, p in _placements(cpu_session.last_plan)):
            raise AssertionError("the CPU placement launched a kernel or "
                                 "placed an operator on the GPU")
        card_session = GpuSession()
        on_card = card_session.create_dataframe(ct).select(*cols).collect()
        nodes = _placements(card_session.last_plan)
        if any(p != "gpu" for _, p in nodes[1:]) or \
                "!" in card_session.last_explain:
            raise AssertionError(f"the catalogue placed {nodes}:\n"
                                 + card_session.last_explain)
        bad, worst = _same_catalogue(on_card, oracle, 1e-12)
        if bad:
            raise AssertionError(f"the card's expressions differ from the "
                                 f"CPU placement in {bad}")
        sat = on_card.filter(pc.is_in(ct["d"], pa.array([1e19, 9.3e18])))
        if set(sat["d2l"].to_pylist()) != {2**63 - 1}:
            raise AssertionError(f"1e19 and 9.3e18 cast to LONG give "
                                 f"{set(sat['d2l'].to_pylist())}")
        edge = on_card.filter(pc.and_(pc.equal(ct["a"], -2**63),
                                      pc.equal(ct["b"], -1)))
        if edge.num_rows == 0 or set(edge["idiv"].to_pylist()) != \
                {-2**63} or set(edge["mod"].to_pylist()) != {0}:
            raise AssertionError("INT64_MIN div and % -1 on the card")
        n128 = _decimal128_on_card(torch, dev, ct, batch_to_device,
                                   EvalContext, ar_mod, t)
        print(f"expression catalogue: {len(cols)} columns over "
              f"{ct.num_rows} rows (INT64_MIN and INT32_MIN operands, "
              f"{edge.num_rows} rows of INT64_MIN over -1, zero divisors, "
              f"NaN, +-inf, -0.0, 1e19 and 9.3e18, nulls): the card "
              f"(GPU-placed, {len(nodes)} operators) equals the CPU "
              f"placement (spark.rapids.sql.enabled=false, no kernel "
              f"launched): integers and booleans exactly, doubles by bits "
              f"or within 1e-12 (largest relative difference {worst:.3g}); "
              f"1e19 and 9.3e18 cast to LONG give INT64_MAX on the card; "
              f"{n128} DECIMAL(30,2) expressions that the plan keeps on "
              f"the CPU engine (%, pmod, greatest, least) evaluated on "
              f"the card equal the CPU engine's words")
        del ct, oracle, on_card
    except Exception:
        failures.append("expression catalogue")
        traceback.print_exc()

    phase_done("the expression catalogue: the card against the CPU")
    # ---- join types not run on the card before, against pyarrow ------
    try:
        jf, jd = _join_table_pairs(table, dim)
        pa_how = {"right": "right outer", "full": "full outer",
                  "left_semi": "left semi", "left_anti": "left anti"}
        done = []
        for how, pa_name in pa_how.items():
            sj = GpuSession()
            count_reset()
            got = sj.create_dataframe(jf).join(
                sj.create_dataframe(jd), on="k", how=how).collect()
            nodes = _placements(sj.last_plan)
            if any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sj.last_explain:
                raise AssertionError(f"{how} join placed {nodes}")
            # semi and anti joins compact the probe side (K1); the others
            # expand pairs (K7, K5)
            after = "compact_rows" if how.startswith("left_") else \
                "expand_pairs"
            if counts()["join_probe"] < 1 or counts()[after] < 1:
                raise AssertionError(f"{how} join launched {counts()}")
            want = jf.join(jd, "k", join_type=pa_name)
            want = want.select(got.column_names)
            if not _sorted_rows(got).equals(_sorted_rows(want)):
                raise AssertionError(f"{how} join differs from pyarrow: "
                                     f"{got.num_rows} rows vs "
                                     f"{want.num_rows}")
            done.append(f"{how} {got.num_rows} rows")
        print(f"joins through GpuSession at {jf.num_rows} fact rows with a "
              f"{jd.num_rows}-row dimension (a third of the fact's keys "
              f"missing, keys the fact lacks): {', '.join(done)}; each "
              f"GPU-placed, K4 launched and K5 (right, full) or K1 (semi, "
              f"anti), equal to pyarrow's join")
    except Exception:
        failures.append("join types")
        traceback.print_exc()

    phase_done("join types not run on the card before, against pyarrow")
    # ---- strings: K14-K17, qs1-qs4 at 2^25 rows, checks at 2^20 ------
    st_fact = st_dim = None
    try:
        t1 = time.perf_counter()
        st_fact, st_dim = _string_tables(table, dim)
        sbytes = {c: int(pc.sum(pc.binary_length(st_fact[c])).as_py() or 0)
                  for c in ("s", "rf", "ls", "c")}
        print(f"string tables: fact {st_fact.num_rows} rows with s "
              f"(\"Customer#%09d\" of k, {sbytes['s']} bytes), rf, ls "
              f"(1 byte), c (10-43 bytes, {st_fact['c'].null_count} null, "
              f"{sbytes['c']} bytes); dimension {st_dim.num_rows} names; "
              f"built from numpy buffers in "
              f"{time.perf_counter() - t1:.1f} s")
        rng = np.random.default_rng(SEED + 77)
        checks = 0
        for what, arr in _string_edge_arrays(rng).items():
            n = len(arr)
            colm = batch_to_device(pa.RecordBatch.from_arrays(
                [arr], names=["x"]), dev).columns[0]
            checks += _string_kernel_check(torch, sops, hashfns_mod,
                                           colm.offsets, colm.data, rng,
                                           what)
        k16_cases = _k16_cases(torch, dev, sops)
        torch.cuda.synchronize()
        print(f"K16 edge cases: {k16_cases} cases equal the plain versions "
              f"bit for bit (every source alignment 0-15 for rows of 1-40 "
              f"bytes, 16-byte rows, stretches ending mid-row, a 1 MB row "
              f"over 256 stretches, a run of invalid slots, one-byte "
              f"flags, n = 1; caps at the total, past it and past a "
              f"partial chunk)")
        print(f"K14-K17 edge cases: {checks} checks (0 rows, all empty, "
              f"all null, a 1 MB string among 2,000 short, 40 bytes of "
              f"shared prefix, multi-byte UTF-8, 255-257 and 4,095-4,097 "
              f"rows, invalid and out-of-range gather slots): each kernel "
              f"equals its plain version bit for bit")
    except Exception:
        failures.append("string kernels (edge cases)")
        traceback.print_exc()

    def k16_row(columns, idx, what):
        """K16 over span columns through the rows ``idx`` (valid where
        the row is), each against the plain versions bit for bit, then
        timed: both launches, each launch alone, the plain versions, and
        one random 4-byte read a row of the source offsets through
        ``idx`` (``index_select``) as the card's random-read yardstick.
        Returns the kernel row."""
        n = int(idx.shape[0])
        runs = []
        for c in columns:
            ok = c.validity.index_select(0, idx.long())
            o, t, st = sops.gather_offsets(c.offsets, idx, ok)
            total = int(t)
            cap = bucket_for(max(total, 1), DEFAULT_CHAR_BUCKETS)
            got = sops.gather_chars(c.data, st, o, total, cap)
            o_p, t_p = sops.gather_offsets_plain(c.offsets, idx, ok)
            if not (torch.equal(o, o_p) and torch.equal(t, t_p) and
                    torch.equal(st, sops.span_starts_plain(c.offsets, idx,
                                                           ok)) and
                    torch.equal(got, sops.gather_chars_plain(
                        c.offsets, c.data, idx, o_p, cap))):
                raise AssertionError(f"K16 differs at {what}")
            runs.append((c, ok, o, st, total, cap))
            del got, o_p, t_p

        def both():
            for c, ok, _, _, total, cap in runs:
                o, _, st = sops.gather_offsets(c.offsets, idx, ok)
                sops.gather_chars(c.data, st, o, total, cap)

        def plain():
            for c, ok, _, _, total, cap in runs:
                o, _ = sops.gather_offsets_plain(c.offsets, idx, ok)
                sops.gather_chars_plain(c.offsets, c.data, idx, o, cap)
        idx_l = idx.long()
        # offsets: index, valid flag and two source offsets read, the new
        # offset written, a row; copy: the new offset and source start a
        # row, the selected bytes read, the whole buffer written.  The
        # function: the offsets launch's bytes and the copy's chars (the
        # source starts are this design's own go-between)
        off_bytes = 17 * n * len(runs)
        chars_bytes = sum(total + cap for *_, total, cap in runs)
        copy_bytes = 8 * n * len(runs) + chars_bytes
        row = dict(
            source="spark_rapids_tpu_torch/csrc/gather_strings.cu",
            replaces="spark_rapids_tpu/ops/strings.py:101",
            max_abs_err=0.0, ms=cuda_ms(both),
            plain_ms=cuda_ms(plain, reps=1), library_ms=None,
            bound_ms=bound(off_bytes + chars_bytes),
            extra=dict(
                offsets_ms=cuda_ms(lambda: [sops.gather_offsets(
                    c.offsets, idx, ok) for c, ok, *_ in runs]),
                offsets_bound_ms=bound(off_bytes),
                copy_ms=cuda_ms(lambda: [sops.gather_chars(
                    c.data, st, o, total, cap)
                    for c, _, o, st, total, cap in runs]),
                copy_bound_ms=bound(copy_bytes),
                random_read_ms=cuda_ms(lambda: [c.offsets.index_select(
                    0, idx_l) for c in columns]),
                bytes=[total for *_, total, _ in runs]))
        x = row["extra"]
        print(f"K16 gather_strings at {what}: {len(runs)} column(s) of "
              f"{n} rows, {x['bytes']} bytes: exact; both launches "
              f"{row['ms']:.3f} ms (bound {row['bound_ms']:.3f}), offsets "
              f"{x['offsets_ms']:.3f} (bound {x['offsets_bound_ms']:.3f}), "
              f"copy {x['copy_ms']:.3f} (bound {x['copy_bound_ms']:.3f}); "
              f"plain {row['plain_ms']:.3f}; one random 4-byte read a row "
              f"(index_select of the source offsets) "
              f"{x['random_read_ms']:.3f} ms; {card}")
        return row

    def string_run(run, df, check, what, session):
        """Cold, then the counted warm run, then 3 warm walls and a
        trace; the plan must be GPU-only."""
        t1 = time.perf_counter()
        check(df.collect(), f"{what} (cold)")
        cold_wall = (time.perf_counter() - t1) * 1e3
        nodes = _placements(session.last_plan)
        if nodes[0] != ("DeviceToHostExec", "cpu") or \
                any(p != "gpu" for _, p in nodes[1:]) or \
                "!" in session.last_explain:
            raise AssertionError(f"{what} placed {nodes}:\n"
                                 f"{session.last_explain}")
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        got = df.collect()
        torch.cuda.synchronize()
        launches[run] = counts()
        check(got, what)
        walls = timed_walls(df.collect)
        trace = _profile(torch, df.collect)
        print(f"main path {what}: plan {[n for n, _ in nodes]}, GPU-only; "
              f"cold wall {cold_wall:.1f} ms; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; busy {trace['busy_ms']:.2f} ms, "
              f"idle share {trace['idle_share']:.3f} (traced wall "
              f"{trace['wall_ms']:.1f} ms); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {launches[run]}; top kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"][:6])
              + f"; {card}")
        return got

    string_caps = {}

    def capture_strings(key, fn):
        """One run of ``fn`` outside the counted ones, keeping the
        arguments of every K14-K17 call."""
        with _Capture(sops, "string_hashes", "order_keys", "gather_offsets",
                      "gather_chars") as cap, \
                _Capture(hashfns_mod, "hash_bytes") as cap15:
            fn()
        cap.calls += cap15.calls
        cap.orig.update(cap15.orig)
        string_caps[key] = cap

    # qs1: TPC-H Q1 with the real flags, one partition and four
    if st_fact is not None:
        try:
            want1 = _qs1_oracle(_q1x_oracle(table))

            def check1(got, what):
                _check_q1x(got, want1, what)
            for parts in (1, 4):
                s1 = GpuSession()
                df1 = _qs1_df(s1, st_fact, parts, F, col, lit)
                string_run("qs1" if parts == 1 else "qs1_4", df1, check1,
                           f"qs1 (TPC-H Q1 grouped by the string flags rf "
                           f"and ls, {ROWS} rows in {parts} partition(s))",
                           s1)
                if parts == 1:
                    capture_strings("qs1", df1.collect)
                del df1, s1
            # K16 at qs1's shape: the two flag columns through the
            # filter's kept rows
            fl = batch_to_device(pa.RecordBatch.from_arrays(
                [st_fact[c].combine_chunks() for c in ("rf", "ls", "v", "f")],
                names=["rf", "ls", "v", "f"]), dev)
            kept = ((fl.columns[3].data <= 0.98) & fl.columns[3].validity &
                    fl.columns[2].validity).nonzero().flatten().to(
                        torch.int32)
            kernel_rows["gather_strings_flags"] = k16_row(
                fl.columns[:2], kept, "qs1's shape (rf and ls through the "
                "filter's kept rows)")
            del fl, kept
        except Exception:
            failures.append("main path (qs1)")
            traceback.print_exc()

    # qs2: q1 keyed by the customer name
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            want2 = _qs2_oracle(st_fact)
            print(f"pyarrow qs2 oracle: {want2.num_rows} groups, "
                  f"{time.perf_counter() - t1:.1f} s")
            s2 = GpuSession()
            df2 = _qs2_df(s2, st_fact, F, col)
            string_run("qs2", df2, lambda g, w: _check_qs2(g, want2, w),
                       f"qs2 (q1 grouped by the 18-byte name s, {ROWS} "
                       f"rows)", s2)
            capture_strings("qs2", df2.collect)
            # K14 at qs2's shape: the names' hashes, as the group-by asks
            names = batch_to_device(pa.RecordBatch.from_arrays(
                [st_fact["s"].combine_chunks()], names=["s"]),
                dev).columns[0]
            n = names.capacity
            got = sops.string_hashes(names.offsets, names.data)
            want = sops.string_hashes_plain(names.offsets, names.data)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("K14 differs at qs2's shape")
            kernel_rows["string_hashes"] = dict(
                source="spark_rapids_tpu_torch/csrc/string_hashes.cu",
                replaces="spark_rapids_tpu/ops/strings.py:41",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: sops.string_hashes(names.offsets,
                                                      names.data)),
                plain_ms=cuda_ms(lambda: sops.string_hashes_plain(
                    names.offsets, names.data), reps=2),
                library_ms=None,
                bound_ms=bound(4 * (n + 1) + sbytes["s"] + 16 * n))
            # K17 at qs4's key, the same names
            got = sops.order_keys(names.offsets, names.data)
            want = sops.order_keys_plain(names.offsets, names.data)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("K17 differs at qs4's shape")
            lens = np.minimum(pc.binary_length(st_fact["s"]).to_numpy(), 32)
            kernel_rows["order_keys"] = dict(
                source="spark_rapids_tpu_torch/csrc/prefix_words.cu",
                replaces="spark_rapids_tpu/ops/strings.py:76",
                max_abs_err=0.0,
                ms=cuda_ms(lambda: sops.order_keys(names.offsets,
                                                   names.data)),
                plain_ms=cuda_ms(lambda: sops.order_keys_plain(
                    names.offsets, names.data), reps=2),
                library_ms=None,
                bound_ms=bound(4 * (n + 1) + int(lens.sum()) + 40 * n))
            print(f"K14 string_hashes and K17 order_keys at {n} names: "
                  f"exact; K14 {kernel_rows['string_hashes']['ms']:.3f} ms "
                  f"(plain {kernel_rows['string_hashes']['plain_ms']:.3f}, "
                  f"bound {kernel_rows['string_hashes']['bound_ms']:.3f}), "
                  f"K17 {kernel_rows['order_keys']['ms']:.3f} ms (plain "
                  f"{kernel_rows['order_keys']['plain_ms']:.3f}, bound "
                  f"{kernel_rows['order_keys']['bound_ms']:.3f}); {card}")
            del names, got, want, df2, s2
        except Exception:
            failures.append("main path (qs2)")
            traceback.print_exc()

    # qs3: the fact joined to the dimension on the name, c as payload
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            want3 = _by_id(st_fact.select(["id", "s", "c"]).join(
                st_dim, "s", join_type="inner"))
            want3 = want3.select(["s", "id", "c", "w"])
            print(f"pyarrow qs3 oracle: {want3.num_rows} joined rows, "
                  f"{time.perf_counter() - t1:.1f} s")

            def check3(got, what):
                got = _by_id(got).select(want3.column_names)
                if not _same_strings_table(got, want3):
                    raise AssertionError(f"{what}: differs from pyarrow's "
                                         f"join ({got.num_rows} rows)")
            s3 = GpuSession()
            df3 = _qs3_df(s3, st_fact, st_dim)
            string_run("qs3", df3, check3,
                       f"qs3 (the fact joined to the dimension on the name "
                       f"s, FK -> PK, the comment c riding on the probe "
                       f"side, {ROWS} rows)", s3)
            capture_strings("qs3", df3.collect)
            del df3, s3
        except Exception:
            failures.append("main path (qs3)")
            traceback.print_exc()

    # qs4: sort by (s, v) carrying c, and its TopN
    if st_fact is not None:
        try:
            t1 = time.perf_counter()
            sub4 = st_fact.select(["s", "v", "c"])
            # s is "Customer#%09d" of k (k < 10^9), so (s, v) sorts as
            # (k, v): numpy's stable lexsort of the integers gives the
            # order pyarrow's stable sort of the strings gives, in a tenth
            # of its time (67 s over 2^25 rows on the H100's host)
            want4 = sub4.take(pa.array(np.lexsort(
                (st_fact["v"].to_numpy(), st_fact["k"].to_numpy()))))
            print(f"numpy qs4 oracle: {want4.num_rows} rows sorted, "
                  f"{time.perf_counter() - t1:.1f} s")

            def check4(got, what):
                if not _same_strings_table(got, want4):
                    raise AssertionError(f"{what}: differs from pyarrow's "
                                         f"sort")
            s4 = GpuSession()
            df4 = _qs4_df(s4, st_fact, col)
            string_run("qs4", df4, check4,
                       f"qs4 (sort by (s, v) carrying c, {ROWS} rows)", s4)
            capture_strings("qs4", df4.collect)
            top4 = want4.slice(0, 1000)

            def check_top(got, what):
                if not _same_strings_table(got, top4):
                    raise AssertionError(f"{what}: differs from pyarrow")
            s5 = GpuSession()
            dft = s5.create_dataframe(sub4).sort(col("s"), col("v")).limit(
                1000)
            string_run("qs4_topn", dft, check_top,
                       "qs4's TopN (sort(s, v).limit(1000))", s5)
            # K16 at qs4's shape: c through the sort's order
            sc = batch_to_device(pa.RecordBatch.from_arrays(
                [sub4[c].combine_chunks() for c in ("s", "v", "c")],
                names=["s", "v", "c"]), dev)
            words = [w for ccol in sc.columns[:2]
                     for w in seg.sort_key_words(ccol)]
            order = carry.sort_order(words)
            kernel_rows["gather_strings"] = k16_row(
                [sc.columns[2]], order, "qs4's shape (c through the sort "
                "order)")
            del sc, words, order, df4, s4, dft, s5, want4, sub4
        except Exception:
            failures.append("main path (qs4)")
            traceback.print_exc()

    # the captured K14-K17 calls of qs1-qs4, against their plain versions
    for key, cap in string_caps.items():
        try:
            seen = _check_string_captured(torch, cap, sops, hashfns_mod, key)
            print(f"captured at {key}: {len(seen)} calls equal their plain "
                  f"versions bit for bit: {', '.join(seen[:8])}"
                  + (" ..." if len(seen) > 8 else ""))
        except Exception:
            failures.append(f"captured string kernels ({key})")
            traceback.print_exc()
    string_caps.clear()

    phase_done("strings: K14-K17, qs1-qs4 at 2^25 rows, checks at 2^20")
    # ---- strings at 2^20 rows against the CPU engine and pyarrow ----
    if st_fact is not None:
        try:
            small = st_fact.slice(0, STRING_SMALL).combine_chunks()
            cpu = GpuSession(conf={"spark.rapids.sql.enabled": False})
            card_s = GpuSession()

            def both(query, what, run=None):
                count_reset()
                want = query(cpu.create_dataframe(small)).collect()
                if any(counts().values()) or any(
                        p != "cpu" for _, p in _placements(cpu.last_plan)):
                    raise AssertionError(f"{what}: the CPU engine launched "
                                         f"a kernel or placed on the GPU")
                count_reset()
                got = query(card_s.create_dataframe(small)).collect()
                if run is not None:
                    launches[run] = counts()
                nodes = _placements(card_s.last_plan)
                if any(p != "gpu" for _, p in nodes[1:]) or \
                        "!" in card_s.last_explain:
                    raise AssertionError(f"{what} placed {nodes}")
                if not _same_window_tables(got, want):
                    raise AssertionError(f"{what}: the card differs from "
                                         f"the CPU engine")
                return got
            done = []
            preds = {
                "s = 'Customer#000000042'":
                    col("s") == lit("Customer#000000042"),
                "s <> 'Customer#000000042'":
                    col("s") != lit("Customer#000000042"),
                "s < 'Customer#000050000'":
                    col("s") < lit("Customer#000050000"),
                "s >= 'Customer#000099990'":
                    col("s") >= lit("Customer#000099990"),
                "rf IN ('A', 'N')": col("rf").isin("A", "N"),
                "s IN (3 names)": col("s").isin(
                    "Customer#000000001", "Customer#000012345",
                    "Customer#000099999"),
                "rf > ls": col("rf") > col("ls"),
                "c IS NULL": col("c").is_null()}
            for what, pred in preds.items():
                got = both(lambda d, p=pred: d.filter(p).select(
                    "id", "s", "rf"), what)
                done.append(f"{what}: {got.num_rows}")
            got = both(lambda d: d.select(
                col("id"), F.hash(col("s"), col("k")).alias("h"),
                F.hash(col("c")).alias("hc")), "F.hash(s, k)", "hash_s")
            capture_strings("hash", lambda: card_s.create_dataframe(
                small).select(F.hash(col("s"), col("k"))).collect())
            done.append(f"F.hash(s, k) and F.hash(c): {got.num_rows}")
            wspec = W.WindowBuilder().partition_by(col("s")).order_by(
                col("v"), col("id"))
            got = both(lambda d: d.select(
                col("id"), col("s"), col("v"),
                F.row_number().over(wspec).alias("rn"),
                F.sum(col("v")).over(wspec).alias("rs"),
                F.lag(col("c"), 1).over(wspec).alias("lc")),
                "window by s")
            done.append(f"window by s ordered by v: {got.num_rows}")
            got = both(lambda d: d.group_by(col("rf")).agg(
                F.min(col("c")).alias("mn"), F.max(col("c")).alias("mx"),
                F.count(col("c")).alias("n")).sort(col("rf")),
                "min/max of c by rf")
            done.append(f"min and max of c by rf: {got.num_rows} groups")
            with tempfile.TemporaryDirectory() as td:
                out = os.path.join(td, "scv")
                card_s.create_dataframe(small.select(["s", "c", "v"])) \
                    .write.mode("overwrite").parquet(out)
                back = pq.read_table(out).select(["s", "c", "v"])
                want_w = small.select(["s", "c", "v"])
                if not _same_strings_table(
                        back.cast(want_w.schema).combine_chunks(),
                        want_w.combine_chunks()):
                    raise AssertionError("the parquet write of (s, c, v) "
                                         "reads back different")
                got = card_s.read.parquet(out).collect()
                if not _same_strings_table(got.cast(want_w.schema),
                                           want_w):
                    raise AssertionError("the parquet scan of (s, c, v) "
                                         "differs")
            done.append("parquet write of (s, c, v) reads back equal "
                        "(pyarrow and the port's scan)")
            print(f"strings at {STRING_SMALL} rows, the card (GPU-placed) "
                  f"against the CPU engine (no kernel launched), exactly: "
                  + "; ".join(done))
            hash_cap = string_caps.pop("hash")
            seen = _check_string_captured(torch, hash_cap, sops,
                                          hashfns_mod, "F.hash")
            for name, args in hash_cap.calls:
                if name != "hash_bytes":
                    continue
                offs, chars = args[0], args[1]
                n = int(offs.shape[0]) - 1
                nb = int(offs[-1])
                kernel_rows["hash_bytes"] = dict(
                    source="spark_rapids_tpu_torch/csrc/hash_bytes.cu",
                    replaces="spark_rapids_tpu/expr/hashfns.py:72",
                    max_abs_err=0.0,
                    ms=cuda_ms(lambda: hashfns_mod.hash_bytes(*args)),
                    plain_ms=cuda_ms(lambda: hashfns_mod.hash_bytes_plain(
                        *args), reps=1),
                    library_ms=None,
                    bound_ms=bound(4 * (n + 1) + nb + 4 * n + 4 * n))
                r15 = kernel_rows["hash_bytes"]
                print(f"K15 hash_bytes at F.hash's shape ({n} rows, {nb} "
                      f"bytes): exact; {r15['ms']:.3f} ms (plain "
                      f"{r15['plain_ms']:.3f}, bound {r15['bound_ms']:.3f}"
                      f"); {card}")
                break
            del small, cpu, card_s
        except Exception:
            failures.append("strings at 2^20 rows")
            traceback.print_exc()
    phase_done("strings at 2^20 rows against the CPU engine and pyarrow")
    # ---- the DataFrame surface: range, union, distinct, sample,
    # repartition, cache and the actions, at 2^25 rows -------------------
    def surface_run(run, fn, check, what, session):
        """Cold, the counted warm run, then 3 warm walls; every operator
        but the final download on the GPU."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(fn(), f"{what} (cold)")
        torch.cuda.synchronize()
        cold_wall = (time.perf_counter() - t1) * 1e3
        nodes = _placements(session.last_plan)
        if nodes[0] != ("DeviceToHostExec", "cpu") or \
                any(p != "gpu" for _, p in nodes[1:]) or \
                "!" in session.last_explain:
            raise AssertionError(f"{what} placed {nodes}:\n"
                                 f"{session.last_explain}")
        count_reset()
        torch.cuda.synchronize()
        got = fn()
        torch.cuda.synchronize()
        launches[run] = counts()
        check(got, what)
        walls = timed_walls(fn)
        print(f"surface {what}: plan {[n for n, _ in nodes]}, GPU-only; "
              f"cold wall {cold_wall:.1f} ms; warm walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms, median "
              f"{sorted(walls)[1]:.1f}; launches "
              f"{ {k: v for k, v in launches[run].items() if v} }; {card}")
        return got

    def plan_has(session, name):
        return any(n == name for n, _ in _placements(session.last_plan))

    def check_n(n):
        def check(got, what):
            if got != n:
                raise AssertionError(f"{what}: count {got}, not {n}")
        return check

    from spark_rapids_tpu_torch.io import cached_batch as cb_mod
    t_surface = time.perf_counter()
    k_np, v_np = table["k"].to_numpy(), table["v"].to_numpy()
    all_g = table.group_by("k").aggregate([("v", "sum"), ("k", "count")]) \
        .sort_by("k")
    all_want = (all_g["k"].to_numpy(), all_g["v_sum"].to_numpy(),
                all_g["k_count"].to_numpy())
    sv = GpuSession()
    fact_df = sv.create_dataframe(table)

    def q1_agg(df):
        return df.group_by(col("k")).agg(
            F.sum(col("v")).alias("sv"), F.avg(col("f")).alias("af"),
            F.count("*").alias("c"))

    def sum_count(df):
        return df.group_by(col("k")).agg(F.sum(col("v")).alias("sv"),
                                         F.count("*").alias("c"))

    try:
        rk, rs, rc = _range_oracle(ROWS, RANGE_MOD)
        for parts in (1, 4):
            sr = GpuSession()
            df = sum_count(sr.range(0, ROWS, num_partitions=parts).select(
                (col("id") % RANGE_MOD).alias("k"),
                (col("id") * 3 - (1 << 24)).alias("v")))
            surface_run("range" if parts == 1 else "range_4", df.collect,
                        lambda g, w: _check_grouped(g, (rk, rs, rc), w),
                        f"range(0, 2^25) over {parts} partition(s), k = "
                        f"id % 100000, v = 3 id - 2^24, grouped by k: "
                        f"sum(v), count", sr)
        start, end, step = 3 * (1 << 20) + 11, -7, -3
        neg_want = np.arange(start, end, step, dtype=np.int64)

        def check_neg(got, what):
            if not np.array_equal(got["id"].to_numpy(), neg_want):
                raise AssertionError(f"{what}: differs from np.arange")
        surface_run("range_neg", sv.range(start, end, step).collect,
                    check_neg, f"range({start}, {end}, {step}): "
                    f"{len(neg_want)} rows, the second batch ending at "
                    f"row {len(neg_want) - (1 << 20)}", sv)
    except Exception:
        failures.append("surface (range)")
        traceback.print_exc()

    try:
        un = fact_df.filter(col("v") > 0).union(
            fact_df.filter(col("v") <= 0))
        surface_run("union", sum_count(un).collect,
                    lambda g, w: _check_grouped(g, all_want, w),
                    "fact.filter(v > 0).union(fact.filter(v <= 0)) grouped "
                    "by k: sum(v), count (q1 without its filter)", sv)

        def check_150(got, what):
            if got.num_rows != 150:
                raise AssertionError(f"{what}: {got.num_rows} rows")
        surface_run("union_limit", un.limit(150).collect, check_150,
                    "the union's limit(150)", sv)
    except Exception:
        failures.append("surface (union)")
        traceback.print_exc()

    try:
        uk = _bincount_keys(k_np, RANGE_MOD)
        m_np = np.fmod(v_np, 7)
        ukm = _bincount_keys(k_np * 13 + (m_np + 6), RANGE_MOD * 13)
        kd_want = (uk,)
        km_want = (ukm // 13, ukm % 13 - 6)
        distinct_caps = {}
        for parts in (1, 4):
            sd = GpuSession()
            df = sd.create_dataframe(table, num_partitions=parts).select(
                col("k")).distinct()
            run = "distinct_k" if parts == 1 else "distinct_k_4"
            surface_run(run, df.collect,
                        lambda g, w: _check_grouped(g, kd_want, w),
                        f"select(k).distinct() over {parts} partition(s) "
                        f"({len(uk)} rows)", sd)
            with _Capture(agg_mod, "segment_reduce_sorted") as cap:
                df.collect()
            distinct_caps[run] = cap
        dkm = fact_df.select(col("k"), (col("v") % 7).alias("m")).distinct()

        def check_km(got, what):
            got = got.sort_by([("k", "ascending"), ("m", "ascending")])
            if got.num_rows != len(ukm) or not (
                    np.array_equal(got["k"].to_numpy(), km_want[0]) and
                    np.array_equal(got["m"].to_numpy(), km_want[1])):
                raise AssertionError(f"{what}: differs from numpy "
                                     f"({got.num_rows} rows, {len(ukm)})")
        surface_run("distinct_km", dkm.collect, check_km,
                    f"select(k, v % 7).distinct() ({len(ukm)} rows)", sv)
        with _Capture(agg_mod, "segment_reduce_sorted") as cap:
            dkm.collect()
        distinct_caps["distinct_km"] = cap
        if st_fact is not None:
            uks = _bincount_keys(k_np * 2 + (v_np > 0), RANGE_MOD * 2)
            ks, pos = uks // 2, uks % 2
            s_want = pa.table({"rf": _one_byte(ks % 3, b"ARN"),
                               "ls": _one_byte(pos, b"FO"),
                               "s": _customer_names(ks)})
            order = [("s", "ascending"), ("ls", "ascending")]
            s_want = s_want.sort_by(order)
            sst = GpuSession()
            dss = sst.create_dataframe(st_fact).select(
                col("rf"), col("ls"), col("s")).distinct()

            def check_ss(got, what):
                if not _same_strings_table(got.sort_by(order), s_want):
                    raise AssertionError(f"{what}: differs from numpy")
            surface_run("distinct_s", dss.collect, check_ss,
                        f"select(rf, ls, s).distinct() on the string table "
                        f"({s_want.num_rows} rows)", sst)
            with _Capture(agg_mod, "segment_reduce_sorted") as cap:
                dss.collect()
            distinct_caps["distinct_s"] = cap
            del sst, dss
        for run, cap in distinct_caps.items():
            calls = _k3_no_op_check(torch, cap, agg_mod, run)
            print(f"K3 with an empty op set at {run}'s shapes: {calls} "
                  f"call(s) equal the plain version (group count and each "
                  f"group's first row)")
        args = next(a for _, a in distinct_caps["distinct_k"].calls
                    if not a[2])
        orig = distinct_caps["distinct_k"].orig["segment_reduce_sorted"]
        n_d = int(args[0][0].shape[0])
        g_d = orig(*args)[3]
        kernel_rows["segment_reduce_sorted_distinct"] = dict(
            source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
            replaces="spark_rapids_tpu/exec/aggregate.py:50",
            max_abs_err=0.0,
            ms=cuda_ms(lambda: orig(*args)),
            plain_ms=cuda_ms(lambda: agg_mod.segment_reduce_sorted_plain(
                *args)),
            library_ms=None,
            bound_ms=bound((8 * len(args[0]) + 4) * n_d + 4 * g_d))
        r = kernel_rows["segment_reduce_sorted_distinct"]
        print(f"K3 with no op at distinct(k)'s shape ({n_d} rows, "
              f"{len(args[0])} words, {g_d} groups): {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f}; "
              f"{card}")
        del distinct_caps, args, orig
    except Exception:
        failures.append("surface (distinct)")
        traceback.print_exc()

    try:
        for parts in (1, 4):
            ss = GpuSession()
            s_want, kept = _sample_oracle(table, parts)
            df = sum_count(ss.create_dataframe(
                table, num_partitions=parts).sample(SAMPLE_FRACTION,
                                                    seed=SAMPLE_SEED))
            surface_run("sample" if parts == 1 else "sample_4", df.collect,
                        lambda g, w, sw=s_want: _check_grouped(g, sw, w),
                        f"sample(0.1, seed=7) over {parts} partition(s) "
                        f"({kept} rows kept, the numpy mixer's rows bit for "
                        f"bit), grouped by k: sum(v), count", ss)

        surface_run("sample_all", fact_df.sample(1.0).count,
                    check_n(ROWS), "sample(1.0).count()", sv)
        surface_run("sample_none", fact_df.sample(0.0).count, check_n(0),
                    "sample(0.0).count()", sv)
    except Exception:
        failures.append("surface (sample)")
        traceback.print_exc()

    try:
        rdf = fact_df.repartition(8, col("k")).filter(col("v") > THRESHOLD)
        surface_run("repart_q1", q1_agg(rdf).collect,
                    lambda g, w: _check_q1(g, q1_want, w),
                    "repartition(8, k), then q1", sv)
        surface_run("repart_count", fact_df.repartition(8).count,
                    check_n(ROWS), "repartition(8).count()", sv)
    except Exception:
        failures.append("surface (repartition)")
        traceback.print_exc()

    try:
        sc = GpuSession()
        cdf = sc.create_dataframe(table).filter(
            col("v") > THRESHOLD).cache()
        entry = cb_mod.CacheManager.lookup(cdf._lp)
        if cdf.limit(5).collect().num_rows != 5 or entry.materialized:
            raise AssertionError("a run under limit(5) materialized the "
                                 "cache")
        q = q1_agg(cdf)
        split = {}

        def tap(name):
            fn = getattr(cb_mod, name)

            def timed(*a):
                k9, k10 = fetch.lane_stats.launches, fetch.pack_lanes.launches
                t = time.perf_counter()
                out = fn(*a)
                split[name] = split.get(name, 0.0) + \
                    (time.perf_counter() - t) * 1e3
                if name == "to_host_batch":
                    split["k9"] = split.get("k9", 0) + \
                        fetch.lane_stats.launches - k9
                    split["k10"] = split.get("k10", 0) + \
                        fetch.pack_lanes.launches - k10
                return out
            setattr(cb_mod, name, timed)
            return fn

        def cache_run(run, what):
            split.clear()
            orig = {n: tap(n) for n in ("to_host_batch", "encode_batch",
                                        "decode_blob", "batch_to_device")}
            try:
                count_reset()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = q.collect()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
                launches[run] = counts()
            finally:
                for n, fn in orig.items():
                    setattr(cb_mod, n, fn)
            _check_q1(got, q1_want, what)
            nodes = _placements(sc.last_plan)
            if any(p != "gpu" for _, p in nodes[1:]):
                raise AssertionError(f"{what} placed {nodes}")
            return wall, dict(split), nodes

        w1, s1, n1 = cache_run("cache_write", "the cache's first run")
        if not (entry.materialized and cdf.is_cached and
                plan_has(sc, "CacheWriteExec")):
            raise AssertionError(f"the first run did not materialize the "
                                 f"cache: {n1}")
        if not (s1.get("k9", 0) > 0 and s1.get("k10", 0) > 0):
            raise AssertionError(f"the cache write fetched without K9 and "
                                 f"K10: {s1}")
        w2, s2, n2 = cache_run("cache_scan", "the cache's second run")
        if not plan_has(sc, "CachedScanExec") or \
                plan_has(sc, "LocalScanExec"):
            raise AssertionError(f"the second run read {n2}")
        warm2 = timed_walls(q.collect)
        cdf.unpersist()
        if cdf.is_cached:
            raise AssertionError("is_cached after unpersist()")
        w3, _, n3 = cache_run("cache_recompute", "the run after unpersist")
        if plan_has(sc, "CachedScanExec") or plan_has(sc, "CacheWriteExec"):
            raise AssertionError(f"the run after unpersist read {n3}")
        warm3 = timed_walls(q.collect)
        print(f"surface cache of fact.filter(v > {THRESHOLD}) "
              f"({entry.size_bytes} parquet bytes in "
              f"{sum(len(p.blobs) for p in entry.partitions)} blob(s)), "
              f"q1 over it three times: first (materialize, "
              f"{[n for n, _ in n1]}) {w1:.1f} ms, of which the fetch "
              f"({s1['k9']} K9, {s1['k10']} K10 launches) "
              f"{s1.get('to_host_batch', 0):.1f} and the parquet "
              f"encode {s1.get('encode_batch', 0):.1f}; second (cached "
              f"scan, {[n for n, _ in n2]}) {w2:.1f} ms, of which decode "
              f"{s2.get('decode_blob', 0):.1f} and upload "
              f"{s2.get('batch_to_device', 0):.1f}, warm walls "
              f"{', '.join(f'{w:.1f}' for w in warm2)}; third (after "
              f"unpersist, recomputed) {w3:.1f} ms, warm walls "
              f"{', '.join(f'{w:.1f}' for w in warm3)}; a limit(5) run "
              f"left it unmaterialized; launches first "
              f"{ {k: v for k, v in launches['cache_write'].items() if v} }"
              f"; {card}")
        del cdf, q, entry
        if st_fact is not None:
            # the whole string table: K16 fetches the chars, and the
            # parquet blobs carry them both ways at the main path's size
            cs = sc.create_dataframe(st_fact).select(
                col("s"), col("c"), col("v")).cache()
            want_s = st_fact.select(["s", "c", "v"])
            walls = []
            for i in range(2):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got_s = cs.collect()
                walls.append((time.perf_counter() - t1) * 1e3)
                if not _same_strings_table(got_s, want_s):
                    raise AssertionError(f"the cached (s, c, v) differs, "
                                         f"run {i + 1}")
                del got_s
            if not plan_has(sc, "CachedScanExec"):
                raise AssertionError("the string cache was not scanned")
            sentry = cb_mod.CacheManager.lookup(cs._lp)
            print(f"surface cache of the string table's (s, c, v) at "
                  f"{want_s.num_rows} rows ({want_s['c'].null_count} null "
                  f"comments, {sentry.size_bytes} parquet bytes): "
                  f"written in {walls[0]:.1f} ms, then scanned in "
                  f"{walls[1]:.1f} ms, equal both times; {card}")
            cs.unpersist()
            del cs, want_s, sentry
        del sc
    except Exception:
        failures.append("surface (cache)")
        traceback.print_exc()
    finally:
        cb_mod.CacheManager.clear()

    try:
        surface_run("act_count", fact_df.count, check_n(ROWS),
                    "count()", sv)
        if fact_df.dtypes != [("k", "bigint"), ("v", "bigint"),
                              ("f", "double")]:
            raise AssertionError(f"dtypes {fact_df.dtypes}")
        fq = fact_df.filter(col("v") > THRESHOLD)
        surface_run("act_pandas", q1_agg(fq).to_pandas,
                    lambda g, w: _check_q1(pa.Table.from_pandas(
                        g, preserve_index=False), q1_want, w),
                    "q1 through to_pandas()", sv)
        ft = table.filter(pc.greater(table["v"], THRESHOLD))
        mm = ft.group_by("k").aggregate([("v", "min"), ("v", "max")]) \
            .sort_by("k")
        shorthands = {
            "sum": (lambda: fq.group_by(col("k")).sum("v").collect(),
                    (q1_want["k"].to_numpy(), q1_want["v_sum"].to_numpy())),
            "count": (lambda: fq.group_by(col("k")).count().collect(),
                      (q1_want["k"].to_numpy(),
                       q1_want["k_count"].to_numpy())),
            "min": (lambda: fq.group_by(col("k")).min("v").collect(),
                    (mm["k"].to_numpy(), mm["v_min"].to_numpy())),
            "max": (lambda: fq.group_by(col("k")).max("v").collect(),
                    (mm["k"].to_numpy(), mm["v_max"].to_numpy()))}
        for name, (fn, w_) in shorthands.items():
            surface_run(f"act_g{name}", fn,
                        lambda g, w, w_=w_: _check_grouped(g, w_, w),
                        f"q1's group_by(k).{name}()", sv)

        def check_avg(got, what):
            got = got.sort_by("k")
            a, b = got["avg(f)"].to_numpy(), q1_want["f_mean"].to_numpy()
            if not np.array_equal(got["k"].to_numpy(),
                                  q1_want["k"].to_numpy()) or \
                    not np.allclose(a, b, rtol=FLOAT_RTOL, atol=0.0):
                raise AssertionError(f"{what}: differs from pyarrow")
        surface_run("act_gavg", lambda: fq.group_by(col("k")).avg(
            "f").collect(), check_avg, "q1's group_by(k).avg(f)", sv)
        del ft, mm, fq
    except Exception:
        failures.append("surface (actions)")
        traceback.print_exc()
    del fact_df, sv, all_g, k_np, v_np
    print(f"surface phases: {time.perf_counter() - t_surface:.1f} s, the "
          f"oracles and the cache's blobs included")

    del st_fact, st_dim

    phase_done("the DataFrame surface: range, union, distinct, sample")
    # ---- the flat types: K3's 128-bit folds, 2-byte lanes, q1d, q1, qn --
    t_types = time.perf_counter()
    k3_synth = None
    try:
        t1 = time.perf_counter()
        n_cases, k3_synth = _k3_128_cases(torch, dev, agg_mod, carry,
                                          cuda_ms, ROWS)
        print(f"K3 128-bit sum and DECIMAL128 min/max: {n_cases} cases on "
              f"the planned path, the direct one and the records, exact "
              f"(DECIMAL(15,2) and DECIMAL(30,2), carries across the low "
              f"word, wrap past 2^127, tile edges); the synthetic call "
              f"({ROWS} rows, 6 groups, 2 key words, a DECIMAL(15,2) sum, "
              f"sum, min and max of DECIMAL(30,2), a count) "
              f"{k3_synth['ms']:.3f} ms planned ({k3_synth['path']}), "
              f"direct {k3_synth['direct_ms']:.3f}, records "
              f"{k3_synth['record_ms']:.3f}, plain "
              f"{k3_synth['plain_ms']:.3f}, bound "
              f"{k3_synth['bound_ms']:.3f}; "
              f"{time.perf_counter() - t1:.1f} s; {card}")
    except Exception:
        failures.append("K3 128-bit")
        traceback.print_exc()
    try:
        t1 = time.perf_counter()
        n_cases = _k3_run_cases(torch, dev, agg_mod, carry)
        print(f"K3 over orders of few runs (the run path): "
              f"{n_cases} cases exact on the planned path, the records, "
              f"the direct path planned, on the run path and in tiles of "
              f"sorted rows "
              f"(1-65 runs, runs ending inside tiles, carries and ties "
              f"across tiles, one 2^25-row group, 100,000 groups, no "
              f"contributor, 0 and 1 row; a DECIMAL64 sum through its "
              f"signs beside DECIMAL128 ops); "
              f"{time.perf_counter() - t1:.1f} s")
    except Exception:
        failures.append("K3 run path")
        traceback.print_exc()
    try:
        # K3's 128-bit buffers through PARTIAL (8 batches) and the merge
        from spark_rapids_tpu_torch.expr.aggregates import Max, Min
        t1 = time.perf_counter()
        dec_table = _decimal_table(ROWS)
        dec_want = pa.TableGroupBy(dec_table, ["k"], use_threads=False
                                   ).aggregate([
            ("d15", "sum"), ("d30", "sum"), ("d30", "min"), ("d30", "max"),
            ("k", "count")])
        print(f"decimal table of {ROWS} rows and its pyarrow oracle: "
              f"{time.perf_counter() - t1:.1f} s")
        dec_agg = GpuHashAggregateExec([A("k")], [
            AggregateExpression(Sum(A("d15")), "s15"),
            AggregateExpression(Sum(A("d30")), "s30"),
            AggregateExpression(Min(A("d30")), "mn"),
            AggregateExpression(Max(A("d30")), "mx"),
            AggregateExpression(Count(None), "c")], COMPLETE,
            LocalScanExec(dec_table, batch_rows=BATCH_ROWS))
        _check_decimal_groups(dec_agg.execute_collect(ExecContext(dev)),
                              dec_want, "decimal exec (cold)")
        count_reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = dec_agg.execute_collect(ExecContext(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches["dec_batches"] = counts()
        _check_decimal_groups(got, dec_want, "decimal exec (8 batches)")
        print(f"decimal exec ({ROWS // BATCH_ROWS} batches of {BATCH_ROWS} "
              f"rows, group by k over 1,000 groups: sum of DECIMAL(15,2), "
              f"sum, min and max of DECIMAL(30,2), count; each batch's "
              f"update, then the merge of the 128-bit buffers): equals "
              f"pyarrow; warm wall {wall * 1e3:.1f} ms; launches "
              f"{launches['dec_batches']}; {card}")
        del dec_table, dec_want, dec_agg, got
    except Exception:
        failures.append("decimal exec (8 batches)")
        traceback.print_exc()
    try:
        t1 = time.perf_counter()
        n_cases, times, info = _short_lane_cases(
            torch, dev, carry, gather_mod, fetch, jk, t, DeviceColumn,
            bucket_for, cuda_ms, ROWS)
        print(f"2-byte lanes: {n_cases} cases of K1, K8 (both paths), K13 "
              f"(both paths), K10 and K5 on int16 lanes at n = "
              f"{', '.join(str(x) for x in SHORT_ROWS)} and {ROWS}, "
              f"exact; at {ROWS} rows (ms) "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
              + f"; {time.perf_counter() - t1:.1f} s; {card}")
        for name, src, rep, k in (
                ("compact_rows", "compact.cu", "ops/carry.py:151", "K1"),
                ("gather_rows", "gather_rows.cu", "ops/carry.py:162", "K8"),
                ("scatter_rows", "scatter_rows.cu", "exec/window.py:517",
                 "K13"),
                ("pack_lanes", "fetch_pack.cu", "columnar/fetch.py:330",
                 "K10"),
                ("expand_pairs", "join_expand.cu",
                 "ops/join_kernels.py:111", "K5")):
            r = info[k]
            kernel_rows[f"{name}_int16"] = dict(
                source=f"spark_rapids_tpu_torch/csrc/{src}",
                replaces=f"spark_rapids_tpu/{rep}", max_abs_err=0.0,
                ms=times[f"{k}_2B"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                extra=dict(ms_4_byte_lane=times[f"{k}_4B"],
                           rows=r["rows"]))
    except Exception:
        failures.append("2-byte lanes")
        traceback.print_exc()

    def path_run(run, fn, check, what, reps=3):
        """A main-path run of the types slice: cold, then ``reps`` warm
        runs (the first with its launches counted), then a trace (not for
        a run of one warm repetition: those wait on the host, idle 0.999
        and more); each result checked."""
        t1 = time.perf_counter()
        check(fn(), f"{what} (cold)")
        cold = time.perf_counter() - t1
        count_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        walls = [(time.perf_counter() - t1) * 1e3]
        launches[run] = counts()
        check(got, what)
        walls += timed_walls(fn, reps - 1)
        trace = _profile(torch, fn) if reps > 1 else dict(
            busy_ms=float("nan"), idle_share=float("nan"), top=[])
        k3_ms = sum(ms for n, ms in trace["top"] if "fold_kernel" in n)
        print(f"{what}: equals its oracle; cold wall {cold * 1e3:.1f} ms, "
              f"warm walls {', '.join(f'{w:.1f}' for w in walls)} ms, "
              f"median {sorted(walls)[len(walls) // 2]:.1f}; busy "
              f"{trace['busy_ms']:.2f} "
              f"ms, idle share {trace['idle_share']:.3f}; K3's fold "
              f"{k3_ms:.3f} ms; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; top "
              f"kernels (ms): "
              + ", ".join(f"{n}={ms:.3f}" for n, ms in trace["top"][:6])
              + f"; launches {launches[run]}; {card}")
        return got

    li_table = li_raw = None
    try:
        t1 = time.perf_counter()
        li_table, li_raw = _lineitem(ROWS)
        q1d_want, _ = _q1_oracles(li_raw)
        print(f"lineitem of {ROWS} rows and the q1d / q1 numpy oracles: "
              f"{time.perf_counter() - t1:.1f} s")
        for parts in (1, 4):
            sd = GpuSession()
            dfd = _q1d_df(sd, li_table, parts, F, col, lit)
            what = f"q1d over {parts} partition(s)"
            path_run("q1d" if parts == 1 else "q1d_4", dfd.collect,
                     lambda got, w: _check_rows(got, q1d_want, w), what)
            # q1d's own K3 calls against the plain version; the first
            # one-partition call is the kernel line's 128-bit row
            with _Capture(agg_mod, "segment_reduce_sorted") as cap:
                dfd.collect()
            row = _k3_call_row(torch, agg_mod, cap, cuda_ms, what)
            print(f"K3 at {what}: {len(cap.calls)} call(s) equal the plain "
                  f"version exactly; the first {row['ms']:.3f} ms "
                  f"({row['extra']['path']}), plain {row['plain_ms']:.3f}, "
                  f"bound {row['bound_ms']:.3f} ({row['extra']}); {card}")
            if parts == 1:
                if k3_synth is not None:
                    row["extra"].update({f"synthetic_{k}": v for k, v in
                                         k3_synth.items()})
                kernel_rows["segment_reduce_sorted_128"] = dict(
                    source="spark_rapids_tpu_torch/csrc/segment_reduce.cu",
                    replaces="spark_rapids_tpu/ops/segmented.py:401",
                    max_abs_err=0.0, library_ms=None, **row)
            nodes = _placements(sd.last_plan)
            if nodes[0] != ("DeviceToHostExec", "cpu") or \
                    any(p != "gpu" for _, p in nodes[1:]) or \
                    "!" in sd.last_explain:
                raise AssertionError(f"{what} placed {nodes}:\n"
                                     f"{sd.last_explain}")
            print(f"{what} placements: {nodes}")
    except Exception:
        failures.append("q1d")
        traceback.print_exc()
    try:
        _, q1t_want = _q1_oracles({k: v[:Q1_TEXT_ROWS]
                                   for k, v in li_raw.items()})
        sq = GpuSession()
        dfq = _q1_df(sq, li_table.slice(0, Q1_TEXT_ROWS), F, col, lit)
        path_run("q1", dfq.collect,
                 lambda got, w: _check_rows(got, q1t_want, w),
                 f"q1, the TPC-H Q1 text over {Q1_TEXT_ROWS} rows", reps=1)
        nodes = _placements(sq.last_plan)
        print(f"q1 placements: {nodes}")
        if nodes != Q1_PLACEMENTS:
            raise AssertionError(f"q1 placed {nodes}, the reference "
                                 f"{Q1_PLACEMENTS}")
    except Exception:
        failures.append("q1 (the TPC-H Q1 text)")
        traceback.print_exc()
    _date_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                 bound, path_run, li_table, li_raw)
    phase_done("the flat types: K3's 128-bit folds, 2-byte lanes, q1d, q1, "
               "dates")
    _agg_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                bound, path_run, li_table, li_raw, table)
    phase_done("the aggregates: K3's first and last, K23, qg1-qg4")
    del li_table, li_raw

    try:
        t1 = time.perf_counter()
        qn_table, qn_vals, qn_masks = _narrow_table(QN_ROWS)
        keep = qn_masks["s"] & qn_masks["f"] & (qn_vals["s"] > 0) & \
            (qn_vals["f"] < 0.5)
        qn_filtered = qn_table.filter(pa.array(keep))
        qn_groups = _qn_group_oracle(qn_table)
        qn_order = _qn_sort_oracle(qn_vals, qn_masks)
        print(f"qn table of {QN_ROWS} rows and its oracles: "
              f"{time.perf_counter() - t1:.1f} s")
        sn = GpuSession()
        dfn = sn.create_dataframe(qn_table)

        def check_equal(want):
            def check(got, w):
                if not got.equals(want):
                    raise AssertionError(f"{w} differs from pyarrow")
            return check

        path_run("qn_filter", lambda: dfn.filter(
            (col("s") > lit(0)) & (col("f") < lit(0.5))).collect(),
            check_equal(qn_filtered), "qn filter s > 0 and f < 0.5")
        path_run("qn_group", lambda: dfn.group_by(col("b"), col("dt")).agg(
            F.sum(col("s")).alias("ss"), F.min(col("s")).alias("mns"),
            F.max(col("s")).alias("mxs"), F.sum(col("f")).alias("sf"),
            F.min(col("f")).alias("mnf"), F.max(col("f")).alias("mxf"),
            F.min(col("ts")).alias("mnt"), F.max(col("ts")).alias("mxt"),
            F.sum(col("dec")).alias("sd"), F.min(col("dec")).alias("mnd"),
            F.max(col("dec")).alias("mxd"),
            F.count("*").alias("c")).collect(),
            lambda got, w: _check_qn_groups(got, qn_groups, w),
            "qn group by (b, dt)")
        for run, limit in (("qn_sort", None), ("qn_topn", 1000)):
            want_rid = qn_order if limit is None else qn_order[:limit]

            def q(limit=limit):
                d = dfn.sort(col("ts").desc(), col("f"))
                return (d if limit is None else d.limit(limit)).collect()

            def check(got, w, want_rid=want_rid):
                if not np.array_equal(got["rid"].to_numpy(), want_rid):
                    raise AssertionError(f"{w}: rows out of order")
                if not got.equals(qn_table.take(pa.array(want_rid))):
                    raise AssertionError(f"{w}: columns differ")
            path_run(run, q, check, f"qn sort(ts desc, f)"
                     + ("" if limit is None else f".limit({limit})"))
        out_dir = tempfile.mkdtemp(prefix="qn_parquet_")
        try:
            qn_part = qn_table.slice(0, QN_WRITE_ROWS)
            dfw = sn.create_dataframe(qn_part)

            def write_back():
                dfw.write.mode("overwrite").parquet(out_dir)
                return pq.read_table(out_dir).sort_by("rid")

            path_run("qn_write", write_back, check_equal(qn_part),
                     f"qn parquet write of {QN_WRITE_ROWS} rows, read back "
                     f"by pyarrow", reps=1)
            t1 = time.perf_counter()
            back = sn.read.parquet(out_dir).collect().sort_by("rid")
            if not back.equals(qn_part):
                raise AssertionError("qn's parquet read through the port "
                                     "differs")
            print(f"qn parquet read back through the port: equal, "
                  f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        del qn_table, qn_filtered, qn_groups, qn_order, dfn, dfw, qn_part
    except Exception:
        failures.append("qn (the narrow types)")
        traceback.print_exc()
    print(f"types phases: {time.perf_counter() - t_types:.1f} s")

    phase_done("the flat types: qn")
    _nested_phases(torch, dev, card, launches, kernel_rows, failures,
                   cuda_ms, bound, path_run)
    phase_done("the nested types")
    torch.cuda.empty_cache()
    _text_phases(torch, dev, card, launches, kernel_rows, failures, cuda_ms,
                 bound, path_run)
    phase_done("the string functions")
    print("phase seconds: " + ", ".join(f"{n} {s:.1f}" for n, s in
                                         phase_secs)
          + f"; total {time.perf_counter() - t_start:.1f} s")

    path_kernels = {
        "dataframe": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "batches": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q2": ("key_hash", "sort_order", "hash_table", "join_probe",
               "expand_ends", "expand_pairs", "segment_reduce_sorted"),
        "q6": ("key_hash", "sort_order", "hash_table", "join_probe",
               "expand_ends", "expand_pairs", "segment_reduce_sorted"),
        "q1_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q1x": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q1x_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q3": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "q3_4": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "topn": ("sort_order", "gather_rows", "lane_stats", "pack_lanes"),
        "q4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
               "scatter_rows", "lane_stats", "pack_lanes"),
        "q4_4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
                 "scatter_rows", "lane_stats", "pack_lanes"),
        "q3_assisted": ("sort_order", "gather_rows", "lane_stats",
                        "pack_lanes"),
        "q3_assisted_4": ("sort_order", "gather_rows", "lane_stats",
                          "pack_lanes"),
        "q5": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q5_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "q7": ("lane_stats", "pack_lanes"),
        "q7_direct": ("compact_rows", "lane_stats", "pack_lanes"),
        "qs1": ("compact_rows", "sort_order", "segment_reduce_sorted",
                "string_hashes", "gather_strings"),
        "qs1_4": ("compact_rows", "sort_order", "segment_reduce_sorted",
                  "string_hashes", "gather_strings"),
        "qs2": ("compact_rows", "sort_order", "segment_reduce_sorted",
                "string_hashes", "gather_strings"),
        "qs3": ("string_hashes", "key_hash", "sort_order", "hash_table",
                "join_probe", "expand_ends", "expand_pairs",
                "gather_strings"),
        "qs4": ("order_keys", "sort_order", "gather_rows",
                "gather_strings"),
        "qs4_topn": ("order_keys", "sort_order", "gather_rows",
                     "gather_strings"),
        "hash_s": ("hash_bytes",),
        "range": ("sort_order", "segment_reduce_sorted"),
        "range_4": ("sort_order", "segment_reduce_sorted"),
        "range_neg": (),
        "union": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "union_limit": ("compact_rows",),
        "distinct_k": ("sort_order", "segment_reduce_sorted"),
        "distinct_k_4": ("sort_order", "segment_reduce_sorted"),
        "distinct_km": ("sort_order", "segment_reduce_sorted"),
        "distinct_s": ("string_hashes", "sort_order",
                       "segment_reduce_sorted", "gather_strings"),
        "sample": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "sample_4": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "sample_all": ("compact_rows", "segment_reduce_sorted"),
        "sample_none": ("compact_rows", "segment_reduce_sorted"),
        "repart_q1": ("compact_rows", "sort_order", "segment_reduce_sorted"),
        "repart_count": ("segment_reduce_sorted",),
        "cache_write": ("compact_rows", "sort_order",
                        "segment_reduce_sorted"),
        "cache_scan": ("sort_order", "segment_reduce_sorted"),
        "cache_recompute": ("compact_rows", "sort_order",
                            "segment_reduce_sorted"),
        "act_count": ("segment_reduce_sorted",),
        **{f"act_{a}": ("compact_rows", "sort_order", "segment_reduce_sorted")
           for a in ("pandas", "gsum", "gcount", "gmin", "gmax", "gavg")},
        # the flat types
        "dec_batches": ("sort_order", "segment_reduce_sorted"),
        "q1d": ("compact_rows", "sort_order", "segment_reduce_sorted",
                "string_hashes", "gather_strings", "gather_rows",
                "order_keys"),
        "q1d_4": ("compact_rows", "sort_order", "segment_reduce_sorted",
                  "string_hashes", "gather_strings", "gather_rows",
                  "order_keys"),
        "q1": ("compact_rows", "sort_order", "gather_rows",
               "gather_strings", "order_keys"),
        "qn_filter": ("compact_rows",),
        "qn_group": ("sort_order", "segment_reduce_sorted"),
        "qn_sort": ("sort_order", "gather_rows"),
        "qn_topn": ("sort_order", "gather_rows"),
        "qn_write": (),
        # the nested types
        "qa1": ("compact_rows", "gather_strings", "span_rows",
                "gather_rows"),
        "qa1_4": ("compact_rows", "gather_strings", "span_rows",
                  "gather_rows"),
        "qa2": ("gather_rows", "gather_strings"),
        "qa3": ("string_hashes", "sort_order", "segment_reduce_sorted",
                "gather_rows", "gather_strings"),
        "qa3_4": ("string_hashes", "sort_order", "segment_reduce_sorted",
                  "gather_rows", "gather_strings"),
        "qa4": ("key_hash", "sort_order", "hash_table", "join_probe",
                "expand_ends", "expand_pairs", "gather_strings",
                "span_rows", "gather_rows"),
        "qa5_union": ("compact_rows", "gather_strings", "span_rows",
                      "gather_rows"),
        "qa5_parquet": ("compact_rows", "gather_strings", "span_rows",
                        "gather_rows"),
        "qa5_cache": (),
        # the string functions
        "qt1": ("string_find", "compact_rows", "sort_order",
                "segment_reduce_sorted"),
        "qt2": ("string_find", "compact_rows", "segment_reduce_sorted"),
        "qt3": ("utf8_cut", "gather_strings", "compact_rows", "sort_order",
                "segment_reduce_sorted"),
        "qt4": ("string_find", "utf8_cut", "string_map", "gather_strings"),
        # dates, bitwise and the small leaves
        "qd1": ("date_fields", "sort_order", "segment_reduce_sorted"),
        "qd1_4": ("date_fields", "sort_order", "segment_reduce_sorted"),
        "qd2": ("date_fields",),
        "qd2_window": ("sort_order", "segment_reduce_sorted"),
        "qd2_subquery": ("date_fields", "compact_rows", "sort_order",
                         "segment_reduce_sorted"),
        # the aggregates
        "qg1": ("sort_order", "segment_reduce_sorted", "compact_rows"),
        "qg1_4": ("sort_order", "segment_reduce_sorted", "compact_rows"),
        "qg2": ("sort_order", "segment_reduce_sorted", "compact_rows",
                "string_hashes", "gather_strings"),
        "qg2_4": ("sort_order", "segment_reduce_sorted", "compact_rows",
                  "string_hashes", "gather_strings", "span_rows"),
        "qg3_pct": ("sort_order", "segment_reduce_sorted", "compact_rows",
                    "string_hashes"),
        "qg3_pct_4": ("sort_order", "segment_reduce_sorted", "compact_rows",
                      "string_hashes", "span_rows"),
        "qg3_pivot": ("date_fields", "sort_order", "segment_reduce_sorted"),
        "qg3_pivot_4": ("date_fields", "sort_order",
                        "segment_reduce_sorted"),
        "qg4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
                "frame_pick", "scatter_rows"),
        "qg4_4": ("sort_order", "gather_rows", "segment_scan", "run_ends",
                  "frame_pick", "scatter_rows")}
    # every download through DeviceToHostExec is the packed fetch now
    for run in ("dataframe", "q2", "q6", "q1_4", "q1x", "q1x_4", "q5",
                "q5_4", "qs1", "qs1_4", "qs2", "qs3", "qs4", "qs4_topn",
                "hash_s", "range", "range_4", "range_neg", "union",
                "union_limit", "distinct_k", "distinct_k_4", "distinct_km",
                "distinct_s", "sample", "sample_4", "sample_all",
                "sample_none", "repart_q1", "repart_count", "cache_write",
                "cache_scan", "cache_recompute", "act_count", "act_pandas",
                "act_gsum", "act_gcount", "act_gmin", "act_gmax",
                "act_gavg", "q1d", "q1d_4", "q1", "qn_filter", "qn_group",
                "qn_sort", "qn_topn", "qn_write", "qa1", "qa1_4", "qa2",
                "qa3", "qa3_4", "qa4", "qa5_union", "qa5_parquet",
                "qa5_cache", "qt1", "qt2", "qt3", "qt4", "qd1", "qd1_4",
                "qd2", "qd2_window", "qd2_subquery", "qg1", "qg1_4", "qg2",
                "qg2_4", "qg3_pct", "qg3_pct_4", "qg3_pivot", "qg3_pivot_4",
                "qg4", "qg4_4"):
        path_kernels[run] += ("lane_stats", "pack_lanes")
    for run, names in path_kernels.items():
        if run not in launches:
            failures.append(f"launch counts of the {run} run missing")
            continue
        for name in names:
            if launches[run][name] <= 0:
                failures.append(f"{name} not launched on the {run} run")
    if "batches" in launches and \
            launches["batches"]["sort_order"] != ROWS // BATCH_ROWS + 1:
        # one sort per batch and the canonical merge's, which K3 then
        # reads through: no second sort of the merge input
        failures.append(f"sort_order launched "
                        f"{launches['batches']['sort_order']} times on the "
                        f"batches run, not {ROWS // BATCH_ROWS + 1}")

    if kernel_rows:
        # launches on the main path each kernel belongs to: q1 for K1-K3,
        # q2 for K4-K7, q3 for K8-K10, q4 for K11-K13, qs2 for K14, the
        # 2^20-row F.hash for K15, qs4 for K16 and K17, qa1 for K18, qt1
        # for K19, qt3 for K20, qt4 for K21, qd1 for K22, qg2 for K3's
        # first and last, qg4 for K23
        run_of = {"key_hash": "q2", "join_probe": "q2", "expand_ends": "q2",
                  "expand_pairs": "q2", "gather_rows": "q3",
                  "segment_reduce_sorted_minmax": "q1x",
                  "lane_stats": "q3", "pack_lanes": "q3",
                  "segment_scan": "q4", "run_ends": "q4",
                  "scatter_rows": "q4", "string_hashes": "qs2",
                  "hash_bytes": "hash_s", "gather_strings": "qs4",
                  "gather_strings_flags": "qs1", "order_keys": "qs4",
                  "segment_reduce_sorted_distinct": "distinct_k",
                  "segment_reduce_sorted_128": "q1d",
                  "compact_rows_int16": "qn_filter",
                  "gather_rows_int16": "qn_sort",
                  "scatter_rows_int16": "q4",
                  "pack_lanes_int16": "qn_filter",
                  "expand_pairs_int16": "q2",
                  "span_rows": "qa1", "string_find": "qt1",
                  "utf8_cut": "qt3", "string_map": "qt4",
                  "date_fields": "qd1",
                  "segment_reduce_sorted_first_last": "qg2",
                  "frame_pick": "qg4"}
        counted_as = {"segment_reduce_sorted_minmax": "segment_reduce_sorted",
                      "gather_strings_flags": "gather_strings",
                      "segment_reduce_sorted_distinct":
                          "segment_reduce_sorted",
                      "segment_reduce_sorted_128": "segment_reduce_sorted",
                      "segment_reduce_sorted_first_last":
                          "segment_reduce_sorted",
                      **{f"{k}_int16": k for k in (
                          "compact_rows", "gather_rows", "scatter_rows",
                          "pack_lanes", "expand_pairs")}}
        print(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=r["source"],
                 replaces=r["replaces"],
                 launches=launches.get(run_of.get(name, "dataframe"),
                                       {}).get(counted_as.get(name, name),
                                               0),
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by="bytes", library_ms=r["library_ms"],
                 **r.get("extra", {}))
            for name, r in kernel_rows.items()]}))
    print(card)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
