"""Window operator.

Counterpart of spark_rapids_tpu/exec/window.py (WindowExec).  Per window
spec, the rows are sorted once by (padding word, partition words, order
words): K2 (``ops/carry.py:sort_order``) orders them and K8
(``ops/gather.py:gather_rows``) moves the input lanes and the key words
through the order.  Every function of the spec is then a vector
computation over the sorted rows:

- K11 (``ops/scan.py:segment_scan``) gives each row the start of its
  partition and of its peer run, the running count of run starts, and
  the running sums and valid counts that running and whole-partition
  aggregates read; K12 (``ops/scan.py:run_ends``) the last row of its
  partition and of its peer run;
- row_number, rank and dense_rank are differences of those positions;
  percent_rank, cume_dist and ntile divide by the partition's live row
  count (its end minus its start, plus one); lead and lag gather a
  shifted row of the same partition;
- a whole-partition aggregate reads the running value at the
  partition's end; RANGE UNBOUNDED PRECEDING..CURRENT ROW, Spark's
  default with ORDER BY, reads it at the end of the row's peer run, so
  tied rows share one value; running min and max are a segmented
  doubling scan; bounded ROWS and RANGE frames take per-row index bounds
  (a binary search per row for RANGE) over global prefix sums, and a
  sparse table for min and max;
- first and last take each row's frame bounds on every frame kind (a
  whole frame is the partition, a running ROWS frame its start to the
  row, a running RANGE frame its start to the end of the row's peer run)
  and K23 (``ops/scan.py:frame_pick``) picks the row; the column, of any
  type, is gathered there.

The results of one spec go back to input order through K13
(``ops/gather.py:scatter_rows``), in one launch for all its lanes, where
the reference sorts them back by the layout's order.  K8 moves each
distinct lane once, and a key as its validity and a value lane rather
than its sort words; K13 does not move a validity that is the live
mask.  A string key's words are its equality lanes (a partition key's
two hashes, K14; an order key's prefix words and length, K17, so peers
are the reference's peers); a string input follows the order through
K16, and a string result (lead, lag) goes back to input order through
K16 over the inverse permutation, which K13 writes (the reference
gathers its span results through ``inv``).  A CPU-placed WindowExec
runs the same code on CPU tensors, i.e. every kernel's plain version,
as the reference's numpy branch does.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import torch

from .. import types as t
from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch, DeviceColumn
from ..expr.aggregates import (AggregateExpression, AggregateFunction,
                               First, Last, bind_aggregate)
from ..expr.core import (ColumnValue, EvalContext, ScalarValue,
                         bind_expression, make_column)
from ..expr.window import (CURRENT_ROW, UNBOUNDED_FOLLOWING,
                           UNBOUNDED_PRECEDING, CumeDist, DenseRank, Lag,
                           Lead, NTile, PercentRank, Rank, RowNumber,
                           WindowExpression)
from ..ops import carry
from ..ops import segmented as seg
from ..ops.gather import (gather_column, gather_columns, gather_rows,
                          scatter_rows)
from ..ops.scan import (cumsum, frame_pick, run_ends, segment_scan,
                        segmented_doubling_scan)
from .base import MERGES, Exec, semantic_sig
from .concat import concat_batches


def _no_mark(stage: str) -> None:
    pass


def _equality_lanes(col: DeviceColumn, words) -> List[torch.Tensor]:
    """Lanes that are equal on two rows exactly when the rows' keys are
    equal (as their grouping words are): the validity, and the data (a
    DECIMAL128's two words), or for a double or a float its
    order-preserving word (NaN canonical, -0.0 == 0.0), or for a string
    its key ``words`` themselves.  The data under
    a null is zero."""
    if col.offsets is not None:
        return list(words)
    if col.dtype == t.DOUBLE:
        return [col.validity, seg.encode_float_ordered(col.data)]
    if col.dtype == t.FLOAT:
        return [col.validity, seg.encode_float_ordered32(col.data)]
    if col.data_hi is not None:         # a DECIMAL128: both words
        return [col.validity, col.data, col.data_hi]
    return [col.validity, col.data]


def _extreme(dtype: torch.dtype, is_min: bool):
    """The identity of a running min (the type's largest value) or max
    (its smallest)."""
    if dtype.is_floating_point:
        return math.inf if is_min else -math.inf
    if dtype == torch.bool:
        return is_min
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _vec_bound(values: torch.Tensor, target: torch.Tensor,
               lo0: torch.Tensor, hi0: torch.Tensor, cap: int,
               left: bool) -> torch.Tensor:
    """Per-row binary search: the first index in [lo0, hi0) where
    values[i] >= target (left) or > target (right).  ``values`` must be
    ascending within each row's window."""
    lo = lo0.to(torch.int64)
    hi = hi0.to(torch.int64)
    for _ in range(max(1, int(math.ceil(math.log2(max(cap, 2)))) + 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        v = values[torch.clamp(mid, 0, cap - 1)]
        pred = (v < target) if left else (v <= target)
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo.to(torch.int32)


def _rmq_query(vv: torch.Tensor, lo_i: torch.Tensor, hi_i: torch.Tensor,
               cap: int, op: str) -> torch.Tensor:
    """Min or max over each row's inclusive [lo_i, hi_i] by a sparse table
    of doubling spans (O(cap log cap))."""
    is_min = op == "min"
    init = _extreme(vv.dtype, is_min)
    fn = torch.minimum if is_min else torch.maximum
    levels = max(1, int(math.ceil(math.log2(max(cap, 2)))))
    st = [vv]
    for k in range(levels):
        sh = 1 << k
        cur = st[-1]
        shifted = torch.cat([cur[sh:], torch.full((min(sh, cap),), init,
                                                  dtype=cur.dtype,
                                                  device=cur.device)])
        st.append(fn(cur, shifted[:cap]))
    length = hi_i.to(torch.int64) - lo_i.to(torch.int64) + 1
    k_row = torch.zeros(cap, dtype=torch.int64, device=vv.device)
    for j in range(1, levels + 1):
        k_row = torch.where(length >= (1 << j), torch.full_like(k_row, j),
                            k_row)
    lo_c = torch.clamp(lo_i.to(torch.int64), 0, cap - 1)
    res = torch.full((cap,), init, dtype=vv.dtype, device=vv.device)
    for j in range(levels + 1):
        b = torch.clamp(hi_i.to(torch.int64) - (1 << j) + 1, 0, cap - 1)
        val = fn(st[j][lo_c], st[j][b])
        res = torch.where((k_row == j) & (length >= 1), val, res)
    return res


def _frame_of(w: WindowExpression) -> Tuple[str, int, int, bool, bool]:
    """(kind, start, end, whole, running) of an aggregate's frame."""
    kind, lo_b, hi_b = w.spec.effective_frame(False)
    whole = lo_b == UNBOUNDED_PRECEDING and hi_b == UNBOUNDED_FOLLOWING
    running = lo_b == UNBOUNDED_PRECEDING and hi_b == CURRENT_ROW
    return kind, lo_b, hi_b, whole, running


class _Layout:
    """The sorted rows one spec's window expressions share: one sort,
    the inputs moved through it, the boundaries, and K11's and K12's
    results."""

    __slots__ = ("order", "cap", "n_live", "live_s", "pos", "new_seg",
                 "new_run", "input_sorted", "okeys_sorted", "seg_start",
                 "run_start", "runs_cum", "seg_end", "run_end", "running")


class WindowExec(Exec):
    def __init__(self, window_exprs: List[WindowExpression], child: Exec):
        super().__init__([child])
        self.window_exprs = list(window_exprs)

    @property
    def output_names(self):
        return self.children[0].output_names + \
            [w.name for w in self.window_exprs]

    @property
    def output_types(self):
        cn, ct = (self.children[0].output_names,
                  self.children[0].output_types)
        return list(ct) + [w.resolved_type(cn, ct)
                           for w in self.window_exprs]

    def describe(self):
        return f"Window [{', '.join(w.name for w in self.window_exprs)}]"

    def partition_use(self):
        return MERGES       # rows regroup by the window's partition keys

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "frames evaluate over the per-spec sorted "
            "space (content-determined); rank/row_number over tied "
            "order keys follow arrival within the tie")

    # ------------------------------------------------------------------
    def _bound_agg(self, func):
        cn, ct = self.children[0].output_names, self.children[0].output_types
        return bind_aggregate(AggregateExpression(func), cn, ct).func

    def _input_exprs(self, w: WindowExpression):
        """Bound input expressions whose columns ride the layout sort, in
        the order _compute_one reads them."""
        cn, ct = self.children[0].output_names, self.children[0].output_types
        func = w.func
        if isinstance(func, (Lead, Lag)):
            return [bind_expression(func.children[0], cn, ct)]
        if isinstance(func, AggregateFunction):
            return [e for e, _ in self._bound_agg(func).update()]
        return []

    @staticmethod
    def _needs(w: WindowExpression) -> set:
        """The positions beyond seg_start that a function reads."""
        f = w.func
        if isinstance(f, AggregateFunction):
            kind, _, _, whole, running = _frame_of(w)
            if whole:
                return {"seg_end"}
            if running:
                return {"run_end"} if kind == "range" else set()
            return {"seg_end", "run_start", "run_end"}
        return {Rank: {"run_start"}, DenseRank: {"runs_cum"},
                PercentRank: {"run_start", "seg_end"},
                CumeDist: {"run_end", "seg_end"}, NTile: {"seg_end"},
                Lead: {"seg_end"}, Lag: {"seg_end"}}.get(type(f), set())

    def _build_layout(self, batch: DeviceBatch, ctx: EvalContext, spec,
                      input_cols, carry_okeys: bool,
                      mark=_no_mark) -> _Layout:
        cn, ct = self.children[0].output_names, self.children[0].output_types
        cap, n_live = batch.capacity, batch.num_rows
        pos = torch.arange(cap, dtype=torch.int32, device=batch.device)
        pkeys = [_eval_col(ctx, bind_expression(p, cn, ct))
                 for p in spec.partition_by]
        okeys = [(_eval_col(ctx, bind_expression(o, cn, ct)), asc, nf)
                 for o, asc, nf in spec.order_by]
        pkw = [seg.key_words_for_column(pk) for pk in pkeys]
        okw = [seg.sort_key_words(ok, asc, nf) for ok, asc, nf in okeys]
        pwords = [w for ws in pkw for w in ws]
        owords = [w for ws in okw for w in ws]
        cols = list(input_cols) + (
            [ok for ok, _, _ in okeys] if carry_okeys else [])
        padding = (pos >= n_live).to(torch.int64)
        mark("words")
        order = carry.sort_order([padding] + pwords + owords)
        mark("K2")
        # K8 moves each distinct lane once: the inputs, and per key its
        # validity and a value lane whose equality is the key's (the
        # reference carries the key words; the validity and the value
        # lane give the same boundaries, and an int64 key's value lane is
        # its data, often an input lane already)
        lanes = [x for c in cols if c.is_flat
                 for x in (c.data, c.validity, c.data_hi) if x is not None]
        pkey_lanes = [x for pk, ws in zip(pkeys, pkw)
                      for x in _equality_lanes(pk, ws)]
        okey_lanes = [x for (ok, _, _), ws in zip(okeys, okw)
                      for x in _equality_lanes(ok, ws)]
        distinct = {}
        for x in lanes + pkey_lanes + okey_lanes:
            distinct.setdefault(id(x), x)
        moved = dict(zip(distinct, gather_rows(order,
                                               list(distinct.values()))))
        spans = iter(gather_columns([c for c in cols if not c.is_flat],
                                    order))
        mark("K8")
        sorted_cols = [next(spans) if not c.is_flat else
                       DeviceColumn(c.dtype, moved[id(c.data)],
                                    moved[id(c.validity)], None,
                                    None if c.data_hi is None
                                    else moved[id(c.data_hi)])
                       for c in cols]
        psorted = [moved[id(x)] for x in pkey_lanes]
        osorted = [moved[id(x)] for x in okey_lanes]
        lay = _Layout()
        lay.order, lay.cap, lay.n_live, lay.pos = order, cap, n_live, pos
        # the padding word sorts the live rows first
        lay.live_s = pos < n_live
        lay.input_sorted = sorted_cols[:len(input_cols)]
        lay.okeys_sorted = [(c, asc, nf) for c, (_, asc, nf) in
                            zip(sorted_cols[len(input_cols):], okeys)]
        lay.new_seg = seg.segment_boundaries(psorted, lay.live_s) \
            if pkeys else pos == 0
        lay.new_run = seg.segment_boundaries(psorted + osorted, lay.live_s) \
            if okeys else lay.new_seg
        mark("boundaries")
        return lay

    def _scan(self, lay: _Layout, members, mark=_no_mark) -> dict:
        """One K11 launch (the positions, and a running sum and count for
        every buffer of a running or whole-partition aggregate) and one
        K12 launch for the spec.  Returns {(id(w), buffer): pair}."""
        needs, pairs, pair_of = set(), [], {}
        for w, start, ncols in members:
            needs |= self._needs(w)
            if isinstance(w.func, AggregateFunction) and \
                    not isinstance(w.func, First) and any(_frame_of(w)[3:]):
                ops = [op for _, op in self._bound_agg(w.func).update()]
                for j in range(ncols):
                    scol = lay.input_sorted[start + j]
                    pair_of[(id(w), j)] = len(pairs)
                    pairs.append((scol.data if ops[j] == "sum" else None,
                                  scol.validity & lay.live_s))
        runs = bool(needs & {"run_start", "runs_cum"})
        sc = segment_scan(lay.new_seg, lay.new_run if runs else None, pairs,
                          seg_start=True, run_start="run_start" in needs,
                          runs_cum="runs_cum" in needs)
        lay.seg_start, lay.run_start, lay.runs_cum = \
            sc.seg_start, sc.run_start, sc.runs_cum
        lay.running = list(zip(sc.sums, sc.counts))
        mark("K11")
        lay.seg_end = lay.run_end = None
        if needs & {"seg_end", "run_end"}:
            lay.seg_end, lay.run_end = run_ends(
                lay.new_seg if "seg_end" in needs else None,
                lay.new_run if "run_end" in needs else None, lay.n_live)
            mark("K12")
        return pair_of

    def _compute_one(self, batch: DeviceBatch, w: WindowExpression,
                     lay: _Layout, sorted_inputs, pair_of
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(data, validity) of one window expression over the sorted
        rows."""
        cap = lay.cap
        live_s, pos = lay.live_s, lay.pos
        seg_start = lay.seg_start
        idx_in_seg = pos - seg_start
        func = w.func
        cn, ct = self.children[0].output_names, self.children[0].output_types
        if not isinstance(func, First) and any(
                t.is_dec128(bind_expression(c, cn, ct).data_type())
                for c in func.children):
            raise NotImplementedError(
                f"window {type(func).__name__} over a decimal of more than "
                f"18 digits is not ported yet (ROADMAP Queue 1 item 3)")
        if type(func) is RowNumber:
            return (idx_in_seg + 1).to(torch.int32), live_s
        if type(func) is Rank:
            return (lay.run_start - seg_start + 1).to(torch.int32), live_s
        if type(func) is DenseRank:
            at = torch.clamp(seg_start, 0, cap - 1).to(torch.int64)
            base = lay.runs_cum[at] - lay.new_run[at].to(torch.int32)
            return (lay.runs_cum - base).to(torch.int32), live_s
        if isinstance(func, (PercentRank, CumeDist, NTile)):
            # live rows of the partition: K12 ends it at the last live row
            n_rows = lay.seg_end - seg_start + 1
            if type(func) is PercentRank:
                rank = (lay.run_start - seg_start + 1).to(torch.float64)
                nr = n_rows.to(torch.float64)
                pr = torch.where(nr > 1, (rank - 1.0) /
                                 torch.clamp(nr - 1.0, min=1.0),
                                 torch.zeros_like(nr))
                return pr, live_s
            if type(func) is CumeDist:
                cd = (lay.run_end - seg_start + 1).to(torch.float64) / \
                    torch.clamp(n_rows.to(torch.float64), min=1.0)
                return cd, live_s
            nt = func.n
            n_rows = n_rows.to(torch.int64)
            idx = idx_in_seg.to(torch.int64)
            base = n_rows // nt
            rem = n_rows % nt
            # the first `rem` buckets get base + 1 rows
            big = rem * (base + 1)
            bucket = torch.where(
                idx < big, idx // torch.clamp(base + 1, min=1),
                rem + (idx - big) // torch.clamp(base, min=1))
            return (bucket + 1).to(torch.int32), live_s
        if isinstance(func, (Lead, Lag)):
            col_s = sorted_inputs[0]
            k = -func.offset if isinstance(func, Lag) else func.offset
            src = pos.to(torch.int64) + k
            same_seg = (src >= seg_start) & (src <= lay.seg_end) & \
                (src >= 0) & (src < cap)
            src = torch.clamp(src, 0, cap - 1)
            shifted = gather_column(col_s, src, same_seg & live_s[src])
            if not shifted.is_flat:     # a string or nested: the column
                return shifted, shifted.validity
            return shifted.data, shifted.validity
        if isinstance(func, AggregateFunction):
            return self._aggregate(batch, w, lay, sorted_inputs, pair_of)
        raise NotImplementedError(f"window function {type(func).__name__}")

    def _aggregate(self, batch, w, lay, sorted_inputs, pair_of):
        cap, live_s = lay.cap, lay.live_s
        f = self._bound_agg(w.func)
        kind, lo_b, hi_b, whole, running = _frame_of(w)
        if isinstance(f, First):
            return self._pick(f, kind, lo_b, hi_b, whole, running, lay,
                              sorted_inputs[0])
        upd = f.update()
        bounds = None if whole or running else self._frame_bounds(
            kind, lo_b, hi_b, lay)
        results = []
        for j, (scol, (_, op)) in enumerate(zip(sorted_inputs, upd)):
            val = scol.validity & live_s
            if scol.offsets is not None and op != "countvalid":
                raise NotImplementedError(
                    f"window {op} over a string column is not ported")
            if op in ("min", "max"):
                vv = torch.where(val, scol.data, torch.full_like(
                    scol.data, _extreme(scol.data.dtype, op == "min")))
            elif op not in ("sum", "countvalid"):
                raise NotImplementedError(f"window aggregate op {op}")
            if bounds is None:
                s, c = lay.running[pair_of[(id(w), j)]]
                if op in ("min", "max"):
                    s = segmented_doubling_scan(
                        vv, lay.new_seg,
                        torch.minimum if op == "min" else torch.maximum,
                        _extreme(vv.dtype, op == "min"))
                elif s is None:                  # countvalid
                    s = c
                at = lay.seg_end if whole else \
                    lay.run_end if kind == "range" else None
                if at is not None:
                    at = at.to(torch.int64)
                    s, c = s[at], c[at]
                results.append((s, c))
                continue
            lo_i, hi_i = bounds
            lo_c = torch.clamp(lo_i, 0, cap - 1).to(torch.int64)
            hi_c = torch.clamp(hi_i, -1, cap - 1).to(torch.int64)
            empty = hi_c < lo_c
            cpre = torch.cat([torch.zeros(1, dtype=torch.int32,
                                          device=val.device),
                              cumsum(val.to(torch.int32),
                                     dtype=torch.int32)])
            c = cpre[hi_c + 1] - cpre[lo_c]
            c = torch.where(empty, torch.zeros_like(c), c)
            if op == "sum":
                vv = torch.where(val, scol.data, torch.zeros_like(scol.data))
                pre = torch.cat([torch.zeros(1, dtype=vv.dtype,
                                             device=vv.device), cumsum(vv)])
                s = pre[hi_c + 1] - pre[lo_c]
                s = torch.where(empty, torch.zeros_like(s), s)
            elif op == "countvalid":
                s = c
            else:
                s = _rmq_query(vv, lo_c, hi_c, cap, op)
            results.append((s, c))
        # evaluate the aggregate from its buffers
        buf_cols = []
        for (data, cnt), (expr, op) in zip(results, upd):
            if op == "countvalid":
                buf_cols.append(ColumnValue(DeviceColumn(
                    t.LONG, data.to(torch.int64),
                    torch.ones(cap, dtype=torch.bool, device=data.device))))
            else:
                buf_cols.append(ColumnValue(DeviceColumn(
                    expr.data_type(), data, cnt > 0)))
        fctx = EvalContext(DeviceBatch([c.col for c in buf_cols],
                                       batch.num_rows))
        res = f.evaluate(fctx, buf_cols)
        return res.col.data, res.col.validity

    def _pick(self, f, kind, lo_b, hi_b, whole, running, lay, scol):
        """First or Last over each row's frame: the frame's bounds (None
        for the row itself), K23's pick and flag, and the column gathered
        there (a string, DECIMAL128 or nested column as a column)."""
        if whole:
            lo, hi = lay.seg_start, lay.seg_end
        elif running:
            lo, hi = lay.seg_start, lay.run_end if kind == "range" else None
        else:
            lo, hi = self._frame_bounds(kind, lo_b, hi_b, lay)
        idx, flag = frame_pick(scol.validity, lo, hi, isinstance(f, Last),
                               f.ignore_nulls, lay.n_live)
        col = gather_columns([scol], idx, flag)[0]
        if col.is_flat and col.data_hi is None:
            return col.data, col.validity
        return col, col.validity

    def _frame_bounds(self, kind, lo_b, hi_b, lay: _Layout):
        """Per-row inclusive [lo_i, hi_i] frame bounds over the sorted
        rows, for bounded ROWS and RANGE frames."""
        pos = lay.pos.to(torch.int64)
        seg_start = lay.seg_start.to(torch.int64)
        seg_end = lay.seg_end.to(torch.int64)
        if kind == "rows":
            lo_i = seg_start if lo_b == UNBOUNDED_PRECEDING else \
                torch.clamp(pos + lo_b, seg_start, seg_end + 1)
            hi_i = seg_end if hi_b == UNBOUNDED_FOLLOWING else \
                torch.clamp(pos + hi_b, seg_start - 1, seg_end)
            return lo_i.to(torch.int32), hi_i.to(torch.int32)
        # range: exactly one ascending flat-numeric order key (tagging
        # enforces this); a null order row frames over its peer run
        oc, _, nf = lay.okeys_sorted[0]
        vals_s, ovalid_s = oc.data, oc.validity
        # park nulls outside every finite search window
        park = _extreme(vals_s.dtype, not nf)
        masked = torch.where(ovalid_s, vals_s, torch.full_like(vals_s, park))
        # padding rows sort after every live row and carry the largest
        # value, so each window [seg_start, seg_end + 1) stays ascending
        masked = torch.where(lay.live_s, masked, torch.full_like(
            vals_s, _extreme(vals_s.dtype, True)))
        if lo_b == UNBOUNDED_PRECEDING:
            lo_i = lay.seg_start
        elif lo_b == CURRENT_ROW:
            lo_i = lay.run_start
        else:
            lo_i = _vec_bound(masked, vals_s + lo_b, seg_start, seg_end + 1,
                              lay.cap, left=True)
        if hi_b == UNBOUNDED_FOLLOWING:
            hi_i = lay.seg_end
        elif hi_b == CURRENT_ROW:
            hi_i = lay.run_end
        else:
            hi_i = _vec_bound(masked, vals_s + hi_b, seg_start, seg_end + 1,
                              lay.cap, left=False) - 1
        null_row = ~ovalid_s
        lo_i = torch.where(null_row, lay.run_start, lo_i.to(torch.int32))
        hi_i = torch.where(null_row, lay.run_end, hi_i.to(torch.int32))
        return lo_i, hi_i

    def _compute(self, batch: DeviceBatch, mark=_no_mark) -> DeviceBatch:
        """The batch with every window expression's column after its own.
        ``mark(stage)`` is called after each stage (words, K2, K8,
        boundaries, K11, K12, results, K13, mask), for timing."""
        cn, ct = self.children[0].output_names, self.children[0].output_types
        ctx = EvalContext(batch)
        live = torch.arange(batch.capacity, device=batch.device) < \
            batch.num_rows
        # group the expressions by spec: each group shares one layout
        groups: dict = {}
        for w in self.window_exprs:
            g = groups.setdefault(semantic_sig(w.spec),
                                  dict(spec=w.spec, inputs=[], members=[]))
            cols = [_eval_col(ctx, e) for e in self._input_exprs(w)]
            g["members"].append((w, len(g["inputs"]), len(cols)))
            g["inputs"].extend(cols)
        out_by_expr = {}
        for g in groups.values():
            bounded_range = any(
                isinstance(w.func, AggregateFunction) and
                _frame_of(w)[0] == "range" and not any(_frame_of(w)[3:])
                for w, _, _ in g["members"])
            lay = self._build_layout(batch, ctx, g["spec"], g["inputs"],
                                     bounded_range, mark)
            pair_of = self._scan(lay, g["members"], mark)
            per = [(w,) + self._compute_one(
                batch, w, lay, lay.input_sorted[start:start + ncols],
                pair_of) for w, start, ncols in g["members"]]
            mark("results")
            # a string result goes back through K16 over the inverse
            # permutation, which K13 writes
            spans = [(w, d) for w, d, _ in per
                     if isinstance(d, DeviceColumn)]
            per = [x for x in per if not isinstance(x[1], DeviceColumn)]
            if spans:
                inv, = scatter_rows(lay.order, [lay.pos])
                for (w, d), col in zip(spans, gather_columns(
                        [d for _, d in spans], inv, live)):
                    out_by_expr[id(w)] = col
            # one scatter back to input order for the whole group; a
            # validity that is the sorted live mask (the ranking
            # functions') comes back as the live mask itself
            lanes = [x for _, d, v in per
                     for x in ((d,) if v is lay.live_s else (d, v))]
            back = iter(scatter_rows(lay.order, lanes))
            mark("K13")
            for w, _, v in per:
                d = next(back)
                valid = live if v is lay.live_s else next(back) & live
                out_by_expr[id(w)] = DeviceColumn(
                    w.resolved_type(cn, ct),
                    torch.where(valid, d, torch.zeros_like(d)), valid)
            mark("mask")
        cols = list(batch.columns) + [out_by_expr[id(w)]
                                      for w in self.window_exprs]
        return DeviceBatch(cols, batch.num_rows, self.output_names)

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        batches = list(self.child_batches(0, pid, ctx))
        if not batches:
            return
        child = self.children[0]
        merged = concat_batches(batches, child.output_names,
                                child.output_types) \
            if len(batches) > 1 else batches[0]
        del batches
        yield self._compute(merged)


def _eval_col(ctx: EvalContext, e) -> DeviceColumn:
    v = e.eval(ctx)
    if isinstance(v, ScalarValue):
        v = make_column(ctx, e.data_type(),
                        v.value if v.value is not None else 0,
                        None if v.value is not None else False)
    return v.col
