"""File scan: Parquet, ORC and CSV with the multi-file reader strategies
and the process-level device pin.

Counterpart of spark_rapids_tpu/io/scan.py.  Column pruning and the
pushed predicates are applied by the host reader (pyarrow), as the
reference does its footer work on the host; the decoded columns go up
through ``batch_to_device`` on the scan's device.  Strategies:

  PERFILE       one partition a file;
  COALESCING    the files concatenate into one batch before the upload
                (one partition);
  MULTITHREADED a thread pool decodes every file ahead of the partition
                that consumes it; the pool shuts down once every
                partition has taken its file.

A GPU-placed scan with ``spark.rapids.sql.fileScan.pinDeviceBatches``
keeps its batches in ``_FILESCAN_PIN``, keyed by the files' identity
(path, size, mtime_ns) and everything that shapes the batches, the
device included: a query over unchanged files reads no file.  The
reference registers those batches with its spill catalog, which the port
has not yet; here the pin is a dict in least-recently-used order, held
under ``_PIN_BUDGET_BYTES`` by dropping its oldest keys, and
``clear_filescan_pin`` empties it.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from typing import Iterator, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.dataset as pads
import pyarrow.orc as paorc
import pyarrow.parquet as papq

from .. import config as cfg
from .. import types as t
from ..columnar.device import DeviceBatch, batch_to_device, column_bytes
from ..columnar.interop import to_arrow_schema
from ..exec.base import GPU, Exec, ExecContext
from ..expr.core import Expression


def _arrow_literal(lit, equality: bool):
    """A literal as pyarrow compares it with a file column, or None where
    pyarrow's order differs from the engine's: a string only in an
    equality (pyarrow orders strings by all their bytes, the engine by 32
    bytes and the length); a DATE as a date32 and a DECIMAL as a decimal128
    of the literal's type (pyarrow compares decimals of any scales
    exactly); a TIMESTAMP not at all (a file's unit and zone may differ
    from the literal's)."""
    import decimal
    v, dt = lit.value, lit.dtype
    if v is None or dt == t.TIMESTAMP:
        return None
    if isinstance(v, bytes):
        return v.decode("utf-8") if equality else None
    if dt == t.DATE:
        return pa.scalar(v, pa.date32())
    if isinstance(dt, t.DecimalType):
        return pa.scalar(decimal.Decimal(v).scaleb(-dt.scale),
                         pa.decimal128(dt.precision, dt.scale))
    return v


def _pushdown_to_arrow(filters: List[Expression], names,
                       types=None) -> Optional[object]:
    """Simple predicates as a pyarrow dataset expression (comparisons of
    a column with a literal, IS NOT NULL, AND and OR of those); the
    rest stay with the exact filter above the scan.  A predicate on a
    binary or nested column (``types``, by name) is never pushed."""
    import pyarrow.compute as pc
    from ..expr import predicates as P
    from ..expr.core import AttributeReference, Literal

    kept = dict(zip(names, types)) if types is not None else {}

    def pushable(name):
        dt = kept.get(name)
        return dt is None or not (dt == t.BINARY or t.is_nested(dt))

    ops = {P.EqualTo: "__eq__", P.LessThan: "__lt__",
           P.LessThanOrEqual: "__le__", P.GreaterThan: "__gt__",
           P.GreaterThanOrEqual: "__ge__"}

    def conv(e):
        if isinstance(e, (P.And, P.Or)):
            a, b = conv(e.children[0]), conv(e.children[1])
            if a is None or b is None:
                return None
            return a & b if isinstance(e, P.And) else a | b
        if type(e) in ops:
            l, r = e.children
            if isinstance(l, AttributeReference) and \
                    isinstance(r, Literal) and pushable(l.name):
                v = _arrow_literal(r, type(e) is P.EqualTo)
                if v is None:
                    return None
                return getattr(pc.field(l.name), ops[type(e)])(v)
        if isinstance(e, P.IsNotNull) and isinstance(
                e.children[0], AttributeReference) and \
                pushable(e.children[0].name):
            return pc.field(e.children[0].name).is_valid()
        return None
    out = None
    for f in filters:
        c = conv(f)
        if c is not None:
            out = c if out is None else (out & c)
    return out


# the current input file of this thread, the source of input_file_name()
# (not ported yet); the pin replays it with each batch
_input_file_ctx = threading.local()


def current_input_file() -> str:
    return getattr(_input_file_ctx, "path", "")


def set_current_input_file(path: str) -> None:
    _input_file_ctx.path = path


# key -> [(input file, batch)], for every partition of every pinned
# scan, the most recently used last; _PIN_BYTES holds each key's bytes
_FILESCAN_PIN: dict = {}
_PIN_BYTES: dict = {}

# the pinned batches' bytes at most (a fifth of an 80 GB H100), until
# the spill catalog can evict them under memory pressure
_PIN_BUDGET_BYTES = 16 << 30


def clear_filescan_pin() -> None:
    """Drop every pinned file-scan batch."""
    _FILESCAN_PIN.clear()
    _PIN_BYTES.clear()


def _batch_bytes(b: DeviceBatch) -> int:
    return sum(column_bytes(c) for c in b.columns)


def _pin(key, produced) -> None:
    """Pin one partition's batches, dropping the least recently used
    keys while the pin would pass its budget; a partition larger than
    the budget alone is not pinned."""
    size = sum(_batch_bytes(b) for _, b in produced)
    if size > _PIN_BUDGET_BYTES:
        return
    while _FILESCAN_PIN and sum(_PIN_BYTES.values()) + size > \
            _PIN_BUDGET_BYTES:
        oldest = next(iter(_FILESCAN_PIN))
        del _FILESCAN_PIN[oldest], _PIN_BYTES[oldest]
    _FILESCAN_PIN[key] = produced
    _PIN_BYTES[key] = size


class FileScanExec(Exec):
    """Columnar file scan."""

    def __init__(self, fmt: str, paths: List[str], names, dtypes,
                 options: dict, conf, pushed_filters=None,
                 required_columns: Optional[List[str]] = None):
        super().__init__([])
        self.fmt = fmt
        self.paths = list(paths)
        self._all_names = list(names)
        self._all_types = list(dtypes)
        self.required_columns = required_columns
        self.options = options or {}
        self.conf = conf
        self.pushed_filters = list(pushed_filters or [])
        reader_type = conf.get(cfg.PARQUET_READER_TYPE)
        if reader_type == "AUTO":
            reader_type = "MULTITHREADED" if len(self.paths) > 4 \
                else ("COALESCING" if len(self.paths) > 1 else "PERFILE")
        self.reader_type = reader_type
        self.batch_rows = conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS)
        self._pool = None
        self._futures = {}
        self._file_ident = None

    @property
    def output_names(self):
        if self.required_columns is not None:
            return list(self.required_columns)
        return self._all_names

    @property
    def output_types(self):
        if self.required_columns is not None:
            idx = {n: i for i, n in enumerate(self._all_names)}
            return [self._all_types[idx[n]] for n in self.required_columns]
        return self._all_types

    @property
    def num_partitions(self):
        if self.reader_type == "COALESCING":
            return 1
        return max(1, len(self.paths))

    def describe(self):
        return (f"FileScan {self.fmt} [{len(self.paths)} files, "
                f"{self.reader_type}] cols={self.output_names}")

    def estimated_size_bytes(self):
        total = 0
        for p in self.paths:
            try:
                total += os.path.getsize(p)
            except OSError:
                return None
        # columnar files are compressed on disk; the in-memory blow-up
        # mirrors Spark's fileCompressionFactor
        return int(total * 3) if self.fmt in ("parquet", "orc") else total

    # -- host decode ---------------------------------------------------------
    def _read_file(self, path: str) -> pa.Table:
        cols = self.output_names
        filt = _pushdown_to_arrow(self.pushed_filters, cols,
                                  self.output_types) \
            if self.fmt in ("parquet", "orc") else None
        if self.fmt == "parquet":
            if filt is not None:
                ds = pads.dataset(path, format="parquet")
                return ds.to_table(columns=cols, filter=filt)
            return papq.read_table(path, columns=cols, use_threads=False)
        if self.fmt == "orc":
            # ORC returns the columns in file order; the reference's
            # scan then fails its cast on a reordered pruning
            return paorc.ORCFile(path).read(columns=cols).select(cols)
        if self.fmt == "csv":
            ropts = pacsv.ReadOptions(
                autogenerate_column_names=not self.options.get("header",
                                                               True))
            copts = pacsv.ConvertOptions(include_columns=cols or None)
            tbl = pacsv.read_csv(path, read_options=ropts,
                                 convert_options=copts)
            want = to_arrow_schema(self.output_names, self.output_types)
            return tbl.select(self.output_names).cast(want)
        # hivetext waits for the port of hive.py
        raise ValueError(self.fmt)

    def _emit(self, table: pa.Table, ctx: ExecContext,
              path: str = "") -> Iterator[DeviceBatch]:
        set_current_input_file(path)
        want = to_arrow_schema(self.output_names, self.output_types)
        combined = table.cast(want).combine_chunks()
        n = combined.num_rows
        step = min(self.batch_rows, max(n, 1))
        dev = self.device(ctx)
        off = 0
        while True:
            rbs = combined.slice(off, step).to_batches()
            rb = rbs[0] if rbs else pa.RecordBatch.from_pydict(
                {f.name: pa.array([], type=f.type) for f in want},
                schema=want)
            yield batch_to_device(rb, dev)
            off += step
            if off >= n:
                break

    def _pin_key(self, pid, ctx: ExecContext):
        """The files' identity (path, size, mtime) and everything that
        shapes the batches: schema, filters, options, reader shape,
        placement, partition and device.  A changed file changes the
        key, so a stale read cannot happen.  The files are stat'ed once
        an exec (a query), not once a partition."""
        if self._file_ident is None:
            ident = []
            for p in self.paths:
                try:
                    st = os.stat(p)
                except OSError:
                    return None
                ident.append((p, st.st_size, st.st_mtime_ns))
            self._file_ident = tuple(ident)
        return (self.fmt, self._file_ident, tuple(self.output_names),
                tuple(repr(d) for d in self.output_types),
                tuple(repr(f) for f in self.pushed_filters),
                tuple(sorted((k, repr(v)) for k, v in self.options.items())),
                self.reader_type, self.batch_rows, self.placement, pid,
                str(self.device(ctx)))

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        use_pin = self.placement == GPU and \
            ctx.conf.get(cfg.FILESCAN_PIN_DEVICE)
        key = self._pin_key(pid, ctx) if use_pin else None
        if key is not None and key in _FILESCAN_PIN:
            # a hit makes the key the most recently used
            _FILESCAN_PIN[key] = _FILESCAN_PIN.pop(key)
            _PIN_BYTES[key] = _PIN_BYTES.pop(key)
            for path, b in _FILESCAN_PIN[key]:
                set_current_input_file(path)
                yield b
            return
        if key is None:
            yield from self._execute_partition_uncached(pid, ctx)
            return
        produced = []
        for b in self._execute_partition_uncached(pid, ctx):
            produced.append((current_input_file(), b))
            yield b
        _pin(key, produced)

    def _execute_partition_uncached(self, pid, ctx) -> Iterator[DeviceBatch]:
        if not self.paths:
            yield from self._emit(to_arrow_schema(
                self.output_names, self.output_types).empty_table(), ctx)
            return
        if self.reader_type == "COALESCING":
            tables = [self._read_file(p) for p in self.paths]
            yield from self._emit(pa.concat_tables(tables), ctx,
                                  ",".join(self.paths))
            return
        if self.reader_type == "MULTITHREADED":
            yield from self._emit(self._prefetched(pid), ctx,
                                  self.paths[pid])
            return
        yield from self._emit(self._read_file(self.paths[pid]), ctx,
                              self.paths[pid])

    def _prefetched(self, pid) -> pa.Table:
        """Partition ``pid``'s file from the pool, which decodes every
        file ahead of its partition; the pool shuts down when the last
        file has been taken."""
        if pid not in self._futures:
            if self._pool is None:
                nthreads = self.conf.get(
                    cfg.PARQUET_MULTITHREAD_READ_NUM_THREADS)
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=min(nthreads, max(len(self.paths), 1)))
                self._futures = {i: self._pool.submit(self._read_file, p)
                                 for i, p in enumerate(self.paths)}
            else:
                self._futures[pid] = self._pool.submit(
                    self._read_file, self.paths[pid])
        fut = self._futures.pop(pid)
        try:
            return fut.result()
        finally:
            if not self._futures:
                self._pool.shutdown(wait=False)
                self._pool = None


def make_scan_exec(relation, conf, extra_filters=None) -> FileScanExec:
    """A scan of ``relation``; ``extra_filters`` are pushed into this
    scan only."""
    return FileScanExec(relation.fmt, relation.paths, relation._names,
                        relation._types, relation.options, conf,
                        list(extra_filters or []))
