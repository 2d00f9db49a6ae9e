"""Columnar file writers: parquet, orc and csv with dynamic partitioning
and write statistics.

Counterpart of spark_rapids_tpu/io/writer.py.  With
``spark.rapids.sql.write.hostAssisted`` (off by default), a write whose
plan only filters rows and prunes columns of a source whose bytes are
already on the host (an in-memory table, or files) fetches only the
boolean keep mask from the device, bit-packed by the fetch
(columnar/fetch.py), and filters the host copy with it; any other plan
is collected as a query is.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq

from .. import config as cfg
from ..exec.base import CPU, ExecContext
from ..expr.core import Alias, AttributeReference
from ..expr.predicates import And
from ..plan import logical as L
from .scan import make_scan_exec


def _host_assisted_table(df) -> Optional[pa.Table]:
    """The rows a write of ``df`` must write, through the keep mask; None
    when the plan computes anything beyond selection."""
    lp = df._lp
    conditions = []
    node = lp
    while True:
        if isinstance(node, L.Project):
            if not all(isinstance(e, AttributeReference)
                       for e in node.exprs):
                return None
            node = node.children[0]
        elif isinstance(node, L.Filter):
            conditions.append(node.condition)
            node = node.children[0]
        elif isinstance(node, (L.LocalRelation, L.FileRelation)):
            break
        else:
            return None

    session = df.session
    if isinstance(node, L.LocalRelation):
        host = node.table
    else:
        # decode on the host through a CPU-placed scan with no pushed
        # filter, so its rows line up with the mask plan's below
        scan = make_scan_exec(node, session.conf)
        scan.placement = CPU
        host = scan.execute_collect(ExecContext(session.device,
                                                session.conf))

    if conditions:
        combined = conditions[0]
        for c in conditions[1:]:
            combined = And(combined, c)
        mask_lp = L.Project([Alias(combined, "__keep__")], node)
        mask = session.execute(mask_lp).column("__keep__")
        # Spark's filter keeps only TRUE rows: arrow drops a null too
        host = host.filter(mask)
    names = lp.schema()[0]
    if list(host.schema.names) != names:
        host = host.select(names)
    return host


class WriteStatsTracker:
    """Per-job write statistics (ref BasicColumnarWriteStatsTracker)."""

    def __init__(self):
        self.num_files = 0
        self.num_rows = 0
        self.num_bytes = 0
        self.partitions: List[str] = []

    def file_written(self, path: str, rows: int):
        self.num_files += 1
        self.num_rows += rows
        try:
            self.num_bytes += os.path.getsize(path)
        except OSError:
            pass


class DataFrameWriter:
    def __init__(self, df):
        self.df = df
        self._mode = "error"
        self._partition_by: List[str] = []
        self._options: Dict = {}
        self.stats = WriteStatsTracker()

    def mode(self, m: str) -> "DataFrameWriter":
        if m not in ("error", "errorifexists", "overwrite", "append",
                     "ignore"):
            raise ValueError(f"unknown save mode {m!r}")
        self._mode = m
        return self

    def partition_by(self, *cols) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    def option(self, k, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def parquet(self, path: str):
        self._write(path, "parquet")

    def orc(self, path: str):
        self._write(path, "orc")

    def csv(self, path: str):
        self._write(path, "csv")

    def _prepare_dir(self, path: str) -> bool:
        if os.path.exists(path):
            if self._mode == "overwrite":
                shutil.rmtree(path)
            elif self._mode == "ignore":
                return False
            elif self._mode in ("error", "errorifexists"):
                raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        return True

    def _write_one(self, table: pa.Table, directory: str, fmt: str):
        out = os.path.join(directory, f"part-{uuid.uuid4().hex[:12]}.{fmt}")
        if fmt == "parquet":
            papq.write_table(table, out,
                             compression=self._options.get("compression",
                                                           "snappy"))
        elif fmt == "orc":
            paorc.write_table(table, out)
        else:
            pacsv.write_csv(table, out)
        self.stats.file_written(out, table.num_rows)

    def _collect(self) -> pa.Table:
        conf = self.df.session.conf
        if conf.sql_enabled and conf.get(cfg.HOST_ASSISTED_WRITE):
            table = _host_assisted_table(self.df)
            if table is not None:
                return table
        return self.df.collect()

    def _write(self, path: str, fmt: str):
        if not self._prepare_dir(path):
            return
        table = self._collect()
        if not self._partition_by:
            self._write_one(table, path, fmt)
            return
        # dynamic partitioning: one directory per distinct key tuple
        keys = self._partition_by
        distinct = table.select(keys).group_by(keys).aggregate([])
        for row in distinct.to_pylist():
            mask = None
            for k in keys:
                column = table.column(k)
                cond = pc.is_null(column) if row[k] is None else \
                    pc.equal(column, pa.scalar(row[k], column.type))
                mask = cond if mask is None else pc.and_(mask, cond)
            part = table.filter(mask).drop_columns(keys)
            sub = os.path.join(path, *(
                f"{k}={'__HIVE_DEFAULT_PARTITION__' if row[k] is None else row[k]}"
                for k in keys))
            os.makedirs(sub, exist_ok=True)
            self.stats.partitions.append(sub)
            self._write_one(part, sub, fmt)
