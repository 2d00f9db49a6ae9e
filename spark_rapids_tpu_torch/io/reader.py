"""DataFrameReader: the ``session.read.parquet/orc/csv`` entry points.

Counterpart of spark_rapids_tpu/io/reader.py: path expansion (recursive,
skipping metadata and hidden files, globs), schema discovery from the
first file's footer (or a CSV sample, or a given schema) and the reader
options.  A column of a type the port does not carry yet raises
NotImplementedError naming the column, at read time.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq

from ..api.dataframe import DataFrame
from ..columnar.interop import from_arrow_type
from ..plan.logical import FileRelation


def _hidden_component(root: str, path: str) -> bool:
    """Any path component below ``root`` starting with '_' or '.' marks
    metadata or leftovers (_SUCCESS, _temporary/ of an interrupted write,
    hidden files); Spark's readers skip these at every depth."""
    rel = os.path.relpath(path, root)
    return any(part.startswith(("_", ".")) for part in rel.split(os.sep))


def _expand(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            # recursive: partitioned writes lay out k=<v>/part-*.parquet
            for fmt_glob in ("*.parquet", "*.orc", "*.csv", "*"):
                hits = sorted(glob.glob(os.path.join(p, "**", fmt_glob),
                                        recursive=True))
                hits = [h for h in hits if os.path.isfile(h)
                        and not _hidden_component(p, h)]
                if hits:
                    out.extend(hits)
                    break
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    return out


def _port_types(schema: pa.Schema, files: List[str]):
    dtypes = []
    for f in schema:
        try:
            dtypes.append(from_arrow_type(f.type))
        except NotImplementedError as ex:
            raise NotImplementedError(
                f"column {f.name!r} of {files[0]}: {ex}") from None
    return dtypes


class DataFrameReader:
    def __init__(self, session):
        self.session = session
        self._options: Dict = {}
        self._schema = None

    def option(self, key, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def schema(self, schema) -> "DataFrameReader":
        """``[(name, port type), ...]``; used by csv."""
        self._schema = schema
        return self

    def _frame(self, fmt, files, names, dtypes, options):
        return DataFrame(FileRelation(fmt, files, names, dtypes, options),
                         self.session)

    def parquet(self, *paths):
        files = _expand(list(paths))
        if not files:
            raise FileNotFoundError(f"no parquet files under {paths}")
        schema = papq.read_schema(files[0])
        return self._frame("parquet", files, list(schema.names),
                           _port_types(schema, files), dict(self._options))

    def orc(self, *paths):
        files = _expand(list(paths))
        if not files:
            raise FileNotFoundError(f"no orc files under {paths}")
        schema = paorc.ORCFile(files[0]).schema
        return self._frame("orc", files, list(schema.names),
                           _port_types(schema, files), dict(self._options))

    def csv(self, *paths, header: bool = True):
        files = _expand(list(paths))
        if not files:
            raise FileNotFoundError(f"no csv files under {paths}")
        opts = dict(self._options)
        opts.setdefault("header", header)
        if self._schema is not None:
            names = [n for n, _ in self._schema]
            dtypes = [d for _, d in self._schema]
        else:
            ropts = pacsv.ReadOptions(
                autogenerate_column_names=not opts.get("header", True))
            sample = pacsv.read_csv(files[0], read_options=ropts)
            names = list(sample.schema.names)
            dtypes = _port_types(sample.schema, files)
        return self._frame("csv", files, names, dtypes, opts)
