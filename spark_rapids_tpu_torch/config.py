"""Typed configuration: the entries the port's plan rewrite reads.

Counterpart of spark_rapids_tpu/config.py (ConfEntry, RapidsConf),
with only the keys this package reads and without the reference's
builder and docs.  Key names, defaults and value checks are the
reference's, so a user's conf carries over;
``spark.rapids.tpu.singleChipFuse`` keeps its name for the same reason.
Per-operator switches are derived keys, read by
``RapidsConf.is_op_enabled``:

  spark.rapids.sql.exec.<ExecName>        e.g. ...exec.CpuJoinExec=false
  spark.rapids.sql.expression.<ExprName>  e.g. ...expression.GreaterThan
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence


def _to_bool(s: Any) -> bool:
    if isinstance(s, bool):
        return s
    s = str(s).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise ValueError(f"cannot convert {s!r} to bool")


def _to_bytes(s: Any) -> int:
    """Parse a byte size like '512m', '1g', '16384'."""
    if isinstance(s, int):
        return s
    s = str(s).strip().lower()
    units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40, "b": 1}
    if s and s[-1] in units:
        return int(float(s[:-1]) * units[s[-1]])
    return int(s)


class ConfEntry:
    """One key: its converter, its default and the values it allows."""

    def __init__(self, key: str, converter: Callable[[Any], Any],
                 default: Any, allowed: Optional[Sequence[Any]] = None):
        self.key = key
        self.converter = converter
        self.default = default
        self.allowed = allowed

    def get(self, conf: Dict[str, Any]) -> Any:
        raw = conf.get(self.key, None)
        if raw is None:
            return self.default
        v = self.converter(raw)
        if self.allowed is not None and v not in self.allowed:
            raise ValueError(f"{self.key}: must be one of "
                             f"{list(self.allowed)}, got {v}")
        return v


SQL_ENABLED = ConfEntry("spark.rapids.sql.enabled", _to_bool, True)

# NONE, ALL, or NOT_ON_GPU (only the operators that stayed on the CPU)
EXPLAIN = ConfEntry("spark.rapids.sql.explain", str, "NOT_ON_GPU",
                    ["NONE", "ALL", "NOT_ON_GPU"])

# broadcast a join's build side of at most this many bytes; -1 disables
AUTO_BROADCAST_JOIN_THRESHOLD = ConfEntry(
    "spark.rapids.sql.autoBroadcastJoinThreshold", _to_bytes,
    10 * 1024 * 1024)

# strip exchanges when the session drives one device: 'auto' = then (the
# port's session always does); 'on' / 'off' force it
SINGLE_CHIP_FUSE = ConfEntry("spark.rapids.tpu.singleChipFuse", str, "auto",
                             ["auto", "on", "off"])

# the cost-based second pass (plan/cost.py), and printing its decisions
OPTIMIZER_ENABLED = ConfEntry("spark.rapids.sql.optimizer.enabled",
                              _to_bool, False)
OPTIMIZER_EXPLAIN = ConfEntry("spark.rapids.sql.optimizer.explain", str,
                              "NONE", ["NONE", "ALL"])


# --- io: the file formats, their readers and the device pin -------------
PARQUET_ENABLED = ConfEntry("spark.rapids.sql.format.parquet.enabled",
                            _to_bool, True)
ORC_ENABLED = ConfEntry("spark.rapids.sql.format.orc.enabled", _to_bool,
                        True)
CSV_ENABLED = ConfEntry("spark.rapids.sql.format.csv.enabled", _to_bool,
                        True)

# AUTO: PERFILE for one file, COALESCING for 2-4, MULTITHREADED above
PARQUET_READER_TYPE = ConfEntry(
    "spark.rapids.sql.format.parquet.reader.type", str, "AUTO",
    ["PERFILE", "COALESCING", "MULTITHREADED", "AUTO"])
PARQUET_MULTITHREAD_READ_NUM_THREADS = ConfEntry(
    "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads", int, 20)

# soft cap on the rows of one batch a file reader produces
MAX_READER_BATCH_SIZE_ROWS = ConfEntry(
    "spark.rapids.sql.reader.batchSizeRows", int, 2147483647)

# keep decoded and uploaded file-scan batches on the device, keyed by the
# files' (path, size, mtime) and everything that shapes the batches
FILESCAN_PIN_DEVICE = ConfEntry("spark.rapids.sql.fileScan.pinDeviceBatches",
                                _to_bool, True)

# transfer elisions: a global sort of an in-memory table fetches only a
# row-id lane and takes on the host; a filtering write fetches only the
# keep mask and filters the host copy.  Off by default, unlike the
# reference: over the H100's host link the direct fetch is faster (the
# host take of bench q3 is about 7x slower than the direct collect).
HOST_ASSISTED_COLLECT = ConfEntry("spark.rapids.sql.collect.hostAssisted",
                                  _to_bool, False)
HOST_ASSISTED_WRITE = ConfEntry("spark.rapids.sql.write.hostAssisted",
                                _to_bool, False)


class RapidsConf:
    """Snapshot of a config map with typed accessors."""

    def __init__(self, conf_map: Optional[Dict[str, Any]] = None):
        self._map = dict(conf_map or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._map)

    def raw(self, key: str, default: Any = None) -> Any:
        return self._map.get(key, default)

    def is_op_enabled(self, kind: str, name: str, default: bool = True
                      ) -> bool:
        """Derived per-op enable keys: ``spark.rapids.sql.<kind>.<name>``
        with kind ``exec`` or ``expression``."""
        raw = self._map.get(f"spark.rapids.sql.{kind}.{name}")
        return default if raw is None else _to_bool(raw)

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def explain(self) -> str:
        return self.get(EXPLAIN)
