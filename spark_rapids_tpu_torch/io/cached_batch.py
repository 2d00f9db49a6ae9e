"""The parquet cached batch: ``df.cache()`` kept as parquet blobs.

Counterpart of spark_rapids_tpu/io/cached_batch.py (the reference's
ParquetCachedBatchSerializer role).  A process-wide ``CacheManager``
keys entries by the id of a logical plan node, and each entry holds a
strong reference to that node: the entry lives until ``unpersist()``
(or ``CacheManager.clear()``), and a freed node's id cannot alias onto
a new one.  The first query that plans a cached node runs it under a
``CacheWriteExec``, which fetches each batch to the host (the packed
fetch, K9 and K10), encodes it as one parquet blob, and passes the
batch on unchanged; a partition's blobs enter the entry only once it
ran to its end, and the entry counts as materialized only when every
partition has, so a run cut short by a limit leaves it unmaterialized
and a cut second write of the entry (``c.union(c)`` under a limit)
leaves a partition that an earlier write completed as it was.  Later
queries plan a ``CachedScanExec`` instead, which decodes each blob and
uploads it (``batch_to_device``).

``cache()`` is a no-op under a Spark 3.0.x dialect, as the reference's
shims have it: ``cached_batch_supported`` reads
``spark.rapids.tpu.sparkVersion`` (default 3.2.0).
"""

from __future__ import annotations

import io
import threading
from typing import Dict, Iterator, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch, batch_to_arrow, batch_to_device
from ..exec.base import READS, Exec, download

SPARK_VERSION_KEY = "spark.rapids.tpu.sparkVersion"


def cached_batch_supported(conf) -> bool:
    """Whether ``cache()`` keeps parquet blobs under the session's Spark
    dialect: not on 3.0.x (the reference's Spark301Shims)."""
    raw = str(conf.raw(SPARK_VERSION_KEY, "3.2.0"))
    parts = (raw.split("-")[0].split(".") + ["0", "0"])[:3]
    version = tuple(int(x) for x in parts)
    return not (3, 0, 0) <= version < (3, 1, 0)


class CachedPartition:
    __slots__ = ("blobs", "complete")

    def __init__(self):
        self.blobs: List[bytes] = []    # one parquet blob per batch
        self.complete = False           # the partition ran to its end


class CacheEntry:
    def __init__(self, lp):
        self.lp = lp
        self.lock = threading.Lock()    # every write of this entry takes it
        self.materialized = False
        self.partitions: List[CachedPartition] = []
        self.schema: Optional[pa.Schema] = None

    @property
    def size_bytes(self) -> int:
        return sum(len(b) for p in self.partitions for b in p.blobs)


class CacheManager:
    """The process-wide registry of cached logical plans."""

    _lock = threading.Lock()
    _entries: Dict[int, CacheEntry] = {}

    @classmethod
    def cache(cls, lp) -> CacheEntry:
        with cls._lock:
            return cls._entries.setdefault(id(lp), CacheEntry(lp))

    @classmethod
    def lookup(cls, lp) -> Optional[CacheEntry]:
        with cls._lock:
            return cls._entries.get(id(lp))

    @classmethod
    def uncache(cls, lp) -> None:
        with cls._lock:
            cls._entries.pop(id(lp), None)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._entries.clear()


def encode_batch(rb: pa.RecordBatch) -> bytes:
    """A RecordBatch as one snappy parquet blob."""
    sink = io.BytesIO()
    pq.write_table(pa.Table.from_batches([rb]), sink, compression="snappy")
    return sink.getvalue()


def decode_blob(blob: bytes) -> List[pa.RecordBatch]:
    return pq.read_table(io.BytesIO(blob)).combine_chunks().to_batches()


def to_host_batch(batch: DeviceBatch, names) -> pa.RecordBatch:
    """A batch's live rows as Arrow: from the card through the packed
    fetch (K9, K10), from the CPU as they are."""
    host = download(batch)
    return batch_to_arrow(DeviceBatch(host.columns, host.num_rows, names))


class CacheWriteExec(Exec):
    """Tees its child's batches into the cache entry while passing them
    on; placed where its child is."""

    def __init__(self, entry: CacheEntry, child: Exec):
        super().__init__([child])
        self.entry = entry
        self.placement = child.placement

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def describe(self):
        return "CacheWrite(parquet)"

    def partition_use(self):
        # the entry keeps the partitions as they come, for later scans
        return READS

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "stores batches in child emission order; the "
            "cached partition's row multiset is invariant")

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        # a partition's blobs are published only once it ran to its end,
        # so a run cut short (a limit; a second write of the same entry
        # in one plan, as in c.union(c)) leaves what an earlier run
        # completed as it was
        blobs, schema = [], None
        for b in self.child_batches(0, pid, ctx):
            rb = to_host_batch(b, self.output_names)
            blobs.append(encode_batch(rb))
            schema = rb.schema
            yield b
        entry = self.entry
        with entry.lock:
            entry.schema = entry.schema or schema
            while len(entry.partitions) <= pid:
                entry.partitions.append(CachedPartition())
            entry.partitions[pid].blobs = blobs
            entry.partitions[pid].complete = True
            if len(entry.partitions) == self.num_partitions and \
                    all(p.complete for p in entry.partitions):
                entry.materialized = True


class CachedScanExec(Exec):
    """Scan over a materialized entry: each blob decoded on the host and
    uploaded to the operator's device."""

    def __init__(self, entry: CacheEntry, names, dtypes):
        super().__init__([])
        self.entry = entry
        self._names = list(names)
        self._types = list(dtypes)

    @property
    def output_names(self):
        return self._names

    @property
    def output_types(self):
        return self._types

    @property
    def num_partitions(self):
        return max(1, len(self.entry.partitions))

    def describe(self):
        return (f"CachedScan(parquet, {self.num_partitions} partitions, "
                f"{self.entry.size_bytes}B)")

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        if pid >= len(self.entry.partitions):
            return
        dev = self.device(ctx)
        for blob in self.entry.partitions[pid].blobs:
            for rb in decode_blob(blob):
                yield batch_to_device(rb, dev)
