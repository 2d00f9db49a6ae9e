"""Physical operator base and the collect to Arrow.

Counterpart of spark_rapids_tpu/exec/base.py.  An operator yields
DeviceBatches per partition; ``execute_collect`` runs every partition,
downloads each batch with ``.cpu()`` and returns one Arrow table.  The
reference's jit cache, metrics, semaphore, spill and speculation hooks
have no counterpart yet.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import pyarrow as pa

from .. import types as t
from ..columnar.device import DeviceBatch, batch_to_arrow, resolve_device
from ..columnar.interop import to_arrow_schema


class ExecContext:
    """Per-query context: the device the query runs on."""

    def __init__(self, device=None):
        self.device = resolve_device(device)


class Exec:
    def __init__(self, children: Sequence["Exec"]):
        self.children: List[Exec] = list(children)

    @property
    def output_names(self) -> List[str]:
        raise NotImplementedError

    @property
    def output_types(self) -> List[t.DataType]:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def estimated_size_bytes(self) -> Optional[int]:
        """Rough output size for planning (the join's build-side choice);
        None when unknown."""
        sizes = [c.estimated_size_bytes() for c in self.children]
        if not sizes or any(s is None for s in sizes):
            return None
        return sum(sizes)

    def execute_partition(self, pid: int, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def execute_collect(self, ctx: ExecContext) -> pa.Table:
        schema = to_arrow_schema(self.output_names, self.output_types)
        out = []
        for pid in range(self.num_partitions):
            for b in self.execute_partition(pid, ctx):
                if b.num_rows:
                    rb = batch_to_arrow(DeviceBatch(b.columns, b.num_rows,
                                                    self.output_names))
                    out.append(rb)
        if not out:
            return schema.empty_table()
        return pa.Table.from_batches(out, schema=schema)

    @property
    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name

    def tree_string(self, level: int = 0) -> str:
        lines = ["  " * level + self.describe()]
        lines += [c.tree_string(level + 1) for c in self.children]
        return "\n".join(lines)

    def foreach(self, fn):
        fn(self)
        for c in self.children:
            c.foreach(fn)
