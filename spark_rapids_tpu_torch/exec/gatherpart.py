"""GatherPartitionsExec: funnel all child partitions into one.

Counterpart of spark_rapids_tpu/exec/gatherpart.py: where an operator
needs co-located data and there is no shuffle (a single device, or a
global aggregate), every child partition's batches stream through
partition 0 in partition order.  As the exchange it stands in for, it
leaves no current input file (input_file_name() is "" above it).
"""

from __future__ import annotations

from typing import Iterator

from ..columnar.device import DeviceBatch
from ..io.scan import set_current_input_file
from .base import Exec


class GatherPartitionsExec(Exec):
    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        assert pid == 0
        for cpid in range(self.children[0].num_partitions):
            for b in self.child_batches(0, cpid, ctx):
                set_current_input_file("")
                yield b
