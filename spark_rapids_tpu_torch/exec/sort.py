"""Sort operator.

Counterpart of spark_rapids_tpu/exec/sort.py (SortExec).  Per sort
expression, order-preserving key words (ops/segmented.py:sort_key_words:
ascending or descending, nulls first or last) follow a padding word that
puts padding rows last; K2 (``ops/carry.py:sort_order``) orders the rows
stably, and K8 (``ops/gather.py:gather_rows``) moves every lane through
the order.  A partition's batches are concatenated and sorted once: the
reference's in-core branch.  Its out-of-core branch (a spill-bounded
external merge of sorted runs, exec/outofcore.py with the spill
catalog) is not ported: a partition must fit on the card.  A CPU-placed
SortExec runs the same code on CPU tensors, i.e. the kernels' plain
versions, as the reference's numpy branch does.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch
from ..expr.core import (EvalContext, ScalarValue, bind_expression,
                         make_column)
from ..ops import carry
from ..ops import segmented as seg
from .base import MERGES, READS, Exec
from .concat import concat_batches


def order_key_words(ctx: EvalContext, bound_orders) -> List[torch.Tensor]:
    """Every bound sort expression's key words over ``ctx``'s batch, most
    significant first; bound_orders: [(expr, ascending, nulls_first)]."""
    words = []
    for e, asc, nulls_first in bound_orders:
        v = e.eval(ctx)
        if isinstance(v, ScalarValue):
            v = make_column(ctx, e.data_type(),
                            v.value if v.value is not None else 0,
                            None if v.value is not None else False)
        words += seg.sort_key_words(v.col, asc, nulls_first)
    return words


class SortExec(Exec):
    """orders: [(expr, ascending, nulls_first)]."""

    def __init__(self, orders, child: Exec, is_global: bool = True):
        super().__init__([child])
        self.orders = list(orders)
        self.is_global = is_global
        cn, ct = child.output_names, child.output_types
        self._bound = [(bind_expression(e, cn, ct), asc, nf)
                       for e, asc, nf in self.orders]

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def describe(self):
        os = ", ".join(f"{e.sql()} {'ASC' if a else 'DESC'}"
                       for e, a, _ in self._bound)
        return f"Sort [{os}] global={self.is_global}"

    def partition_use(self):
        # a global sort orders the whole; sortWithinPartitions each part
        return MERGES if self.is_global else READS

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "stable sort: key order is a function of "
            "content, tie order follows arrival",
            establishes_order=True)

    def sort_words(self, batch: DeviceBatch) -> List[torch.Tensor]:
        """The padding word (padding rows last), then every sort
        expression's key words."""
        live = torch.arange(batch.capacity, device=batch.device) < \
            batch.num_rows
        return [(~live).to(torch.int64)] + order_key_words(
            EvalContext(batch), self._bound)

    def sort_batch(self, batch: DeviceBatch) -> DeviceBatch:
        _, cols, _ = carry.sort_rows(self.sort_words(batch), batch.columns)
        return DeviceBatch(cols, batch.num_rows, batch.names)

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        batches = list(self.child_batches(0, pid, ctx))
        if not batches:
            return
        merged = concat_batches(batches, self.output_names,
                                self.output_types) \
            if len(batches) > 1 else batches[0]
        del batches
        yield self.sort_batch(merged)
