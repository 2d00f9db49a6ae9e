"""Replay classes that operators declare through ``Exec.determinism()``.

Counterpart of the lattice and the ``Determinism`` record of
spark_rapids_tpu/analysis/determinism.py (the analysis pass that
composes the declarations is not ported).  Strongest first:

  bit_exact        recompute reproduces the output bytes exactly,
                   whatever the batch arrival order or input split
  order_stable     the output multiset per partition is invariant under
                   batch arrival order and input-split changes; row
                   order within a partition may differ
  order_dependent  output values depend on arrival order, e.g. a float
                   accumulation whose grouping follows batch arrival
  nondeterministic two runs may disagree on content
"""

from __future__ import annotations

BIT_EXACT = "bit_exact"
ORDER_STABLE = "order_stable"
ORDER_DEPENDENT = "order_dependent"
NONDETERMINISTIC = "nondeterministic"

CLASSES = (BIT_EXACT, ORDER_STABLE, ORDER_DEPENDENT, NONDETERMINISTIC)


class Determinism:
    """One operator's declared replay behaviour.

    ``cls`` is the operator's own contribution, its inputs arriving
    bit-identically.  ``order_sensitive_selection``: the output content
    depends on input row order (limits, offset-keyed sampling).
    ``establishes_order``: the output row order is a function of content
    (sorts).  ``partition_scoped``: output values depend on the partition
    grouping itself (PARTIAL aggregates).  ``canonicalizable``: the
    weakness goes away when the operator's canonical keyed merge is
    forced on."""

    __slots__ = ("cls", "reason", "order_sensitive_selection",
                 "establishes_order", "partition_scoped",
                 "canonicalizable")

    def __init__(self, cls: str, reason: str = "",
                 order_sensitive_selection: bool = False,
                 establishes_order: bool = False,
                 partition_scoped: bool = False,
                 canonicalizable: bool = False):
        if cls not in CLASSES:
            raise ValueError(f"unknown replay class {cls!r}")
        self.cls = cls
        self.reason = reason
        self.order_sensitive_selection = order_sensitive_selection
        self.establishes_order = establishes_order
        self.partition_scoped = partition_scoped
        self.canonicalizable = canonicalizable

    def __repr__(self):
        return f"Determinism({self.cls!r}, {self.reason!r})"
