"""Physical operator base, the host/device transitions and the collect to
Arrow.

Counterpart of spark_rapids_tpu/exec/base.py.  An operator yields
DeviceBatches per partition; ``execute_collect`` runs every partition
and returns one Arrow table.  Every operator has a placement, GPU or
CPU: a GPU-placed operator works on tensors on the context's device, a
CPU-placed one on CPU tensors, so the kernel wrappers run their plain
versions for it (the port's form of the reference's
``xp = np if placement == CPU``).  An operator built by hand is placed
on the GPU unless its class runs on the host only (the CPU engines, the
in-memory exchange, the download); the planner's plan is CPU-placed and
the plan rewrite (plan/overrides.py) places each node.
HostToDeviceExec and DeviceToHostExec move batches across a placement
boundary.  Every operator reads its children through ``child_batches``,
which raises on a batch that does not lie where the operator's input
placement says, and ``execute_collect`` refuses a plan whose placement
changes without a transition.  The reference's jit cache, metrics,
semaphore, spill and speculation hooks have no counterpart yet; the
determinism declarations do.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, batch_to_arrow, move_batch,
                               resolve_device)
from ..columnar.fetch import fetch_batch
from ..columnar.interop import to_arrow_schema
from ..config import RapidsConf

CPU = "cpu"
GPU = "gpu"

# how an operator's output depends on the way its input is split into
# partitions (Exec.partition_use)
PASSES = "passes"   # it carries the layout on to its parent
READS = "reads"     # what it emits depends on the layout
MERGES = "merges"   # it regroups the rows: nothing above sees the layout


class ExecContext:
    """Per-query context: the session's device, where GPU-placed operators
    run, and its configuration."""

    def __init__(self, device=None, conf=None):
        self.device = resolve_device(device)
        self.cpu = torch.device("cpu")
        self.conf = conf if conf is not None else RapidsConf()


def placed_device(ctx: ExecContext, placement: str) -> torch.device:
    """The context's device for GPU placement, the CPU for CPU."""
    return ctx.device if placement == GPU else ctx.cpu


_SIG_ATOMS = (str, bytes, int, float, bool, type(None), complex)


def semantic_sig(v) -> object:
    """Canonical, hashable signature of an expression tree or a window
    spec: a node walks (class, fields, children), a type is its repr, a
    container recurses.  Two window expressions whose specs have equal
    signatures share one sorted layout (exec/window.py).  The part of
    the reference's ``semantic_sig`` that expressions and specs need; an
    object with no fields keys by its id, which can only split layouts,
    never merge two that differ."""
    if isinstance(v, _SIG_ATOMS):
        return v
    if isinstance(v, t.DataType):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(semantic_sig(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, semantic_sig(x)) for k, x in v.items()))
    try:
        fields = vars(v)
    except TypeError:
        return (type(v).__name__, id(v))
    return (type(v).__name__,) + tuple(
        (k, semantic_sig(x)) for k, x in sorted(fields.items())
        if not k.startswith("__"))


class Exec:
    placement = GPU

    def __init__(self, children: Sequence["Exec"]):
        self.children: List[Exec] = list(children)

    def device(self, ctx: ExecContext) -> torch.device:
        """The device this operator's tensors live on."""
        return placed_device(ctx, self.placement)

    def input_placement(self) -> str:
        """Where this operator's children must be placed: its own
        placement, except across a transition."""
        return self.placement

    def child_batches(self, i: int, pid: int, ctx: ExecContext
                      ) -> Iterator[DeviceBatch]:
        """Child ``i``'s batches of partition ``pid``; a batch that does
        not lie where this operator's input placement says raises."""
        want = placed_device(ctx, self.input_placement())
        for b in self.children[i].execute_partition(pid, ctx):
            if b.columns and b.device.type != want.type:
                raise RuntimeError(
                    f"{self.name} ({self.placement}-placed) got a batch on "
                    f"{b.device} from {self.children[i].name}; expected "
                    f"{want.type} tensors")
            yield b

    def check_placements(self):
        """Raise unless every child is placed where its parent reads: a
        placement change needs a HostToDeviceExec or DeviceToHostExec
        (plan/overrides.py:insert_transitions puts them in)."""
        for c in self.children:
            if c.placement != self.input_placement():
                raise ValueError(
                    f"{self.name} ({self.placement}-placed) reads "
                    f"{c.name} ({c.placement}-placed) with no transition "
                    f"between; plan the query through GpuSession or pass "
                    f"the plan through plan.overrides.insert_transitions")
            c.check_placements()

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

    def partition_use(self) -> str:
        """PASSES, READS or MERGES: whether this operator's output
        depends on how its input is split into partitions.  The plan
        rewrite strips an exchange on one device only where no READS
        operator sits above it before a MERGES one."""
        return PASSES

    def determinism(self):
        """Declared replay class (analysis/determinism.py): None for an
        operator whose output is a row-wise function of its input
        (bit_exact), else a Determinism.  Overridden where the reference
        overrides it, by the same rules."""
        return None

    def execute_partition(self, pid: int, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def execute_collect(self, ctx: ExecContext) -> pa.Table:
        self.check_placements()
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
        mark = "*" if self.placement == GPU else " "
        lines = ["  " * level + mark + self.describe()]
        lines += [c.tree_string(level + 1) for c in self.children]
        return "\n".join(lines)

    def with_new_children(self, children: Sequence["Exec"]) -> "Exec":
        import copy
        c = copy.copy(self)
        c.children = list(children)
        return c

    def transform_up(self, fn):
        node = self
        new_children = [c.transform_up(fn) for c in self.children]
        if any(a is not b for a, b in zip(new_children, node.children)):
            node = node.with_new_children(new_children)
        return fn(node)

    def foreach(self, fn):
        fn(self)
        for c in self.children:
            c.foreach(fn)


def download(batch: DeviceBatch) -> DeviceBatch:
    """How a batch leaves the card: its live rows through the packed
    fetch (``fetch_batch``) when it lies on the card, as ``move_batch``
    moves them when it already lies on the CPU."""
    if batch.columns and batch.device.type == "cuda":
        return fetch_batch(batch)
    return move_batch(batch, torch.device("cpu"), live_only=True)


class _Transition(Exec):
    input_side: str      # the child's placement

    def input_placement(self) -> str:
        return self.input_side

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types


class HostToDeviceExec(_Transition):
    """Move a CPU-placed child's batches onto the context's device."""

    placement = GPU
    input_side = CPU

    def __init__(self, child: Exec):
        super().__init__([child])

    def execute_partition(self, pid, ctx):
        for b in self.child_batches(0, pid, ctx):
            yield move_batch(b, ctx.device)


class DeviceToHostExec(_Transition):
    """Bring a GPU-placed child's batches to CPU tensors (the live rows
    only): a batch on the card through the packed fetch
    (columnar/fetch.py:fetch_batch), as the reference's does; a batch
    already on the CPU (a session on ``device="cpu"``) as it is."""

    placement = CPU
    input_side = GPU

    def __init__(self, child: Exec):
        super().__init__([child])

    def execute_partition(self, pid, ctx):
        for b in self.child_batches(0, pid, ctx):
            yield download(b)
