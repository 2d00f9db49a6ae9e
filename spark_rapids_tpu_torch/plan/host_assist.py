"""Collect-side transfer elision for a global sort of an in-memory table.

Counterpart of spark_rapids_tpu/plan/host_assist.py.  A global sort of a
host-resident table computes a permutation: the result's bytes already
sit on the host and only their order is new.  So the device plan carries
a row id (monotonically_increasing_id) through the filters and the sort
and fetches that one lane (narrowed by the packed fetch), and the host
``take``s its own copy of the table in that order.

Scope: a global Sort over optional Filters and attribute-only Projects
over a LocalRelation of at least ``_MIN_ROWS`` rows; below that the
direct fetch costs no more, and small tests keep driving it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa

from .. import config as cfg
from ..expr.core import Alias, AttributeReference
from ..expr.hashfns import MonotonicallyIncreasingID
from . import logical as L

_MIN_ROWS = 1 << 16

_RID = "__rid__"


def try_host_assisted_collect(session, lp) -> Optional[pa.Table]:
    """The collect's result through a host take, or None when the plan
    is not a row permutation of a host-resident table."""
    if not (session.conf.sql_enabled and
            session.conf.get(cfg.HOST_ASSISTED_COLLECT)):
        return None
    if not isinstance(lp, L.Sort) or not lp.is_global:
        return None
    filters = []
    node = lp.children[0]
    while True:
        if isinstance(node, L.Project):
            if not all(isinstance(e, AttributeReference)
                       for e in node.exprs):
                return None
            node = node.children[0]
        elif isinstance(node, L.Filter):
            filters.append(node.condition)
            node = node.children[0]
        elif isinstance(node, L.LocalRelation):
            break
        else:
            return None
    host = node.table
    if host.num_rows < _MIN_ROWS:
        return None

    # only the columns the filters and the sort keys read ride along
    needed = []
    for e in filters + [o[0] for o in lp.orders]:
        for a in e.collect(lambda x: isinstance(x, AttributeReference)):
            if a.name not in needed:
                needed.append(a.name)
    rid_plan: L.LogicalPlan = L.Project(
        [AttributeReference(n) for n in host.schema.names if n in needed]
        + [Alias(MonotonicallyIncreasingID(), _RID)], node)
    for cond in reversed(filters):
        rid_plan = L.Filter(cond, rid_plan)
    rid_plan = L.Sort(lp.orders, True, rid_plan)
    rid_plan = L.Project([AttributeReference(_RID)], rid_plan)
    rid = session.execute(rid_plan).column(_RID).to_numpy()

    # (partition << 33) + offset -> the row's index in the table; the
    # scan slices the table into ceil(n / p)-row partitions in order
    per = -(-host.num_rows // max(1, node.num_partitions))
    idx = (rid >> 33) * per + (rid & ((np.int64(1) << 33) - 1))
    out = host.combine_chunks().take(idx)
    names = lp.schema()[0]
    if list(out.schema.names) != names:
        out = out.select(names)
    return out
