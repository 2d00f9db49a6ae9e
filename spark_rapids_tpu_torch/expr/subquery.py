"""Scalar subqueries: a one-row, one-column query used as a value.

Counterpart of spark_rapids_tpu/expr/subquery.py.  ``ScalarSubquery``
holds the subquery's logical plan; ``resolve_scalar_subqueries`` runs
each one through the session before the outer query is planned (Spark's
order: the subquery first) and puts a typed Literal of its value in its
place, so the outer query plans and runs with a constant.  The caller's
logical plan is left as it was: a second collect runs the subqueries
again, over the data as it is then.
"""

from __future__ import annotations

import copy

from .core import Expression, Literal

# the logical plan's attributes that hold expressions
_EXPR_ATTRS = ("condition", "exprs", "grouping", "aggregates", "orders",
               "keys", "window_exprs")


class ScalarSubquery(Expression):
    """A subquery that must give exactly one row of one column."""

    def __init__(self, lp):
        self.children = ()
        self.lp = lp

    def data_type(self):
        return self.lp.schema()[1][0]

    def sql(self):
        return "scalar_subquery(...)"


def _map_exprs(v, fn):
    """``fn`` over every Expression in a (nested) list or tuple, keeping
    its shape and every other item."""
    if isinstance(v, Expression):
        return fn(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_map_exprs(x, fn) for x in v)
    return v


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a is b


def resolve_scalar_subqueries(lp, session, execute: bool = True):
    """The plan with every ScalarSubquery replaced by a Literal of its
    value (``execute=False``: a typed null, so that explain runs nothing).
    Raises ValueError where a subquery gives other than one row, Spark's
    runtime error."""

    def fn(x: Expression) -> Expression:
        from .window import WindowExpression
        if isinstance(x, ScalarSubquery):
            if not execute:
                return Literal(None, x.data_type())
            out = session.execute(x.lp)
            if out.num_columns < 1 or out.num_rows != 1:
                raise ValueError(f"scalar subquery must return one row, "
                                 f"got {out.num_rows}")
            return Literal(out.column(0).to_pylist()[0], x.data_type())
        if isinstance(x, WindowExpression):
            # the window spec's keys live outside the children
            spec = x.spec
            pb = [e.transform_up(fn) for e in spec.partition_by]
            ob = _map_exprs(spec.order_by, lambda e: e.transform_up(fn))
            if not (_same(pb, spec.partition_by) and
                    _same(ob, spec.order_by)):
                x = copy.copy(x)
                x.spec = copy.copy(spec)
                x.spec.partition_by, x.spec.order_by = pb, ob
        return x

    def walk(node):
        children = tuple(walk(c) for c in node.children)
        changed = {}
        for attr in _EXPR_ATTRS:
            v = getattr(node, attr, None)
            if v is None:
                continue
            nv = _map_exprs(v, lambda e: e.transform_up(fn))
            if not _same(v, nv):
                changed[attr] = nv
        if not changed and _same(children, node.children):
            return node
        node = copy.copy(node)
        node.children = children
        for attr, nv in changed.items():
            setattr(node, attr, nv)
        return node

    return walk(lp)
