"""The host path of the string rules that evaluate on the CPU engine only
(``concat_ws``, ``md5``, ``substring_index`` with a delimiter of other
than one byte).

Counterpart of spark_rapids_tpu/expr/regex.py's ``_host_only``,
``np_string_rows`` and ``build_string_column`` (without the regex
rules, which come with ROADMAP Queue 1 item 4e).  Tagging keeps such a
rule's operator on the CPU engine, whose tensors lie on the CPU; on a
CUDA tensor the evaluator raises.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import types as t
from ..columnar.device import DeviceColumn
from .core import ColumnValue, EvalContext


def host_only(ctx: EvalContext, name: str) -> None:
    if ctx.device.type != "cpu":
        raise RuntimeError(f"{name} evaluates on the host engine only; "
                           f"tagging keeps it off the GPU")


def host_string_rows(col: DeviceColumn, cap: int,
                     errors: Optional[str] = "replace") -> List:
    """A CPU string column's rows (None for a null): Python strings decoded
    with ``errors`` ("surrogateescape" keeps invalid UTF-8 intact through
    ``build_string_column``), or the bytes themselves for None."""
    offs = col.offsets.tolist()
    data = col.data.numpy().tobytes()
    valid = col.validity.tolist()
    rows = [data[offs[i]:offs[i + 1]] if valid[i] else None
            for i in range(cap)]
    if errors is None:
        return rows
    return [r.decode("utf-8", errors) if r is not None else None
            for r in rows]


def build_string_column(ctx: EvalContext, rows: List) -> ColumnValue:
    """A STRING column of Python strings or bytes (None for a null) on the
    CPU."""
    enc = [b"" if r is None else r if isinstance(r, bytes)
           else r.encode("utf-8", "surrogateescape") for r in rows]
    offs = [0]
    for b in enc:
        offs.append(offs[-1] + len(b))
    data = b"".join(enc)
    chars = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(1, dtype=torch.uint8)
    return ColumnValue(DeviceColumn(
        t.STRING, chars, torch.tensor([r is not None for r in rows],
                                      dtype=torch.bool),
        torch.tensor(offs, dtype=torch.int32)))
