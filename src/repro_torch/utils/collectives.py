"""Collective inventory and ring-model wire bytes: the port's counterpart
of :mod:`repro.utils.hlo`.

The JAX package reads its collectives out of XLA's partitioned HLO text.
The port has no HLO: a DTensor program issues PyTorch's functional
collectives (``torch.ops._c10d_functional.*``), which a
``TorchDispatchMode`` sees on each rank's local tensors.
:func:`collective_of` turns one such call into a :class:`Collective` (op
kind, result bytes, group size), and :func:`collective_stats` sums a record
of them into the JAX package's :class:`CollectiveStats`, converting each op
to *per-device wire bytes* with the ring-algorithm formulas of
``hlo.py``:

  all-gather         (g-1)/g × result_bytes
  reduce-scatter     (g-1)   × result_bytes          (operand = g × result)
  all-reduce         2(g-1)/g × result_bytes
  all-to-all         (g-1)/g × result_bytes
  collective-permute 1 × result_bytes

An op over a group of one rank moves nothing and is not counted.
:class:`repro_torch.utils.cost.Counter` keeps such a record.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterable

import torch

_RING = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: g - 1,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# torch.ops._c10d_functional op name -> HLO op kind
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def shape_bytes(dtype: torch.dtype, shape) -> int:
    """Bytes of a ``dtype`` tensor of ``shape``."""
    return math.prod(shape) * dtype.itemsize


def wire_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Ring-model bytes one device sends for ``op`` (an HLO op kind) over a
    group of ``group_size`` ranks."""
    return _RING[op](group_size) * result_bytes if group_size > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class Collective:
    op: str              # HLO op kind: "all-gather", "reduce-scatter", ...
    result_bytes: int    # bytes of this rank's result
    group_size: int


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    result_bytes: dict[str, int]       # summed result sizes per op kind
    wire_bytes: dict[str, float]       # ring-model per-device bytes
    total_wire_bytes: float

    def summary(self) -> str:
        parts = [f"{k}×{self.counts[k]} ({self.wire_bytes[k]/1e6:.1f} MB)"
                 for k in sorted(self.counts)]
        return ", ".join(parts) if parts else "none"


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for t in x if isinstance(t, torch.Tensor)] if isinstance(x, (list, tuple)) else []


def collective_of(func, args, out) -> Collective | None:
    """The :class:`Collective` of one functional collective call ``func(*args)
    -> out`` as a dispatch mode sees it, or ``None`` for any other op (also
    ``wait_tensor``)."""
    packet = getattr(func, "_overloadpacket", None)
    if packet is None or getattr(packet, "_qualified_op_name", "").split("::")[0] != "_c10d_functional":
        return None
    op = _FUNCTIONAL.get(packet.__name__)
    if op is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(args[-1]).size()
    return Collective(op, sum(t.numel() * t.dtype.itemsize for t in _tensors(out)), group)


def collective_stats(record: Iterable[Collective]) -> CollectiveStats:
    """Counts, result bytes and ring-model wire bytes per op kind of a record
    of collectives; ops over a group of one are left out."""
    counts: dict[str, int] = defaultdict(int)
    result_bytes: dict[str, int] = defaultdict(int)
    wire: dict[str, float] = defaultdict(float)
    for c in record:
        if c.group_size <= 1:
            continue
        counts[c.op] += 1
        result_bytes[c.op] += c.result_bytes
        wire[c.op] += wire_bytes(c.op, c.result_bytes, c.group_size)
    return CollectiveStats(dict(counts), dict(result_bytes), dict(wire),
                           float(sum(wire.values())))
