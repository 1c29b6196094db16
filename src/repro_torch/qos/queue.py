# Copy of src/repro/qos/queue.py, kept numpy-only; change both copies together.
"""Weighted-fair queueing across client classes, with deadline shedding.

The gateway serves two very different traffic shapes from one reader map:
*interactive* requests (serving lookups — small, latency-sensitive) and
*batch* requests (training scans — huge, throughput-bound). A FIFO queue
lets one heavy client starve everyone; weighted-fair queueing gives each
class a share of service proportional to its weight, the way exchange
operators are scheduled in high-speed-network query engines
(arXiv:1502.07169).

The discipline is classic virtual-finish-time WFQ: request *i* of class *c*
gets ``finish_i = max(vtime, last_finish_c) + cost_i / weight_c`` and the
queue pops the smallest finish tag. ``cost`` is the request's service
estimate in abstract units (the gateway calibrates units → modeled seconds
as it serves). A class with weight 4 therefore drains 4× the service of a
weight-1 class under contention, while an idle class loses nothing (its
``last_finish`` lags ``vtime``).

:class:`FifoQueue` is the same interface with arrival-order tags — the
"quotas disabled" baseline the contention benchmark compares against.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class ClientClass:
    name: str
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"class {self.name!r} needs weight > 0")


#: Default two-class split: interactive traffic gets 4× the service share.
INTERACTIVE = ClientClass("interactive", 4.0)
BATCH = ClientClass("batch", 1.0)


class WeightedFairQueue:
    """Virtual-finish-time WFQ over client classes."""

    fair = True

    def __init__(self, classes: Iterable[ClientClass] | None = None):
        self.classes = {c.name: c for c in (classes or (INTERACTIVE, BATCH))}
        self._heap: list[tuple[float, int, float, object]] = []
        self._seq = 0
        self._vtime = 0.0
        self._last_finish: dict[str, float] = {}

    def weight(self, klass: str) -> float:
        cls = self.classes.get(klass)
        return cls.weight if cls is not None else 1.0

    # ----------------------------------------------------------- enqueueing
    def would_finish(self, klass: str, cost: float) -> float:
        """The finish tag a push would get — used for shed estimates."""
        start = max(self._vtime, self._last_finish.get(klass, 0.0))
        return start + max(cost, 1e-12) / self.weight(klass)

    def backlog_before(self, finish_tag: float) -> float:
        """Total queued cost that would be served before ``finish_tag`` —
        the modeled wait (in cost units) a new request with that tag faces."""
        return sum(cost for tag, _, cost, _ in self._heap if tag <= finish_tag)

    def push(self, item, klass: str, cost: float = 1.0) -> float:
        tag = self.would_finish(klass, cost)
        self._last_finish[klass] = tag
        heapq.heappush(self._heap, (tag, self._seq, max(cost, 1e-12), item))
        self._seq += 1
        return tag

    # ------------------------------------------------------------ dequeuing
    def pop(self, now_s: float | None = None):
        """Pop the smallest finish tag. With ``now_s`` (the preemption-aware
        gateway's modeled clock), only items that have *arrived*
        (``item.arrival_s <= now_s``) compete; when nothing has arrived yet
        the global minimum is returned and the caller advances its clock to
        that item's arrival. Without ``now_s`` arrival times are ignored
        (the pre-sched behavior)."""
        if now_s is None or not self._heap:
            tag, _, _, item = heapq.heappop(self._heap)
            self._vtime = max(self._vtime, tag)
            return item
        arrived = [e for e in self._heap
                   if getattr(e[3], "arrival_s", 0.0) <= now_s]
        if arrived:
            entry = min(arrived)
        else:
            # idle gateway: serve the EARLIEST arrival next (jumping to a
            # later-arriving item's tag would idle past — and spuriously
            # deadline-shed — requests that arrive in between)
            entry = min(self._heap,
                        key=lambda e: (getattr(e[3], "arrival_s", 0.0),
                                       e[0], e[1]))
        self._heap.remove(entry)
        heapq.heapify(self._heap)
        self._vtime = max(self._vtime, entry[0])
        return entry[3]

    def has_preemptor(self, klass: str, now_s: float) -> bool:
        """True when a strictly higher-weight request has arrived by
        ``now_s`` — the gateway's signal to park a running ``klass`` scan
        at its next lease boundary."""
        w = self.weight(klass)
        return any(
            self.weight(getattr(item, "klass", "?")) > w
            and getattr(item, "arrival_s", 0.0) <= now_s
            for _, _, _, item in self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def depth_by_class(self, key=lambda item: getattr(item, "klass", "?")
                       ) -> dict[str, int]:
        depths: dict[str, int] = {}
        for _, _, _, item in self._heap:
            k = key(item)
            depths[k] = depths.get(k, 0) + 1
        return depths


class FifoQueue(WeightedFairQueue):
    """Arrival-order queue: the no-QoS baseline (weights ignored)."""

    fair = False

    def would_finish(self, klass: str, cost: float) -> float:
        return float(self._seq)

    def push(self, item, klass: str, cost: float = 1.0) -> float:
        tag = float(self._seq)
        heapq.heappush(self._heap, (tag, self._seq, max(cost, 1e-12), item))
        self._seq += 1
        return tag
