# Copy of src/repro/sched/__init__.py, kept numpy-only; change both copies together.
"""repro.sched: the adaptive scan scheduler.

The execution layer between the qos :class:`~repro.qos.ScanGateway` and the
cluster :class:`~repro.cluster.streams.MultiStreamPuller`. Static plans
waste fast fabrics three ways, and each module here closes one gap:

* **work stealing** (:mod:`.steal`) — a lagging replica's remaining batch
  range is split at a lease boundary and re-leased to the fastest idle
  replica mid-scan, collapsing the straggler's critical path;
* **shared tickets** (:mod:`.share`) — identical queued requests coalesce
  onto one fan-out; the reassembled result is multicast (copy-on-read) to
  every subscriber with per-subscriber accounting;
* **preemption** (:mod:`.preempt`) — a batch-class scan pauses at its
  bounded-lease boundary when interactive traffic arrives, releasing its
  leases back to the admission budget, and resumes where it stopped when
  the weighted-fair queue readmits it.

:class:`AdaptiveScheduler` (:mod:`.scheduler`) bundles the three; the qos
gateway accepts one via ``ScanGateway(scheduler=…)``.
"""
from __future__ import annotations

from .preempt import PreemptConfig, PreemptibleScan  # noqa: F401
from .scheduler import AdaptiveScheduler  # noqa: F401
from .share import Ticket, TicketStats, TicketTable  # noqa: F401
from .steal import (  # noqa: F401
    ProgressTracker, RateHistory, ServerRateStats, StealConfig, StealEvent,
    StealingPuller,
)
