# Copy of src/repro/sched/scheduler.py, kept numpy-only; change both copies together.
"""The adaptive scheduler: one object bundling the three mechanisms.

``AdaptiveScheduler`` is what callers hand to the qos
:class:`~repro.qos.ScanGateway` (or use directly against a coordinator):
turn on any subset of work stealing (:mod:`.steal`), shared tickets
(:mod:`.share`) and lease-boundary preemption (:mod:`.preempt`) by setting
the corresponding config. ``AdaptiveScheduler.default()`` enables all three
with conservative knobs.

The scheduler also owns the cross-scan state the mechanisms learn from:
``history`` (a :class:`~.steal.RateHistory`) lives here — NOT on the
per-scan puller — so per-server EWMA rates, flap quarantines and
repeat-straggler counts persist across every fan-out this scheduler drives.
A repeat straggler is stolen from earlier on the next scan, and a server
quarantined for flapping stays quarantined into the next scan's decisions.
"""
from __future__ import annotations

import dataclasses

from ..cluster.plan import ScanPlan
from ..cluster.streams import MultiStreamPuller
from .preempt import PreemptConfig
from .share import TicketTable
from .steal import RateHistory, StealConfig, StealingPuller


@dataclasses.dataclass
class AdaptiveScheduler:
    """Adaptive execution policy between the gateway and the dataplane."""

    steal: StealConfig | None = None
    tickets: TicketTable | None = None
    preempt: PreemptConfig | None = None
    history: RateHistory | None = None

    @classmethod
    def default(cls) -> "AdaptiveScheduler":
        """All three mechanisms on, conservative thresholds, with a
        persistent rate history feeding the steal decisions."""
        return cls(steal=StealConfig(), tickets=TicketTable(),
                   preempt=PreemptConfig(), history=RateHistory())

    def make_puller(self, coordinator, plan: ScanPlan,
                    **kwargs) -> MultiStreamPuller:
        """The dataplane driver for one fan-out: a stealing puller when
        stealing is enabled, the plain static one otherwise. The shared
        ``history`` rides along so this scan's rate observations inform the
        next scan's steal thresholds. A ``trace=`` kwarg (an
        ``obs.TraceContext`` from the gateway) passes through untouched —
        the puller fans it out into per-stream child traces."""
        if self.steal is not None:
            return StealingPuller(coordinator, plan, steal=self.steal,
                                  history=self.history, **kwargs)
        return MultiStreamPuller(coordinator, plan, **kwargs)
