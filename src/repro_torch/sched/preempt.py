# Copy of src/repro/sched/preempt.py, kept numpy-only; change both copies together.
"""Lease-boundary preemption: pause a heavy scan, run the lookup, resume.

The qos layer's deadline shedding rejects at grant time only — once a
batch-class fan-out holds its leases, an interactive arrival waits behind
the whole scan. But the dataplane already pulls in bounded ``max_batches``
leases, and a lease boundary is a natural preemption point: nothing is in
flight, every stream's resume offset is exact.

:class:`PreemptibleScan` drives a :class:`~repro.cluster.streams.
MultiStreamPuller` (or a :class:`~.steal.StealingPuller`) one lease round at
a time so the gateway can interleave scheduling decisions with execution:

* :meth:`run_round` pulls one bounded lease on every live stream and
  returns the modeled time the round added to the scan's critical path;
* :meth:`park` releases every stream's server lease **and its admission
  slot** back to the budget (``StreamPuller.park``), checkpointing resume
  offsets — the scan holds no server-side resources while parked;
* :meth:`resume` re-opens every stream where it stopped through fresh
  admission-gated leases (``init_scan(start_batch=…)``), once the WFQ
  virtual clock readmits the parked request.

The gateway decides *when*: it parks a batch-class scan as soon as a
higher-weight (interactive) request has arrived on the modeled clock, and
pushes the remainder back into the weighted-fair queue at its residual cost.
"""
from __future__ import annotations

import dataclasses

from ..cluster.streams import (ClusterStats, MultiStreamPuller,
                               notify_coordinator)


@dataclasses.dataclass(frozen=True)
class PreemptConfig:
    """Knobs for the gateway's preemption policy.

    ``preemptible_classes`` limits which client classes may be paused;
    ``None`` means any class outweighed by another configured class (with
    the default two-class split: batch yields to interactive).
    """

    preemptible_classes: tuple[str, ...] | None = None
    min_rounds_before_park: int = 1    # let a scan make some progress

    def applies_to(self, klass: str) -> bool:
        return (self.preemptible_classes is None
                or klass in self.preemptible_classes)


class PreemptibleScan:
    """A fan-out that executes in parkable lease-round bursts.

    Accumulates per-stream deliveries across bursts so the gateway can
    reassemble the final result exactly as if the scan had run unbroken.
    ``copy_out`` must be set when a pool is attached (pooled buffers recycle
    on the next pull; parked results must survive arbitrarily long).
    """

    def __init__(self, puller: MultiStreamPuller, copy_batch=None):
        self.puller = puller
        self._copy = copy_batch if puller.pool is not None else None
        self.per_stream: list[list] = [[] for _ in puller.pullers]
        self.rounds = 0
        self.parked = False
        self.park_count = 0
        self.elapsed_s = 0.0            # modeled execution time, bursts only

    # ------------------------------------------------------------ progress
    @property
    def done(self) -> bool:
        return all(p.drained for p in self.puller.pullers)

    @property
    def delivered(self) -> int:
        return sum(p.delivered for p in self.puller.pullers)

    @property
    def total_batches(self) -> int | None:
        """Known total for bounded (replica) plans, else ``None``."""
        totals = [p.endpoint.max_batches for p in self.puller.pullers]
        if any(t is None for t in totals):
            return None
        return sum(totals)

    def _clock_s(self) -> float:
        return max((p.stats.start_s + p.stats.clock_s
                    for p in self.puller.pullers), default=0.0)

    # --------------------------------------------------------------- drive
    def run_round(self) -> float:
        """One bounded lease on every live stream; returns the modeled time
        this round added to the scan's critical path."""
        if self.parked:
            raise RuntimeError("scan is parked; resume() before driving")
        before = self._clock_s()
        for idx, puller in enumerate(self.puller.pullers):
            if puller.drained:
                continue
            out = puller.pull_lease(self.puller.lease_batches)
            while out:
                batch, handle = out.pop(0)
                self.per_stream[idx].append(
                    self._copy(batch) if self._copy is not None else batch)
                if handle is not None:
                    self.puller.pool.release(handle)
        # stealing drivers may have appended thief pullers mid-round via
        # explicit rebalance() calls; keep the delivery table in step
        while len(self.per_stream) < len(self.puller.pullers):
            self.per_stream.append([])
        self.rounds += 1
        delta = self._clock_s() - before
        self.elapsed_s += delta
        return delta

    def rebalance(self) -> int:
        """Run the underlying driver's straggler check, when it has one
        (a :class:`~.steal.StealingPuller`). Returns new streams added."""
        maybe_steal = getattr(self.puller, "_maybe_steal", None)
        if maybe_steal is None:
            return 0
        added = list(maybe_steal())
        while len(self.per_stream) < len(self.puller.pullers):
            self.per_stream.append([])
        return len(added)

    # --------------------------------------------------------- park/resume
    def park(self) -> None:
        """Release every live lease (and its admission slot) at the current
        lease boundary; resume offsets are already checkpointed per stream
        (``StreamPuller.delivered``)."""
        if self.parked:
            return
        if self.puller.trace is not None:
            self.puller.trace.instant("scan.park", self._clock_s(),
                                      cat="sched", group="scan",
                                      rounds=self.rounds)
        for puller in self.puller.pullers:
            puller.park()
        self.parked = True
        self.park_count += 1
        notify_coordinator(self.puller.coordinator, "scan.park",
                           now_s=self._clock_s(), rounds=self.rounds)

    def resume(self) -> None:
        """Re-open every parked stream where it stopped. May raise
        ``qos.Backpressure`` — parking gave the slots back, so resuming is
        a fresh admission decision; on a partial failure the streams that
        did re-open are parked again (nothing leaks)."""
        if not self.parked:
            return
        reopened = []
        try:
            for puller in self.puller.pullers:
                puller.unpark()
                reopened.append(puller)
        except BaseException:
            for puller in reopened:
                puller.park()
            raise
        self.parked = False
        if self.puller.trace is not None:
            self.puller.trace.instant("scan.resume", self._clock_s(),
                                      cat="sched", group="scan",
                                      rounds=self.rounds)
        notify_coordinator(self.puller.coordinator, "scan.resume",
                           now_s=self._clock_s(), rounds=self.rounds)

    # -------------------------------------------------------------- finish
    def abandon(self) -> None:
        """Tear down leases for a scan that will never finish (its request
        was shed while parked)."""
        self.puller._abandon()

    def stats(self) -> ClusterStats:
        return self.puller.stats()
