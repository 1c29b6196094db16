# Copy of src/repro/qos/metrics.py, kept numpy-only; change both copies together.
"""QoS observability: per-class service metrics that compose with ClusterStats.

Every granted request carries its own
:class:`~repro.cluster.streams.ClusterStats` (the dataplane decomposition);
:class:`QosStats` is the layer above — queue depth, grant latency, shed
counts and per-class throughput — so a benchmark row can report "interactive
p50 grant latency under heavy batch load" next to "bytes over the wire" from
one object.

Latencies and service times are **modeled seconds** (the gateway's clock),
which keeps every fairness comparison deterministic under any machine load —
the same trick :attr:`ClusterStats.modeled_critical_path_s` uses.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

from ..obs.registry import MetricsRegistry, record_qos

if TYPE_CHECKING:   # avoid a hard qos -> cluster import edge for typing only
    from ..cluster.streams import ClusterStats


def _quantile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


@dataclasses.dataclass
class ClassStats:
    """One client class's view of the gateway."""

    name: str
    submitted: int = 0
    granted: int = 0
    shed: int = 0                  # deadline-based rejections
    failed: int = 0                # malformed requests (planner/exec errors)
    grant_latency_s: list[float] = dataclasses.field(default_factory=list)
    service_s: float = 0.0         # modeled service time consumed
    bytes: int = 0                 # from the per-request ClusterStats
    batches: int = 0
    ticket_hits: int = 0           # served by shared-ticket multicast
    preemptions: int = 0           # parked at a lease boundary (sched)

    @property
    def p50_grant_latency_s(self) -> float:
        return _quantile(self.grant_latency_s, 0.5)

    @property
    def p99_grant_latency_s(self) -> float:
        return _quantile(self.grant_latency_s, 0.99)

    @property
    def mean_grant_latency_s(self) -> float:
        """Mean grant latency; 0.0 with no samples (a class that was shed
        wholesale must not take the report down)."""
        if not self.grant_latency_s:
            return 0.0
        return sum(self.grant_latency_s) / len(self.grant_latency_s)

    @property
    def max_grant_latency_s(self) -> float:
        return max(self.grant_latency_s, default=0.0)

    @property
    def throughput_bytes_per_s(self) -> float:
        """Class throughput over the service time it actually consumed."""
        return self.bytes / self.service_s if self.service_s > 0 else 0.0

    def throughput_over(self, duration_s: float) -> float:
        """Bytes per second over an externally chosen modeled window (the
        stress driver's fairness window). A zero-width window — a burst
        whose every request shed before any service ran, or a driver
        queried before its first beat — reports 0.0 rather than dividing
        by zero."""
        return self.bytes / duration_s if duration_s > 0 else 0.0

    def merge(self, other: "ClassStats") -> "ClassStats":
        """Fold another run's view of the same class into this one:
        counters add, the latency samples concatenate (so merged
        percentiles are computed over the union, not averaged)."""
        if other.name != self.name:
            raise ValueError(
                f"cannot merge class {other.name!r} into {self.name!r}")
        self.submitted += other.submitted
        self.granted += other.granted
        self.shed += other.shed
        self.failed += other.failed
        self.grant_latency_s.extend(other.grant_latency_s)
        self.service_s += other.service_s
        self.bytes += other.bytes
        self.batches += other.batches
        self.ticket_hits += other.ticket_hits
        self.preemptions += other.preemptions
        return self


@dataclasses.dataclass
class QosStats:
    """Aggregate gateway metrics across classes + the per-request dataplane
    stats they compose with."""

    classes: dict[str, ClassStats] = dataclasses.field(default_factory=dict)
    queue_depth_max: int = 0
    throttle_wait_s: float = 0.0        # token-bucket wait (admission)
    makespan_s: float = 0.0             # gateway clock when the queue drained
    replans: int = 0                    # freed-slot events that widened a
    #                                     quota-capped in-flight fan-out
    alerts: int = 0                     # SLO burn-rate alerts fired against
    #                                     this gateway's heartbeat snapshots
    cluster: list["ClusterStats"] = dataclasses.field(default_factory=list)
    # admission snapshot (duck-typed: AdmissionStats, or the sharded
    # DistributedStats whose .shards dict carries per-shard grant/denial/
    # borrow/reconcile counters — utils/report.admission_table renders it)
    admission: object = None

    def klass(self, name: str) -> ClassStats:
        if name not in self.classes:
            self.classes[name] = ClassStats(name)
        return self.classes[name]

    @property
    def submitted(self) -> int:
        return sum(c.submitted for c in self.classes.values())

    @property
    def granted(self) -> int:
        return sum(c.granted for c in self.classes.values())

    @property
    def shed(self) -> int:
        return sum(c.shed for c in self.classes.values())

    @property
    def failed(self) -> int:
        return sum(c.failed for c in self.classes.values())

    @property
    def bytes(self) -> int:
        return sum(c.bytes for c in self.classes.values())

    @property
    def ticket_hits(self) -> int:
        """Requests served by shared-ticket multicast (no fan-out ran)."""
        return sum(c.ticket_hits for c in self.classes.values())

    @property
    def preemptions(self) -> int:
        """Lease-boundary parks across every class."""
        return sum(c.preemptions for c in self.classes.values())

    @property
    def steals(self) -> int:
        """Work-stealing range migrations across every granted fan-out."""
        return sum(c.steals for c in self.cluster)

    @property
    def declines(self) -> int:
        """Steals refused because the thief's admission shard was at its
        local quota (shard-aware stealing backing off)."""
        return sum(c.declines for c in self.cluster)

    @property
    def re_steals(self) -> int:
        """Stolen tails reclaimed by their original victim after the thief
        degraded (one per range, by construction)."""
        return sum(c.re_steals for c in self.cluster)

    def merge(self, other: "QosStats") -> "QosStats":
        """Fold another gateway's (or run's) stats into this one. Classes
        merge by name — disjoint class sets union cleanly; overlapping
        classes combine via :meth:`ClassStats.merge`. Gauges take the max
        (queue depth, makespan), durations/counters add, and the
        per-request cluster list concatenates so steal attribution and
        the registry roll-up keep seeing every fan-out. The admission
        snapshot is kept from whichever side has one (self wins when
        both do — admission controllers are shared, not additive)."""
        for name, cstats in other.classes.items():
            if name in self.classes:
                self.classes[name].merge(cstats)
            else:
                self.classes[name] = cstats
        self.queue_depth_max = max(self.queue_depth_max,
                                   other.queue_depth_max)
        self.throttle_wait_s += other.throttle_wait_s
        self.makespan_s = max(self.makespan_s, other.makespan_s)
        self.replans += other.replans
        self.alerts += getattr(other, "alerts", 0)
        self.cluster.extend(other.cluster)
        if self.admission is None:
            self.admission = other.admission
        return self

    def registry(self) -> "MetricsRegistry":
        """This stats object snapshotted into a fresh
        :class:`~repro.obs.MetricsRegistry` (the ``qos.*`` namespace)."""
        reg = MetricsRegistry()
        record_qos(reg, self)
        return reg

    def summary(self) -> str:
        """One benchmark-row string: the acceptance-criteria numbers."""
        parts = [f"depth_max={self.queue_depth_max}", f"shed={self.shed}",
                 f"failed={self.failed}",
                 f"throttle_us={self.throttle_wait_s * 1e6:.1f}",
                 f"makespan_us={self.makespan_s * 1e6:.1f}"]
        if self.steals or self.ticket_hits or self.preemptions:
            parts.append(f"steals={self.steals} "
                         f"ticket_hits={self.ticket_hits} "
                         f"preempt={self.preemptions}")
        if self.declines or self.re_steals:
            parts.append(f"declines={self.declines} "
                         f"re_steals={self.re_steals}")
        if self.replans:
            parts.append(f"replans={self.replans}")
        if self.alerts:
            parts.append(f"alerts={self.alerts}")
        shards = getattr(self.admission, "shards", None)
        if shards:
            agg = self.admission
            parts.append(f"shards={len(shards)} borrows={agg.borrows} "
                         f"reconciles={agg.reconciles} "
                         f"peak={agg.peak_total}")
        for name in sorted(self.classes):
            c = self.classes[name]
            parts.append(
                f"{name}[n={c.granted}/{c.submitted} "
                f"p50_grant_us={c.p50_grant_latency_s * 1e6:.1f} "
                f"tput_MBps={c.throughput_bytes_per_s / 1e6:.1f}]")
        return " ".join(parts)
