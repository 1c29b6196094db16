# Copy of src/repro/obs/registry.py, kept numpy-only; change both copies together.
"""The unified telemetry registry.

A :class:`MetricsRegistry` holds counters, gauges and histograms under a
stable dotted namespace; every ``*Stats`` dataclass in the stack snapshots
into it via the duck-typed ``record_*`` helpers below (this module imports
nothing from the rest of :mod:`repro`, so any layer can import it).

Namespace conventions:

* durations are recorded in **microseconds** under ``.us``-suffixed names
  (``cluster.pull.us``, ``qos.makespan.us``);
* per-event latencies go into histograms, whose snapshot expands to
  ``.count`` / ``.p50`` / ``.p95`` / ``.p99`` / ``.max`` / ``.sum``
  (``qos.grant_latency.p50`` is the p50 of the grant-latency histogram);
* discrete events are counters (``sched.steals.decline``,
  ``pool.evictions``), sizes/levels are gauges.

``registry.snapshot()`` flattens everything to one ``{name: float}`` dict —
the single surface CI, reports and the loader roll-up read from.
"""
from __future__ import annotations

import dataclasses


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class MetricsRegistry:
    """Counters, gauges and histograms under dotted names."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}

    # ------------------------------------------------------------- writers
    def counter(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str, value) -> None:
        """Record one observation, or extend with an iterable of them.
        Non-numeric observations are skipped (the registry is a telemetry
        sink — it must never take the caller down)."""
        bucket = self.histograms.setdefault(name, [])
        if isinstance(value, (str, bytes)) or not hasattr(value, "__iter__"):
            value = (value,)
        for v in value:
            try:
                bucket.append(float(v))
            except (TypeError, ValueError):
                continue

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into self: counters add, gauges take the latest,
        histograms concatenate. Returns self for chaining."""
        for name, v in other.counters.items():
            self.counter(name, v)
        self.gauges.update(other.gauges)
        for name, vals in other.histograms.items():
            self.histogram(name, vals)
        return self

    # ------------------------------------------------------------- readers
    def snapshot(self) -> dict[str, float]:
        """One flat ``{dotted.name: value}`` view; histograms expand to
        ``.count/.p50/.p95/.p99/.max/.sum``."""
        out: dict[str, float] = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, vals in self.histograms.items():
            vs = sorted(vals)
            out[f"{name}.count"] = float(len(vs))
            out[f"{name}.p50"] = _quantile(vs, 0.50)
            out[f"{name}.p95"] = _quantile(vs, 0.95)
            out[f"{name}.p99"] = _quantile(vs, 0.99)
            out[f"{name}.max"] = vs[-1] if vs else 0.0
            out[f"{name}.sum"] = sum(vs)
        return out

    def get(self, name: str, default: float = 0.0) -> float:
        return self.snapshot().get(name, default)


# --------------------------------------------------------------------------
# Duck-typed recorders: one per *Stats* family, each writing its stable
# namespace. All tolerate missing attributes (older snapshots) via getattr.
# --------------------------------------------------------------------------

def _us(reg: MetricsRegistry, name: str, seconds: float) -> None:
    reg.gauge(name, seconds * 1e6)


def record_pool(reg: MetricsRegistry, pool_stats, prefix: str = "pool") -> None:
    """``repro.cluster.PoolStats`` → ``pool.*``."""
    s = pool_stats
    reg.counter(f"{prefix}.hits", s.hits)
    reg.counter(f"{prefix}.misses", s.misses)
    reg.counter(f"{prefix}.slabs_created", s.slabs_created)
    reg.counter(f"{prefix}.evictions", s.evictions)
    reg.counter(f"{prefix}.bytes_evicted", s.bytes_evicted)
    reg.gauge(f"{prefix}.bytes_pooled", s.bytes_pooled)
    reg.gauge(f"{prefix}.bytes_resident", s.bytes_resident)
    reg.gauge(f"{prefix}.registered_segments", s.registered_segments)
    reg.gauge(f"{prefix}.hit_rate", s.hit_rate)
    _us(reg, f"{prefix}.register.us", s.modeled_register_s)
    _us(reg, f"{prefix}.acquire.us", s.acquire_s)


def record_repair(reg: MetricsRegistry, repair_stats,
                  prefix: str = "repair") -> None:
    """``repro.cluster.RepairStats`` → ``repair.*``: the peer-to-peer
    re-placement traffic (pulls/reuse), the durability fallbacks
    (``table_copies``), and the background-class QoS charges."""
    s = repair_stats
    reg.counter(f"{prefix}.repairs", s.repairs)
    reg.counter(f"{prefix}.batches_pulled", s.batches_pulled)
    reg.counter(f"{prefix}.bytes_pulled", s.bytes_pulled)
    reg.counter(f"{prefix}.segments_pulled", s.segments_pulled)
    reg.counter(f"{prefix}.batches_reused", s.batches_reused)
    reg.counter(f"{prefix}.table_copies", s.table_copies)
    reg.counter(f"{prefix}.bytes_copied", s.bytes_copied)
    reg.counter(f"{prefix}.yields", s.yields)
    _us(reg, f"{prefix}.wire.us", s.modeled_wire_s)
    _us(reg, f"{prefix}.copy.us", s.modeled_copy_s)
    _us(reg, f"{prefix}.throttle_wait.us", s.throttle_wait_s)
    _us(reg, f"{prefix}.yield.us", s.yield_s)
    _us(reg, f"{prefix}.clock.us", s.clock_s)


def record_stream(reg: MetricsRegistry, stream_stats,
                  prefix: str = "cluster.stream") -> None:
    """One ``repro.cluster.StreamStats`` → counters + per-stream clock
    histogram under ``cluster.stream.*``."""
    s = stream_stats
    reg.counter(f"{prefix}.batches", s.batches)
    reg.counter(f"{prefix}.bytes", s.bytes)
    reg.counter(f"{prefix}.segments", s.segments)
    reg.counter(f"{prefix}.rdma_ops", s.rdma_ops)
    reg.counter(f"{prefix}.control_rpcs", s.control_rpcs)
    reg.counter(f"{prefix}.resumes", s.resumes)
    reg.counter(f"{prefix}.parks", getattr(s, "parks", 0))
    reg.histogram(f"{prefix}.clock.us", s.clock_s * 1e6)


def record_cluster(reg: MetricsRegistry, cluster_stats,
                   prefix: str = "cluster") -> None:
    """``repro.cluster.ClusterStats`` → ``cluster.*`` + ``sched.steals.*``.
    ``cluster.pull.us`` is the fan-out's modeled wire time."""
    c = cluster_stats
    _us(reg, f"{prefix}.pull.us", c.modeled_wire_s)
    _us(reg, f"{prefix}.critical_path.us", c.critical_path_s)
    _us(reg, f"{prefix}.modeled_critical_path.us", c.modeled_critical_path_s)
    _us(reg, f"{prefix}.register.us", c.modeled_register_s)
    _us(reg, f"{prefix}.control_rpc.us", c.control_rpc_s)
    _us(reg, f"{prefix}.prefetch_overlap.us", c.prefetch_overlap_s)
    _us(reg, f"{prefix}.throttle_wait.us", c.throttle_wait_s)
    reg.counter(f"{prefix}.batches", c.batches)
    reg.counter(f"{prefix}.bytes", c.bytes)
    reg.counter(f"{prefix}.segments", sum(s.segments for s in c.streams))
    reg.counter(f"{prefix}.rdma_ops", sum(s.rdma_ops for s in c.streams))
    reg.counter(f"{prefix}.control_rpcs",
                sum(s.control_rpcs for s in c.streams))
    reg.counter(f"{prefix}.resumes", c.resumes)
    reg.counter(f"{prefix}.streams", len(c.streams))
    reg.counter("sched.steals.total", c.steals)
    reg.counter("sched.steals.decline", c.declines)
    reg.counter("sched.steals.re_steal", c.re_steals)
    for s in c.streams:
        record_stream(reg, s, prefix=f"{prefix}.stream")
    if getattr(c, "pool", None) is not None:
        record_pool(reg, c.pool)


def record_tickets(reg: MetricsRegistry, ticket_stats,
                   prefix: str = "sched.tickets") -> None:
    """``repro.sched.TicketStats`` → ``sched.tickets.*``."""
    t = ticket_stats
    reg.counter(f"{prefix}.hits", t.hits)
    reg.counter(f"{prefix}.misses", t.misses)
    reg.counter(f"{prefix}.cancels", t.cancels)
    reg.counter(f"{prefix}.bytes_multicast", t.bytes_multicast)
    reg.gauge(f"{prefix}.hit_rate", t.hit_rate)
    reg.gauge(f"{prefix}.fanouts_saved", t.fanouts_saved)


def record_admission(reg: MetricsRegistry, adm_stats,
                     prefix: str = "qos.admission") -> None:
    """``AdmissionStats`` / ``ShardStats`` / ``DistributedStats`` →
    ``qos.admission.*`` (per-shard stats recurse under ``.shard.<id>``)."""
    a = adm_stats
    reg.counter(f"{prefix}.stream_grants", a.stream_grants)
    reg.counter(f"{prefix}.stream_denials", a.stream_denials)
    reg.counter(f"{prefix}.total_denials", a.total_denials)
    reg.counter(f"{prefix}.memory_denials", a.memory_denials)
    reg.counter(f"{prefix}.lease_grants", a.lease_grants)
    reg.gauge(f"{prefix}.peak_active", a.peak_active)
    _us(reg, f"{prefix}.throttle_wait.us", a.throttle_wait_s)
    for field in ("borrows", "lends", "reconciles"):
        if hasattr(a, field):
            reg.counter(f"{prefix}.{field}", getattr(a, field))
    for field, kind in (("tokens_in", "g"), ("tokens_out", "g"),
                        ("tokens_rebalanced", "g"), ("peak_total", "g")):
        if hasattr(a, field):
            reg.gauge(f"{prefix}.{field}", getattr(a, field))
    for sid, shard in (getattr(a, "shards", None) or {}).items():
        record_admission(reg, shard, prefix=f"{prefix}.shard.{sid}")


def record_qos(reg: MetricsRegistry, qos_stats,
               prefix: str = "qos") -> None:
    """``repro.qos.QosStats`` → ``qos.*`` + per-class ``qos.class.<name>.*``,
    plus the cluster / admission / sched roll-ups it carries.
    ``qos.grant_latency.p50`` is the p50 of the all-class grant-latency
    histogram in µs."""
    q = qos_stats
    reg.counter(f"{prefix}.submitted", q.submitted)
    reg.counter(f"{prefix}.granted", q.granted)
    reg.counter(f"{prefix}.shed", q.shed)
    reg.counter(f"{prefix}.failed", q.failed)
    reg.counter(f"{prefix}.replans", q.replans)
    reg.counter(f"{prefix}.bytes", q.bytes)
    reg.counter(f"{prefix}.batches",
                sum(c.batches for c in q.classes.values()))
    reg.counter(f"{prefix}.ticket_hits", q.ticket_hits)
    reg.counter(f"{prefix}.preemptions", q.preemptions)
    reg.counter(f"{prefix}.alerts", getattr(q, "alerts", 0))
    reg.gauge(f"{prefix}.queue_depth.max", q.queue_depth_max)
    _us(reg, f"{prefix}.makespan.us", q.makespan_s)
    _us(reg, f"{prefix}.throttle_wait.us", q.throttle_wait_s)
    _us(reg, f"{prefix}.service.us",
        sum(c.service_s for c in q.classes.values()))
    for name, c in q.classes.items():
        cp = f"{prefix}.class.{name}"
        reg.counter(f"{cp}.submitted", c.submitted)
        reg.counter(f"{cp}.granted", c.granted)
        reg.counter(f"{cp}.shed", c.shed)
        reg.counter(f"{cp}.failed", c.failed)
        reg.counter(f"{cp}.bytes", c.bytes)
        reg.counter(f"{cp}.batches", c.batches)
        reg.counter(f"{cp}.ticket_hits", c.ticket_hits)
        reg.counter(f"{cp}.preemptions", c.preemptions)
        _us(reg, f"{cp}.service.us", c.service_s)
        reg.histogram(f"{cp}.grant_latency",
                      [v * 1e6 for v in c.grant_latency_s])
        reg.histogram(f"{prefix}.grant_latency",
                      [v * 1e6 for v in c.grant_latency_s])
    if not q.classes:
        reg.histogram(f"{prefix}.grant_latency", [])
    for c in q.cluster:
        record_cluster(reg, c)
    if q.admission is not None:
        record_admission(reg, q.admission, prefix=f"{prefix}.admission")


def record_fabric(reg: MetricsRegistry, fabric,
                  prefix: str = "fabric") -> None:
    """``repro.core.Fabric`` counters → ``fabric.*``."""
    reg.counter(f"{prefix}.rpc_count", fabric.rpc_count)
    reg.counter(f"{prefix}.rdma_count", fabric.rdma_count)
    reg.counter(f"{prefix}.bytes_over_rpc", fabric.bytes_over_rpc)
    reg.counter(f"{prefix}.bytes_over_rdma", fabric.bytes_over_rdma)
    reg.counter(f"{prefix}.registrations", fabric.registrations)
    _us(reg, f"{prefix}.modeled_wire.us",
        getattr(fabric, "modeled_wire_s", 0.0))


def record_loader(reg: MetricsRegistry, loader_stats,
                  prefix: str = "loader") -> None:
    """``repro.data.LoaderStats`` → ``loader.*``."""
    s = loader_stats
    reg.counter(f"{prefix}.batches", s.batches)
    reg.counter(f"{prefix}.backup_requests", s.backup_requests)
    reg.counter(f"{prefix}.stream_resumes", s.stream_resumes)
    reg.counter(f"{prefix}.shared_scans", getattr(s, "shared_scans", 0))
    reg.counter(f"{prefix}.preemptions", getattr(s, "preemptions", 0))
    reg.counter(f"{prefix}.backpressures", getattr(s, "backpressures", 0))
    _us(reg, f"{prefix}.transport.us", s.transport_s)


def record_health(reg: MetricsRegistry, monitor,
                  prefix: str = "health") -> None:
    """``repro.obs.HealthMonitor`` → ``health.*``: per-server state level
    (0=healthy .. 3=quarantined) as a gauge, transition totals as
    counters, plus the cluster-wide pool-pressure gauge."""
    snap = monitor.snapshot()
    reg.gauge(f"{prefix}.heartbeats", snap.get("heartbeats", 0))
    reg.gauge(f"{prefix}.pool_pressure", snap.get("pool_pressure", 0.0))
    levels = {"healthy": 0, "degraded": 1, "suspect": 2, "quarantined": 3}
    for sid, h in snap.get("servers", {}).items():
        sp = f"{prefix}.server.{sid}"
        reg.gauge(f"{sp}.level", levels.get(h.get("state"), 0))
        reg.counter(f"{sp}.transitions", h.get("transitions", 0))
        reg.counter(f"{sp}.faults", h.get("faults", 0))
        reg.counter(f"{sp}.declines", h.get("declines", 0))


def record_gateway(reg: MetricsRegistry, gateway) -> None:
    """Everything a ``ScanGateway`` can see: its ``QosStats`` roll-up plus
    the shared-ticket table and buffer pool when attached."""
    record_qos(reg, gateway.stats)
    scheduler = getattr(gateway, "scheduler", None)
    tickets = getattr(scheduler, "tickets", None)
    if tickets is not None:
        record_tickets(reg, tickets.stats)
    if getattr(gateway, "pool", None) is not None:
        record_pool(reg, gateway.pool.stats)


#: recursion ceiling for :func:`record_any` — deep enough for any real
#: ``*Stats`` nesting, shallow enough to stop self-referential objects
#: (an ndarray's ``.T`` is a fresh ndarray, forever).
_ANY_MAX_DEPTH = 8


def record_any(reg: MetricsRegistry, prefix: str, obj,
               _depth: int = 0) -> None:
    """Generic fallback: walk any ``*Stats`` dataclass (or dict / list of
    them) and record every numeric leaf as a gauge under ``prefix`` —
    proves the whole stats surface round-trips through the registry even
    for classes without a bespoke recorder. Non-numeric / ``None`` leaves
    and unrecognizably exotic objects are skipped, never raised on."""
    if obj is None or isinstance(obj, (str, bytes)):
        return
    if isinstance(obj, bool):
        reg.gauge(prefix, float(obj))
        return
    if isinstance(obj, (int, float)):
        reg.gauge(prefix, float(obj))
        return
    if _depth >= _ANY_MAX_DEPTH:
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            record_any(reg, f"{prefix}.{k}", v, _depth + 1)
        return
    if isinstance(obj, (list, tuple)):
        if obj and all(isinstance(v, (int, float)) and
                       not isinstance(v, bool) for v in obj):
            reg.histogram(prefix, obj)
        else:
            for i, v in enumerate(obj):
                record_any(reg, f"{prefix}.{i}", v, _depth + 1)
        return
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            try:
                v = getattr(obj, f.name)
            except Exception:
                continue
            record_any(reg, f"{prefix}.{f.name}", v, _depth + 1)
        return
    # numeric-like scalar (numpy scalar, Decimal, ...): gauge if it converts
    try:
        reg.gauge(prefix, float(obj))
        return
    except (TypeError, ValueError):
        pass
    # non-dataclass object (e.g. AdmissionStats-like): walk public attrs,
    # but only for plain attribute-bag objects — property-heavy extension
    # types (ndarrays et al.) synthesize fresh objects per access and
    # would recurse without converging.
    if not hasattr(obj, "__dict__"):
        return
    for name in dir(obj):
        if name.startswith("_"):
            continue
        try:
            v = getattr(obj, name)
        except Exception:
            continue
        if callable(v):
            continue
        record_any(reg, f"{prefix}.{name}", v, _depth + 1)
