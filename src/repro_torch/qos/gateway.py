# Copy of src/repro/qos/gateway.py, kept numpy-only; change both copies together.
"""The scan gateway: request-level scatter-gather behind admission control.

One logical request enters as a :class:`ScanRequest` and leaves as a
:class:`ScanResult` whose batches are in **global scan order** — the gateway
plans the query across shard/replica servers, pulls every endpoint
concurrently through :class:`~repro.cluster.streams.MultiStreamPuller`, and
reassembles the per-stream deliveries (scatter-gather at the request level,
not just the batch level). Between submit and grant sit the two QoS layers:

* the :class:`~.queue.WeightedFairQueue` orders grants across client
  classes (interactive > batch) and sheds requests whose modeled wait
  exceeds their deadline budget;
* the :class:`~.admission.AdmissionController` meters lease grants with a
  token bucket (one token per stream the fan-out opens) and caps each
  client's *effective parallelism* at its stream quota — a quota-capped
  request still sees every shard (nothing is silently dropped), its streams
  are just serialized onto ``quota`` modeled lanes.

With a :class:`repro.sched.AdaptiveScheduler` attached, execution itself
becomes adaptive:

* **work stealing** — fan-outs run on a
  :class:`~repro.sched.steal.StealingPuller`, so a lagging replica's
  remaining range migrates to the fastest idle replica mid-scan;
* **shared tickets** — identical queued requests (same
  ``(sql, dataset, start_batch)``) coalesce onto one fan-out; the first to
  reach the head of the queue executes and publishes, every later
  subscriber is served by multicast (copy-on-read) with its own per-class
  accounting but zero additional server-side service;
* **preemption** — batch-class requests execute in parkable lease rounds
  (:class:`~repro.sched.preempt.PreemptibleScan`); the moment an
  interactive request has *arrived* on the modeled clock, the batch scan
  parks at its lease boundary (leases and admission slots released), the
  remainder re-enters the weighted-fair queue at its residual cost, and the
  scan resumes where it stopped when the virtual clock readmits it.

Admission may be **distributed**: with a
:class:`~.distributed.ShardedAdmission`, lease tokens are metered against
each endpoint server's own bucket shard (concurrent grants — the charged
wait is the slowest shard's), and the gateway auto-subscribes to the
controller's freed-slot events: :meth:`ScanGateway.replan_on_release`
records the modeled instant another client's stream closed, and a
quota-capped in-flight fan-out whose service window covers that instant
packs its remaining streams onto the widened lane set instead of
serializing onto the grant-time lanes for its whole service
(``QosStats.replans`` counts the widenings).

Time is modeled: the gateway runs a deterministic clock that advances by
each request's modeled service time, so grant latency / shedding / fairness
comparisons reproduce exactly under any machine load. The coordinator handed
to a gateway should **not** carry its own admission controller — the gateway
already meters at request granularity, and per-stream metering underneath it
would double-charge the bucket.
"""
from __future__ import annotations

import dataclasses
import weakref

from ..cluster.mempool import BufferPool
from ..cluster.plan import Endpoint, ScanPlan
from ..cluster.coordinator import ClusterCoordinator
from ..cluster.streams import (ClusterStats, MultiStreamPuller,
                               notify_coordinator)
from ..core.recordbatch import RecordBatch
from ..sched import AdaptiveScheduler, PreemptibleScan, Ticket
from .admission import AdmissionController, Backpressure
from .metrics import QosStats
from .queue import ClientClass, FifoQueue, WeightedFairQueue


@dataclasses.dataclass
class ScanRequest:
    """One logical scan: what a client submits to the gateway."""

    client_id: str
    klass: str                      # client-class name (queue weight lookup)
    sql: str
    dataset: str
    request_id: int | None = None   # assigned by the gateway when None
    cost_hint: float = 1.0          # relative service estimate (WFQ units)
    deadline_s: float | None = None  # shed if modeled wait exceeds this
    arrival_s: float = 0.0          # modeled arrival time
    num_streams: int | None = None  # fan-out hint (replica placement)
    start_batch: int = 0            # resume offset in global scan order


@dataclasses.dataclass
class ScanResult:
    request: ScanRequest
    batches: list[RecordBatch]      # reassembled in global scan order
    cluster: ClusterStats
    grant_latency_s: float          # modeled submit -> grant
    service_s: float                # modeled execution (quota-capped makespan)
    shared: bool = False            # served by shared-ticket multicast
    preemptions: int = 0            # times this scan was parked mid-flight


def reassemble(plan: ScanPlan, per_stream: list[list[RecordBatch]],
               endpoints: tuple[Endpoint, ...] | None = None
               ) -> list[RecordBatch]:
    """Merge per-stream deliveries back into global scan order.

    * ``replica`` plans slice the batch range contiguously — concatenate
      streams by ``start_batch``. Work stealing splits ranges but keeps
      them contiguous and disjoint, so the same sort covers stolen tails;
      pass the *actual* endpoints driven (``puller.endpoints`` may have
      grown past ``plan.endpoints``).
    * ``shard`` plans come from :meth:`ClusterCoordinator.place_shards`,
      which deals ``batches[i::n]`` to the i-th sorted server, so stream
      *i*'s j-th batch is global batch ``j*n + i`` — re-interleave. After
      a membership change re-deals orphaned batches, shards are irregular
      and the interleave assumption breaks; such plans carry each shard's
      dataset-global indices on ``Endpoint.global_batches``, and the merge
      orders by those instead.
    """
    endpoints = plan.endpoints if endpoints is None else endpoints
    if plan.placement == "replica":
        order = sorted(range(len(endpoints)),
                       key=lambda i: endpoints[i].start_batch)
        return [b for i in order for b in per_stream[i]]
    if endpoints and all(e.global_batches is not None for e in endpoints):
        tagged = [(g, b)
                  for ep, stream in zip(endpoints, per_stream)
                  for g, b in zip(ep.global_batches, stream)]
        return [b for _, b in sorted(tagged, key=lambda t: t[0])]
    out: list[RecordBatch] = []
    j = 0
    while True:
        row = [s[j] for s in per_stream if j < len(s)]
        if not row:
            return out
        out.extend(row)
        j += 1


def _copy_batch(batch: RecordBatch) -> RecordBatch:
    """Deep copy out of pooled buffers (they recycle on the next pull)."""
    cols = tuple(dataclasses.replace(
        c, values=c.values.copy(),
        offsets=None if c.offsets is None else c.offsets.copy(),
        validity=None if c.validity is None else c.validity.copy())
        for c in batch.columns)
    return RecordBatch(batch.schema, cols)


def _makespan(clock_s: list[float], parallelism: int | None,
              extra_lanes: tuple[float, ...] = ()) -> float:
    """Modeled completion time of the fan-out under a concurrency cap:
    longest-processing-time greedy assignment of stream clocks onto
    ``parallelism`` lanes. With no cap this is the plain critical path.

    ``extra_lanes`` are lanes that *open mid-service* — freed-slot
    re-planning (another client's streams closed at that relative offset):
    each value is a lane whose earliest start is that offset, so the
    remaining work can widen onto it the moment it frees."""
    if parallelism is None or (parallelism >= len(clock_s)
                               and not extra_lanes):
        return max(clock_s, default=0.0)
    lanes = [0.0] * max(1, parallelism) + [max(0.0, t) for t in extra_lanes]
    makespan = 0.0
    for c in sorted(clock_s, reverse=True):
        idx = min(range(len(lanes)), key=lanes.__getitem__)
        lanes[idx] += c
        makespan = max(makespan, lanes[idx])
    return makespan


@dataclasses.dataclass
class _ParkedScan:
    """A preempted request's continuation, re-queued at residual cost."""

    request: ScanRequest
    scan: PreemptibleScan
    plan: ScanPlan
    grant_latency_s: float          # first grant — preserved across parks
    trim: int                       # leading batches to drop (start_batch)

    @property
    def klass(self) -> str:
        return self.request.klass

    @property
    def arrival_s(self) -> float:
        return self.request.arrival_s

    def residual_cost(self) -> float:
        total = self.scan.total_batches
        frac = (self.scan.delivered / total) if total else 0.5
        return max(self.request.cost_hint * (1.0 - frac), 1e-12)


class ScanGateway:
    """Admission-controlled front door for every scan against the cluster."""

    def __init__(self, coordinator: ClusterCoordinator,
                 classes: list[ClientClass] | None = None,
                 admission: AdmissionController | None = None,
                 pool: BufferPool | None = None, fair: bool = True,
                 lease_batches: int = 1, prefetch: bool = True,
                 est_service_s_per_cost: float = 1e-4,
                 scheduler: AdaptiveScheduler | None = None,
                 tracer=None, modeled_service: bool = False):
        self.coordinator = coordinator
        self.admission = admission
        self.pool = pool
        self.lease_batches = lease_batches
        self.prefetch = prefetch
        self.scheduler = scheduler
        self.tracer = tracer            # obs.Tracer; None = tracing off
        # modeled_service: advance the gateway clock by each stream's
        # fabric-modeled wire time instead of its measured transport clock.
        # The measured clock folds in host CPU (allocation, reassembly), so
        # grant latencies jitter run-to-run; the modeled clock is a pure
        # function of the fabric config and the scan shape, which is what a
        # determinism-asserting scenario (stress) needs. Off by default:
        # throughput scenarios deliberately measure the host.
        self.modeled_service = modeled_service
        self.queue = WeightedFairQueue(classes) if fair else FifoQueue()
        self.stats = QosStats()
        self.results: dict[int, ScanResult] = {}
        self.clock_s = 0.0
        self._next_id = 0
        self._traces: dict[int, object] = {}   # request_id -> TraceContext
        # calibration: WFQ cost units -> modeled seconds, refined as we serve
        self._service_s_per_cost = est_service_s_per_cost
        # freed-slot events (modeled time, slots) awaiting an in-flight
        # fan-out to widen onto; fed by replan_on_release
        self._replan_events: list[tuple[float, int]] = []
        if admission is not None and hasattr(admission, "subscribe_release"):
            # subscribe through a weakref: a long-lived controller sees
            # many gateways come and go, and a strong bound-method
            # subscription would pin each dead gateway (and its event
            # list) forever
            ref = weakref.ref(self)

            def _on_release(server_id=None, client_id=None, now_s=None,
                            _ref=ref):
                gateway = _ref()
                if gateway is not None:
                    gateway.replan_on_release(server_id, client_id, now_s)

            admission.subscribe_release(_on_release)

    # ------------------------------------------------------------- modeling
    def _quota(self) -> int | None:
        return (self.admission.config.max_streams_per_client
                if self.admission is not None else None)

    def _effective_parallelism(self, held_back: int = 0) -> int | None:
        """Lanes a fan-out may run on right now: the client's stream quota,
        further narrowed by what other admission clients currently hold
        against the global stream cap (``None`` == uncapped). ``held_back``
        re-adds slots whose freeing lies *ahead* on the modeled clock — the
        controller's occupancy is wall-clock-current, but a release event
        stamped mid-service means the slot was still held at grant time."""
        quota = self._quota()
        adm = self.admission
        cap = (getattr(adm.config, "max_streams_total", None)
               if adm is not None else None)
        if cap is None:
            return quota
        free = max(1, cap - adm.active_total() - held_back)
        return free if quota is None else min(quota, free)

    def replan_on_release(self, server_id: str | None = None,
                          client_id: str | None = None,
                          now_s: float | None = None) -> None:
        """A stream slot somewhere freed at modeled time ``now_s`` (another
        client closed a stream, a batch scan parked). Remember it: the next
        quota-capped fan-out whose service window covers that instant packs
        its remaining streams onto the widened lane set instead of
        serializing onto the grant-time lanes for its whole service.
        Auto-subscribed to the admission controller's freed-slot events
        when it exposes ``subscribe_release``.

        ``now_s`` must be on THIS gateway's modeled timeline; releases that
        carry none (e.g. a stream close whose only clock is scan-relative)
        are stamped with the current gateway clock, which folds them into
        the next grant's occupancy instead of a mid-service widening —
        conservative, never wrong."""
        t = self.clock_s if now_s is None else now_s
        self._replan_events.append((t, 1))

    def _service_time(self, streams, start_s: float | None = None) -> float:
        """Modeled service of a fan-out: the critical path of absolute
        stream finish times, floored by the quota-lane packing of stream
        *durations*. A stolen stream's ``start_s`` epoch is waiting, not
        work — it bounds the finish time but must not be packed into a
        lane as if the lane were busy.

        With ``start_s`` (the grant instant), freed-slot events after it
        open extra lanes mid-service (gateway re-planning): slots released
        before the grant are already reflected in the occupancy-derived
        lane count, so they are pruned rather than double-counted.

        Under ``modeled_service`` each stream contributes its
        fabric-modeled wire time rather than its measured transport clock,
        making the whole computation deterministic (see ``__init__``)."""
        durations = [s.modeled_wire_s if self.modeled_service else s.clock_s
                     for s in streams]
        finish = max((s.start_s + d for s, d in zip(streams, durations)),
                     default=0.0)
        if self._replan_events:
            # events at or before the service window's start are already
            # reflected in the controller's occupancy — drop them (the
            # preemptible path passes no start_s and widens conservatively,
            # but still drains the backlog against the current clock)
            cut = self.clock_s if start_s is None else start_s
            self._replan_events = [e for e in self._replan_events
                                   if e[0] > cut]
        if start_s is None or not self._replan_events:
            return max(finish,
                       _makespan(durations, self._effective_parallelism()))
        pending = sorted(self._replan_events)
        held_back = sum(k for _, k in pending)
        extra = tuple(t - start_s for t, k in pending for _ in range(k))
        service = max(finish,
                      _makespan(durations,
                                self._effective_parallelism(held_back),
                                extra))
        # only events inside the computed window widened this fan-out; a
        # release stamped beyond it stays queued for the next request
        # whose window actually covers that instant (_makespan never
        # assigns work to a lane opening at or past the final makespan,
        # so dropping those lanes cannot have changed the result)
        kept = [e for e in pending if e[0] - start_s >= service]
        self._replan_events = kept
        self.stats.replans += held_back - sum(k for _, k in kept)
        return service

    # ---------------------------------------------------------- sched hooks
    @property
    def _tickets(self):
        return self.scheduler.tickets if self.scheduler is not None else None

    @property
    def _preempt(self):
        return self.scheduler.preempt if self.scheduler is not None else None

    def _ticket_key(self, request: ScanRequest):
        return (request.sql, request.dataset, request.start_batch)

    def _make_puller(self, plan: ScanPlan, client_id: str,
                     trace=None) -> MultiStreamPuller:
        kwargs = dict(pool=self.pool, lease_batches=self.lease_batches,
                      prefetch=self.prefetch, client_id=client_id,
                      trace=trace)
        if self.scheduler is not None:
            return self.scheduler.make_puller(self.coordinator, plan,
                                              **kwargs)
        return MultiStreamPuller(self.coordinator, plan, **kwargs)

    # -------------------------------------------------------------- tracing
    def _trace(self, request: ScanRequest):
        return self._traces.get(request.request_id)

    def _trace_close(self, request: ScanRequest, event: str | None = None,
                     base_s: float | None = None) -> None:
        """Commit a request's trace (idempotent) and drop it from the live
        table. ``base_s`` places the scan-relative span groups (per-stream
        clocks, steal epochs) at the grant instant on the gateway clock."""
        ctx = self._traces.pop(request.request_id, None)
        if ctx is None:
            return
        if base_s is not None:
            ctx.base_s = base_s
        if event is not None:
            ctx.instant(event, self.clock_s, cat="gateway")
        ctx.commit()

    # --------------------------------------------------------------- submit
    def submit(self, request: ScanRequest) -> ScanRequest | None:
        """Enqueue a request. Returns the (id-assigned) request, or ``None``
        when it was shed at submit time: the modeled wait ahead of it —
        queued cost that WFQ will serve first, at the calibrated service
        rate — already exceeds its deadline budget."""
        if request.request_id is None:
            request = dataclasses.replace(request, request_id=self._next_id)
        self._next_id = max(self._next_id, request.request_id) + 1
        cstats = self.stats.klass(request.klass)
        cstats.submitted += 1
        if request.deadline_s is not None:
            tag = self.queue.would_finish(request.klass, request.cost_hint)
            est_wait = (max(0.0, self.clock_s - request.arrival_s)
                        + self.queue.backlog_before(tag)
                        * self._service_s_per_cost)
            if est_wait > request.deadline_s:
                cstats.shed += 1
                notify_coordinator(self.coordinator, "qos.shed",
                                   now_s=self.clock_s, klass=request.klass,
                                   client=request.client_id,
                                   reason="deadline-at-submit")
                return None
        if self.tracer is not None:
            ctx = self.tracer.begin(f"scan-{request.request_id}")
            ctx.instant("submit", request.arrival_s, cat="gateway",
                        klass=request.klass, client=request.client_id)
            self._traces[request.request_id] = ctx
        self.queue.push(request, request.klass, request.cost_hint)
        if self._tickets is not None:
            self._tickets.subscribe(self._ticket_key(request),
                                    request.request_id)
        self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                         len(self.queue))
        return request

    # ------------------------------------------------------------------ run
    def run(self) -> list[ScanResult]:
        """Drain the queue in fair order; returns results in grant order."""
        granted: list[ScanResult] = []
        tickets, preempt = self._tickets, self._preempt
        if tickets is not None:
            tickets.begin_drain()
        while len(self.queue):
            item = (self.queue.pop(self.clock_s) if preempt is not None
                    else self.queue.pop())
            if isinstance(item, _ParkedScan):
                result = self._run_preemptible(item)
                if result is not None:
                    granted.append(result)
                    self.results[item.request.request_id] = result
                continue
            request = item
            if preempt is not None and request.arrival_s > self.clock_s:
                # nothing else had arrived: the gateway idles to the next
                # arrival. Only the arrival-aware pop path models time this
                # way — the plain pop ignores arrivals entirely, and jumping
                # its clock would shed co-queued requests spuriously.
                self.clock_s = request.arrival_s
            cstats = self.stats.klass(request.klass)
            waited = self.clock_s - request.arrival_s
            if request.deadline_s is not None and waited > request.deadline_s:
                cstats.shed += 1          # deadline expired while queued
                if tickets is not None:   # a subscriber cancel
                    tickets.cancel(self._ticket_key(request),
                                   request.request_id)
                self._trace_close(request, "shed")
                notify_coordinator(self.coordinator, "qos.shed",
                                   now_s=self.clock_s, klass=request.klass,
                                   client=request.client_id,
                                   reason="deadline-in-queue")
                continue
            if tickets is not None:
                ticket = tickets.redeem(self._ticket_key(request),
                                        request.request_id)
                if ticket is not None:    # coalesced: multicast, no fan-out
                    result = self._multicast(request, ticket)
                    granted.append(result)
                    self.results[request.request_id] = result
                    continue
            try:
                result = self._execute(request)
            except Backpressure:
                # a coordinator-level admission denial (a gateway-bypassing
                # config); treat as a shed rather than crashing the drain
                cstats.shed += 1
                if tickets is not None:
                    tickets.cancel(self._ticket_key(request),
                                   request.request_id)
                self._trace_close(request, "shed")
                notify_coordinator(self.coordinator, "qos.backpressure",
                                   now_s=self.clock_s, klass=request.klass,
                                   client=request.client_id)
                continue
            except Exception:
                # one malformed request (bad SQL, unknown dataset, an
                # impossible num_streams hint) must not abort the drain and
                # take every other client's queued work with it
                cstats.failed += 1
                if tickets is not None:
                    tickets.cancel(self._ticket_key(request),
                                   request.request_id)
                self._trace_close(request, "failed")
                notify_coordinator(self.coordinator, "qos.failed",
                                   now_s=self.clock_s, klass=request.klass,
                                   client=request.client_id)
                continue
            if result is None:            # parked mid-scan; re-queued
                continue
            granted.append(result)
            self.results[request.request_id] = result
        self.stats.makespan_s = self.clock_s
        if self.admission is not None:
            admission_stats = self.admission.stats
            self.stats.throttle_wait_s = admission_stats.throttle_wait_s
            self.stats.admission = admission_stats   # per-shard when sharded
        return granted

    def result(self, request_id: int) -> ScanResult | None:
        return self.results.get(request_id)

    # -------------------------------------------------------------- execute
    def _apply_start(self, plan: ScanPlan,
                     start_batch: int) -> tuple[ScanPlan, int]:
        """Push a global resume offset down into the plan when the layout
        allows it. Replica plans slice contiguous ranges, so the offset
        intersects exactly (no wasted transport); shard plans interleave, so
        the offset is applied by trimming the reassembled head instead."""
        if start_batch <= 0 or plan.placement != "replica":
            return plan, max(0, start_batch)
        endpoints = []
        for ep in plan.endpoints:
            if ep.max_batches is None:
                endpoints.append(ep)
                continue
            end = ep.start_batch + ep.max_batches
            lo = max(ep.start_batch, start_batch)
            if lo < end:
                endpoints.append(dataclasses.replace(
                    ep, start_batch=lo, max_batches=end - lo))
        return dataclasses.replace(plan, endpoints=tuple(endpoints)), 0

    def _plan(self, request: ScanRequest) -> tuple[ScanPlan, int]:
        quota = self._quota()
        num_streams = request.num_streams
        if (quota is not None and
                self.coordinator.placement_mode(request.dataset) == "replica"):
            # replica fan-out is elastic: plan no wider than the quota
            hosts = len(self.coordinator.hosts(request.dataset))
            num_streams = min(num_streams or hosts, quota)
        plan = self.coordinator.plan(request.sql, request.dataset,
                                     num_streams=num_streams)
        return self._apply_start(plan, request.start_batch)

    def _charge_leases(self, plan: ScanPlan) -> float:
        """Token-bucket wait for one lease per stream the fan-out opens.
        A sharded controller meters each endpoint against its own server's
        bucket (``lease_wait_for_counts``); the per-shard grants run
        concurrently, so the charged wait is the slowest shard's (two
        endpoints on one shard still serialize on that shard's bucket)."""
        adm = self.admission
        sharded = getattr(adm, "lease_wait_for_counts", None)
        if sharded is not None:
            counts: dict[str, int] = {}
            for ep in plan.endpoints:
                counts[ep.server_id] = counts.get(ep.server_id, 0) + 1
            return sharded(self.clock_s, counts)
        return adm.lease_wait_s(self.clock_s, len(plan.endpoints))

    def _execute(self, request: ScanRequest) -> ScanResult | None:
        ctx = self._trace(request)
        plan, trim = self._plan(request)
        queue_wait = self.clock_s - request.arrival_s
        if self.admission is not None:
            # one lease token per stream the fan-out opens
            lease_wait = self._charge_leases(plan)
            if ctx is not None and lease_wait > 0.0:
                ctx.span("admission.lease", self.clock_s, lease_wait,
                         cat="admission", streams=len(plan.endpoints))
            self.clock_s += lease_wait
        if ctx is not None and queue_wait > 0.0:
            ctx.span("queue.wait", request.arrival_s, queue_wait,
                     cat="queue", klass=request.klass)
        grant_latency = self.clock_s - request.arrival_s
        puller = self._make_puller(plan, request.client_id, trace=ctx)
        preempt = self._preempt
        if (preempt is not None and preempt.applies_to(request.klass)
                and self._outweighed(request.klass)):
            scan = PreemptibleScan(puller, copy_batch=_copy_batch)
            return self._run_preemptible(
                _ParkedScan(request, scan, plan, grant_latency, trim))
        per_stream: list[list[RecordBatch]] = [[] for _ in plan.endpoints]

        def sink(idx: int, batch: RecordBatch) -> None:
            while len(per_stream) <= idx:   # stolen streams grow the table
                per_stream.append([])
            per_stream[idx].append(
                _copy_batch(batch) if self.pool is not None else batch)

        grant_clock_s = self.clock_s
        cluster = puller.run(sink)
        service = self._service_time(cluster.streams, start_s=grant_clock_s)
        self.clock_s += service
        endpoints = tuple(p.endpoint for p in puller.pullers)
        batches = reassemble(plan, per_stream, endpoints)[trim:]
        if ctx is not None:
            ctx.span("reassemble", self.clock_s, 0.0, cat="gateway",
                     batches=len(batches))
            self._trace_close(request, base_s=grant_clock_s)
        return self._finalize(request, batches, cluster, grant_latency,
                              service)

    def _outweighed(self, klass: str) -> bool:
        """Someone configured above this class's weight might preempt it."""
        w = self.queue.weight(klass)
        return any(c.weight > w for c in self.queue.classes.values())

    # --------------------------------------------------------- sched paths
    def _run_preemptible(self, parked: _ParkedScan) -> ScanResult | None:
        """Drive (or resume) a parkable scan; returns ``None`` when it was
        parked again (its continuation is back in the queue) or shed."""
        request, scan = parked.request, parked.scan
        cstats = self.stats.klass(request.klass)
        preempt = self._preempt
        if scan.parked:
            try:
                scan.resume()
            except Backpressure:
                # the budget moved against us while parked; the scan cannot
                # hold half a result forever — shed it and free everything
                cstats.shed += 1
                scan.abandon()
                if self._tickets is not None:   # a subscriber cancel
                    self._tickets.cancel(self._ticket_key(request),
                                         request.request_id)
                self._trace_close(request, "shed",
                                  base_s=(request.arrival_s
                                          + parked.grant_latency_s))
                notify_coordinator(self.coordinator, "qos.backpressure",
                                   now_s=self.clock_s, klass=request.klass,
                                   client=request.client_id,
                                   reason="resume-denied")
                return None
        rounds = 0
        while not scan.done:
            self.clock_s += scan.run_round()
            scan.rebalance()             # stealing composes with preemption
            rounds += 1
            if (not scan.done
                    and rounds >= preempt.min_rounds_before_park
                    and self.queue.has_preemptor(request.klass,
                                                 self.clock_s)):
                scan.park()
                cstats.preemptions += 1
                self.queue.push(parked, request.klass,
                                parked.residual_cost())
                self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                                 len(self.queue))
                return None
        cluster = scan.stats()
        # the rounds advanced the clock by unconstrained critical-path
        # deltas (scan.elapsed_s telescopes to the critical path); a stream
        # quota serializes lanes exactly like the one-shot path, so charge
        # the serialization remainder now
        service = max(scan.elapsed_s, self._service_time(cluster.streams))
        self.clock_s += service - scan.elapsed_s
        endpoints = tuple(p.endpoint for p in scan.puller.pullers)
        batches = reassemble(parked.plan, scan.per_stream,
                             endpoints)[parked.trim:]
        ctx = self._trace(request)
        if ctx is not None:
            ctx.span("reassemble", self.clock_s, 0.0, cat="gateway",
                     batches=len(batches))
            self._trace_close(request,
                              base_s=(request.arrival_s
                                      + parked.grant_latency_s))
        return self._finalize(request, batches, cluster,
                              parked.grant_latency_s, service,
                              preemptions=scan.park_count)

    def _multicast(self, request: ScanRequest, ticket: Ticket) -> ScanResult:
        """Serve a coalesced subscriber from the published ticket: each
        subscriber reads its own deep copy (copy-on-read), is attributed
        granted batches/bytes in its own class, and consumes **zero**
        additional server-side service — the multicast copy is client-side,
        off the modeled critical path."""
        grant_latency = self.clock_s - request.arrival_s
        batches = [_copy_batch(b) for b in ticket.batches]
        cstats = self.stats.klass(request.klass)
        cstats.granted += 1
        cstats.ticket_hits += 1
        cstats.grant_latency_s.append(grant_latency)
        cstats.bytes += getattr(ticket.cluster, "bytes", 0)
        cstats.batches += len(batches)
        self._trace_close(request, "ticket.hit")
        return ScanResult(request, batches, ticket.cluster, grant_latency,
                          0.0, shared=True)

    # ------------------------------------------------------------- finalize
    def _finalize(self, request: ScanRequest, batches: list[RecordBatch],
                  cluster: ClusterStats, grant_latency: float,
                  service: float, preemptions: int = 0) -> ScanResult:
        cstats = self.stats.klass(request.klass)
        cstats.granted += 1
        cstats.grant_latency_s.append(grant_latency)
        cstats.service_s += service
        cstats.bytes += cluster.bytes
        cstats.batches += cluster.batches
        self.stats.cluster.append(cluster)
        # refine the cost->seconds calibration (EMA over served requests)
        observed = service / max(request.cost_hint, 1e-12)
        self._service_s_per_cost = (0.5 * self._service_s_per_cost
                                    + 0.5 * observed)
        if self._tickets is not None:
            self._tickets.publish(self._ticket_key(request),
                                  request.request_id, batches, cluster)
        return ScanResult(request, batches, cluster, grant_latency, service,
                          preemptions=preemptions)
