# Copy of src/repro/cluster/streams.py, kept numpy-only; change both copies together.
"""Multi-stream puller: N concurrent resumable leases over one scan plan.

Each :class:`Endpoint` of a :class:`~repro.cluster.plan.ScanPlan` becomes a
:class:`StreamPuller` driving its own ``init_scan → iterate(lease) →
finalize`` loop. A :class:`MultiStreamPuller` interleaves the pullers with
bounded ``max_batches`` leases under one of two schedules:

* ``round_robin`` — deterministic rotation (the loader uses this so resume
  offsets are well-defined);
* ``first_ready`` — always lease from the stream whose modeled clock is
  furthest behind (first-ready-wins, the scheduling Arrow Flight clients use
  to keep parallel endpoints drained evenly).

Streams are independently fault-tolerant: an ``iterate`` that raises is
resumed through the coordinator (``init_scan(start_batch=delivered)``) up to
``max_resumes`` times, without disturbing the other streams.

Because the wire is modeled (no NIC here), concurrency is modeled too: each
stream accrues a **modeled clock** (its serial wire + measured client CPU
time), and :attr:`ClusterStats.critical_path_s` — the cluster's transport
duration — is the slowest stream's clock, while ``sum_total_s`` is the total
work. Both come from the same per-batch stats, so benchmark decompositions
for 1 stream and N streams share one code path.

Two flow-control behaviours ride on that clock:

* **async pipelining** (``prefetch=True``, the default): each stream keeps a
  one-deep prefetch slot, so the control/lease RPC for batch *k+1* is posted
  while the modeled RDMA pull of batch *k* is in flight. The hidden portion
  is recorded as ``prefetch_overlap_s`` and the stream clock only pays the
  remainder — turning prefetch off shows the full serial RPC cost in
  ``critical_path_s``.
* **backpressure reporting**: when the coordinator carries a
  ``qos.AdmissionController``, every lease grant asks its token bucket for a
  token; a throttled grant's modeled wait is charged to the stream clock and
  surfaced as ``throttle_wait_s`` — the signal the qos layer aggregates.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterator

from ..core import bulk as bulk_mod
from ..core.recordbatch import RecordBatch
from ..core.transport import TransportStats, rdma_pull_batch
from .coordinator import ClusterCoordinator
from .mempool import BufferPool, PoolStats
from .plan import Endpoint, ScanPlan


def notify_coordinator(coordinator, kind: str, **kw) -> None:
    """Forward one decision to ``coordinator.notify`` when it exists — the
    observability funnel is optional and coordinators are duck-typed in
    tests, so emission sites never assume the method."""
    notify = getattr(coordinator, "notify", None)
    if notify is not None:
        notify(kind, **kw)


@dataclasses.dataclass
class StreamStats:
    """Per-stream fabric-level counters + timing decomposition."""

    server_id: str = ""
    batches: int = 0
    bytes: int = 0
    segments: int = 0
    rdma_ops: int = 0
    control_rpcs: int = 0
    resumes: int = 0
    migrations: int = 0             # leases failed over to another replica
    alloc_s: float = 0.0            # measured: pool checkout or fresh alloc
    deserialize_s: float = 0.0      # measured: zero-copy assembly
    modeled_wire_s: float = 0.0
    modeled_register_s: float = 0.0  # per-pull registration actually charged
    control_rpc_s: float = 0.0      # modeled lease/control RPC time charged
    prefetch_overlap_s: float = 0.0  # control RPC hidden under prior pulls
    throttle_wait_s: float = 0.0    # admission token-bucket wait charged
    clock_s: float = 0.0            # this stream's serial transport time
    start_s: float = 0.0            # modeled epoch the stream began (a stolen
    #                                 stream starts mid-scan, not at t=0)
    parks: int = 0                  # lease-boundary preemptions survived


@dataclasses.dataclass
class ClusterStats:
    """Aggregate view over all streams of one partitioned scan."""

    query_id: str = ""
    placement: str = ""
    streams: list[StreamStats] = dataclasses.field(default_factory=list)
    pool: PoolStats | None = None
    # work-stealing audit trail (repro.sched.StealEvent instances; kept
    # duck-typed so cluster does not import sched)
    steal_events: list = dataclasses.field(default_factory=list)

    @property
    def steals(self) -> int:
        """Ranges moved to an idle replica. Events are kind-tagged
        (``steal`` / ``decline`` / ``re_steal``, see
        ``repro.sched.StealEvent``); an untagged event is a steal."""
        return sum(1 for e in self.steal_events
                   if getattr(e, "kind", "steal") == "steal")

    @property
    def declines(self) -> int:
        """Steals refused because the thief's admission shard was full."""
        return sum(1 for e in self.steal_events
                   if getattr(e, "kind", "steal") == "decline")

    @property
    def re_steals(self) -> int:
        """Tails reclaimed by their original victim from a degraded thief."""
        return sum(1 for e in self.steal_events
                   if getattr(e, "kind", "steal") == "re_steal")

    def steal_attribution(self) -> dict:
        """Per-shard decision counts: ``server_id -> {kind: count,
        "batches": moved}`` (``batches`` counts ranges that actually moved —
        steals and re-steals; declines moved nothing). Every event carries
        the shard it landed on (``StealEvent.server_id`` — the thief's
        shard for a steal, the refusing shard for a decline, the reclaiming
        shard for a re-steal); events recorded before the field existed are
        backfilled from their ``thief``, so old traces still attribute.
        ``utils/report.steal_table`` renders this."""
        out: dict = {}
        for e in self.steal_events:
            sid = getattr(e, "server_id", "") or getattr(e, "thief", "?")
            kind = getattr(e, "kind", "steal")
            per = out.setdefault(sid, {"batches": 0})
            per[kind] = per.get(kind, 0) + 1
            if kind != "decline":
                per["batches"] += e.num_batches
        return out

    @property
    def parks(self) -> int:
        return sum(s.parks for s in self.streams)

    @property
    def batches(self) -> int:
        return sum(s.batches for s in self.streams)

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self.streams)

    @property
    def alloc_s(self) -> float:
        return sum(s.alloc_s for s in self.streams)

    @property
    def deserialize_s(self) -> float:
        return sum(s.deserialize_s for s in self.streams)

    @property
    def modeled_wire_s(self) -> float:
        return sum(s.modeled_wire_s for s in self.streams)

    @property
    def modeled_register_s(self) -> float:
        """Registration cost actually charged on pulls, plus the pool's
        one-time slab pinning (amortized across every batch it served)."""
        charged = sum(s.modeled_register_s for s in self.streams)
        if self.pool is not None:
            charged += self.pool.modeled_register_s
        return charged

    @property
    def control_rpc_s(self) -> float:
        return sum(s.control_rpc_s for s in self.streams)

    @property
    def prefetch_overlap_s(self) -> float:
        """Lease-RPC time hidden under RDMA pulls by the prefetch slot —
        the critical path shrinks by exactly the slowest stream's share."""
        return sum(s.prefetch_overlap_s for s in self.streams)

    @property
    def throttle_wait_s(self) -> float:
        return sum(s.throttle_wait_s for s in self.streams)

    @property
    def resumes(self) -> int:
        return sum(s.resumes for s in self.streams)

    @property
    def migrations(self) -> int:
        """Leases that failed over to a surviving replica mid-scan."""
        return sum(s.migrations for s in self.streams)

    @property
    def sum_total_s(self) -> float:
        """Total transport work across streams (serial equivalent)."""
        return sum(s.clock_s for s in self.streams)

    @property
    def critical_path_s(self) -> float:
        """Cluster transport duration: streams run concurrently, so the scan
        finishes when the slowest stream does. Includes each stream's
        measured client CPU time (alloc/assembly), so it is wall-clock-noisy;
        use :attr:`modeled_critical_path_s` for deterministic comparisons.
        A stream's finish time is its start epoch plus its own clock — a
        stolen stream begins mid-scan, so its ``start_s`` is nonzero."""
        return max((s.start_s + s.clock_s for s in self.streams), default=0.0)

    @property
    def modeled_critical_path_s(self) -> float:
        """Slowest stream by modeled wire time only — a pure function of
        bytes/segments/ops, reproducible under any machine load."""
        return max((s.start_s + s.modeled_wire_s for s in self.streams),
                   default=0.0)


class StreamPuller:
    """One endpoint's resumable lease-driven pull loop."""

    def __init__(self, coordinator: ClusterCoordinator, endpoint: Endpoint,
                 pool: BufferPool | None = None, max_resumes: int = 3,
                 prefetch: bool = True, client_id: str = "default",
                 trace=None):
        self.coordinator = coordinator
        self.endpoint = endpoint
        self.pool = pool
        self.max_resumes = max_resumes
        self.prefetch = prefetch
        self.client_id = client_id
        self.trace = trace              # obs.StreamTrace, local-clock spans
        self.stats = StreamStats(server_id=endpoint.server_id)
        self.delivered = 0
        self.drained = False
        self.parked = False
        self._prefetch_budget_s = 0.0   # prior pull's wire time still hideable
        try:
            self.server = coordinator.server(endpoint.server_id)
            self._handle = coordinator.open_stream(endpoint,
                                                   client_id=client_id,
                                                   trace=trace, now_s=0.0)
        except (KeyError, ConnectionError):
            # the plan named a server that left/crashed between planning and
            # open — migrate the stream before it ever starts. No admission
            # slot is held yet (open_stream released on failure), and
            # qos.Backpressure is not a connection fault, so it propagates.
            failover = getattr(coordinator, "failover_stream", None)
            if failover is None:
                raise
            self.endpoint, self._handle = failover(endpoint, 0, client_id,
                                                   slot_held=False)
            self.server = coordinator.server(self.endpoint.server_id)
            self.stats.server_id = self.endpoint.server_id
            self.stats.migrations += 1
        self._lease_out: list[tuple[RecordBatch, bulk_mod.BulkHandle | None]] = []

    # ----------------------------------------------------------- remaining
    @property
    def remaining(self) -> int | None:
        """Batches still owed by this stream's bounded range (``None`` for an
        unbounded drain-to-end endpoint)."""
        if self.endpoint.max_batches is None:
            return None
        return max(0, self.endpoint.max_batches - self.delivered)

    # ----------------------------------------------------------- split hook
    def split(self, keep_batches: int) -> tuple[int, int]:
        """Work-stealing split at a lease boundary: truncate this stream's
        bounded range to ``delivered + keep_batches`` and return the tail as
        a global ``(start_batch, num_batches)`` range for the thief to
        re-lease via ``init_scan(start_batch=…)``. Pure client-side
        bookkeeping — the victim's server reader simply stops being asked
        past the truncated range."""
        remaining = self.remaining
        if remaining is None:
            raise ValueError("cannot split an unbounded stream")
        if not 0 <= keep_batches < remaining:
            raise ValueError(
                f"keep_batches={keep_batches} outside [0, {remaining})")
        tail_start = (self.endpoint.start_batch + self.delivered
                      + keep_batches)
        tail_count = remaining - keep_batches
        self.endpoint = dataclasses.replace(
            self.endpoint, max_batches=self.delivered + keep_batches)
        return tail_start, tail_count

    # ----------------------------------------------------- park/unpark hooks
    def park(self) -> None:
        """Lease-boundary preemption: release the server lease (and the
        admission slot it holds) and checkpoint the resume offset. The
        stream stays logically alive — :meth:`unpark` re-opens it where it
        stopped. Call only between leases (never with a lease in flight)."""
        if self.drained or self.parked:
            return
        self.parked = True
        self.stats.parks += 1
        self._prefetch_budget_s = 0.0    # the pipeline is cold after a park
        if self.trace is not None:
            self.trace.instant("stream.park", self.stats.clock_s, cat="sched")
        notify_coordinator(self.coordinator, "stream.park",
                           server_id=self.endpoint.server_id,
                           now_s=self.stats.clock_s,
                           delivered=self.delivered)
        # no now_s: the stream clock is scan-relative, not on the admission
        # controller's timeline — release listeners stamp their own clocks
        self.coordinator.close_stream(self.endpoint, self._handle.uuid,
                                      client_id=self.client_id)
        self._handle = None

    def unpark(self) -> None:
        """Resume a parked stream: a fresh admission-gated lease fast-
        forwarded past everything already delivered (may raise
        ``qos.Backpressure`` — the slot was given back at park time)."""
        if self.drained or not self.parked:
            return
        self._handle = self.coordinator.reopen_stream(
            self.endpoint, self.delivered, client_id=self.client_id)
        self.parked = False
        if self.trace is not None:
            self.trace.instant("stream.unpark", self.stats.clock_s,
                               cat="sched")
        notify_coordinator(self.coordinator, "stream.unpark",
                           server_id=self.endpoint.server_id,
                           now_s=self.stats.clock_s,
                           delivered=self.delivered)

    # ------------------------------------------------------------- do_rdma
    def _do_rdma(self, num_rows: int, sizes, remote: bulk_mod.BulkHandle
                 ) -> TransportStats:
        # pin=True (no-pool path): fault pages in, the per-batch cost
        # registration pays and the pool amortizes
        batch, local, stats = rdma_pull_batch(
            self.server.fabric, self._handle.schema, num_rows, remote,
            pool=self.pool, pin=True)
        s = self.stats
        # the per-batch control message (descriptor RPC) the server charges
        # to the fabric; with the prefetch slot armed, the RPC for this batch
        # was posted while the previous batch's RDMA pull was in flight, so
        # only the un-hidden remainder lands on the stream clock
        cfg = self.server.fabric.config
        meta_bytes = 64 + 8 * sum(len(v) for v in sizes)
        rpc_s = cfg.rpc_rtt_s + meta_bytes / cfg.rpc_bw
        hidden = (min(rpc_s, self._prefetch_budget_s)
                  if self.prefetch and s.batches > 0 else 0.0)
        self._prefetch_budget_s = stats.wire.modeled_wire_s
        if self.trace is not None:
            # the spans partition this pull's clock advance exactly:
            # rpc_u + alloc + rdma + assemble == stats.total_s + rpc_u
            t0 = s.clock_s
            rpc_u = rpc_s - hidden
            wire_s = stats.wire.modeled_wire_s
            self.trace.span("lease.rpc", t0, rpc_u, cat="lease",
                            meta_bytes=meta_bytes)
            self.trace.span("alloc", t0 + rpc_u, stats.alloc_s, cat="alloc")
            self.trace.span("rdma.pull", t0 + rpc_u + stats.alloc_s, wire_s,
                            cat="rdma", bytes=stats.wire.bytes_moved,
                            segments=stats.wire.num_segments)
            self.trace.span("assemble", t0 + rpc_u + stats.alloc_s + wire_s,
                            stats.total_s - stats.alloc_s - wire_s,
                            cat="assemble")
            if hidden > 0.0:
                # off the critical path: the slice of this batch's control
                # RPC hidden under the previous pull, on its own lane
                self.trace.span("prefetch.overlap", t0 - hidden, hidden,
                                cat="prefetch", track_suffix=".prefetch")
        s.batches += 1
        s.bytes += stats.wire.bytes_moved
        s.segments += stats.wire.num_segments
        s.rdma_ops += 1
        s.control_rpcs += 1
        s.alloc_s += stats.alloc_s
        s.deserialize_s += stats.deserialize_s
        s.modeled_wire_s += stats.wire.modeled_wire_s
        s.modeled_register_s += stats.wire.modeled_register_s
        s.control_rpc_s += rpc_s - hidden
        s.prefetch_overlap_s += hidden
        s.clock_s += stats.total_s + (rpc_s - hidden)
        self._lease_out.append(
            (batch, local if self.pool is not None else None))
        return stats

    # --------------------------------------------------------------- lease
    def pull_lease(self, lease_batches: int
                   ) -> list[tuple[RecordBatch, bulk_mod.BulkHandle | None]]:
        """Pull up to ``lease_batches`` batches; empty list == drained.
        Returns (batch, pooled_handle) pairs — the caller owns releasing the
        handles back to the pool once the batch is consumed."""
        if self.drained:
            return []
        if self.parked:
            raise RuntimeError("stream is parked; unpark() before pulling")
        if self.endpoint.max_batches is not None:
            lease_batches = min(
                lease_batches, self.endpoint.max_batches - self.delivered)
            if lease_batches <= 0:
                self._finish()
                return []
        admission = self.coordinator.admission
        if admission is not None:
            # token-bucket lease metering: a throttled grant charges its
            # modeled wait to this stream's clock (backpressure signal).
            # Routed per server so a sharded controller meters this lease
            # against the endpoint's own bucket shard.
            wait = admission.lease_wait_s(self.stats.clock_s, 1,
                                          server_id=self.endpoint.server_id)
            if wait > 0.0 and self.trace is not None:
                self.trace.span("admission.throttle", self.stats.clock_s,
                                wait, cat="admission")
            self.stats.throttle_wait_s += wait
            self.stats.clock_s += wait
        self._lease_out = []
        for attempt in range(self.max_resumes + 1):
            try:
                self.server.iterate(
                    self._handle.uuid, self._do_rdma,
                    max_batches=lease_batches - len(self._lease_out))
                break
            except Exception:
                if attempt == self.max_resumes:
                    raise
                # resume just this stream where it died: batches that landed
                # before the fault stay delivered, the lease pulls the rest
                self.stats.resumes += 1
                delivered = self.delivered + len(self._lease_out)
                notify_coordinator(
                    self.coordinator, "stream.fault",
                    server_id=self.endpoint.server_id,
                    now_s=self.stats.clock_s,
                    delivered=delivered)
                failover = getattr(self.coordinator, "failover_stream", None)
                if failover is None:
                    self._handle = self.coordinator.resume_stream(
                        self.endpoint, delivered)
                    continue
                # same-server resume when the server is alive; otherwise the
                # lease fails over to a surviving replica mid-flight — the
                # delivered prefix stays delivered, only the tail re-targets
                old_sid = self.endpoint.server_id
                self.endpoint, self._handle = failover(
                    self.endpoint, delivered, self.client_id,
                    now_s=self.stats.clock_s)
                if self.endpoint.server_id != old_sid:
                    self.server = self.coordinator.server(
                        self.endpoint.server_id)
                    self.stats.server_id = self.endpoint.server_id
                    self.stats.migrations += 1
                    self._prefetch_budget_s = 0.0  # cold pipe on new server
        self.delivered += len(self._lease_out)
        if not self._lease_out:
            self._finish()
        return self._lease_out

    def _finish(self) -> None:
        if not self.drained:
            self.drained = True
            if self.parked:      # lease already released at park time
                self.parked = False
                return
            self.coordinator.close_stream(self.endpoint, self._handle.uuid,
                                          client_id=self.client_id,
                                          trace=self.trace,
                                          trace_now_s=self.stats.clock_s)


class MultiStreamPuller:
    """Drive every endpoint of a plan with bounded leases."""

    def __init__(self, coordinator: ClusterCoordinator, plan: ScanPlan,
                 pool: BufferPool | None = None, lease_batches: int = 1,
                 schedule: str = "round_robin", max_resumes: int = 3,
                 prefetch: bool = True, client_id: str = "default",
                 trace=None):
        if schedule not in ("round_robin", "first_ready"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.coordinator = coordinator
        self.plan = plan
        self.pool = pool
        # snapshot so stats() reports only THIS scan's pool activity even
        # when the pool is shared across many scans (gateway traffic)
        self._pool_baseline = (dataclasses.replace(pool.stats)
                               if pool is not None else None)
        self.lease_batches = lease_batches
        self.schedule = schedule
        self.trace = trace             # obs.TraceContext for the whole scan
        self.steal_events: list = []   # appended by repro.sched drivers
        self.pullers: list[StreamPuller] = []
        try:
            for i, ep in enumerate(plan.endpoints):
                self.pullers.append(
                    StreamPuller(coordinator, ep, pool=pool,
                                 max_resumes=max_resumes, prefetch=prefetch,
                                 client_id=client_id,
                                 trace=self._stream_trace(i, ep)))
        except BaseException:
            # an admission denial (or open failure) partway through the
            # fan-out must not leak the streams that did open
            self._abandon()
            raise

    def _stream_trace(self, idx: int, endpoint: Endpoint):
        """A per-stream child trace (own track + shift-group), or None
        when the scan is untraced."""
        if self.trace is None:
            return None
        return self.trace.stream(f"stream{idx}:{endpoint.server_id}")

    # ----------------------------------------------------------- iteration
    def batches(self) -> Iterator[tuple[int, RecordBatch]]:
        """Yield ``(stream_index, batch)`` in schedule order.

        With a pool, a yielded batch's buffers are recycled when iteration
        resumes — consume or copy it before advancing (streaming contract)."""
        pending: bulk_mod.BulkHandle | None = None
        try:
            for idx, batch, handle in self._drive():
                if pending is not None:
                    self.pool.release(pending)
                pending = handle
                yield idx, batch
        finally:
            if pending is not None:
                self.pool.release(pending)

    def run(self, sink: Callable[[int, RecordBatch], None] | None = None
            ) -> ClusterStats:
        """Drain every stream; optionally hand each batch to ``sink``."""
        for idx, batch, handle in self._drive():
            try:
                if sink is not None:
                    sink(idx, batch)
            finally:
                if handle is not None:
                    self.pool.release(handle)
        return self.stats()

    def _drive(self) -> Iterator[tuple[int, RecordBatch,
                                       bulk_mod.BulkHandle | None]]:
        try:
            if self.schedule == "round_robin":
                active = list(range(len(self.pullers)))
                while active:
                    still = []
                    for idx in active:
                        yield from self._lease(idx)
                        if not self.pullers[idx].drained:
                            still.append(idx)
                    active = still
            else:  # first_ready: lease from the stream furthest behind
                heap = [(0.0, idx) for idx in range(len(self.pullers))]
                heapq.heapify(heap)
                while heap:
                    _, idx = heapq.heappop(heap)
                    yield from self._lease(idx)
                    if not self.pullers[idx].drained:
                        heapq.heappush(
                            heap, (self.pullers[idx].stats.clock_s, idx))
        finally:
            self._abandon()    # no-op on a fully drained run

    def _lease(self, idx: int) -> Iterator[tuple[int, RecordBatch,
                                                 bulk_mod.BulkHandle | None]]:
        # pull_lease returns the puller's live _lease_out list; popping as we
        # yield means anything still in it was never handed to the consumer
        out = self.pullers[idx].pull_lease(self.lease_batches)
        while out:
            batch, handle = out.pop(0)
            yield idx, batch, handle

    def _abandon(self) -> None:
        """Consumer walked away mid-scan: release pooled handles for batches
        it never saw and finalize every still-open lease, so abandoned scans
        don't leak slabs or reader-map entries."""
        for puller in self.pullers:
            for _, handle in puller._lease_out:
                if handle is not None:
                    self.pool.release(handle)
            puller._lease_out = []
            puller._finish()

    # -------------------------------------------------------------- stats
    def stats(self) -> ClusterStats:
        return ClusterStats(
            query_id=self.plan.query_id, placement=self.plan.placement,
            streams=[p.stats for p in self.pullers],
            pool=(self.pool.stats.delta_since(self._pool_baseline)
                  if self.pool is not None else None),
            steal_events=list(self.steal_events))
