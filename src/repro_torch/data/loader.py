# Copy of src/repro/data/loader.py, kept numpy-only; change both copies together.
"""ThallusLoader: the paper's protocol as a training input pipeline.

Server side: token shards behind the query engine. Client side: each
training job ``init_scan``s its shard query, streams record batches via the
zero-copy transport, reshapes token columns *by view* (``batch_to_device``
being the trainer's job), and feeds (tokens, labels) numpy batches.

Three transports, one knob:

* ``"thallus"`` / ``"rpc"`` — the paper's single-stream scan (zero-copy vs
  serialize), with **backup requests**: if the primary's simulated response
  time exceeds ``straggler_deadline_s``, the batch is re-pulled from the
  next replica, first-ready wins.
* ``"cluster"`` — the :mod:`repro.cluster` dataplane: the query is planned
  into per-replica batch-range partitions (``placement="replica"``, or
  ``"shard"`` if the servers hold disjoint shards), pulled over N concurrent
  leases through a registered buffer pool. This subsumes the backup-request
  hack — a slow or failed stream is resumed individually via
  ``init_scan(start_batch=…)`` instead of re-running the whole query.
* ``"gateway"`` — the loader submits one logical
  ``qos.ScanRequest`` per epoch through a ``qos.ScanGateway`` (pass
  ``gateway=``). The scan then rides whatever adaptive scheduling the
  gateway carries: identical concurrent queries coalesce onto a shared
  ticket (``LoaderStats.shared_scans`` counts multicast grants that cost no
  extra server work), a batch-class scan may be preempted at lease
  boundaries by interactive traffic (``LoaderStats.preemptions``), and
  stragglers are work-stolen. Resume uses the request's ``start_batch``
  (global scan order — the gateway reassembles before the loader sees
  batches, so per-stream offsets are unnecessary).

Resumable cursors in every mode: ``state_dict()``/``load_state_dict()``
round-trip the cursor through the checkpoint manifest. Cluster mode tracks
*per-stream* offsets (the merged order is only defined per stream).

Cluster mode is admission-aware: pass a ``qos.AdmissionController`` (plus a
``client_id``) and every stream lease is granted through it. A
``qos.ShardedAdmission`` works identically — the loader's coordinator names
its servers ``s0..sN-1`` and routes every lease to the endpoint server's
quota shard, so build the controller over the same ids
(``ShardedAdmission(cfg, [f"s{i}" for i in range(n)])``). A denied grant
— stream quota hit, registered-memory budget exhausted — surfaces to the
caller as :class:`repro.qos.Backpressure` with a ``retry_after_s`` hint and
bumps ``LoaderStats.backpressures``; the loader's cursor state is
unchanged, so the caller simply waits and re-iterates (or narrows
``num_streams`` under its quota). Gateway mode never sees that exception —
the gateway queues or sheds instead — so a scan shed or failed while
queued yields an **empty epoch** with ``backpressures`` bumped and the
cursor unchanged: check it to distinguish "retry later" from "dataset
exhausted".
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..cluster import BufferPool, ClusterCoordinator, MultiStreamPuller
from ..core.protocol import RpcClient, ThallusClient, ThallusServer
from ..core.recordbatch import RecordBatch
from .tokens import batch_to_tokens, shift_labels


@dataclasses.dataclass
class LoaderStats:
    batches: int = 0
    backup_requests: int = 0
    stream_resumes: int = 0
    transport_s: float = 0.0
    shared_scans: int = 0        # gateway scans served by ticket multicast
    preemptions: int = 0         # times a gateway scan parked mid-flight
    backpressures: int = 0       # admission denials surfaced to the caller


class ThallusLoader:
    """Streams (tokens, labels) numpy batches; device placement is the
    trainer's job (it owns the mesh)."""

    def __init__(self, servers: list[ThallusServer], sql: str, dataset: str,
                 seq_len: int, batch_seqs: int, transport: str = "thallus",
                 straggler_deadline_s: float = 0.5, start_batch: int = 0,
                 num_streams: int | None = None, use_pool: bool = True,
                 placement: str = "replica", admission=None,
                 client_id: str = "loader", gateway=None,
                 klass: str = "batch"):
        if transport == "gateway":
            if gateway is None:
                raise ValueError("transport='gateway' needs a gateway=")
        elif not servers:
            raise ValueError("need at least one server")
        if transport not in ("thallus", "rpc", "cluster", "gateway"):
            raise ValueError(f"unknown transport {transport!r}")
        self.servers = servers
        self.sql = sql
        self.dataset = dataset
        self.seq_len = seq_len
        self.batch_seqs = batch_seqs
        self.transport = transport
        self.deadline = straggler_deadline_s
        self.num_streams = num_streams
        self.use_pool = use_pool
        self.placement = placement
        self.admission = admission
        self.client_id = client_id
        self.gateway = gateway
        self.klass = klass
        self.stats = LoaderStats()
        self._offset = start_batch
        self._stream_offsets: list[int] = []
        self._buffer: list[np.ndarray] = []    # leftover sequences

    # -- telemetry ----------------------------------------------------------
    def metrics(self) -> "MetricsRegistry":
        """The loader-level telemetry roll-up: its own ``loader.*``
        counters plus everything the gateway below it saw (``qos.*``,
        ``sched.*``, ``cluster.*``, ``pool.*``) when one is attached —
        one ``snapshot()`` for the whole data path."""
        from ..obs.registry import (MetricsRegistry, record_gateway,
                                    record_loader)
        reg = MetricsRegistry()
        record_loader(reg, self.stats)
        if self.gateway is not None:
            record_gateway(reg, self.gateway)
        monitor = self._health_monitor()
        if monitor is not None:
            from ..obs.registry import record_health
            record_health(reg, monitor)
        return reg

    def health(self) -> dict:
        """Per-server health verdicts from the cluster's
        ``obs.HealthMonitor`` when one is attached to the gateway's
        coordinator (``{server_id: "healthy" | "degraded" | "suspect" |
        "quarantined"}``); ``{}`` when no monitor watches this data path."""
        monitor = self._health_monitor()
        if monitor is None:
            return {}
        return monitor.states()

    def _health_monitor(self):
        coordinator = getattr(self.gateway, "coordinator", None)
        return getattr(coordinator, "health", None)

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"batch_offset": self._offset,
                "stream_offsets": list(self._stream_offsets)}

    def load_state_dict(self, d: dict) -> None:
        self._offset = int(d["batch_offset"])
        self._stream_offsets = [int(v) for v in d.get("stream_offsets", [])]
        self._buffer.clear()

    # -- streaming ----------------------------------------------------------
    def _pull_batches(self) -> Iterator[RecordBatch]:
        if self.transport == "cluster":
            yield from self._pull_cluster()
        elif self.transport == "gateway":
            yield from self._pull_gateway()
        else:
            yield from self._pull_single_stream()

    def _pull_single_stream(self) -> Iterator[RecordBatch]:
        """Stream record batches from the first-ready replica per batch."""
        cls = ThallusClient if self.transport == "thallus" else RpcClient
        primary = cls(self.servers[0])
        batches = primary.run_query(self.sql, self.dataset,
                                    start_batch=self._offset)
        for i, b in enumerate(batches):
            stats = primary.stats[i]
            if stats.total_s > self.deadline and len(self.servers) > 1:
                # straggler: issue backup request to a replica for exactly
                # this batch. self._offset is its global index (advanced
                # once per earlier batch); the client is fresh and the pull
                # bounded, so rb == [that one batch].
                backup = cls(self.servers[1])
                rb = backup.run_query(self.sql, self.dataset,
                                      start_batch=self._offset,
                                      max_batches=1)
                self.stats.backup_requests += 1
                b = rb[0] if rb else b
            self.stats.transport_s += stats.total_s
            self.stats.batches += 1
            self._offset += 1
            yield b

    def _pull_gateway(self) -> Iterator[RecordBatch]:
        """One logical scan through the qos gateway, resumed by global
        offset: the request's ``start_batch`` IS the loader cursor (the
        gateway pushes it down into replica plans, or trims the reassembled
        head for shard plans), so checkpoint state stays a single integer.
        Surfaces the adaptive-scheduler outcomes: ``shared_scans`` when the
        result arrived by shared-ticket multicast, ``preemptions`` when the
        scan was parked for interactive traffic mid-flight."""
        from ..qos import ScanRequest   # data -> qos only on this path
        request = self.gateway.submit(ScanRequest(
            self.client_id, self.klass, self.sql, self.dataset,
            num_streams=self.num_streams, start_batch=self._offset))
        if request is None:             # shed at submit (deadline policy)
            self.stats.backpressures += 1
            return
        self.gateway.run()
        result = self.gateway.result(request.request_id)
        if result is None:
            # shed or failed while queued: the gateway converts admission
            # denials to sheds instead of raising, so the empty epoch is
            # flagged here — callers distinguish it from dataset
            # exhaustion via stats.backpressures and retry
            self.stats.backpressures += 1
            return
        self.stats.shared_scans += int(result.shared)
        self.stats.preemptions += result.preemptions
        self.stats.stream_resumes += result.cluster.resumes
        self.stats.transport_s += result.service_s
        try:
            for batch in result.batches:
                self._offset += 1
                self.stats.batches += 1
                yield batch
        finally:
            # the loader re-submits every epoch; leaving each epoch's fully
            # materialized result in the gateway map would grow unbounded
            self.gateway.results.pop(request.request_id, None)

    def _pull_cluster(self) -> Iterator[RecordBatch]:
        """Partitioned multi-stream pull with per-stream resume offsets.

        Resume semantics: when the checkpoint carries ``stream_offsets``
        (written by a cluster-mode run), each stream fast-forwards
        server-side via ``init_scan(start_batch=…)`` — no wasted transport.
        A bare global offset (the ``start_batch`` constructor arg, or a
        checkpoint from a single-stream run) cannot be mapped onto streams
        exactly, so the first ``offset`` batches are pulled and discarded —
        correct under any schedule, at the cost of re-transporting them.

        With the pool on, a yielded batch's buffers are recycled once the
        next batch is requested, so ``__iter__`` copies the token block out
        (the np.stack that builds training chunks copies regardless)."""
        coordinator = ClusterCoordinator(admission=self.admission)
        for i, server in enumerate(self.servers):
            coordinator.add_server(f"s{i}", server)
        plan = coordinator.plan(self.sql, self.dataset,
                                num_streams=self.num_streams,
                                placement=self.placement)
        # fast-forward each stream past what previous runs already delivered
        if self._stream_offsets and \
                len(self._stream_offsets) != len(plan.endpoints):
            raise ValueError(
                f"checkpoint has {len(self._stream_offsets)} stream offsets "
                f"but the plan has {len(plan.endpoints)} endpoints")
        offsets = self._stream_offsets or [0] * len(plan.endpoints)
        endpoints = tuple(
            dataclasses.replace(
                ep, start_batch=ep.start_batch + off,
                max_batches=(None if ep.max_batches is None
                             else ep.max_batches - off))
            for ep, off in zip(plan.endpoints, offsets))
        plan = dataclasses.replace(plan, endpoints=endpoints)
        pool = BufferPool(self.servers[0].fabric) if self.use_pool else None
        # Backpressure from an admission controller propagates from here:
        # no lease opened yet counts against the cursor, so the caller can
        # retry after `retry_after_s` with state intact
        try:
            puller = MultiStreamPuller(coordinator, plan, pool=pool,
                                       schedule="round_robin",
                                       client_id=self.client_id)
        except Exception as exc:
            # duck-typed qos.Backpressure (data -> qos stays import-free)
            if hasattr(exc, "retry_after_s"):
                self.stats.backpressures += 1
            raise
        self._stream_offsets = offsets
        skip = self._offset - sum(offsets)   # global offset not yet mapped
        if skip < 0:
            raise ValueError(
                f"inconsistent checkpoint: batch_offset={self._offset} < "
                f"sum(stream_offsets)={sum(offsets)}")
        try:
            for idx, batch in puller.batches():
                self._stream_offsets[idx] += 1
                if skip > 0:    # already consumed before this incarnation
                    skip -= 1
                    continue
                self._offset += 1
                self.stats.batches += 1
                yield batch
        finally:
            # a consumer that stops early (checkpoint-and-exit) still pulled
            # batches — account whatever transport accrued, drained or not
            cluster = puller.stats()
            self.stats.stream_resumes += cluster.resumes
            self.stats.transport_s += cluster.critical_path_s

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        copy_out = self.transport == "cluster" and self.use_pool
        for rb in self._pull_batches():
            seqs = batch_to_tokens(rb, self.seq_len)
            if copy_out:
                seqs = seqs.copy()     # pooled buffers are about to recycle
            self._buffer.extend(seqs)
            while len(self._buffer) >= self.batch_seqs:
                chunk = np.stack(self._buffer[: self.batch_seqs])
                del self._buffer[: self.batch_seqs]
                yield {"tokens": chunk, "labels": shift_labels(chunk)}
