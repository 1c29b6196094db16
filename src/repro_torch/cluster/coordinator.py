# Copy of src/repro/cluster/coordinator.py, kept numpy-only; change both copies together.
"""Cluster coordinator: server/endpoint registry, dataset placement, lease
reclamation, and stream resume.

The coordinator is the control-plane brain the dataplane modules lean on:

* **registry** — server_id → :class:`ThallusServer`, plus a record of which
  datasets live where and how (``shard`` vs ``replica`` placement);
* **placement** — :meth:`place_shards` splits a table's batches round-robin
  across servers under one dataset path (disjoint shards);
  :meth:`place_replicas` registers a full copy everywhere;
* **planning** — :meth:`plan` delegates to :func:`repro.cluster.plan.plan_scan`
  with the recorded placement;
* **lease lifecycle** — :meth:`open_stream` / :meth:`resume_stream` /
  :meth:`close_stream` wrap ``init_scan``/``finalize``, and
  :meth:`reclaim_stale` sweeps every server's reader map (activity-based, so
  live streams survive the sweep);
* **admission** — an optional :class:`repro.qos.AdmissionController` (duck
  typed, so there is no cluster→qos import) gates every lease grant:
  ``open_stream`` acquires a per-client stream slot (raising
  ``qos.Backpressure`` at the quota or over the memory budget) and
  ``close_stream`` releases it. Admission checks are routed **per server**:
  the endpoint's ``server_id`` rides along on every acquire/release, so a
  :class:`repro.qos.ShardedAdmission` meters each lease against that
  server's own quota shard (a centralized controller simply ignores the
  routing hint). The qos ``ScanGateway`` meters at request granularity
  instead, so a gateway's coordinator runs without one;
* **observability funnel** — optional ``recorder`` (an
  ``obs.FlightRecorder``) and ``health`` (an ``obs.HealthMonitor``), both
  duck-typed. Every layer above and below reports its decisions through
  :meth:`notify` (steal/decline, park/resume, shed, stream fault, ...) so
  one attribute check on the coordinator fans the event out to the flight
  recorder ring and the health monitor's window counters; :meth:`heartbeat`
  advances the health state machine in modeled time. Plain deployments set
  neither and pay two ``None`` checks per event.
"""
from __future__ import annotations

import dataclasses

from ..core.protocol import ScanHandle, ThallusServer
from ..engine.table import Table
from .plan import Endpoint, ScanPlan, plan_scan


class PlacementError(KeyError):
    """No registered server can serve the dataset — every host named by the
    recorded placement has left the cluster (or none was ever registered)."""


class MigrationError(RuntimeError):
    """A stream lease cannot fail over: no surviving replica hosts the
    dataset (shard placements hold disjoint data — a dead shard's rows have
    no second home until re-placement repairs the map)."""


# health states, worst-last — used only to *order* failover candidates, so
# the coordinator stays duck-typed on the monitor (no cluster→obs import)
_HEALTH_RANK = {"healthy": 0, "degraded": 1, "suspect": 2, "quarantined": 3}


@dataclasses.dataclass
class _Placement:
    mode: str                      # "shard" | "replica"
    server_ids: tuple[str, ...]
    table: Table | None = None     # source table, for membership re-placement
    # shard mode: server_id → dataset-global batch indices its shard holds
    assignment: dict[str, tuple[int, ...]] | None = None


class ClusterCoordinator:
    """Registry + lease lifecycle for a set of Thallus servers."""

    def __init__(self, admission=None, recorder=None, health=None) -> None:
        self.servers: dict[str, ThallusServer] = {}
        self.admission = admission
        self.recorder = recorder       # obs.FlightRecorder (duck-typed)
        self.health = health           # obs.HealthMonitor (duck-typed)
        # optional cluster.repair.ShardRepairer (duck-typed: observe /
        # forget / reshard / replicate). When attached, every re-placement
        # moves bytes peer-to-peer over the registered RDMA path instead of
        # re-registering slices of the coordinator's stored source table;
        # without one the legacy table-copy path below runs unchanged.
        self.repairer = None
        self._placements: dict[str, _Placement] = {}

    # ------------------------------------------------- observability funnel
    def notify(self, kind: str, server_id: str = "", now_s: float = 0.0,
               **attrs) -> None:
        """Report one structured decision (``steal.decline``,
        ``stream.fault``, ``qos.shed``, ...) to the attached flight
        recorder and health monitor. A no-op when neither is attached."""
        if self.recorder is not None:
            self.recorder.record(kind, now_s=now_s, server_id=server_id,
                                 **attrs)
        if self.health is not None:
            observe = getattr(self.health, "observe_event", None)
            if observe is not None:
                observe(kind, server_id, now_s)

    def heartbeat(self, now_s: float) -> list:
        """Advance the attached health monitor one heartbeat on the modeled
        clock; returns the health transitions it produced ([] when no
        monitor is attached)."""
        if self.health is None:
            return []
        return self.health.heartbeat(now_s)

    # ------------------------------------------------------------ registry
    def add_server(self, server_id: str, server: ThallusServer, *,
                   rebalance: bool = False, now_s: float = 0.0) -> None:
        """Register a server. With ``rebalance=True`` (a live *join*), every
        recorded placement is repaired to put the joiner to work: replica
        datasets get a full copy registered on it, shard datasets hand it a
        minimal-movement slice (only ``⌊batches/n⌋`` batches move, taken one
        at a time from the currently-largest shards)."""
        if server_id in self.servers:
            raise ValueError(f"server id {server_id!r} already registered")
        self.servers[server_id] = server
        if rebalance:
            for dataset, placement in self._placements.items():
                if server_id in placement.server_ids:
                    continue
                if placement.table is None:
                    continue   # legacy placement with no stored source table
                if placement.mode == "replica":
                    placement.server_ids = tuple(
                        sorted((*placement.server_ids, server_id)))
                    if self.repairer is not None:
                        self.repairer.replicate(dataset, placement, server_id,
                                                now_s=now_s)
                    else:
                        server.engine.register(dataset, placement.table)
                    self.notify("placement.repair", server_id=server_id,
                                now_s=now_s, dataset=dataset, mode="replica",
                                action="join")
                else:
                    self._join_shard(dataset, placement, server_id, now_s)

    def remove_server(self, server_id: str, *,
                      now_s: float = 0.0) -> ThallusServer:
        """Deregister a server (a live *leave*/eviction) and repair every
        placement naming it: replica placements just drop the host; shard
        placements re-deal the orphaned shard's batches across the smallest
        surviving shards (survivors keep everything they already hold —
        minimal movement). Returns the removed server so a membership
        controller can stash it for re-admission."""
        server = self.server(server_id)
        del self.servers[server_id]
        if self.repairer is not None:
            # the departed server's pinned memory is gone: purge it from the
            # donor directory BEFORE any re-deal tries to pull from it
            self.repairer.forget(server_id)
        for dataset, placement in self._placements.items():
            if server_id not in placement.server_ids:
                continue
            placement.server_ids = tuple(
                sid for sid in placement.server_ids if sid != server_id)
            if placement.mode == "shard" and placement.assignment is not None:
                orphans = placement.assignment.pop(server_id, ())
                self._redeal(dataset, placement, orphans, now_s=now_s)
                self.notify("placement.repair", server_id=server_id,
                            now_s=now_s, dataset=dataset, mode="shard",
                            action="leave", moved=len(orphans))
            else:
                self.notify("placement.repair", server_id=server_id,
                            now_s=now_s, dataset=dataset,
                            mode=placement.mode, action="leave")
        return server

    def _join_shard(self, dataset: str, placement: _Placement,
                    joiner: str, now_s: float) -> None:
        """Hand a joining server a minimal-movement shard slice."""
        assignment = placement.assignment
        if assignment is None:
            assignment = placement.assignment = {}
        total = sum(len(v) for v in assignment.values())
        want = total // (len(placement.server_ids) + 1)
        taken: list[int] = []
        donors: set[str] = set()
        for _ in range(want):
            # take one batch from the largest donor shard (deterministic
            # tie-break: largest size, then highest server_id) — its
            # highest global index, so donors keep their prefix
            donor = max(assignment,
                        key=lambda sid: (len(assignment[sid]), sid))
            *keep, moved = assignment[donor]
            assignment[donor] = tuple(keep)
            taken.append(moved)
            donors.add(donor)
        assignment[joiner] = tuple(sorted(taken))
        placement.server_ids = tuple(sorted((*placement.server_ids, joiner)))
        if self.repairer is not None:
            # the joiner pulls FIRST: the moved batches are still pinned on
            # their donors, so every one rides the peer RDMA path; the
            # donors then shrink to their kept prefix with zero movement
            self.repairer.reshard(dataset, placement, joiner, now_s=now_s)
            for donor in sorted(donors):
                self.repairer.reshard(dataset, placement, donor, now_s=now_s)
        else:
            for donor in sorted(donors):
                self._register_shard(dataset, placement, donor)
            self._register_shard(dataset, placement, joiner)
        self.notify("placement.repair", server_id=joiner, now_s=now_s,
                    dataset=dataset, mode="shard", action="join",
                    moved=len(taken))

    def _redeal(self, dataset: str, placement: _Placement,
                orphans: tuple[int, ...], now_s: float = 0.0) -> None:
        """Deal orphaned global batch indices to the smallest surviving
        shards (ties → lowest server_id), keeping each shard sorted."""
        assignment = placement.assignment
        if assignment is None or not placement.server_ids:
            return
        for idx in sorted(orphans):
            target = min(placement.server_ids,
                         key=lambda sid: (len(assignment.get(sid, ())), sid))
            assignment[target] = tuple(sorted((*assignment.get(target, ()),
                                               idx)))
        for sid in placement.server_ids:
            if self.repairer is not None:
                # survivors reuse what they hold; the orphaned indices have
                # no live holder left (shards are disjoint), so each lands
                # via the stored-table fallback — the durability story
                self.repairer.reshard(dataset, placement, sid, now_s=now_s)
            else:
                self._register_shard(dataset, placement, sid)

    def _register_shard(self, dataset: str, placement: _Placement,
                        server_id: str) -> None:
        table = placement.table
        if table is None or placement.assignment is None:
            return
        shard = Table(table.name, table.schema,
                      batches=[table.batches[j]
                               for j in placement.assignment.get(server_id,
                                                                 ())])
        self.server(server_id).engine.register(dataset, shard)

    def server(self, server_id: str) -> ThallusServer:
        if server_id not in self.servers:
            raise KeyError(f"unknown server {server_id!r}")
        return self.servers[server_id]

    def hosts(self, dataset: str) -> dict[str, ThallusServer]:
        """Which servers host ``dataset``. Uses the recorded placement when
        one exists, otherwise falls back to probing server catalogs.

        A placement may name servers that have since left the cluster
        (anything that bypassed :meth:`remove_server`'s repair); those are
        dropped from the returned map — and reported as ``placement.stale``
        — rather than raised, so one stale entry can't strand every scan of
        the dataset. :meth:`plan` raises :class:`PlacementError` only when
        *no* host survives."""
        placement = self._placements.get(dataset)
        if placement is not None:
            missing = [sid for sid in placement.server_ids
                       if sid not in self.servers]
            for sid in missing:
                self.notify("placement.stale", server_id=sid,
                            dataset=dataset)
            return {sid: self.servers[sid] for sid in placement.server_ids
                    if sid in self.servers}
        found = {}
        for sid, server in self.servers.items():
            catalog = getattr(server.engine, "catalog", None)
            if catalog is not None and dataset in catalog:
                found[sid] = server
        return found

    def placement_mode(self, dataset: str) -> str:
        placement = self._placements.get(dataset)
        return placement.mode if placement is not None else "shard"

    # ----------------------------------------------------------- placement
    def place_shards(self, dataset: str, table: Table,
                     server_ids: list[str] | None = None) -> None:
        """Split ``table``'s batches round-robin into disjoint shards, one
        per server, all registered under the same dataset path."""
        ids = sorted(server_ids or self.servers)
        if not ids:
            raise ValueError("no servers to place shards on")
        assignment = {sid: tuple(range(i, len(table.batches), len(ids)))
                      for i, sid in enumerate(ids)}
        for i, sid in enumerate(ids):
            shard = Table(table.name, table.schema,
                          batches=table.batches[i::len(ids)])
            self.server(sid).engine.register(dataset, shard)
        self._placements[dataset] = _Placement("shard", tuple(ids),
                                               table=table,
                                               assignment=assignment)
        if self.repairer is not None:
            self.repairer.observe(dataset, self._placements[dataset])

    def place_replicas(self, dataset: str, table: Table,
                       server_ids: list[str] | None = None) -> None:
        """Register a full copy of ``table`` on every server."""
        ids = sorted(server_ids or self.servers)
        if not ids:
            raise ValueError("no servers to place replicas on")
        for sid in ids:
            self.server(sid).engine.register(dataset, table)
        self._placements[dataset] = _Placement("replica", tuple(ids),
                                               table=table)
        if self.repairer is not None:
            self.repairer.observe(dataset, self._placements[dataset])

    # ------------------------------------------------------------ planning
    def plan(self, sql: str, dataset: str,
             num_streams: int | None = None,
             placement: str | None = None) -> ScanPlan:
        hosts = self.hosts(dataset)
        if not hosts:
            raise PlacementError(f"no server hosts dataset {dataset!r}")
        mode = placement or self.placement_mode(dataset)
        recorded = self._placements.get(dataset)
        assignment = (recorded.assignment
                      if recorded is not None and mode == "shard" else None)
        return plan_scan(sql, dataset, hosts, placement=mode,
                         num_streams=num_streams, assignment=assignment)

    # ------------------------------------------------- stream lease lifecycle
    def open_stream(self, endpoint: Endpoint,
                    client_id: str = "default", trace=None,
                    now_s: float = 0.0) -> ScanHandle:
        """Open one stream lease; admission-gated when a controller is set
        (may raise ``qos.Backpressure`` with a retry-after hint). The check
        is routed to the endpoint server's quota shard when the controller
        is sharded (``server_id=`` is ignored by a centralized one).
        ``trace`` (an ``obs.StreamTrace``) gets a ``stream.open`` instant
        at ``now_s`` on the stream's local clock."""
        if self.admission is not None:
            self.admission.acquire_stream(client_id,
                                          server_id=endpoint.server_id)
        try:
            server = self.server(endpoint.server_id)
            handle = server.init_scan(endpoint.sql, endpoint.dataset,
                                      start_batch=endpoint.start_batch)
        except BaseException:
            if self.admission is not None:
                self.admission.release_stream(client_id,
                                              server_id=endpoint.server_id)
            raise
        if trace is not None:
            trace.instant("stream.open", now_s, cat="stream",
                          server=endpoint.server_id)
        return handle

    def admission_headroom(self, server_id: str,
                           client_id: str = "default") -> int | None:
        """Free admission capacity at ``server_id``'s quota shard for one
        more of ``client_id``'s streams, or ``None`` when unlimited/unknown.

        The steal scheduler's thief-side check: before re-leasing a stolen
        range onto a server, it asks whether that server's shard could admit
        the extra stream *locally* — a shard at its quota would stall the
        thief on admission (or force a borrow), trading a transport stall
        for an admission stall. Duck-typed like every admission touchpoint:
        controllers without a ``headroom`` query report ``None`` (no
        opinion), so plain deployments steal exactly as before."""
        if self.admission is None:
            return None
        headroom = getattr(self.admission, "headroom", None)
        if headroom is None:
            return None
        return headroom(server_id, client_id)

    def resume_stream(self, endpoint: Endpoint, delivered: int) -> ScanHandle:
        """Restart one failed stream where it died: a fresh ``init_scan``
        fast-forwarded past the batches the stream already delivered. The
        stream's admission slot stays held — a resume is the same logical
        stream, not a new grant."""
        server = self.server(endpoint.server_id)
        return server.init_scan(
            endpoint.sql, endpoint.dataset,
            start_batch=endpoint.start_batch + delivered)

    def failover_target(self, endpoint: Endpoint) -> str:
        """Pick the surviving replica a dead server's stream migrates to.

        Only replica placements can fail over — a shard's rows have no
        second home. Candidates are the dataset's other registered,
        non-crashed hosts, ordered best-health-first (ties broken by sorted
        server_id so the choice is deterministic); raises
        :class:`MigrationError` when none survives."""
        placement = self._placements.get(endpoint.dataset)
        if placement is None or placement.mode != "replica":
            raise MigrationError(
                f"stream on {endpoint.server_id!r} cannot fail over: "
                f"dataset {endpoint.dataset!r} is not replica-placed")
        candidates = [
            sid for sid in placement.server_ids
            if sid != endpoint.server_id and sid in self.servers
            and not getattr(self.servers[sid], "crashed", False)]
        if not candidates:
            raise MigrationError(
                f"no surviving replica hosts dataset {endpoint.dataset!r} "
                f"(stream was on {endpoint.server_id!r})")
        if self.health is not None:
            state = getattr(self.health, "state", None)
            if state is not None:
                return min(candidates,
                           key=lambda sid: (_HEALTH_RANK.get(state(sid), 0),
                                            sid))
        return min(candidates)

    def failover_stream(self, endpoint: Endpoint, delivered: int,
                        client_id: str = "default", *,
                        slot_held: bool = True,
                        now_s: float = 0.0) -> tuple[Endpoint, ScanHandle]:
        """Migrate one stream lease off a dead/unregistered server.

        When the endpoint's server is still alive this is exactly
        :meth:`resume_stream` (same server, same slot). Otherwise the lease
        moves to :meth:`failover_target`'s pick: the dead shard's admission
        slot is released (when ``slot_held``), a fresh slot is acquired on
        the target's shard, and the scan resumes mid-flight via
        ``init_scan(start_batch=endpoint.start_batch + delivered)`` — the
        delivered prefix is never re-shipped. Returns the re-targeted
        endpoint (original ``start_batch``, so the caller's delivered-count
        bookkeeping stays valid) plus the new handle, and reports
        ``stream.migrate`` through the funnel."""
        server = self.servers.get(endpoint.server_id)
        if server is not None and not getattr(server, "crashed", False):
            return endpoint, self.resume_stream(endpoint, delivered)
        target = self.failover_target(endpoint)
        if self.admission is not None and slot_held:
            self.admission.release_stream(client_id,
                                          server_id=endpoint.server_id,
                                          now_s=now_s)
        new_endpoint = dataclasses.replace(endpoint, server_id=target)
        handle = self.open_stream(
            dataclasses.replace(new_endpoint,
                                start_batch=endpoint.start_batch + delivered),
            client_id=client_id, now_s=now_s)
        self.notify("stream.migrate", server_id=endpoint.server_id,
                    now_s=now_s, to=target, delivered=delivered,
                    client=client_id)
        return new_endpoint, handle

    def reopen_stream(self, endpoint: Endpoint, delivered: int,
                      client_id: str = "default") -> ScanHandle:
        """Resume a *parked* stream (lease-boundary preemption, see
        :mod:`repro.sched.preempt`). Unlike :meth:`resume_stream`, parking
        released the admission slot back to the budget, so the re-open is a
        fresh admission-gated grant — it may raise ``qos.Backpressure``."""
        return self.open_stream(
            dataclasses.replace(
                endpoint, start_batch=endpoint.start_batch + delivered),
            client_id=client_id)

    def close_stream(self, endpoint: Endpoint, uid: str,
                     client_id: str = "default",
                     now_s: float | None = None, trace=None,
                     trace_now_s: float = 0.0) -> None:
        """Release the lease and its admission slot. ``now_s`` is an
        optional timestamp on the admission controller's modeled timeline,
        forwarded to its freed-slot callbacks; leave it ``None`` when the
        caller has no clock on that timeline (listeners then stamp their
        own — per-stream scan clocks do NOT qualify, they are relative).
        ``trace``/``trace_now_s`` record a ``stream.close`` instant on the
        stream's own (relative) clock — a different timeline on purpose."""
        if self.admission is not None:
            self.admission.release_stream(client_id,
                                          server_id=endpoint.server_id,
                                          now_s=now_s)
        server = self.server(endpoint.server_id)
        if uid in server.reader_map:   # may already be reclaimed/evicted
            server.finalize(uid)
        if trace is not None:
            trace.instant("stream.close", trace_now_s, cat="stream",
                          server=endpoint.server_id)

    def reclaim_stale(self, older_than_s: float,
                      now_s: float | None = None) -> int:
        """Sweep abandoned leases across the whole cluster. ``now_s`` pins
        the sweep to the modeled timeline (see
        :meth:`ThallusServer.reclaim_stale`)."""
        return sum(s.reclaim_stale(older_than_s, now_s=now_s)
                   for s in self.servers.values())
