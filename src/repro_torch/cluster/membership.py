# Copy of src/repro/cluster/membership.py, kept numpy-only; change both copies together.
"""Elastic membership: health verdicts drive server evict / re-admit.

The :class:`~repro.obs.health.HealthMonitor` (PR 7) already decides *how
sick* each server is; this module closes the loop by acting on the verdicts:

* a registered server whose health state reaches ``quarantined`` is
  **evicted** — :meth:`ClusterCoordinator.remove_server` repairs every
  placement naming it (replica drop / minimal-movement shard re-deal), the
  sharded admission controller absorbs its quota shard into the survivors,
  and the server object is stashed for later re-admission;
* a stashed server whose health has **recovered** (hysteretically stepped
  back down to ``degraded`` or better) and whose process is actually up
  (``not server.crashed``) is **re-admitted** —
  ``add_server(rebalance=True)`` puts it back to work and the admission
  layer spawns it a fresh quota shard.

Every transition funnels through ``coordinator.notify`` (``membership.evict``
/ ``membership.readmit``) so a nemesis postmortem can prove the causal chain
verdict → evict → migrate → re-admit beat by beat.

Like the rest of the cluster layer the controller is duck-typed on its
collaborators: ``health`` is anything with ``state(server_id) -> str``,
``admission`` anything with ``remove_shard``/``add_shard`` (a centralized
controller without them is simply left alone), so there is still no
cluster→qos or cluster→obs import.
"""
from __future__ import annotations

import dataclasses

from ..core.protocol import ThallusServer
from .coordinator import ClusterCoordinator

#: health states that keep a server in (or return it to) the serving set
SERVABLE_STATES = ("healthy", "degraded")
#: the health state that triggers eviction
EVICT_STATE = "quarantined"


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership transition, in modeled time."""

    action: str            # "evict" | "readmit"
    server_id: str
    now_s: float
    reason: str = ""


class MembershipController:
    """Heartbeat-driven evict/re-admit loop over health verdicts."""

    def __init__(self, coordinator: ClusterCoordinator, health,
                 admission=None) -> None:
        self.coordinator = coordinator
        self.health = health
        self.admission = admission
        self._evicted: dict[str, ThallusServer] = {}
        self.events: list[MembershipEvent] = []

    @property
    def evicted(self) -> tuple[str, ...]:
        """Servers currently out of the serving set, sorted."""
        return tuple(sorted(self._evicted))

    def heartbeat(self, now_s: float) -> list[MembershipEvent]:
        """One membership pass: evict newly-quarantined servers, re-admit
        recovered ones. Call *after* ``coordinator.heartbeat`` so this
        beat's health verdicts are already advanced. Returns the
        transitions made this beat."""
        fired: list[MembershipEvent] = []
        for sid in sorted(self.coordinator.servers):
            if self.health.state(sid) == EVICT_STATE:
                fired.append(self._evict(sid, now_s))
        for sid in sorted(self._evicted):
            server = self._evicted[sid]
            if getattr(server, "crashed", False):
                continue           # process still down: nothing to re-admit
            if self.health.state(sid) in SERVABLE_STATES:
                fired.append(self._readmit(sid, now_s))
        self.events.extend(fired)
        return fired

    def _evict(self, sid: str, now_s: float) -> MembershipEvent:
        server = self.coordinator.remove_server(sid, now_s=now_s)
        self._evicted[sid] = server
        if self.admission is not None:
            remove = getattr(self.admission, "remove_shard", None)
            if remove is not None and sid in getattr(self.admission,
                                                     "shards", {}):
                remove(sid, now_s=now_s)
        event = MembershipEvent("evict", sid, now_s,
                                reason=self.health.state(sid))
        self.coordinator.notify("membership.evict", server_id=sid,
                                now_s=now_s, reason=event.reason)
        return event

    def _readmit(self, sid: str, now_s: float) -> MembershipEvent:
        server = self._evicted.pop(sid)
        # the rebalance below IS the re-admit pre-warm: with a repairer
        # attached it pulls the joiner's slices/replicas peer-to-peer over
        # the registered RDMA path; attribute that movement to this event
        repairer = getattr(self.coordinator, "repairer", None)
        baseline = (dataclasses.replace(repairer.stats)
                    if repairer is not None else None)
        self.coordinator.add_server(sid, server, rebalance=True, now_s=now_s)
        if repairer is not None:
            warm = repairer.stats.delta_since(baseline)
            if warm.batches_pulled or warm.table_copies or warm.batches_reused:
                self.coordinator.notify(
                    "repair.prewarm", server_id=sid, now_s=now_s,
                    pulled=warm.batches_pulled, copied=warm.table_copies,
                    reused=warm.batches_reused, bytes=warm.bytes_pulled)
        if self.admission is not None:
            add = getattr(self.admission, "add_shard", None)
            if add is not None and sid not in getattr(self.admission,
                                                      "shards", {}):
                add(sid, now_s=now_s)
        event = MembershipEvent("readmit", sid, now_s,
                                reason=self.health.state(sid))
        self.coordinator.notify("membership.readmit", server_id=sid,
                                now_s=now_s, reason=event.reason)
        return event
