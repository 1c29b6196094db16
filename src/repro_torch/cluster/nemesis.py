# Copy of src/repro/cluster/nemesis.py, kept numpy-only; change both copies together.
"""Nemesis: a deterministic, scheduled fault injector for the cluster.

Modeled on YDB's nemesis tooling (a tracker of *active* faults driven by a
schedule, injected while a side workload keeps traffic flowing): each
:class:`FaultSpec` names one fault — ``kill`` (the server process dies and
its reader map with it), ``slow`` (its fabric loses bandwidth), or
``partition`` (its admission shard stops reconciling) — with the beat it
starts and, optionally, the beat it heals. :meth:`Nemesis.beat` is called
once per driver beat and injects/heals exactly what the schedule says, so
the same ``(seed, FabricConfig, schedule)`` replays the identical fault
timeline — the PR 8 byte-identical discipline extended to faults.

The nemesis is the *outside world*: targets resolve through the
coordinator's live registry first (so servers that join after construction
are fair game) with a construction-time snapshot as fallback, so it can
crash, heal, or slow a server regardless of whether the membership
controller currently has it registered. Everything it does is reported through ``coordinator.notify``
(``nemesis.inject`` / ``nemesis.heal``) so the postmortem shows the fault
next to the recovery it caused.
"""
from __future__ import annotations

import dataclasses
import random

from .coordinator import ClusterCoordinator

KINDS = ("kill", "slow", "partition")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``stop_beat=None`` means the schedule never heals it (a permanent
    fault). ``factor`` applies to ``slow`` (bandwidth divisor);
    ``after_batches`` applies to ``kill`` (die only after shipping that
    many more batches — a mid-lease death, the case lease migration must
    survive; ``0`` dies immediately).
    """

    kind: str
    server_id: str
    start_beat: int
    stop_beat: int | None = None
    factor: float = 4.0
    after_batches: int = 0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.stop_beat is not None and self.stop_beat <= self.start_beat:
            raise ValueError("stop_beat must follow start_beat")


class Nemesis:
    """Inject/heal the scheduled faults, track the active set."""

    def __init__(self, coordinator: ClusterCoordinator,
                 schedule: list[FaultSpec] | tuple[FaultSpec, ...],
                 admission=None) -> None:
        self.coordinator = coordinator
        self.schedule = tuple(schedule)
        self.admission = admission
        # the outside world's view of the fleet: a fallback for servers the
        # membership layer has evicted. The coordinator's live registry is
        # consulted first, so post-construction joiners are targetable too.
        self._servers = dict(coordinator.servers)
        self._saved_fabric: dict[str, object] = {}
        # overlapping slow faults COMPOUND: every active factor per server,
        # applied as a product over the saved base config
        self._slow_factors: dict[str, list[float]] = {}
        # live injections per (kind, server_id): kill/partition heal their
        # server-level effect only when the LAST overlapping window closes
        self._refcount: dict[tuple[str, str], int] = {}
        # active faults keyed by spec (not (kind, sid)), so two overlapping
        # windows on one server track — and heal — independently
        self.active: dict[FaultSpec, int] = {}
        # (beat, action, kind, server_id) — the determinism witness
        self.timeline: list[tuple[int, str, str, str]] = []

    def beat(self, beat: int, now_s: float) -> list[FaultSpec]:
        """Apply the schedule for one beat; returns the specs acted on."""
        acted: list[FaultSpec] = []
        for spec in self.schedule:
            if spec.stop_beat is not None and spec.stop_beat == beat:
                self._heal(spec, beat, now_s)
                acted.append(spec)
        for spec in self.schedule:
            if spec.start_beat == beat:
                self._inject(spec, beat, now_s)
                acted.append(spec)
        return acted

    def _server(self, server_id: str):
        """Resolve a target: the coordinator's live view first (so joiners
        added after construction are reachable), then the construction
        snapshot (so evicted servers stay crashable/healable)."""
        server = self.coordinator.servers.get(server_id)
        if server is not None:
            self._servers[server_id] = server     # keep the fallback fresh
            return server
        if server_id in self._servers:
            return self._servers[server_id]
        raise KeyError(f"nemesis has never seen server {server_id!r}")

    def _apply_slow(self, server, server_id: str) -> None:
        """(Re)apply the compounded product of every active slow factor."""
        base = self._saved_fabric[server_id]
        factor = 1.0
        for f in self._slow_factors[server_id]:
            factor *= f
        server.fabric.config = dataclasses.replace(
            base, rdma_bw=base.rdma_bw / factor,
            rpc_bw=base.rpc_bw / factor)

    # ------------------------------------------------------------- inject
    def _inject(self, spec: FaultSpec, beat: int, now_s: float) -> None:
        server = self._server(spec.server_id)
        sid = spec.server_id
        key = (spec.kind, sid)
        if spec.kind == "kill":
            server.crash(after_batches=spec.after_batches)
        elif spec.kind == "slow":
            if sid not in self._saved_fabric:
                self._saved_fabric[sid] = server.fabric.config
            self._slow_factors.setdefault(sid, []).append(spec.factor)
            self._apply_slow(server, sid)
        else:  # partition
            if (self.admission is None
                    or sid not in getattr(self.admission, "shards", {})):
                # the shard is absent (absorbed by an evict, or no sharded
                # controller at all): nothing was injected, so nothing is
                # recorded — no phantom faults in the active set/timeline
                return
            if self._refcount.get(key, 0) == 0:
                self.admission.partition(sid)
        self._refcount[key] = self._refcount.get(key, 0) + 1
        self.active[spec] = self.active.get(spec, 0) + 1
        self.timeline.append((beat, "inject", spec.kind, sid))
        self.coordinator.notify("nemesis.inject", server_id=sid,
                                now_s=now_s, fault=spec.kind,
                                stop_beat=spec.stop_beat)

    # --------------------------------------------------------------- heal
    def _heal(self, spec: FaultSpec, beat: int, now_s: float) -> None:
        if self.active.get(spec, 0) <= 0:
            return
        sid = spec.server_id
        key = (spec.kind, sid)
        server = self._server(sid)
        remaining = self._refcount.get(key, 1) - 1
        if spec.kind == "kill":
            if remaining <= 0:
                server.restore()
        elif spec.kind == "slow":
            factors = self._slow_factors.get(sid, [])
            try:
                factors.remove(spec.factor)
            except ValueError:
                pass
            if factors:
                self._apply_slow(server, sid)    # others still in force
            else:
                self._slow_factors.pop(sid, None)
                saved = self._saved_fabric.pop(sid, None)
                if saved is not None:
                    server.fabric.config = saved
        else:  # partition
            if remaining <= 0 and self.admission is not None:
                rejoin = getattr(self.admission, "rejoin", None)
                if (rejoin is not None
                        and sid in getattr(self.admission, "shards", {})):
                    rejoin(sid)
        self._refcount[key] = max(0, remaining)
        self.active[spec] -= 1
        if self.active[spec] <= 0:
            del self.active[spec]
        self.timeline.append((beat, "heal", spec.kind, sid))
        self.coordinator.notify("nemesis.heal", server_id=sid,
                                now_s=now_s, fault=spec.kind)


def seeded_schedule(seed: int, server_ids: list[str] | tuple[str, ...],
                    beats: int, faults: int = 3,
                    kinds: tuple[str, ...] = KINDS,
                    min_duration: int = 2,
                    max_duration: int = 4) -> tuple[FaultSpec, ...]:
    """A deterministic random schedule: ``faults`` specs drawn from
    ``seed``, each targeting one server for a bounded window whose
    ``stop_beat`` never exceeds ``beats`` — a fault the run cannot heal
    would silently become permanent. Same arguments → same schedule,
    always (the clamp keeps the draw sequence identical, so seeds that
    already fit produce the exact schedules they always did)."""
    if beats < min_duration + 1:
        raise ValueError(
            f"beats={beats} cannot fit a fault of min_duration="
            f"{min_duration} (faults start at beat 1)")
    rng = random.Random(seed)
    ids = sorted(server_ids)
    specs = []
    for _ in range(faults):
        kind = rng.choice(list(kinds))
        sid = rng.choice(ids)
        duration = rng.randint(min_duration, max_duration)
        start = rng.randint(1, max(1, beats - duration - 1))
        duration = min(duration, beats - start)   # clamp to the window
        specs.append(FaultSpec(kind, sid, start, stop_beat=start + duration))
    return tuple(specs)
