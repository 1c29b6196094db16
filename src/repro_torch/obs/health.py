# Copy of src/repro/obs/health.py, kept numpy-only; change both copies together.
"""Cluster health monitor: a per-server state machine over existing signals.

The stack already produces everything a health verdict needs — it just
never reads it in one place. Per server, in modeled time:

* ``sched.RateHistory`` — EWMA transport rates, flap counts, and the
  authoritative quarantine decision (``quarantined(sid)``);
* ``qos.distributed`` shards — grant/denial/decline/borrow counters;
* ``cluster.BufferPool`` — registered-memory residency and evictions
  (cluster-wide pressure: registered memory is a shared resource);
* stream fault/resume and park counts, fed as events through
  ``ClusterCoordinator.notify``.

``HealthMonitor.heartbeat(now_s)`` samples those sources and drives each
server through ``healthy → degraded → suspect → quarantined``:

* **escalation is immediate** — the first heartbeat that sees a worse
  signal jumps straight to the matching state;
* **recovery is hysteretic** — a server must post ``recover_heartbeats``
  consecutive clean heartbeats to step *one* level back down, so a flapping
  signal cannot flap the health state at heartbeat rate;
* **quarantine is mirrored, not re-derived** — while the bound
  ``RateHistory`` quarantines a server the monitor reports ``quarantined``,
  and the heartbeat after the history lifts it the monitor steps it down to
  ``suspect`` (then recovers through hysteresis). The monitor's own
  fault-storm rule (``fault_quarantine`` stream faults inside one heartbeat
  window) is the only other path into ``quarantined``, so in fault-free
  runs the monitor's quarantine verdicts are exactly the history's.

Every transition is a frozen :class:`HealthTransition` (the ``PerfEvent``
discipline from ``obs/events.py``), appended to ``transitions`` and echoed
into an attached ``FlightRecorder``. Like the rest of ``repro.obs`` the
module imports nothing from the layers it watches — every source is bound
duck-typed via :meth:`HealthMonitor.bind`.
"""
from __future__ import annotations

import dataclasses

HEALTHY = "healthy"
DEGRADED = "degraded"
SUSPECT = "suspect"
QUARANTINED = "quarantined"

#: severity order, worst last
STATES = (HEALTHY, DEGRADED, SUSPECT, QUARANTINED)
_LEVEL = {s: i for i, s in enumerate(STATES)}


@dataclasses.dataclass
class HealthConfig:
    """Thresholds for one heartbeat's verdict (all in per-window deltas)."""

    rate_ratio_degraded: float = 2.0   # EWMA worse than fleet median by this
    flaps_suspect: int = 1             # new flap records in the window
    faults_suspect: int = 1            # stream fault-resumes in the window
    fault_quarantine: int = 3          # fault storm: monitor-own quarantine
    denials_degraded: int = 1          # new shard stream/total/memory denials
    declines_degraded: int = 1         # new thief-side steal declines
    pool_pressure_degraded: float = 0.9  # resident/max_bytes fraction
    recover_heartbeats: int = 2        # clean beats per one-level step-down


@dataclasses.dataclass
class ServerHealth:
    """One server's current verdict plus the window counters behind it."""

    server_id: str
    state: str = HEALTHY
    since_s: float = 0.0               # modeled time of the last transition
    clean_streak: int = 0              # consecutive clean heartbeats
    transitions: int = 0
    # window counters (reset every heartbeat)
    window_faults: int = 0
    window_parks: int = 0
    window_declines: int = 0
    # latest sampled signals (for reporting)
    rate_s: float | None = None
    flaps: int = 0
    faults: int = 0
    denials: int = 0
    declines: int = 0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class HealthTransition:
    """Typed health-state-change event (same discipline as ``PerfEvent``)."""

    kind: str                          # "escalate" | "recover"
    server_id: str
    frm: str
    to: str
    now_s: float
    reason: str = ""
    detail: str = ""

    @property
    def is_escalation(self) -> bool:
        return _LEVEL[self.to] > _LEVEL[self.frm]

    def __str__(self) -> str:
        arrow = "^" if self.is_escalation else "v"
        why = f" ({self.reason})" if self.reason else ""
        return (f"[health:{self.kind}] {self.server_id} {self.frm} -> "
                f"{self.to} {arrow} at {self.now_s * 1e3:.3f}ms{why}")


class HealthMonitor:
    """Heartbeat-driven per-server health, sourced from bound subsystems."""

    def __init__(self, config: HealthConfig | None = None,
                 recorder=None) -> None:
        self.config = config or HealthConfig()
        self.recorder = recorder
        self.servers: dict[str, ServerHealth] = {}
        self.transitions: list[HealthTransition] = []
        self.heartbeats = 0
        self.pool_pressure = 0.0       # latest resident/max_bytes fraction
        # sources (all optional, duck-typed)
        self._history = None           # sched.RateHistory
        self._admission = None         # qos.distributed.ShardedAdmission
        self._pool = None              # cluster.BufferPool
        # last-seen cumulative counters, for per-window deltas
        self._seen_flaps: dict[str, int] = {}
        self._seen_denials: dict[str, int] = {}
        self._seen_evictions = 0

    def bind(self, history=None, admission=None, pool=None) -> "HealthMonitor":
        """Attach signal sources; returns self for chaining. Only the
        sources passed are (re)bound."""
        if history is not None:
            self._history = history
        if admission is not None:
            self._admission = admission
        if pool is not None:
            self._pool = pool
        return self

    # -- event feed (via ClusterCoordinator.notify) -----------------------

    def observe_event(self, kind: str, server_id: str | None,
                      now_s: float) -> None:
        """Count per-window occurrences of the event kinds health cares
        about. Unknown kinds are ignored — the recorder keeps them."""
        if not server_id:
            return
        h = self._server(server_id)
        if kind in ("stream.fault", "stream.resume", "stream.migrate"):
            # a migration is attributed to the server the lease *left* —
            # the strongest per-window evidence that server is gone
            h.window_faults += 1
            h.faults += 1
        elif kind in ("stream.park", "scan.park"):
            h.window_parks += 1
        elif kind == "steal.decline":
            h.window_declines += 1
            h.declines += 1

    # -- heartbeat --------------------------------------------------------

    def heartbeat(self, now_s: float) -> list[HealthTransition]:
        """Sample every bound source and advance each server's state.
        Returns the transitions this heartbeat produced."""
        self.heartbeats += 1
        self._sample_pool()
        fleet = self._fleet_rates()
        median_rate = _median([r for r in fleet.values() if r is not None])
        fired: list[HealthTransition] = []

        for sid in self._known_servers():
            h = self._server(sid)
            h.rate_s = fleet.get(sid)
            target, reason = self._verdict(h, median_rate)
            fired.extend(self._advance(h, target, reason, now_s))
            # close the window
            h.window_faults = 0
            h.window_parks = 0
            h.window_declines = 0
        return fired

    def _verdict(self, h: ServerHealth, median_rate: float | None):
        """(worst deserved state, reason) from this window's signals."""
        cfg = self.config
        sid = h.server_id
        if self._history is not None and self._history.quarantined(sid):
            return QUARANTINED, "rate-history quarantine"
        if h.window_faults >= cfg.fault_quarantine:
            return QUARANTINED, f"fault storm ({h.window_faults}/window)"

        flaps_delta = 0
        if self._history is not None:
            rec = self._history.servers.get(sid)
            flaps = rec.flaps if rec is not None else 0
            flaps_delta = flaps - self._seen_flaps.get(sid, 0)
            self._seen_flaps[sid] = flaps
            h.flaps = flaps
        if flaps_delta >= cfg.flaps_suspect:
            return SUSPECT, f"{flaps_delta} new flap(s)"
        if h.window_faults >= cfg.faults_suspect:
            return SUSPECT, f"{h.window_faults} stream fault(s)"

        denials_delta = self._denials_delta(sid, h)
        if denials_delta >= cfg.denials_degraded:
            return DEGRADED, f"{denials_delta} admission denial(s)"
        if h.window_declines >= cfg.declines_degraded:
            return DEGRADED, f"{h.window_declines} steal decline(s)"
        if (h.rate_s is not None and median_rate is not None
                and median_rate > 0.0
                and h.rate_s > cfg.rate_ratio_degraded * median_rate):
            return DEGRADED, (f"rate {h.rate_s * 1e6:.0f}us/batch > "
                              f"{cfg.rate_ratio_degraded:g}x fleet median")
        if self.pool_pressure > cfg.pool_pressure_degraded:
            return DEGRADED, (f"pool pressure "
                              f"{self.pool_pressure:.2f} resident/budget")
        return HEALTHY, ""

    def _advance(self, h: ServerHealth, target: str, reason: str,
                 now_s: float) -> list[HealthTransition]:
        cur, tgt = _LEVEL[h.state], _LEVEL[target]
        if tgt > cur:
            h.clean_streak = 0
            return [self._transition(h, target, reason, now_s, "escalate")]
        if tgt == cur:
            h.clean_streak = 0
            if reason:
                h.reason = reason
            return []
        # target is better than current: recover
        if h.state == QUARANTINED:
            # quarantine mirrors the source; the beat it lifts, drop to
            # suspect immediately (an ex-quarantined server is not trusted
            # yet) and let hysteresis take it the rest of the way down.
            h.clean_streak = 0
            down = STATES[max(tgt, _LEVEL[SUSPECT])]
            return [self._transition(h, down, "quarantine lifted", now_s,
                                     "recover")]
        h.clean_streak += 1
        if h.clean_streak < self.config.recover_heartbeats:
            return []
        h.clean_streak = 0
        down = STATES[cur - 1]
        return [self._transition(
            h, down, f"{self.config.recover_heartbeats} clean heartbeats",
            now_s, "recover")]

    def _transition(self, h: ServerHealth, to: str, reason: str,
                    now_s: float, kind: str) -> HealthTransition:
        tr = HealthTransition(kind=kind, server_id=h.server_id, frm=h.state,
                              to=to, now_s=now_s, reason=reason)
        h.state = to
        h.since_s = now_s
        h.reason = reason
        h.transitions += 1
        self.transitions.append(tr)
        if self.recorder is not None:
            self.recorder.record("health." + kind, now_s=now_s,
                                 server_id=h.server_id, frm=tr.frm, to=to,
                                 reason=reason)
        return tr

    # -- signal sampling --------------------------------------------------

    def _sample_pool(self) -> None:
        pool = self._pool
        if pool is None:
            return
        max_bytes = getattr(pool, "max_bytes", None)
        resident = getattr(getattr(pool, "stats", None), "bytes_resident", 0)
        self.pool_pressure = (resident / max_bytes
                              if max_bytes else 0.0)

    def _fleet_rates(self) -> dict[str, float | None]:
        if self._history is None:
            return {}
        return {sid: rec.rate_s
                for sid, rec in self._history.servers.items()}

    def _denials_delta(self, sid: str, h: ServerHealth) -> int:
        if self._admission is None:
            return 0
        shard = getattr(self._admission, "shards", {}).get(sid)
        if shard is None:
            return 0
        s = shard.stats
        total = (getattr(s, "stream_denials", 0)
                 + getattr(s, "total_denials", 0)
                 + getattr(s, "memory_denials", 0))
        delta = total - self._seen_denials.get(sid, 0)
        self._seen_denials[sid] = total
        h.denials = total
        return delta

    def _known_servers(self) -> list[str]:
        ids = set(self.servers)
        if self._history is not None:
            ids.update(self._history.servers)
        if self._admission is not None:
            ids.update(getattr(self._admission, "shards", {}))
        return sorted(ids)

    def _server(self, server_id: str) -> ServerHealth:
        if server_id not in self.servers:
            self.servers[server_id] = ServerHealth(server_id=server_id)
        return self.servers[server_id]

    # -- read side --------------------------------------------------------

    def state(self, server_id: str) -> str:
        h = self.servers.get(server_id)
        return h.state if h is not None else HEALTHY

    def states(self) -> dict[str, str]:
        return {sid: h.state for sid, h in sorted(self.servers.items())}

    def snapshot(self) -> dict:
        """Plain-data view for postmortems and ``report.health_table``."""
        return {
            "heartbeats": self.heartbeats,
            "pool_pressure": self.pool_pressure,
            "servers": {
                sid: {
                    "state": h.state,
                    "since_s": h.since_s,
                    "reason": h.reason,
                    "rate_us_per_batch": (h.rate_s * 1e6
                                          if h.rate_s is not None else None),
                    "flaps": h.flaps,
                    "faults": h.faults,
                    "denials": h.denials,
                    "declines": h.declines,
                    "transitions": h.transitions,
                }
                for sid, h in sorted(self.servers.items())
            },
        }


def _median(vals: list[float]) -> float | None:
    if not vals:
        return None
    vs = sorted(vals)
    mid = len(vs) // 2
    if len(vs) % 2:
        return vs[mid]
    return 0.5 * (vs[mid - 1] + vs[mid])
