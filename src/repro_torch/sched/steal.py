# Copy of src/repro/sched/steal.py, kept numpy-only; change both copies together.
"""Work stealing: move a straggler's remaining batch range mid-scan.

The cluster dataplane executes a :class:`~repro.cluster.plan.ScanPlan`
statically — once the planner has dealt batch ranges to replicas, a lagging
endpoint drags the whole critical path while faster replicas sit idle after
draining their slices. On fast fabrics that scheduling gap, not the wire, is
the bottleneck (Rödiger et al., arXiv:1502.07169). This module closes it:

* :class:`ProgressTracker` watches every stream's **modeled clock** during
  the drive loop and projects a finish time (ETA) from its observed
  per-batch rate and remaining bounded range;
* when a stream's ETA exceeds the fleet median by ``StealConfig.factor``,
  :class:`StealingPuller` splits the victim's remaining
  ``(start_batch, end_batch)`` range at the current lease boundary
  (:meth:`StreamPuller.split`) and re-leases the tail to the **fastest idle
  replica** via a fresh ``init_scan(start_batch=…)`` lease;
* every move is recorded as a :class:`StealEvent` on the scan's
  :class:`~repro.cluster.streams.ClusterStats`.

With a :class:`RateHistory` attached the decisions become *stateful* —
informed by transport progress across scans AND by the admission layer:

* **hysteresis** — the history keeps an EWMA per-server rate and a count of
  past steals. A repeat straggler is stolen from *earlier*: its per-victim
  steal factor decays by ``repeat_decay`` per recorded steal (floored at
  ``min_factor``), so the static ``StealConfig.factor`` is only the
  first-offense threshold.
* **flap quarantine** — a server whose observed per-lease rate reverses
  direction by more than ``flap_ratio`` (fast→slow→fast, or the mirror) is
  flapping; it is quarantined from being a steal **victim or thief** for
  ``quarantine_rounds`` lease rounds — stealing from (or onto) a link that
  is about to flip back is churn, not progress.
* **shard-aware declines** — before re-leasing a tail, the thief's
  admission shard is asked for local
  :meth:`~repro.qos.distributed.ShardedAdmission.headroom`
  (via :meth:`ClusterCoordinator.admission_headroom`). A thief whose shard
  is at its local quota *declines* (a ``kind="decline"`` event) and the
  tracker offers the tail to the next-fastest idle replica — stealing onto
  a saturated shard trades a transport stall for an admission stall. A
  declined shard is retried only after a freed-slot event says it drained.
* **re-steal** — every steal is remembered; if the thief's observed rate
  later degrades past the victim's recovered rate (by ``resteal_margin``),
  the victim reclaims the remaining tail at the thief's next lease boundary
  (a ``kind="re_steal"`` event). One re-steal per stolen range, ever — the
  bound that makes victim↔thief ping-pong impossible.

With ``history=None`` every stateful path is disabled and the puller is
event-for-event identical to the static-factor behavior (the conformance
suite replays a recorded straggler trace against both).

Stealing requires ``replica`` placement — only a server holding a full copy
can serve an arbitrary batch range. Shard plans pass through untouched.

Modeled-time bookkeeping: a stolen stream does not start at t=0. Its
``StreamStats.start_s`` is seeded with the steal epoch — the moment its
thief server went idle (it cannot start earlier) — so
``ClusterStats.modeled_critical_path_s`` stays an honest makespan.
"""
from __future__ import annotations

import dataclasses
import heapq
import weakref
from typing import Iterator

from ..cluster.plan import Endpoint
from ..cluster.streams import (MultiStreamPuller, StreamPuller,
                               notify_coordinator)


@dataclasses.dataclass(frozen=True)
class StealEvent:
    """One range-migration decision, for the audit trail in ``ClusterStats``.

    ``kind`` distinguishes the three decisions: ``"steal"`` (a range moved
    to an idle replica), ``"decline"`` (a candidate thief's admission shard
    had no local headroom; nothing moved), ``"re_steal"`` (the original
    victim reclaimed a degraded thief's remaining tail). ``server_id`` is
    the *shard* the decision lands on — the thief's shard for a steal, the
    declining shard for a decline, the reclaiming victim's shard for a
    re-steal — so report tables can attribute migrations per shard.
    """

    victim: str              # server_id the range was taken from
    thief: str               # server_id it was re-leased to
    start_batch: int         # first stolen global batch index
    num_batches: int
    epoch_s: float           # modeled time the stolen stream started
    victim_eta_s: float      # victim's projected finish before the steal
    median_eta_s: float      # fleet median ETA at the decision
    kind: str = "steal"      # "steal" | "decline" | "re_steal"
    server_id: str = ""      # shard attribution (see class docstring)


@dataclasses.dataclass(frozen=True)
class StealConfig:
    """When and how aggressively to move work.

    ``factor`` is the straggler threshold: steal when a stream's projected
    finish exceeds the fleet median projection by this multiple. ``2.0`` is
    conservative (a replica must be twice as late as the median); lower it
    toward 1 for eager rebalancing, at the cost of more split/lease churn.
    With a :class:`RateHistory` it is the *first-offense* threshold — the
    history decays it per recorded steal of the same server.
    """

    factor: float = 2.0
    min_batches: int = 2       # never move a tail smaller than this
    max_steals: int = 16       # per scan — runaway-split guard
    steal_headroom_min: int = 1   # thief shard must hold >= this many free
    #                               admission slots or the steal is declined
    resteal_margin: float = 1.2   # thief must be this much slower than the
    #                               recovered victim before a re-steal

    def __post_init__(self) -> None:
        if self.factor < 1.0:
            raise ValueError("steal factor must be >= 1.0")
        if self.min_batches < 1:
            raise ValueError("min_batches must be >= 1")
        if self.steal_headroom_min < 1:
            raise ValueError("steal_headroom_min must be >= 1")
        if self.resteal_margin < 1.0:
            raise ValueError("resteal_margin must be >= 1.0")


# --------------------------------------------------------------- rate history
@dataclasses.dataclass
class ServerRateStats:
    """One server's persistent transport-rate record."""

    rate_s: float | None = None        # EWMA modeled seconds per batch
    last_rate_s: float | None = None   # previous instantaneous observation
    last_dir: int = 0                  # sign of the last significant move
    observations: int = 0
    flaps: int = 0                     # direction reversals past flap_ratio
    steals_from: int = 0               # times this server was a steal victim
    quarantined_until: int = -1        # lease round the quarantine lifts at


class RateHistory:
    """Per-server EWMA rate + flap record, persisted across scans.

    The :class:`StealingPuller` feeds it one observation per lease — the
    *instantaneous* modeled seconds/batch of that lease — and ticks a lease
    round. The EWMA smooths the straggler signal across scans (a new scan
    starts with last scan's verdicts instead of a cold tracker); the
    instantaneous sequence drives flap detection: a move of more than
    ``flap_ratio`` in one direction followed by one in the other is a flap,
    and the server is quarantined for exactly ``quarantine_rounds`` lease
    rounds from being a steal victim *or* thief.
    """

    def __init__(self, alpha: float = 0.3, flap_ratio: float = 2.0,
                 quarantine_rounds: int = 16, repeat_decay: float = 0.75,
                 min_factor: float = 1.1):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if flap_ratio <= 1.0:
            raise ValueError("flap_ratio must be > 1.0")
        if quarantine_rounds < 1:
            raise ValueError("quarantine_rounds must be >= 1")
        if not 0.0 < repeat_decay <= 1.0:
            raise ValueError("repeat_decay must be in (0, 1]")
        if min_factor < 1.0:
            raise ValueError("min_factor must be >= 1.0")
        self.alpha = alpha
        self.flap_ratio = flap_ratio
        self.quarantine_rounds = quarantine_rounds
        self.repeat_decay = repeat_decay
        self.min_factor = min_factor
        self.round = 0
        self.servers: dict[str, ServerRateStats] = {}

    def server(self, server_id: str) -> ServerRateStats:
        if server_id not in self.servers:
            self.servers[server_id] = ServerRateStats()
        return self.servers[server_id]

    # ---------------------------------------------------------- observation
    def observe(self, server_id: str, rate_s: float) -> None:
        """Fold one instantaneous per-lease rate into the server's record."""
        if rate_s <= 0:
            return
        h = self.server(server_id)
        h.observations += 1
        h.rate_s = (rate_s if h.rate_s is None
                    else h.rate_s + self.alpha * (rate_s - h.rate_s))
        if h.last_rate_s is not None:
            if rate_s > h.last_rate_s * self.flap_ratio:
                direction = 1                       # got slower, sharply
            elif rate_s * self.flap_ratio < h.last_rate_s:
                direction = -1                      # got faster, sharply
            else:
                direction = 0
            if direction and h.last_dir and direction != h.last_dir:
                h.flaps += 1
                h.quarantined_until = self.round + self.quarantine_rounds
            if direction:
                h.last_dir = direction
        h.last_rate_s = rate_s

    def tick(self) -> None:
        """Advance one lease round (quarantines are counted in these)."""
        self.round += 1

    # ------------------------------------------------------------- verdicts
    def rate_for(self, server_id: str) -> float | None:
        h = self.servers.get(server_id)
        return h.rate_s if h is not None else None

    def quarantined(self, server_id: str) -> bool:
        h = self.servers.get(server_id)
        return h is not None and self.round < h.quarantined_until

    def record_steal(self, server_id: str) -> None:
        self.server(server_id).steals_from += 1

    def factor_for(self, server_id: str, base_factor: float) -> float:
        """Per-victim steal threshold: the static factor decayed once per
        recorded steal of this server, floored at ``min_factor`` — repeat
        stragglers are stolen from earlier."""
        h = self.servers.get(server_id)
        n = h.steals_from if h is not None else 0
        return max(self.min_factor, base_factor * self.repeat_decay ** n)

    # ---------------------------------------------------------------- stats
    @property
    def total_flaps(self) -> int:
        return sum(h.flaps for h in self.servers.values())

    @property
    def total_steals(self) -> int:
        return sum(h.steals_from for h in self.servers.values())


class ProgressTracker:
    """Projects per-stream finish times from modeled clocks.

    All arithmetic is on ``StreamStats.modeled_wire_s`` (a pure function of
    bytes/segments/ops), so straggler detection is deterministic under any
    machine load — the same trick ``modeled_critical_path_s`` uses.
    """

    def __init__(self, config: StealConfig | None = None,
                 history: RateHistory | None = None):
        self.config = config or StealConfig()
        self.history = history

    @staticmethod
    def finish_s(puller: StreamPuller) -> float:
        """Modeled time at which this stream is (or was) done pulling."""
        return puller.stats.start_s + puller.stats.modeled_wire_s

    def rate_s(self, puller: StreamPuller) -> float | None:
        """Observed modeled seconds per batch; ``None`` before first batch."""
        s = puller.stats
        return s.modeled_wire_s / s.batches if s.batches > 0 else None

    def eta_s(self, puller: StreamPuller) -> float | None:
        """Projected finish: progress so far plus remaining batches at the
        observed rate. ``None`` when unmeasurable (no batches yet) or
        unbounded (no known remaining range)."""
        if puller.drained:
            return self.finish_s(puller)
        rate, remaining = self.rate_s(puller), puller.remaining
        if rate is None or remaining is None:
            return None
        return self.finish_s(puller) + remaining * rate

    def victim_factor(self, server_id: str) -> float:
        """The steal threshold for this victim: static without history,
        decayed per recorded steal with it (repeat-straggler hysteresis)."""
        if self.history is None:
            return self.config.factor
        return self.history.factor_for(server_id, self.config.factor)

    def find_straggler(self, pullers: list[StreamPuller]
                       ) -> tuple[int, float, float] | None:
        """The stream to steal from, or ``None`` if the fleet is balanced.

        Returns ``(victim_index, victim_eta, median_eta)``. A victim must be
        live, bounded, measurable, owe at least ``min_batches``, project
        past its per-victim factor × the fleet median ETA, and (with a
        history) not be quarantined for flapping.
        """
        etas = [self.eta_s(p) for p in pullers]
        known = sorted(e for e in etas if e is not None)
        if len(known) < 2:
            return None
        median = known[(len(known) - 1) // 2]
        victim, victim_eta = None, 0.0
        for idx, (p, eta) in enumerate(zip(pullers, etas)):
            if (eta is None or p.drained or p.parked
                    or (p.remaining or 0) < self.config.min_batches):
                continue
            if (self.history is not None
                    and self.history.quarantined(p.endpoint.server_id)):
                continue
            if eta > victim_eta:
                victim, victim_eta = idx, eta
        if victim is None:
            return None
        factor = self.victim_factor(pullers[victim].endpoint.server_id)
        if victim_eta <= factor * max(median, 1e-30):
            return None
        return victim, victim_eta, median


@dataclasses.dataclass
class _StealRecord:
    """Live bookkeeping for one executed steal (drives re-steal)."""

    thief_idx: int           # index of the thief's puller in self.pullers
    victim_sid: str          # original victim server
    thief_sid: str
    re_stolen: bool = False  # the one-re-steal-per-range bound


class StealingPuller(MultiStreamPuller):
    """A first-ready multi-stream drive that rebalances between leases.

    Drop-in for :class:`~repro.cluster.streams.MultiStreamPuller`: same
    batches, same streaming contract, plus work stealing. Consumers that
    index per-stream output by stream id must size for growth — stolen
    streams append pullers past the original plan width (the qos gateway
    reassembles by endpoint range, so it is unaffected).

    ``history`` (a :class:`RateHistory`, usually owned by the
    :class:`~repro.sched.scheduler.AdaptiveScheduler` so it persists across
    scans) turns on hysteresis, flap quarantine and re-steal; shard-aware
    declines only need the coordinator's admission controller to answer
    ``headroom`` queries (see :meth:`ClusterCoordinator.admission_headroom`).
    """

    def __init__(self, coordinator, plan, steal: StealConfig | None = None,
                 history: RateHistory | None = None, **kwargs):
        kwargs.setdefault("schedule", "first_ready")
        super().__init__(coordinator, plan, **kwargs)
        self.history = history
        self.tracker = ProgressTracker(steal, history=history)
        self._stealable = (plan.placement == "replica")
        self._records: list[_StealRecord] = []
        self._declined: set[str] = set()    # shards declined until they drain
        self._observed: dict[int, tuple[float, int]] = {}  # idx -> wire,batches
        self._release_cb = None
        self._release_admission = None
        admission = getattr(coordinator, "admission", None)
        if (self._stealable and admission is not None
                and hasattr(admission, "headroom")
                and hasattr(admission, "subscribe_release")):
            # freed-slot hook: a declined shard becomes a candidate again
            # the moment a slot on it drains. Subscribed through a weakref
            # (a long-lived controller must not pin a dead puller) and
            # unsubscribed when the drive loop ends (_abandon) — one scan's
            # scheduler must not leave a callback behind on a controller
            # that outlives thousands of scans.
            ref = weakref.ref(self)

            def _on_release(server_id=None, client_id=None, now_s=None,
                            _ref=ref):
                puller = _ref()
                if puller is not None and server_id is not None:
                    puller._declined.discard(server_id)

            admission.subscribe_release(_on_release)
            self._release_cb = _on_release
            self._release_admission = admission

    def _abandon(self) -> None:
        super()._abandon()
        # the scan is over (drained, abandoned, or failed mid-open):
        # retire the freed-slot subscription. Idempotent — _abandon can run
        # more than once, and the base __init__ error path reaches here
        # before this subclass's fields exist.
        cb = getattr(self, "_release_cb", None)
        if cb is not None:
            unsubscribe = getattr(self._release_admission,
                                  "unsubscribe_release", None)
            if unsubscribe is not None:
                unsubscribe(cb)
            self._release_cb = None

    @staticmethod
    def _modeled_clock(puller: StreamPuller) -> float:
        """Stream progress on the *modeled* timeline only. The drive loop
        must sequence leases (and therefore steal decisions) by modeled
        time — the measured components of ``clock_s`` (host memcpy wall
        time) are similar across streams and would mask the very lag the
        tracker is looking for."""
        s = puller.stats
        return (s.start_s + s.modeled_wire_s + s.control_rpc_s
                + s.throttle_wait_s)

    # ----------------------------------------------------------- drive loop
    def _drive(self):
        try:
            heap = [(0.0, idx) for idx in range(len(self.pullers))]
            heapq.heapify(heap)
            while heap:
                _, idx = heapq.heappop(heap)
                yield from self._lease(idx)
                self._observe(idx)
                puller = self.pullers[idx]
                if not puller.drained:
                    heapq.heappush(heap, (self._modeled_clock(puller), idx))
                for new_idx in self._rebalance():
                    thief = self.pullers[new_idx]
                    heapq.heappush(
                        heap, (self._modeled_clock(thief), new_idx))
        finally:
            self._abandon()

    # ------------------------------------------------------------- stealing
    def _observe(self, idx: int) -> None:
        """Feed the history one instantaneous per-lease rate observation and
        tick the lease round (quarantine's unit of time)."""
        if self.history is None:
            return
        puller = self.pullers[idx]
        s = puller.stats
        prev_wire, prev_batches = self._observed.get(idx, (0.0, 0))
        if s.batches > prev_batches:
            rate = (s.modeled_wire_s - prev_wire) / (s.batches - prev_batches)
            self.history.observe(puller.endpoint.server_id, rate)
        self._observed[idx] = (s.modeled_wire_s, s.batches)
        self.history.tick()

    def _migrations(self) -> int:
        """Executed moves so far (declines are free — they moved nothing)."""
        return sum(1 for e in self.steal_events
                   if getattr(e, "kind", "steal") != "decline")

    def _rebalance(self) -> Iterator[int]:
        """One inter-lease scheduling pass: re-steal checks, then the
        straggler check. Yields indices of new pullers for the heap."""
        if not self._stealable:
            return
        yield from self._maybe_resteal()
        yield from self._maybe_steal()

    def _idle_servers(self) -> dict[str, float]:
        """server_id → idle-since epoch for replicas with no live stream of
        this scan. A server never leased by this scan is idle from t=0.
        A crashed process or a health-quarantined server is never idle in
        the thieving sense — re-leasing a tail onto it would just fault the
        tail back off (both checks duck-typed: plain deployments with
        neither crash hooks nor a monitor steal exactly as before)."""
        hosts = self.coordinator.hosts(self.plan.dataset)
        busy = {p.endpoint.server_id for p in self.pullers if not p.drained}
        monitor = getattr(self.coordinator, "health", None)
        state = getattr(monitor, "state", None) if monitor is not None \
            else None
        idle: dict[str, float] = {}
        for sid, server in hosts.items():
            if sid in busy:
                continue
            if getattr(server, "crashed", False):
                continue
            if state is not None and state(sid) == "quarantined":
                continue
            drained = [p for p in self.pullers
                       if p.endpoint.server_id == sid and p.drained]
            idle[sid] = max((self.tracker.finish_s(p) for p in drained),
                            default=0.0)
        return idle

    def _server_rate(self, server_id: str) -> float | None:
        """Observed per-batch modeled rate of a server's drained streams."""
        rates = [self.tracker.rate_s(p) for p in self.pullers
                 if p.endpoint.server_id == server_id
                 and p.stats.batches > 0]
        rates = [r for r in rates if r is not None]
        return min(rates) if rates else None

    def _thief_rate(self, server_id: str) -> float | None:
        """A candidate thief's modeled rate. With a history, its EWMA wins:
        the scan-local view is the *minimum* over drained streams, which
        goes stale the moment a server degrades mid-scan (exactly the
        server re-steal exists for), while the EWMA tracks the drift.
        Without one, the scan-local observation is all there is."""
        if self.history is not None:
            rate = self.history.rate_for(server_id)
            if rate is not None:
                return rate
        return self._server_rate(server_id)

    def _spawn(self, endpoint: Endpoint, like: StreamPuller,
               epoch_s: float) -> StreamPuller | None:
        """Open a re-leased stream mirroring the source stream's transport
        options; ``None`` when admission denies the extra lease."""
        stream_trace = self._stream_trace(len(self.pullers), endpoint)
        try:
            puller = StreamPuller(self.coordinator, endpoint, pool=self.pool,
                                  max_resumes=like.max_resumes,
                                  prefetch=like.prefetch,
                                  client_id=like.client_id,
                                  trace=stream_trace)
        except Exception:
            return None
        puller.stats.start_s = epoch_s
        if stream_trace is not None:
            # place the thief's local clock at its spawn epoch on the scan
            # timeline — its spans shift as a group at commit
            self.trace.set_shift(stream_trace.group, epoch_s)
        return puller

    def _trace_instant(self, name: str, at_s: float, **args) -> None:
        """A steal-decision instant on the scan-level track (scan-relative
        timeline: shifted by the gateway's grant clock at commit)."""
        if self.trace is not None:
            self.trace.instant(name, at_s, cat="steal", group="scan", **args)

    def _maybe_steal(self) -> Iterator[int]:
        """Run one straggler check; yields indices of new (thief) pullers."""
        if self._migrations() >= self.tracker.config.max_steals:
            return
        found = self.tracker.find_straggler(self.pullers)
        if found is None:
            return
        victim_idx, victim_eta, median_eta = found
        victim = self.pullers[victim_idx]
        victim_sid = victim.endpoint.server_id
        idle = self._idle_servers()
        if self.history is not None:
            # a flapping server may not thieve either: its rate estimate is
            # exactly as untrustworthy as when it was the victim
            idle = {sid: t for sid, t in idle.items()
                    if not self.history.quarantined(sid)}
        if not idle:
            return                       # nobody free to take the tail
        rate_v = self.tracker.rate_s(victim)
        # fastest idle replica first: best observed rate, unmeasured last
        order = sorted(idle, key=lambda sid: (self._thief_rate(sid) is None,
                                              self._thief_rate(sid) or 0.0,
                                              sid))
        for thief_sid in order:
            if thief_sid in self._declined:
                continue                 # declined; waiting on a freed slot
            headroom = self.coordinator.admission_headroom(thief_sid,
                                                           victim.client_id)
            if (headroom is not None
                    and headroom < self.tracker.config.steal_headroom_min):
                # thief's shard is at/near its local quota: stealing onto
                # it would trade the transport stall for an admission stall.
                # Decline, remember, and offer the next-fastest replica;
                # the freed-slot hook re-opens this shard when it drains.
                self._declined.add(thief_sid)
                self.steal_events.append(StealEvent(
                    victim=victim_sid, thief=thief_sid,
                    start_batch=(victim.endpoint.start_batch
                                 + victim.delivered),
                    num_batches=victim.remaining,
                    epoch_s=idle[thief_sid], victim_eta_s=victim_eta,
                    median_eta_s=median_eta, kind="decline",
                    server_id=thief_sid))
                self._trace_instant("steal.decline", idle[thief_sid],
                                    victim=victim_sid, thief=thief_sid)
                notify_coordinator(self.coordinator, "steal.decline",
                                   server_id=thief_sid,
                                   now_s=idle[thief_sid], victim=victim_sid,
                                   headroom=headroom)
                continue
            rate_t = self._thief_rate(thief_sid) or rate_v
            remaining = victim.remaining
            # split so victim and thief project to finish together:
            # keep × rate_v ≈ (remaining − keep) × rate_t — but never move
            # a tail smaller than min_batches (the churn floor)
            keep = int(remaining * rate_t / max(rate_v + rate_t, 1e-30))
            keep = min(max(keep, 0),
                       remaining - self.tracker.config.min_batches)
            epoch = max(idle[thief_sid],
                        self.tracker.finish_s(victim))   # detection point
            endpoint = Endpoint(thief_sid, victim.endpoint.sql,
                                victim.endpoint.dataset,
                                start_batch=(victim.endpoint.start_batch
                                             + victim.delivered + keep),
                                max_batches=remaining - keep)
            thief = self._spawn(endpoint, victim, epoch)
            if thief is None:
                return                   # admission denied the extra lease
            victim.split(keep)           # truncate only once the lease holds
            self.steal_events.append(StealEvent(
                victim=victim_sid, thief=thief_sid,
                start_batch=endpoint.start_batch,
                num_batches=endpoint.max_batches,
                epoch_s=epoch, victim_eta_s=victim_eta,
                median_eta_s=median_eta, server_id=thief_sid))
            self._trace_instant("steal", epoch, victim=victim_sid,
                                thief=thief_sid,
                                batches=endpoint.max_batches)
            notify_coordinator(self.coordinator, "steal",
                               server_id=thief_sid, now_s=epoch,
                               victim=victim_sid,
                               batches=endpoint.max_batches)
            self.pullers.append(thief)
            if self.history is not None:
                self.history.record_steal(victim_sid)
                self._records.append(_StealRecord(
                    thief_idx=len(self.pullers) - 1,
                    victim_sid=victim_sid, thief_sid=thief_sid))
            yield len(self.pullers) - 1
            return

    def _maybe_resteal(self) -> Iterator[int]:
        """Victim re-steal: when a thief's observed rate degrades past the
        original victim's recovered rate, the (now idle) victim reclaims the
        whole remaining tail at the thief's current lease boundary. At most
        once per stolen range — a re-stolen range is never re-examined, so
        victim↔thief ping-pong cannot happen."""
        if self.history is None:
            return
        config = self.tracker.config
        for record in self._records:
            if record.re_stolen or self._migrations() >= config.max_steals:
                continue
            thief = self.pullers[record.thief_idx]
            remaining = thief.remaining
            if (thief.drained or thief.parked or remaining is None
                    or remaining < config.min_batches):
                continue
            rate_t = self.tracker.rate_s(thief)
            if rate_t is None:
                continue
            # the victim's *recovered* rate: what its server shows now
            rate_v = self._thief_rate(record.victim_sid)
            if rate_v is None or rate_t <= rate_v * config.resteal_margin:
                continue
            idle = self._idle_servers()
            if (record.victim_sid not in idle
                    or self.history.quarantined(record.victim_sid)):
                continue                 # victim busy (or flapping itself)
            epoch = max(idle[record.victim_sid],
                        self.tracker.finish_s(thief))
            endpoint = Endpoint(record.victim_sid, thief.endpoint.sql,
                                thief.endpoint.dataset,
                                start_batch=(thief.endpoint.start_batch
                                             + thief.delivered),
                                max_batches=remaining)
            back = self._spawn(endpoint, thief, epoch)
            if back is None:
                continue                 # victim's shard denied: tail stays
            thief.split(0)               # thief keeps only what it delivered
            record.re_stolen = True
            self.steal_events.append(StealEvent(
                victim=record.thief_sid, thief=record.victim_sid,
                start_batch=endpoint.start_batch,
                num_batches=endpoint.max_batches, epoch_s=epoch,
                victim_eta_s=self.tracker.eta_s(thief) or epoch,
                median_eta_s=rate_v * remaining, kind="re_steal",
                server_id=record.victim_sid))
            self._trace_instant("steal.re_steal", epoch,
                                victim=record.thief_sid,
                                thief=record.victim_sid,
                                batches=endpoint.max_batches)
            notify_coordinator(self.coordinator, "steal.re_steal",
                               server_id=record.victim_sid, now_s=epoch,
                               victim=record.thief_sid,
                               batches=endpoint.max_batches)
            self.pullers.append(back)
            yield len(self.pullers) - 1
