# Copy of src/repro/qos/distributed.py, kept numpy-only; change both copies together.
"""Distributed admission control: per-server quota shards + reconciliation.

One :class:`~.admission.AdmissionController` is a single process — exactly
the coordination bottleneck the Thallus paper moves off the RDMA data path,
and the reason Flight-scale deployments (arXiv:2204.03032) and RDMA exchange
schedulers (arXiv:1502.07169) shard admission state per server and reconcile
it approximately. This module splits the global budget into per-server
shards and keeps the *global* invariants by construction:

* **shards** — each :class:`AdmissionShard` (one per ``ThallusServer``) owns
  a slice of the per-client stream quota, the global stream cap, and the
  lease token bucket. A grant only ever touches the endpoint's shard — no
  cross-shard lock on the admission fast path.
* **borrowing** — a shard at its local limit borrows bounded slack from the
  least-loaded peer *before* raising :class:`~.admission.Backpressure`.
  Borrows move capacity units between shards conservatively (one shard's
  gain is another's loss), so the cluster-wide quota can never be exceeded:
  for every client, ``sum(shard capacities) == global quota`` at all times.
* **reconciliation** — :meth:`ShardedAdmission.reconcile` runs on the
  modeled clock (periodically via ``reconcile_interval_s``, or explicitly):
  it returns unused borrowed capacity to its lenders, converging back to the
  balanced allocation, and rebalances unused lease tokens between shard
  buckets. Token moves conserve the total — the :class:`ReconcileReport`
  carries before/after sums so tests (and the property suite) can check.
* **partitions** — a shard whose reconciler stops firing
  (:meth:`ShardedAdmission.partition`) degrades to its local reserve: it can
  neither borrow nor lend, so it keeps admitting up to its own capacity and
  can never over-admit. On :meth:`rejoin` the next reconcile rounds fold it
  back into the balanced allocation.

Drop-in: a one-shard :class:`ShardedAdmission` is grant-for-grant,
denial-for-denial, wait-for-wait identical to the centralized controller
(the shard *is* an ``AdmissionController`` with the full budget; the
conformance suite replays recorded op sequences against both). Callers that
know the endpoint pass ``server_id=`` to route; callers that don't are
routed deterministically (least-loaded shard), so the centralized call shape
keeps working.
"""
from __future__ import annotations

import dataclasses

from .admission import (AdmissionConfig, AdmissionController, AdmissionStats,
                        Backpressure)


@dataclasses.dataclass
class DistributedConfig:
    """Knobs for the sharded layer (the admission budget itself lives in
    :class:`~.admission.AdmissionConfig`)."""

    reconcile_interval_s: float = 50e-3   # modeled period of the reconciler
    borrow_limit: int = 4                 # max units a shard holds borrowed

    def __post_init__(self) -> None:
        if self.reconcile_interval_s <= 0:
            raise ValueError("reconcile_interval_s must be > 0")
        if self.borrow_limit < 0:
            raise ValueError("borrow_limit must be >= 0")


@dataclasses.dataclass
class ShardStats(AdmissionStats):
    """One shard's :class:`AdmissionStats` plus the distributed counters."""

    borrows: int = 0             # capacity units borrowed in from peers
    lends: int = 0               # capacity units lent out to peers
    reconciles: int = 0          # rebalance rounds participated in
    tokens_in: float = 0.0       # lease tokens received in rebalances
    tokens_out: float = 0.0      # lease tokens given up in rebalances


@dataclasses.dataclass
class DistributedStats(AdmissionStats):
    """Aggregate over every shard, plus the per-shard breakdown. The
    inherited fields sum the shards', so anything reading a centralized
    controller's ``stats`` (the gateway, the report tables) keeps working."""

    borrows: int = 0
    lends: int = 0
    reconciles: int = 0
    tokens_rebalanced: float = 0.0     # total tokens moved between buckets
    peak_total: int = 0                # cluster-wide concurrent-stream peak
    shards: dict = dataclasses.field(default_factory=dict)  # sid -> ShardStats


@dataclasses.dataclass
class ReconcileReport:
    """What one reconcile round did — and proof it conserved the budget."""

    now_s: float
    participants: tuple[str, ...]
    capacity_returned: int = 0         # borrowed units handed back to lenders
    tokens_moved: float = 0.0          # abs lease tokens shifted into buckets
    tokens_before: float = 0.0         # sum over participants, post-refill
    tokens_after: float = 0.0          # must equal tokens_before


class AdmissionShard(AdmissionController):
    """One server's slice of the admission budget.

    The base controller does all the real work; the shard only re-reads its
    limits through the ``_client_quota`` / ``_total_cap`` hooks so borrowed
    capacity (``_client_adjust`` / ``_total_adjust``, maintained by the
    parent) is honored without forking the grant path. Invariant: for every
    client, adjustments across shards sum to zero.
    """

    def __init__(self, server_id: str, config: AdmissionConfig, pool=None):
        super().__init__(config, pool=pool)
        self.server_id = server_id
        self.stats = ShardStats()
        self._client_adjust: dict[str, int] = {}   # client -> net borrowed
        self._total_adjust = 0                     # net borrowed (global cap)

    def _client_quota(self, client_id: str) -> int | None:
        base = self.config.max_streams_per_client
        if base is None:
            return None
        return base + self._client_adjust.get(client_id, 0)

    def _total_cap(self) -> int | None:
        base = self.config.max_streams_total
        if base is None:
            return None
        return base + self._total_adjust

    # -------------------------------------------------------- borrow slack
    def client_slack(self, client_id: str) -> int | None:
        quota = self._client_quota(client_id)
        return (None if quota is None
                else quota - self.active_streams(client_id))

    def total_slack(self) -> int | None:
        cap = self._total_cap()
        return None if cap is None else cap - self.active_total()


def _split(total: int, n: int) -> list[int]:
    """Deal ``total`` units across ``n`` shards, remainder to the first."""
    base, rem = divmod(total, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _water_fill(shards: list[AdmissionShard],
                total: float) -> dict[str, float]:
    """Level ``total`` lease tokens toward equal shares across ``shards``,
    capped at each bucket's burst; any spill re-levels among buckets with
    headroom (``total <= sum of bursts``, so it always fits). Returns
    server_id → target token count. Shared by the reconciler's periodic
    rebalance and the membership re-split."""
    targets = {s.server_id: 0.0 for s in shards}
    remaining = total
    pool = list(shards)
    while pool and remaining > 1e-12:
        share = remaining / len(pool)
        spill = [s for s in pool
                 if float(s.config.lease_burst) - targets[s.server_id]
                 <= share]
        if not spill:
            for s in pool:
                targets[s.server_id] += share
            break
        for s in spill:
            add = float(s.config.lease_burst) - targets[s.server_id]
            targets[s.server_id] += add
            remaining -= add
            pool.remove(s)
    return targets


class ShardedAdmission:
    """Per-server admission shards under one global budget.

    ``config`` is the *global* budget (same dataclass the centralized
    controller takes); it is split across ``server_ids`` — per-client quota
    and global cap dealt as integers, lease rate and burst divided — so the
    shards jointly hold exactly the centralized budget. ``pool`` (the
    registered-memory budget) is a genuinely global resource and every shard
    checks the same one.
    """

    #: the coordinator and gateway route per-endpoint when they see this
    per_server = True

    def __init__(self, config: AdmissionConfig | None = None,
                 server_ids: list[str] | tuple[str, ...] = ("s0",),
                 pool=None, dist: DistributedConfig | None = None):
        if not server_ids:
            raise ValueError("need at least one server_id to shard over")
        if len(set(server_ids)) != len(server_ids):
            raise ValueError("duplicate server_ids")
        self.config = config or AdmissionConfig()
        self.dist = dist or DistributedConfig()
        self.pool = pool
        ids = list(server_ids)
        n = len(ids)
        quotas = (_split(self.config.max_streams_per_client, n)
                  if self.config.max_streams_per_client is not None
                  else [None] * n)
        caps = (_split(self.config.max_streams_total, n)
                if self.config.max_streams_total is not None
                else [None] * n)
        bursts = _split(self.config.lease_burst, n)
        rate = self.config.lease_rate_per_s
        self.shards: dict[str, AdmissionShard] = {}
        for i, sid in enumerate(ids):
            local = dataclasses.replace(
                self.config, max_streams_per_client=quotas[i],
                max_streams_total=caps[i],
                lease_rate_per_s=None if rate is None else rate / n,
                lease_burst=bursts[i])
            self.shards[sid] = AdmissionShard(sid, local, pool=pool)
        self._partitioned: set[str] = set()
        # evicted shards kept as tombstones so late releases from leases
        # that were in flight when the server died settle against the dead
        # ledger instead of mis-routing onto a live shard (see remove_shard)
        self._retired: dict[str, AdmissionShard] = {}
        self._release_cbs: list = []
        self._last_reconcile_s = 0.0
        self._reconciles = 0
        self._tokens_rebalanced = 0.0
        self._peak_total = 0
        self._client_peaks: dict[str, int] = {}
        # optional obs.FlightRecorder (duck-typed): borrow/reconcile events
        # land in the postmortem ring when one is attached
        self.recorder = None

    @classmethod
    def for_coordinator(cls, coordinator,
                        config: AdmissionConfig | None = None,
                        pool=None, dist: DistributedConfig | None = None
                        ) -> "ShardedAdmission":
        """One shard per registered server, in registry order (duck-typed:
        anything with a ``servers`` mapping works)."""
        return cls(config, sorted(coordinator.servers), pool=pool, dist=dist)

    # ------------------------------------------------------------- routing
    def shard(self, server_id: str) -> AdmissionShard:
        if server_id not in self.shards:
            raise KeyError(f"unknown shard {server_id!r}")
        return self.shards[server_id]

    def _route_acquire(self, client_id: str,
                       server_id: str | None) -> AdmissionShard:
        if server_id is not None and server_id in self.shards:
            return self.shards[server_id]
        # endpoint unknown: deterministic least-loaded routing (the shard
        # with the most per-client headroom; ties break by server id)
        def headroom(item):
            sid, shard = item
            slack = shard.client_slack(client_id)
            return (-(10**9 if slack is None else slack), sid)
        return min(self.shards.items(), key=headroom)[1]

    def _route_release(self, client_id: str,
                       server_id: str | None) -> AdmissionShard | None:
        if server_id is not None and server_id in self.shards:
            return self.shards[server_id]
        # release where the slot is actually held, or it would leak
        holding = [(sid, s) for sid, s in self.shards.items()
                   if s.active_streams(client_id) > 0]
        if not holding:
            return None
        return max(holding, key=lambda kv: (kv[1].active_streams(client_id),
                                            kv[0]))[1]

    def headroom(self, server_id: str,
                 client_id: str = "default") -> int | None:
        """The shard's **local** free capacity for one more of
        ``client_id``'s streams: the tighter of its per-client quota slack
        and its total-cap slack (``None`` == both unlimited). Deliberately
        blind to borrowable peer slack — the caller (the steal scheduler's
        thief-side check, via ``ClusterCoordinator.admission_headroom``)
        wants to know whether an extra grant would stall on admission or
        force a borrow, and a borrow is exactly the stall it is avoiding.
        Unknown servers answer from the shard an acquire would route to."""
        shard = self._route_acquire(client_id, server_id)
        slacks = [s for s in (shard.client_slack(client_id),
                              shard.total_slack()) if s is not None]
        return min(slacks) if slacks else None

    # ------------------------------------------------------------- streams
    def active_streams(self, client_id: str = "default") -> int:
        return sum(s.active_streams(client_id) for s in self.shards.values())

    def active_total(self) -> int:
        return sum(s.active_total() for s in self.shards.values())

    def acquire_stream(self, client_id: str = "default",
                       server_id: str | None = None) -> None:
        """Admission-check against the endpoint's shard; on a local limit,
        borrow bounded slack from the least-loaded peer before denying."""
        shard = self._route_acquire(client_id, server_id)
        # a grant may be blocked on BOTH the per-client quota slice and the
        # shard's total-cap slice: borrow for each binding reason until the
        # grant clears or a borrow makes no progress (no peer slack / limit)
        borrowed: list[tuple[AdmissionShard, str]] = []
        reason = shard._deny_reason(client_id)
        while reason in ("quota", "total"):
            lender = self._borrow(shard, client_id, reason)
            if lender is not None:
                borrowed.append((lender, reason))
            cleared = shard._deny_reason(client_id)
            if cleared == reason:              # borrow failed: deny below
                break
            reason = cleared
        try:
            shard.acquire_stream(client_id)    # raises if still over limit
        except Backpressure:
            # a borrow that cleared one reason while the other still denies
            # must not strand capacity at a shard that didn't use it
            for lender, kind in reversed(borrowed):
                self._unborrow(shard, lender, client_id, kind)
            raise
        self._peak_total = max(self._peak_total, self.active_total())
        self._client_peaks[client_id] = max(
            self._client_peaks.get(client_id, 0),
            self.active_streams(client_id))

    def release_stream(self, client_id: str = "default",
                       server_id: str | None = None,
                       now_s: float | None = None) -> None:
        if server_id is not None and server_id in self._retired:
            # the slot was held on a shard that has since been absorbed
            # (server evicted); settle the dead ledger quietly — the
            # capacity already moved to the survivors, so no live slot
            # frees and no freed-slot callback fires
            tomb = self._retired[server_id]
            if tomb.active_streams(client_id) > 0:
                tomb.release_stream(client_id, server_id=server_id,
                                    now_s=now_s)
            return
        shard = self._route_release(client_id, server_id)
        if shard is None or shard.active_streams(client_id) == 0:
            return       # nothing held: no decrement, no phantom event
        shard.release_stream(client_id, server_id=shard.server_id,
                             now_s=now_s)
        for cb in self._release_cbs:
            cb(shard.server_id, client_id, now_s)

    def subscribe_release(self, callback) -> None:
        """``callback(server_id, client_id, now_s)`` on every freed slot —
        the gateway's ``replan_on_release`` hook and the steal scheduler's
        declined-shard retry plug in here."""
        self._release_cbs.append(callback)

    def unsubscribe_release(self, callback) -> None:
        """Remove a freed-slot listener (idempotent) — per-scan subscribers
        unsubscribe on drain so the list doesn't grow with scan count."""
        try:
            self._release_cbs.remove(callback)
        except ValueError:
            pass

    # ------------------------------------------------------------ borrowing
    def _peers(self, shard: AdmissionShard) -> list[AdmissionShard]:
        if shard.server_id in self._partitioned:
            return []              # partitioned: degraded to local reserve
        return [s for sid, s in sorted(self.shards.items())
                if s is not shard and sid not in self._partitioned]

    def _borrow(self, shard: AdmissionShard, client_id: str,
                reason: str) -> AdmissionShard | None:
        """Move one capacity unit from the least-loaded peer to ``shard``;
        returns the lender (``None`` when no borrow happened). Bounded: a
        shard never holds more than ``dist.borrow_limit`` net borrowed
        units, and a lender never gives up in-use capacity. A failed
        borrow is a no-op — the caller's acquire raises the denial."""
        if reason == "quota":
            held = shard._client_adjust.get(client_id, 0)
            slack_of = lambda peer: peer.client_slack(client_id)  # noqa: E731
        else:
            held = shard._total_adjust
            slack_of = lambda peer: peer.total_slack()            # noqa: E731
        if held >= self.dist.borrow_limit:
            return None
        candidates = [(p, slack_of(p)) for p in self._peers(shard)]
        candidates = [(p, s) for p, s in candidates
                      if s is not None and s > 0]
        if not candidates:
            return None
        lender = max(candidates, key=lambda ps: (ps[1], ps[0].server_id))[0]
        if reason == "quota":
            lender._client_adjust[client_id] = \
                lender._client_adjust.get(client_id, 0) - 1
            shard._client_adjust[client_id] = held + 1
        else:
            lender._total_adjust -= 1
            shard._total_adjust = held + 1
        lender.stats.lends += 1
        shard.stats.borrows += 1
        if self.recorder is not None:
            self.recorder.record("admission.borrow",
                                 server_id=shard.server_id,
                                 lender=lender.server_id, reason=reason)
        return lender

    def _unborrow(self, shard: AdmissionShard, lender: AdmissionShard,
                  client_id: str, reason: str) -> None:
        """Reverse one :meth:`_borrow` whose grant was ultimately denied.
        The stats counters are rolled back too — ``borrows``/``lends``
        count capacity that actually moved for a grant, not probes."""
        if reason == "quota":
            shard._client_adjust[client_id] -= 1
            if shard._client_adjust[client_id] == 0:
                del shard._client_adjust[client_id]
            lender._client_adjust[client_id] = \
                lender._client_adjust.get(client_id, 0) + 1
            if lender._client_adjust.get(client_id) == 0:
                del lender._client_adjust[client_id]
        else:
            shard._total_adjust -= 1
            lender._total_adjust += 1
        lender.stats.lends -= 1
        shard.stats.borrows -= 1

    # --------------------------------------------------------- token bucket
    def _maybe_reconcile(self, now_s: float) -> None:
        if now_s - self._last_reconcile_s >= self.dist.reconcile_interval_s:
            self.reconcile(now_s)

    def lease_wait_s(self, now_s: float, n: int = 1,
                     server_id: str | None = None) -> float:
        """Meter ``n`` lease tokens against the endpoint shard's bucket
        (or the richest bucket when the caller doesn't know the endpoint).
        Piggybacks the periodic reconciler on the modeled clock."""
        self._maybe_reconcile(now_s)
        if server_id is not None and server_id in self.shards:
            shard = self.shards[server_id]
        else:
            shard = max(sorted(self.shards.items()),
                        key=lambda kv: kv[1].tokens_at(now_s))[1]
        return shard.lease_wait_s(now_s, n)

    def lease_wait_for_counts(self, now_s: float,
                              counts: dict[str, int]) -> float:
        """Meter a fan-out's per-server token demand: group by the shard
        that actually serves each server (unknown servers fall back to the
        richest bucket), charge every shard **once** with its whole demand,
        and return the slowest wait — per-shard grants run concurrently,
        but one shard's demand serializes on its own bucket. With one
        shard this collapses to a single n-token grant, exactly the
        centralized controller's call shape (drop-in conformance)."""
        self._maybe_reconcile(now_s)
        by_shard: dict[str, int] = {}
        for sid, n in sorted(counts.items()):
            if sid not in self.shards:
                sid = max(sorted(self.shards.items()),
                          key=lambda kv: kv[1].tokens_at(now_s))[0]
            by_shard[sid] = by_shard.get(sid, 0) + n
        return max((self.shards[sid].lease_wait_s(now_s, n)
                    for sid, n in sorted(by_shard.items())), default=0.0)

    # ------------------------------------------------------- reconciliation
    def partition(self, server_id: str) -> None:
        """The shard's reconciler stopped firing: exclude it from borrow
        and rebalance rounds. It keeps admitting against its local reserve
        (capacity it already holds), so it can never over-admit."""
        self.shard(server_id)      # KeyError on unknown
        self._partitioned.add(server_id)

    def rejoin(self, server_id: str) -> None:
        self._partitioned.discard(server_id)

    def partitioned(self, server_id: str) -> bool:
        return server_id in self._partitioned

    # ----------------------------------------------------------- membership
    def remove_shard(self, server_id: str, now_s: float = 0.0) -> None:
        """Absorb a dead/evicted server's quota shard into the survivors.

        The shard's bucket is refilled to ``now_s`` and its tokens join the
        re-split (conserved, never destroyed); the base budget is re-dealt
        across the surviving shards so the cluster-wide quota is unchanged
        by the membership change. The shard itself is kept as a tombstone:
        leases that were in flight when the server died release against it
        later without touching a live shard's ledger."""
        shard = self.shard(server_id)
        if len(self.shards) == 1:
            raise ValueError("cannot remove the last admission shard")
        shard._refill(now_s)
        orphan_tokens = shard._tokens
        shard._tokens = 0.0
        del self.shards[server_id]
        self._partitioned.discard(server_id)
        self._retired[server_id] = shard
        self._resplit(now_s, extra_tokens=orphan_tokens)
        if self.recorder is not None:
            self.recorder.record("admission.shard_absorbed", now_s=now_s,
                                 server_id=server_id,
                                 tokens_absorbed=orphan_tokens,
                                 survivors=len(self.shards))

    def add_shard(self, server_id: str, now_s: float = 0.0) -> None:
        """Spawn a quota shard for a joining (or re-admitted) server by
        re-splitting the base budget across the grown membership. A
        re-admitted server starts with a clean ledger — its pre-eviction
        leases died with the process (or migrated and settled against the
        tombstone, which is dropped here)."""
        if server_id in self.shards:
            raise ValueError(f"shard {server_id!r} already exists")
        self._retired.pop(server_id, None)
        local = dataclasses.replace(self.config, lease_burst=0,
                                    lease_rate_per_s=None)
        self.shards[server_id] = AdmissionShard(server_id, local,
                                                pool=self.pool)
        self._resplit(now_s)
        if self.recorder is not None:
            self.recorder.record("admission.shard_spawned", now_s=now_s,
                                 server_id=server_id,
                                 members=len(self.shards))

    def _resplit(self, now_s: float, extra_tokens: float = 0.0) -> None:
        """Re-deal the base budget across the current shard set.

        Every borrow adjustment is cleared (all-zero trivially satisfies
        the zero-sum invariant) and each shard's config becomes its fresh
        slice of the global budget; a shard holding more in-use streams
        than its new slice simply denies new grants until it drains, so
        the global caps are never exceeded. Tokens (current holdings plus
        ``extra_tokens`` from an absorbed shard) are re-leveled by the
        same water-fill the reconciler uses — conserved by construction."""
        ids = sorted(self.shards)
        n = len(ids)
        quotas = (_split(self.config.max_streams_per_client, n)
                  if self.config.max_streams_per_client is not None
                  else [None] * n)
        caps = (_split(self.config.max_streams_total, n)
                if self.config.max_streams_total is not None
                else [None] * n)
        bursts = _split(self.config.lease_burst, n)
        rate = self.config.lease_rate_per_s
        shards = [self.shards[sid] for sid in ids]
        for shard in shards:
            shard._refill(now_s)
        total_tokens = sum(s._tokens for s in shards) + extra_tokens
        for i, (sid, shard) in enumerate(zip(ids, shards)):
            shard.config = dataclasses.replace(
                shard.config, max_streams_per_client=quotas[i],
                max_streams_total=caps[i],
                lease_rate_per_s=None if rate is None else rate / n,
                lease_burst=bursts[i])
            shard._client_adjust.clear()
            shard._total_adjust = 0
            # a joiner's bucket clock starts at the re-split (its placeholder
            # config had no rate, so _refill above didn't advance it)
            shard._bucket_clock_s = max(shard._bucket_clock_s, now_s)
        targets = _water_fill(shards, total_tokens)
        for shard in shards:
            shard._tokens = min(targets[shard.server_id],
                                float(shard.config.lease_burst))

    def reconcile(self, now_s: float) -> ReconcileReport:
        """One rebalance round over the non-partitioned shards.

        1. *Capacity*: every borrowed unit not pinned by in-use streams goes
           back to its lenders — repeated rounds converge to the balanced
           (base) allocation once load drops.
        2. *Lease tokens*: refill every participating bucket to ``now_s``,
           then level tokens across buckets (water-filling capped at each
           bucket's burst). Conserves the total — no shard pair creates or
           destroys tokens; the report proves it.
        """
        ids = tuple(sid for sid in sorted(self.shards)
                    if sid not in self._partitioned)
        report = ReconcileReport(now_s=now_s, participants=ids)
        self._last_reconcile_s = now_s
        self._reconciles += 1
        shards = [self.shards[sid] for sid in ids]
        for shard in shards:
            shard.stats.reconciles += 1
        if len(shards) >= 2:
            report.capacity_returned = self._rebalance_capacity(shards)
            self._rebalance_tokens(shards, now_s, report)
        else:
            report.tokens_before = report.tokens_after = sum(
                s.tokens_at(now_s) for s in shards)
        if self.recorder is not None:
            self.recorder.record(
                "admission.reconcile", now_s=now_s,
                participants=len(ids),
                capacity_returned=report.capacity_returned,
                tokens_moved=report.tokens_moved)
        return report

    def _rebalance_capacity(self, shards: list[AdmissionShard]) -> int:
        returned = 0
        # per-client quota adjustments: borrowers return what in-use
        # streams don't pin; lenders with the largest debt are repaid first
        clients = sorted({c for s in shards for c in s._client_adjust})
        for client in clients:
            for borrower in shards:
                held = borrower._client_adjust.get(client, 0)
                if held <= 0:
                    continue
                slack = borrower.client_slack(client)
                give = min(held, max(0, slack if slack is not None else 0))
                while give > 0:
                    lenders = [s for s in shards
                               if s._client_adjust.get(client, 0) < 0]
                    if not lenders:
                        break
                    lender = min(lenders, key=lambda s: (
                        s._client_adjust.get(client, 0), s.server_id))
                    lender._client_adjust[client] += 1
                    if lender._client_adjust[client] == 0:
                        del lender._client_adjust[client]
                    borrower._client_adjust[client] -= 1
                    give -= 1
                    returned += 1
                if borrower._client_adjust.get(client, 0) == 0:
                    borrower._client_adjust.pop(client, None)
        # global-cap adjustments: same settlement, one ledger
        for borrower in shards:
            if borrower._total_adjust <= 0:
                continue
            slack = borrower.total_slack()
            give = min(borrower._total_adjust,
                       max(0, slack if slack is not None else 0))
            while give > 0:
                lenders = [s for s in shards if s._total_adjust < 0]
                if not lenders:
                    break
                lender = min(lenders,
                             key=lambda s: (s._total_adjust, s.server_id))
                lender._total_adjust += 1
                borrower._total_adjust -= 1
                give -= 1
                returned += 1
        return returned

    def _rebalance_tokens(self, shards: list[AdmissionShard], now_s: float,
                          report: ReconcileReport) -> None:
        rate = self.config.lease_rate_per_s
        if rate is None or rate <= 0:
            return
        for shard in shards:
            shard._refill(now_s)
        total = sum(s._tokens for s in shards)
        report.tokens_before = total
        targets = _water_fill(shards, total)
        for shard in shards:
            delta = targets[shard.server_id] - shard._tokens
            if delta > 1e-12:
                shard.stats.tokens_in += delta
                report.tokens_moved += delta
            elif delta < -1e-12:
                shard.stats.tokens_out += -delta
            shard._tokens = targets[shard.server_id]
        self._tokens_rebalanced += report.tokens_moved
        report.tokens_after = sum(s._tokens for s in shards)

    # --------------------------------------------------------------- stats
    @property
    def memory_budget_bytes(self) -> int | None:
        if self.config.memory_budget_bytes is not None:
            return self.config.memory_budget_bytes
        if self.pool is not None:
            return getattr(self.pool, "max_bytes", None)
        return None

    @property
    def peak_total(self) -> int:
        return self._peak_total

    def peak_streams(self, client_id: str = "default") -> int:
        """High-water mark of one client's concurrent streams, cluster-wide.
        Summing shard peaks would over-count (they need not be simultaneous),
        so the exact global peak is tracked at acquire time instead."""
        return self._client_peaks.get(client_id, 0)

    @property
    def stats(self) -> DistributedStats:
        agg = DistributedStats(peak_total=self._peak_total,
                               reconciles=self._reconciles,
                               tokens_rebalanced=self._tokens_rebalanced)
        for sid in sorted(self.shards):
            s = self.shards[sid].stats
            agg.shards[sid] = s
            agg.stream_grants += s.stream_grants
            agg.stream_denials += s.stream_denials
            agg.total_denials += s.total_denials
            agg.memory_denials += s.memory_denials
            agg.lease_grants += s.lease_grants
            agg.throttle_wait_s += s.throttle_wait_s
            agg.borrows += s.borrows
            agg.lends += s.lends
            agg.peak_active = max(agg.peak_active, s.peak_active)
        return agg
