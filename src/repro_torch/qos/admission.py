# Copy of src/repro/qos/admission.py, kept numpy-only; change both copies together.
"""Admission control: who may open streams, and how fast leases are granted.

The cluster dataplane (PR 1) lets any client open unbounded streams against
the coordinator — exactly the regime where Flight-style servers add
admission control ("Benchmarking Apache Arrow Flight", arXiv:2204.03032)
and RDMA engines schedule exchange explicitly (arXiv:1502.07169): every
stream pins registered memory server-side and holds a reader-map lease, so
an unthrottled heavy client can exhaust both. This module is the gatekeeper:

* **per-client stream quotas** — :meth:`AdmissionController.acquire_stream`
  counts concurrently open streams per client and raises
  :class:`Backpressure` (with a ``retry_after_s`` hint) at the quota;
* **registered-memory budget** — derived from the
  :class:`~repro.cluster.mempool.BufferPool` budget when a pool is attached:
  a pool already over its slab budget denies new streams until releases or
  evictions bring it back under;
* **token-bucket lease rate** — :meth:`lease_wait_s` meters lease grants in
  *modeled* time (the repo's wire is modeled, so its flow control is too):
  a grant beyond the burst capacity returns the modeled wait the caller must
  charge to its clock, which is how pullers report backpressure upstream.

A ``max_streams_total`` cap bounds concurrent streams across *all* clients
(the reader-map's physical ceiling); freed slots fire ``subscribe_release``
callbacks so the gateway can re-plan in-flight fan-outs. The quota checks
route through overridable ``_client_quota`` / ``_total_cap`` hooks — that is
the seam :mod:`repro.qos.distributed` shards the budget on without forking
the grant path.

Everything here is duck-typed against the cluster layer (no imports from
:mod:`repro.cluster`), so the coordinator can hold an admission controller
without creating an import cycle. The duck-typed contract (what the
coordinator and pullers call): ``acquire_stream(client_id, server_id=)``,
``release_stream(client_id, server_id=, now_s=)`` and
``lease_wait_s(now_s, n, server_id=)`` — a custom controller must accept
the routing keywords even if (like this one) it ignores them; only the
sharded controller routes on them.
"""
from __future__ import annotations

import dataclasses


class Backpressure(Exception):
    """The admission controller denied a grant; retry after ``retry_after_s``.

    Raised instead of queueing when the caller owns its own retry loop (the
    loader, an external client). The gateway never lets this escape — it
    queues or sheds instead.
    """

    def __init__(self, reason: str, retry_after_s: float = 0.0):
        super().__init__(f"{reason} (retry after {retry_after_s * 1e3:.3f} ms)")
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class AdmissionConfig:
    max_streams_per_client: int | None = None   # None == unlimited
    max_streams_total: int | None = None        # global cap across clients
    memory_budget_bytes: int | None = None      # None == derive from pool
    lease_rate_per_s: float | None = None       # token refill; None == open
    lease_burst: int = 8                        # bucket capacity (tokens)
    retry_after_hint_s: float = 1e-3            # Backpressure retry hint


@dataclasses.dataclass
class AdmissionStats:
    stream_grants: int = 0
    stream_denials: int = 0          # quota Backpressure raised
    total_denials: int = 0           # global-cap Backpressure raised
    memory_denials: int = 0          # budget Backpressure raised
    lease_grants: int = 0            # token-bucket grants (incl. waited)
    throttle_wait_s: float = 0.0     # modeled wait charged by the bucket
    peak_active: int = 0             # high-water mark of concurrent streams


class AdmissionController:
    """Stream quotas + memory budget + token-bucket lease metering.

    ``pool`` is the client-side :class:`~repro.cluster.mempool.BufferPool`
    whose registered-slab budget backs the memory check (duck-typed: anything
    with ``max_bytes`` and ``stats.bytes_resident`` works).
    """

    def __init__(self, config: AdmissionConfig | None = None, pool=None):
        self.config = config or AdmissionConfig()
        self.pool = pool
        self.stats = AdmissionStats()
        self._active: dict[str, int] = {}        # client_id -> open streams
        self._tokens = float(self.config.lease_burst)
        self._bucket_clock_s = 0.0               # modeled time of last refill
        self._release_cbs: list = []             # freed-slot listeners

    # ------------------------------------------------------------- streams
    def active_streams(self, client_id: str = "default") -> int:
        return self._active.get(client_id, 0)

    def active_total(self) -> int:
        """Concurrently open streams across every client."""
        return sum(self._active.values())

    # ------------------------------------------------------------ telemetry
    def metrics(self) -> "MetricsRegistry":
        """This controller's counters plus live occupancy gauges, under
        the ``qos.admission.*`` namespace of a fresh registry."""
        from ..obs.registry import MetricsRegistry, record_admission
        reg = MetricsRegistry()
        record_admission(reg, self.stats)
        reg.gauge("qos.admission.active_total", self.active_total())
        for client_id, n in self._active.items():
            reg.gauge(f"qos.admission.active.{client_id}", n)
        return reg

    # Overridable limit hooks: the distributed layer's shards re-read these
    # from their borrow-adjusted local capacities; everything else in the
    # grant path is shared, so a one-shard deployment is grant-for-grant
    # identical to this controller (the conformance suite's invariant).
    def _client_quota(self, client_id: str) -> int | None:
        return self.config.max_streams_per_client

    def _total_cap(self) -> int | None:
        return self.config.max_streams_total

    def _deny_reason(self, client_id: str) -> str | None:
        """Would :meth:`acquire_stream` deny right now? Returns the denial
        kind (``"quota"`` / ``"total"`` / ``"memory"``) without touching any
        stats — the distributed layer peeks before deciding to borrow."""
        quota = self._client_quota(client_id)
        if quota is not None and self.active_streams(client_id) >= quota:
            return "quota"
        cap = self._total_cap()
        if cap is not None and self.active_total() >= cap:
            return "total"
        budget = self.memory_budget_bytes
        if (budget is not None and self.pool is not None
                and self.pool.stats.bytes_resident > budget):
            return "memory"
        return None

    def headroom(self, server_id: str | None = None,
                 client_id: str = "default") -> int | None:
        """Streams this controller could still grant ``client_id`` right
        now, or ``None`` when unlimited. ``server_id`` is interface parity
        with the sharded controller (which answers for that server's shard
        alone); a centralized budget has one answer for every server. The
        steal scheduler's thief-side check reads this through
        :meth:`ClusterCoordinator.admission_headroom`."""
        slacks = []
        quota = self._client_quota(client_id)
        if quota is not None:
            slacks.append(quota - self.active_streams(client_id))
        cap = self._total_cap()
        if cap is not None:
            slacks.append(cap - self.active_total())
        return min(slacks) if slacks else None

    def acquire_stream(self, client_id: str = "default",
                       server_id: str | None = None) -> None:
        """Grant one concurrent stream to ``client_id`` or raise
        :class:`Backpressure`. Pairs with :meth:`release_stream`.
        ``server_id`` is accepted for interface parity with the sharded
        controller (which routes the check to that server's shard) and
        ignored here — one process holds the whole budget.

        The verdict comes from :meth:`_deny_reason` — the ONE place the
        checks live, so the sharded borrow loop (which peeks the reason
        before borrowing, then calls this) can never disagree with the
        grant path."""
        reason = self._deny_reason(client_id)
        if reason == "quota":
            self.stats.stream_denials += 1
            raise Backpressure(
                f"client {client_id!r} at stream quota "
                f"({self._client_quota(client_id)})",
                self.config.retry_after_hint_s)
        if reason == "total":
            self.stats.total_denials += 1
            raise Backpressure(
                f"cluster at global stream cap ({self._total_cap()})",
                self.config.retry_after_hint_s)
        if reason == "memory":
            self.stats.memory_denials += 1
            raise Backpressure(
                f"registered-memory budget exhausted "
                f"({self.pool.stats.bytes_resident} > "
                f"{self.memory_budget_bytes} bytes)",
                self.config.retry_after_hint_s)
        self._active[client_id] = self.active_streams(client_id) + 1
        self.stats.stream_grants += 1
        self.stats.peak_active = max(self.stats.peak_active,
                                     self.active_total())

    def subscribe_release(self, callback) -> None:
        """Register ``callback(server_id, client_id, now_s)`` to fire on
        every freed stream slot — the signal the gateway's
        ``replan_on_release`` hook widens in-flight fan-outs on."""
        self._release_cbs.append(callback)

    def unsubscribe_release(self, callback) -> None:
        """Remove a freed-slot listener. Short-lived subscribers (one scan's
        steal scheduler) MUST unsubscribe when done — a long-lived
        controller outlives thousands of them, and the listener list is
        walked on every release."""
        try:
            self._release_cbs.remove(callback)
        except ValueError:
            pass                       # already removed: idempotent

    def release_stream(self, client_id: str = "default",
                       server_id: str | None = None,
                       now_s: float | None = None) -> None:
        n = self.active_streams(client_id)
        if n > 0:
            self._active[client_id] = n - 1
            for cb in self._release_cbs:
                cb(server_id, client_id, now_s)

    # -------------------------------------------------------------- memory
    @property
    def memory_budget_bytes(self) -> int | None:
        if self.config.memory_budget_bytes is not None:
            return self.config.memory_budget_bytes
        if self.pool is not None:
            return getattr(self.pool, "max_bytes", None)
        return None

    # --------------------------------------------------------- token bucket
    def _refill(self, now_s: float) -> None:
        """Advance the bucket to ``now_s`` (forward motion only)."""
        rate = self.config.lease_rate_per_s
        if rate is None or rate <= 0:
            return
        if now_s > self._bucket_clock_s:
            self._tokens = min(float(self.config.lease_burst),
                               self._tokens
                               + (now_s - self._bucket_clock_s) * rate)
            self._bucket_clock_s = now_s

    def tokens_at(self, now_s: float) -> float:
        """Tokens the bucket would hold at ``now_s``, without mutating it —
        the distributed reconciler's conservation bookkeeping reads this."""
        rate = self.config.lease_rate_per_s
        if rate is None or rate <= 0 or now_s <= self._bucket_clock_s:
            return self._tokens
        return min(float(self.config.lease_burst),
                   self._tokens + (now_s - self._bucket_clock_s) * rate)

    def lease_wait_s(self, now_s: float, n: int = 1,
                     server_id: str | None = None) -> float:
        """Grant ``n`` lease tokens at modeled time ``now_s``; return the
        modeled wait before the grant fires (0.0 when the bucket covers it).

        Callers charge the wait to their own modeled clock — streams run on
        per-stream clocks, so ``now_s`` may jump backwards between callers;
        the bucket only refills on forward motion. ``server_id`` is for
        interface parity with the sharded controller (ignored here)."""
        self.stats.lease_grants += n
        rate = self.config.lease_rate_per_s
        if rate is None or rate <= 0:
            return 0.0
        self._refill(now_s)
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        wait = (n - self._tokens) / rate
        self._tokens = 0.0
        self._bucket_clock_s = max(self._bucket_clock_s, now_s) + wait
        self.stats.throttle_wait_s += wait
        return wait
