# Copy of src/repro/sched/share.py, kept numpy-only; change both copies together.
"""Shared tickets: coalesce identical queued scans into one fan-out.

The Arrow Flight benchmark paper (arXiv:2204.03032) motivates the *shared
ticket* model: when many clients ask for the same result, the server
executes once and every requester pulls the same stream. The qos gateway
sees every queued :class:`~repro.qos.ScanRequest` before it plans, which is
exactly the place to apply the trick: a :class:`TicketTable` keys tickets on
``(sql, dataset, start_batch)``; the first subscriber popped becomes the
**primary** and executes the fan-out; the reassembled batches are published
on the ticket and *multicast* — copy-on-read, each subscriber receives its
own deep copy at grant time — to everyone else, with per-subscriber
``QosStats`` attribution (a hit still counts granted batches/bytes for its
class, it just consumes no server-side service).

Tickets live for one gateway drain (``begin_drain`` clears the table): a
published result is a snapshot of the tables at execution time, and holding
it across drains would hand later subscribers stale data.

Everything is duck-typed (subscriber ids are opaque ints, results are
opaque lists), so this module imports nothing from :mod:`repro.qos` —
the gateway imports us, never the reverse.
"""
from __future__ import annotations

import dataclasses


TicketKey = tuple[str, str, int]        # (sql, dataset, start_batch)


@dataclasses.dataclass
class Ticket:
    """One coalesced result: its subscribers and, once executed, its data."""

    key: TicketKey
    subscribers: list[int] = dataclasses.field(default_factory=list)
    primary_id: int | None = None       # the request that ran the fan-out
    batches: list | None = None         # published reassembled batches
    cluster: object | None = None       # the primary's ClusterStats

    @property
    def published(self) -> bool:
        return self.batches is not None


@dataclasses.dataclass
class TicketStats:
    hits: int = 0                       # requests served by multicast
    misses: int = 0                     # requests that ran their own fan-out
    cancels: int = 0                    # subscribers shed while queued
    bytes_multicast: int = 0            # delivered without touching a server

    @property
    def fanouts_saved(self) -> int:
        return self.hits

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class TicketTable:
    """Keyed registry of in-flight/published shared tickets."""

    def __init__(self) -> None:
        self._tickets: dict[TicketKey, Ticket] = {}
        self.stats = TicketStats()

    @staticmethod
    def key_for(sql: str, dataset: str, start_batch: int = 0) -> TicketKey:
        return (sql, dataset, start_batch)

    def __len__(self) -> int:
        return len(self._tickets)

    def lookup(self, key: TicketKey) -> Ticket | None:
        return self._tickets.get(key)

    # ------------------------------------------------------------ telemetry
    def metrics(self) -> "MetricsRegistry":
        """This table's counters under the ``sched.tickets.*`` namespace of
        a fresh registry, plus the live in-flight ticket count — the same
        natural-root hook ``QosStats.registry()`` and
        ``AdmissionController.metrics()`` expose."""
        from ..obs.registry import MetricsRegistry, record_tickets
        reg = MetricsRegistry()
        record_tickets(reg, self.stats)
        reg.gauge("sched.tickets.in_flight", len(self))
        return reg

    # ------------------------------------------------------------ lifecycle
    def begin_drain(self) -> None:
        """Forget published results from earlier drains (data may have
        changed between drains); keep tickets that still have queued
        subscribers waiting."""
        self._tickets = {k: t for k, t in self._tickets.items()
                         if t.subscribers and not t.published}

    def subscribe(self, key: TicketKey, request_id: int) -> Ticket:
        """Register a queued request's interest — a later identical request
        may join an existing ticket mid-flight (after the primary was
        submitted, even after it executed within the same drain)."""
        ticket = self._tickets.setdefault(key, Ticket(key))
        if request_id not in ticket.subscribers:
            ticket.subscribers.append(request_id)
        return ticket

    def cancel(self, key: TicketKey, request_id: int) -> None:
        """A subscriber was shed while queued. Dropping the last subscriber
        of an unexecuted ticket drops the ticket — nobody will run it."""
        ticket = self._tickets.get(key)
        if ticket is None or request_id not in ticket.subscribers:
            return
        ticket.subscribers.remove(request_id)
        self.stats.cancels += 1
        if not ticket.subscribers and not ticket.published:
            del self._tickets[key]

    def publish(self, key: TicketKey, request_id: int, batches: list,
                cluster) -> Ticket:
        """The primary executed: record its reassembled result for every
        remaining subscriber to read."""
        ticket = self.subscribe(key, request_id)
        ticket.subscribers.remove(request_id)    # the primary is served
        ticket.primary_id = request_id
        ticket.batches = batches
        ticket.cluster = cluster
        self.stats.misses += 1
        return ticket

    def redeem(self, key: TicketKey, request_id: int) -> Ticket | None:
        """A subscriber reached the head of the queue: if its ticket is
        published, the caller multicasts (copy-on-read) instead of planning
        a fan-out. Returns ``None`` when the request must execute itself."""
        ticket = self._tickets.get(key)
        if ticket is None or not ticket.published:
            return None
        if request_id in ticket.subscribers:
            ticket.subscribers.remove(request_id)
        self.stats.hits += 1
        self.stats.bytes_multicast += getattr(ticket.cluster, "bytes", 0)
        return ticket
