# Copy of src/repro/obs/recorder.py, kept numpy-only; change both copies together.
"""Flight recorder: a bounded ring of structured cross-layer events.

Every layer of the stack already *decides* things in modeled time — the
gateway sheds a deadline-missed scan, the stealing puller declines a thief
shard at quota, a stream faults and resumes, a shard borrows a slot from a
peer, the pool evicts a cold slab. Those decisions are exactly what a
postmortem needs, and exactly what a cumulative ``*Stats`` counter erases:
the counter says *how many*, the recorder says *which, when, and in what
order*.

``FlightRecorder`` is deliberately dumb: a ``deque(maxlen=...)`` of frozen
:class:`FlightEvent` records. Producers call :meth:`FlightRecorder.record`
(usually via ``ClusterCoordinator.notify`` — see ``cluster/coordinator.py``
— so plain deployments pay a single attribute check). When an SLO alert
fires (``obs/slo.py``), :meth:`FlightRecorder.postmortem` assembles the
bundle: the last-N causal events, the full metrics-registry snapshot, the
per-server health states, and the Chrome trace export — everything needed
to answer "why was this scan slow" without re-running anything.

Like the rest of ``repro.obs`` this module imports nothing from the layers
it observes; ``registry``/``health``/``tracer`` arguments are duck-typed.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class FlightEvent:
    """One structured decision, in modeled time.

    ``kind`` is a dotted verb (``steal.decline``, ``qos.shed``,
    ``stream.fault``, ``admission.borrow``, ``pool.eviction``, ...);
    ``server_id`` is the server the decision is *about* (empty when the
    event is cluster-wide); ``attrs`` carries the kind-specific detail
    (victim, batches, nbytes, ...).
    """

    seq: int
    kind: str
    now_s: float
    server_id: str = ""
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "kind": self.kind, "now_s": self.now_s,
                "server_id": self.server_id, "attrs": dict(self.attrs)}

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        extra = " ".join(f"{k}={v}" for k, v in sorted(self.attrs.items()))
        sid = f" [{self.server_id}]" if self.server_id else ""
        return f"#{self.seq} {self.now_s * 1e3:9.3f}ms {self.kind}{sid} {extra}"


class FlightRecorder:
    """Bounded ring of :class:`FlightEvent` records.

    The ring holds the most recent ``capacity`` events; older events fall
    off the front (``dropped`` counts them) so a long-lived recorder stays
    O(capacity) no matter how chatty the cluster gets.
    """

    def __init__(self, capacity: int = 512) -> None:
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0

    def record(self, kind: str, now_s: float = 0.0, server_id: str = "",
               **attrs) -> FlightEvent:
        """Append one event; returns it (handy in tests)."""
        event = FlightEvent(seq=self._seq, kind=kind, now_s=now_s,
                            server_id=server_id or "", attrs=attrs)
        self._seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(event)
        return event

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def next_seq(self) -> int:
        """The seq the next recorded event will get — a cursor for
        incremental consumers (every event with ``seq < next_seq`` has
        been recorded, even if the ring has since dropped it)."""
        return self._seq

    def events(self, last_n: int | None = None,
               kinds: Iterable[str] | None = None) -> list[FlightEvent]:
        """The recorded events, oldest first; optionally only the last
        ``last_n`` and/or only the listed ``kinds``."""
        out = list(self._ring)
        if kinds is not None:
            wanted = set(kinds)
            out = [e for e in out if e.kind in wanted]
        if last_n is not None:
            out = out[-last_n:]
        return out

    def counts(self) -> dict[str, int]:
        """Events currently in the ring, tallied by kind."""
        tally: dict[str, int] = {}
        for event in self._ring:
            tally[event.kind] = tally.get(event.kind, 0) + 1
        return dict(sorted(tally.items()))

    # -- postmortems ------------------------------------------------------

    def postmortem(self, trigger=None, registry=None, health=None,
                   tracer=None, membership=None, last_n: int = 64) -> dict:
        """Assemble the diagnosis bundle for one alert.

        ``trigger`` is whatever fired (an ``SloAlert``, a ``PerfEvent``, a
        plain dict/string); ``registry``/``health``/``tracer`` are the
        session's ``MetricsRegistry`` / ``HealthMonitor`` / ``Tracer`` if
        present — all duck-typed, all optional, so the recorder stays
        importable anywhere. ``membership`` (a
        ``cluster.MembershipController``) adds the currently-evicted set
        and the evict/re-admit transition log, so a nemesis postmortem
        shows *who was out* when the page fired.
        """
        bundle: dict = {
            "trigger": _as_plain(trigger),
            "events": [e.to_dict() for e in self.events(last_n=last_n)],
            "event_counts": self.counts(),
            "events_dropped": self.dropped,
        }
        if registry is not None and hasattr(registry, "snapshot"):
            bundle["registry"] = registry.snapshot()
        if health is not None:
            if hasattr(health, "snapshot"):
                bundle["health"] = health.snapshot()
            transitions = getattr(health, "transitions", None)
            if transitions is not None:
                bundle["health_transitions"] = [_as_plain(t)
                                               for t in transitions]
        if tracer is not None and hasattr(tracer, "to_chrome"):
            bundle["trace"] = tracer.to_chrome()
        if membership is not None:
            bundle["membership"] = {
                "evicted": list(getattr(membership, "evicted", ()) or ()),
                "events": [_as_plain(e)
                           for e in getattr(membership, "events", [])],
            }
        return bundle

    def dump(self, path: str, trigger=None, registry=None, health=None,
             tracer=None, membership=None, last_n: int = 64) -> str:
        """Write :meth:`postmortem` as JSON; returns the path written."""
        bundle = self.postmortem(trigger=trigger, registry=registry,
                                 health=health, tracer=tracer,
                                 membership=membership, last_n=last_n)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(bundle, fh, indent=2, sort_keys=True, default=str)
        return path


def _as_plain(obj):
    """Best-effort plain-data view of a trigger/transition object."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {str(k): _as_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_as_plain(v) for v in obj]
    return str(obj)
