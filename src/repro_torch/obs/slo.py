# Copy of src/repro/obs/slo.py, kept numpy-only; change both copies together.
"""SLO objectives with multi-window burn-rate alerting, in modeled time.

An :class:`SloObjective` is declarative: a ``MetricsRegistry`` snapshot
name (``qos.grant_latency.p50``, ``cluster.modeled_critical_path.us``,
``scan.delivered``, ...), a threshold that makes one sample *good* or
*bad*, and a goal fraction of good samples. The :class:`SloEngine` is fed
one snapshot per heartbeat (:meth:`SloEngine.observe`) and evaluates the
classic multi-window burn rate over the samples' modeled timestamps:

    ``burn(window) = bad_fraction(window) / (1 - goal)``

i.e. burn 1.0 consumes the error budget exactly at the rate the goal
allows; an alert fires only when **every** configured window's burn
exceeds its threshold — the long window proves the burn is sustained (no
paging on one bad scan), the short window proves it is *current* (no
paging an hour after the incident ended). Deduplication is stateful: a
firing objective stays latched until every window drops back under its
threshold, so a sustained breach produces one alert, not one per
heartbeat.

Alerts are frozen :class:`SloAlert` events — same discipline as
``obs.events.PerfEvent`` — appended to ``SloEngine.alerts`` and pushed to
subscribers (typically a ``FlightRecorder.postmortem`` dump). The module
imports nothing outside ``repro.obs``; snapshots are plain dicts.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective over a registry snapshot name.

    ``windows`` is a tuple of ``(window_s, max_burn)`` pairs in modeled
    seconds, longest first by convention; ``min_samples`` applies to the
    longest window (shorter windows only need one sample — they exist to
    prove the burn is current, not to establish it).
    """

    name: str
    metric: str
    target: float
    better: str = "lower"             # good when value <= target ("lower")
    goal: float = 0.99                # required good-sample fraction
    windows: tuple = ((1.0, 1.0), (0.25, 1.0))
    min_samples: int = 3

    def bad(self, value: float) -> bool:
        if self.better == "lower":
            return value > self.target
        return value < self.target

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SloAlert:
    """Typed burn-rate alert (the ``PerfEvent`` discipline)."""

    kind: str                         # "burn_rate"
    objective: str
    metric: str
    value: float                      # the sample that tipped it
    target: float
    goal: float
    burns: tuple                      # burn per window, objective order
    windows: tuple                    # the (window_s, max_burn) pairs
    now_s: float
    n_samples: int
    detail: str = ""

    @property
    def is_page(self) -> bool:
        """Every window over threshold — by construction, always true for
        emitted alerts; kept as a property for symmetry with
        ``PerfEvent.is_regression``."""
        return all(b >= max_burn for b, (_, max_burn)
                   in zip(self.burns, self.windows))

    def __str__(self) -> str:
        wins = ", ".join(
            f"{w * 1e3:g}ms burn {b:.2f}/{mb:g}"
            for b, (w, mb) in zip(self.burns, self.windows))
        return (f"[slo:{self.kind}] {self.objective} ({self.metric}) "
                f"value {self.value:g} vs target {self.target:g} at "
                f"{self.now_s * 1e3:.3f}ms [{wins}] "
                f"n={self.n_samples}{' ' + self.detail if self.detail else ''}")


class SloEngine:
    """Evaluates objectives against per-heartbeat registry snapshots."""

    def __init__(self, objectives=()):
        self.objectives: list[SloObjective] = list(objectives)
        self.alerts: list[SloAlert] = []
        self.resolved = 0              # latched alerts that cleared
        self._samples: dict[str, collections.deque] = {}
        self._firing: dict[str, bool] = {}
        self._subs: list[Callable[[SloAlert], None]] = []

    def add(self, objective: SloObjective) -> "SloEngine":
        self.objectives.append(objective)
        return self

    def subscribe(self, callback: Callable[[SloAlert], None]) -> None:
        """``callback(alert)`` runs synchronously when an alert fires —
        the postmortem hook."""
        self._subs.append(callback)

    def firing(self, name: str) -> bool:
        return self._firing.get(name, False)

    # -- evaluation -------------------------------------------------------

    def observe(self, now_s: float, snapshot: dict) -> list[SloAlert]:
        """Feed one heartbeat's registry snapshot; returns alerts fired by
        this observation. Objectives whose metric is absent from the
        snapshot simply record no sample this beat."""
        fired: list[SloAlert] = []
        for obj in self.objectives:
            value = snapshot.get(obj.metric)
            if value is None or isinstance(value, bool):
                continue
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            samples = self._samples.setdefault(obj.name, collections.deque())
            samples.append((now_s, obj.bad(value), value))
            self._trim(obj, samples, now_s)
            alert = self._evaluate(obj, samples, now_s, value)
            if alert is not None:
                fired.append(alert)
        return fired

    def _evaluate(self, obj: SloObjective, samples, now_s: float,
                  value: float) -> SloAlert | None:
        burns: list[float] = []
        total_long = 0
        over_all = bool(obj.windows)
        budget = max(1.0 - obj.goal, 1e-9)
        for i, (window_s, max_burn) in enumerate(obj.windows):
            inside = [bad for (t, bad, _) in samples
                      if t > now_s - window_s]
            n = len(inside)
            if i == 0:
                total_long = n
            if n == 0:
                burns.append(0.0)
                over_all = False
                continue
            burn = (sum(inside) / n) / budget
            burns.append(burn)
            if burn < max_burn:
                over_all = False
        if total_long < obj.min_samples:
            over_all = False

        if not over_all:
            if self._firing.get(obj.name):
                self._firing[obj.name] = False
                self.resolved += 1
            return None
        if self._firing.get(obj.name):
            return None                   # latched: dedup sustained breach
        self._firing[obj.name] = True
        alert = SloAlert(kind="burn_rate", objective=obj.name,
                         metric=obj.metric, value=value, target=obj.target,
                         goal=obj.goal, burns=tuple(burns),
                         windows=tuple(obj.windows), now_s=now_s,
                         n_samples=total_long)
        self.alerts.append(alert)
        for cb in list(self._subs):
            cb(alert)
        return alert

    @staticmethod
    def _trim(obj: SloObjective, samples, now_s: float) -> None:
        if not obj.windows:
            return
        horizon = now_s - 2.0 * max(w for w, _ in obj.windows)
        while samples and samples[0][0] <= horizon:
            samples.popleft()
