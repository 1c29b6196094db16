# Copy of src/repro/obs/events.py, kept numpy-only; change both copies together.
"""Typed perf events: regression / improvement detection against baselines.

Each benchmark metric declares a :class:`MetricPolicy` (direction, bootstrap
floor/ceiling, envelope slack). :func:`detect_events` compares the latest
run against the rolling baseline of its predecessors:

* with fewer than :data:`~.baseline.MIN_RUNS` prior runs the trajectory is
  still bootstrapping — only the hand-tuned ``floor`` / ``ceiling``
  constants apply (exactly the constants CI asserted before this module
  existed);
* once enough history exists, the envelope takes over:
  ``median ± max(k·1.4826·MAD, rel_slack·|median|)`` — a robust band that
  adapts as the system (or the host) drifts, instead of rotting constants.

Events are plain data so CI can render them, count regressions for the
exit code, and archive them next to the trajectory.
"""
from __future__ import annotations

import dataclasses

from .baseline import MIN_RUNS, RunRecord, rolling_baseline


@dataclasses.dataclass(frozen=True)
class MetricPolicy:
    """How one benchmark metric is judged.

    ``better`` gives the improvement direction ("higher" for speedups,
    "lower" for latencies); ``floor``/``ceiling`` are the bootstrap
    constants asserted while the trajectory is short (and kept as absolute
    backstops afterwards); ``rel_slack`` widens the envelope to at least
    that fraction of the median so a near-zero MAD (deterministic metric)
    doesn't flag noise-level wiggle.
    """

    metric: str
    better: str = "higher"              # "higher" | "lower"
    floor: float | None = None          # bootstrap: fail if value < floor
    ceiling: float | None = None        # bootstrap: fail if value > ceiling
    rel_slack: float = 0.10
    window: int = 10

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MetricPolicy":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass(frozen=True)
class PerfEvent:
    """One detected excursion: a regression, an improvement, or a bootstrap
    floor/ceiling violation."""

    kind: str                           # "regression" | "improvement"
    scenario: str
    metric: str
    value: float
    baseline_median: float
    lo: float
    hi: float
    n_runs: int                         # prior runs the baseline used
    detail: str = ""

    @property
    def is_regression(self) -> bool:
        return self.kind == "regression"

    def __str__(self) -> str:
        band = (f"baseline={self.baseline_median:.4g} "
                f"[{self.lo:.4g}, {self.hi:.4g}] n={self.n_runs}")
        return (f"[{self.kind.upper()}] {self.scenario}.{self.metric} = "
                f"{self.value:.4g} ({band}){' — ' + self.detail if self.detail else ''}")


def _bootstrap_events(record: RunRecord, policy: MetricPolicy,
                      value: float, n: int) -> list[PerfEvent]:
    events = []
    if policy.floor is not None and value < policy.floor:
        events.append(PerfEvent(
            "regression", record.scenario, policy.metric, value,
            policy.floor, policy.floor, float("inf"), n,
            detail="bootstrap floor"))
    if policy.ceiling is not None and value > policy.ceiling:
        events.append(PerfEvent(
            "regression", record.scenario, policy.metric, value,
            policy.ceiling, float("-inf"), policy.ceiling, n,
            detail="bootstrap ceiling"))
    return events


def detect_events(record: RunRecord, history: list[RunRecord],
                  policies: dict[str, MetricPolicy]) -> list[PerfEvent]:
    """Judge ``record`` against its predecessors (``history`` excludes the
    record itself). Returns every excursion, regressions and improvements
    both; callers gate CI on ``[e for e in events if e.is_regression]``."""
    events: list[PerfEvent] = []
    for name, policy in policies.items():
        if name not in record.metrics:
            continue
        value = record.metrics[name]
        prior = [r for r in history if name in r.metrics]
        n = len(prior)
        # absolute backstops always apply (and are all that applies while
        # the trajectory is bootstrapping)
        events.extend(_bootstrap_events(record, policy, value, n))
        if n < MIN_RUNS:
            continue
        base = rolling_baseline(prior, name, window=policy.window)
        lo, hi = base.envelope(rel_slack=policy.rel_slack)
        if policy.better == "higher":
            if value < lo:
                events.append(PerfEvent("regression", record.scenario, name,
                                        value, base.median, lo, hi, n))
            elif value > hi:
                events.append(PerfEvent("improvement", record.scenario, name,
                                        value, base.median, lo, hi, n))
        else:
            if value > hi:
                events.append(PerfEvent("regression", record.scenario, name,
                                        value, base.median, lo, hi, n))
            elif value < lo:
                events.append(PerfEvent("improvement", record.scenario, name,
                                        value, base.median, lo, hi, n))
    return events
