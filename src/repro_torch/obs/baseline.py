# Copy of src/repro/obs/baseline.py, kept numpy-only; change both copies together.
"""Continuous perf baselining: run records, trajectories, rolling baselines.

Every ``transport_bench`` scenario emits a :class:`RunRecord` — git sha,
host/config fingerprint, per-metric values, per-metric policies — written
as ``BENCH_<scenario>.json`` (the latest run) and appended to
``trajectory.jsonl`` (the full history). :func:`rolling_baseline` reduces a
metric's recent history to a median + MAD :class:`Baseline`, whose
``envelope()`` is the pass band CI checks instead of hand-tuned constants.

Run as a module to re-judge the latest record of every scenario in a
trajectory directory (this is what the CI ``bench-trajectory`` job calls)::

    python -m repro.obs.baseline artifacts/bench

Exit status 1 when any regression event fires.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess

# Envelope activates once a metric has this many *prior* runs (i.e. from
# the third run of a trajectory); before that only bootstrap constants
# apply. ISSUE: "constants remain only as bootstrap floors while the
# trajectory has <3 runs".
MIN_RUNS = 2

TRAJECTORY = "trajectory.jsonl"


def current_git_sha(cwd: str | None = None) -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except Exception:
        return ""


@dataclasses.dataclass
class RunRecord:
    """One benchmark scenario execution, self-describing enough to be
    re-judged later: values plus the policies they were judged under."""

    scenario: str
    metrics: dict = dataclasses.field(default_factory=dict)
    policies: dict = dataclasses.field(default_factory=dict)  # name -> dict
    git_sha: str = ""
    config: dict = dataclasses.field(default_factory=dict)
    timestamp: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunRecord":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class Baseline:
    """Robust location/scale of one metric over a trajectory window."""

    metric: str
    median: float
    mad: float                          # median absolute deviation
    n: int                              # runs in the window

    def envelope(self, rel_slack: float = 0.10,
                 k: float = 3.0) -> tuple[float, float]:
        """``median ± max(k·1.4826·MAD, rel_slack·|median|)``. The MAD term
        scales with observed run-to-run noise (1.4826 makes it a sigma
        estimate under normality); the relative term keeps a deterministic
        metric (MAD 0) from flagging sub-percent wiggle."""
        spread = max(k * 1.4826 * self.mad, rel_slack * abs(self.median))
        return self.median - spread, self.median + spread


def rolling_baseline(records: list["RunRecord"], metric: str,
                     window: int = 10) -> Baseline:
    """Median + MAD of ``metric`` over the most recent ``window`` records
    that carry it (records are oldest-first, as loaded)."""
    vals = [r.metrics[metric] for r in records if metric in r.metrics]
    vals = vals[-window:]
    if not vals:
        return Baseline(metric, 0.0, 0.0, 0)
    med = statistics.median(vals)
    mad = statistics.median([abs(v - med) for v in vals])
    return Baseline(metric, med, mad, len(vals))


# ---------------------------------------------------------------- storage
def append_run(out_dir: str, record: RunRecord) -> str:
    """Write ``BENCH_<scenario>.json`` (latest run, human-inspectable) and
    append the record to ``trajectory.jsonl``. Returns the JSON path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{record.scenario}.json")
    with open(path, "w") as f:
        json.dump(record.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    with open(os.path.join(out_dir, TRAJECTORY), "a") as f:
        f.write(json.dumps(record.to_dict(), sort_keys=True) + "\n")
    return path


def load_trajectory(out_dir: str,
                    scenario: str | None = None) -> list[RunRecord]:
    """All recorded runs, oldest first; optionally one scenario's."""
    path = os.path.join(out_dir, TRAJECTORY)
    if not os.path.exists(path):
        return []
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = RunRecord.from_dict(json.loads(line))
            if scenario is None or rec.scenario == scenario:
                records.append(rec)
    return records


# -------------------------------------------------------------------- CLI
def check_dir(out_dir: str) -> tuple[list, int]:
    """Re-judge the newest record of every scenario in ``out_dir`` against
    its predecessors, under the policies persisted in the record itself.
    Returns (events, n_scenarios_checked)."""
    from .events import MetricPolicy, detect_events   # lazy: events imports us
    trajectory = load_trajectory(out_dir)
    events, checked = [], 0
    for scenario in sorted({r.scenario for r in trajectory}):
        runs = [r for r in trajectory if r.scenario == scenario]
        latest, history = runs[-1], runs[:-1]
        policies = {name: MetricPolicy.from_dict(d)
                    for name, d in latest.policies.items()}
        if not policies:
            continue
        checked += 1
        events.extend(detect_events(latest, history, policies))
    return events, checked


def main(argv: list[str] | None = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="judge the latest benchmark runs against their "
                    "rolling baselines")
    parser.add_argument("out_dir", help="trajectory directory "
                        "(holds trajectory.jsonl + BENCH_*.json)")
    args = parser.parse_args(argv)
    events, checked = check_dir(args.out_dir)
    regressions = [e for e in events if e.is_regression]
    for e in events:
        print(e)
    runs = len(load_trajectory(args.out_dir))
    print(f"baseline: {checked} scenario(s) checked over {runs} recorded "
          f"run(s); {len(regressions)} regression(s), "
          f"{len(events) - len(regressions)} improvement(s)")
    return 1 if regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
