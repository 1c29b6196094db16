# Copy of src/repro/obs/__init__.py, kept numpy-only; change both copies together.
"""repro.obs: the measurement substrate — tracing, telemetry, baselining.

Three coupled layers, all dependency-free (obs imports nothing from the
rest of :mod:`repro`, so every other layer may import obs without cycles):

* **distributed scan tracing** (:mod:`.trace`) — a :class:`TraceContext`
  created at ``ScanGateway.submit`` rides the scan down through the
  scheduler, the stream pullers and the coordinator, recording spans in
  **modeled time** (admission wait, WFQ queueing, lease RPC, RDMA pull,
  prefetch overlap, steal/decline/re-steal, park/unpark, reassembly);
  :class:`Tracer` collects committed scans and exports Chrome
  ``trace_event`` JSON (``utils/report.export_trace``);
* **telemetry registry** (:mod:`.registry`) — a :class:`MetricsRegistry`
  of counters/gauges/histograms that every ``*Stats`` class snapshots
  into under a stable dotted namespace (``cluster.pull.us``,
  ``qos.grant_latency.p50``, ``sched.steals.decline``,
  ``pool.evictions``, …), with one ``registry.snapshot()`` replacing the
  ad-hoc per-layer ``summary()`` plumbing;
* **continuous perf baselining** (:mod:`.baseline` + :mod:`.events`) —
  every ``transport_bench`` scenario emits a structured
  ``BENCH_<scenario>.json`` run record appended to a trajectory;
  rolling baselines (median + MAD window) replace hand-tuned CI
  constants, which remain only as bootstrap floors while the trajectory
  holds fewer than :data:`~repro.obs.baseline.MIN_RUNS` runs;
* **health / SLO / postmortems** (:mod:`.health` + :mod:`.slo` +
  :mod:`.recorder`) — a heartbeat-driven per-server
  ``healthy → degraded → suspect → quarantined`` state machine over the
  signals the stack already produces (:class:`HealthMonitor`),
  declarative objectives over registry names with multi-window
  burn-rate alerting in modeled time (:class:`SloEngine`), and a bounded
  flight-recorder ring of structured cross-layer events
  (:class:`FlightRecorder`) that dumps a postmortem bundle — causal
  events + registry snapshot + health states + trace — when an alert
  fires;
* **stress workload driver** (:mod:`.workload`) — deterministic, seeded
  client populations (:class:`ClientPopulation`) run as side workloads
  (:class:`SideWorkload` / :class:`PopulationSideWorkload`) or as a full
  mix through one gateway (:class:`StressDriver`), with per-population
  telemetry under ``workload.*`` (grant-latency percentiles, throughput,
  shed/decline attribution) and cross-population fairness
  (:func:`jain_index`, latency inflation) judged by ``SloObjective``\\ s.
"""
from __future__ import annotations

from .baseline import (  # noqa: F401
    MIN_RUNS, Baseline, RunRecord, append_run, current_git_sha,
    load_trajectory, rolling_baseline,
)
from .events import MetricPolicy, PerfEvent, detect_events  # noqa: F401
from .health import (  # noqa: F401
    DEGRADED, HEALTHY, QUARANTINED, STATES, SUSPECT, HealthConfig,
    HealthMonitor, HealthTransition, ServerHealth,
)
from .recorder import FlightEvent, FlightRecorder  # noqa: F401
from .registry import (  # noqa: F401
    MetricsRegistry, record_admission, record_any, record_cluster,
    record_fabric, record_gateway, record_health, record_loader,
    record_pool, record_qos, record_repair, record_tickets,
)
from .slo import SloAlert, SloEngine, SloObjective  # noqa: F401
from .trace import Span, StreamTrace, TraceContext, Tracer  # noqa: F401
from .workload import (  # noqa: F401
    BeatReport, ClientPopulation, InteractiveSideLoad,
    PopulationSideWorkload, SideWorkload, StressDriver, jain_index,
    population_classes, record_workload,
)
