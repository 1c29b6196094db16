# Copy of src/repro/obs/workload.py, kept numpy-only; change both copies together.
"""Stress workload driver: modeled client populations + fairness telemetry.

Every scenario in the BENCH trajectory exercises one scripted shape per
feature; production traffic is a *mix* — interactive lookups riding under
batch analytics while a scan storm bursts and a quota squatter sits on
admission slots. This module generates that mix deterministically:

* :class:`ClientPopulation` — a declarative spec for one client class
  (arrival process, per-beat rate, cost distribution, fan-out width,
  deadline, activation window, optional admission-slot squatting);
* :class:`SideWorkload` — the protocol (after YDB's ``side_workloads.py``)
  for anything that submits background requests *alongside* a measured
  scenario, on the measured scenario's own modeled clock.
  :class:`InteractiveSideLoad` is the reference implementation (the PR 7
  ``transport_bench.submit_side_load`` shape); :class:`PopulationSideWorkload`
  runs one :class:`ClientPopulation` as a side workload;
* :class:`StressDriver` — submits a whole population mix through one
  ``ScanGateway`` heartbeat by heartbeat, snapshots per-population
  telemetry into the ``workload.*`` registry namespace
  (``workload.<pop>.grant_latency.p50/p99``, per-population throughput,
  shed/decline attribution from the flight recorder) plus cross-population
  fairness (:func:`jain_index` over per-class throughput,
  interactive-vs-batch latency inflation), and feeds every beat's snapshot
  to an optional ``SloEngine`` so burn-rate pages are the pass/fail signal.

Arrivals for beat *b* are stamped inside the modeled window
``(prev_beat_clock, this_beat_clock]`` — "arrived while the previous beat
was draining, submitted at the boundary" — so queue waits are non-negative
by construction and a long overloaded beat genuinely inflates the next
beat's grant latencies. Randomness comes from a per-population
``numpy.random.default_rng`` seeded from ``(seed, crc32(name))``: the same
seed replays the identical submit schedule and registry snapshot.

Like the rest of :mod:`repro.obs` this module imports nothing from the
layers it drives at import time — the gateway/admission objects are
duck-typed, and ``ScanRequest``/``ClientClass`` are imported lazily inside
the factories that build them.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .registry import MetricsRegistry


def jain_index(values) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over per-class throughput.

    Bounds: ``1/n`` (one class hogs everything) to ``1.0`` (perfect
    equality). Degenerate inputs are *fair by definition*: an empty set,
    a single class, or an all-zero allocation all return 1.0 — nobody is
    being starved relative to anybody else.
    """
    vals = [max(0.0, float(v)) for v in values]
    total = sum(vals)
    if not vals or total <= 0.0:
        return 1.0
    return (total * total) / (len(vals) * sum(v * v for v in vals))


def _request(**kw):
    # lazy: obs stays an import-leaf; the qos layer is only touched when a
    # workload actually builds a request
    from ..qos import ScanRequest
    return ScanRequest(**kw)


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """One client class's traffic spec, in modeled time.

    ``arrival`` picks the process stamping offsets inside each beat window:

    * ``"burst"`` — all ``rate_per_beat`` requests at the window end (the
      submit instant; what scripted scenarios and side-loads do);
    * ``"uniform"`` — evenly spaced across the window, rng-free (so a
      population without cost jitter is schedule-identical across seeds);
    * ``"poisson"`` — a Poisson-drawn count at uniform-random offsets.

    ``squat_servers`` names admission shards on which the population holds
    one stream slot each while active (the adversarial quota-squatter: it
    submits nothing, it just makes *other* tenants' fan-outs decline).
    A server listed twice squats two of its slots.
    """

    name: str                          # gateway class name (WFQ weight key)
    weight: float = 1.0                # WFQ weight for the class
    arrival: str = "burst"             # "burst" | "uniform" | "poisson"
    rate_per_beat: float = 1.0         # mean submissions per heartbeat
    sql: str = "SELECT c0 FROM t"
    dataset: str = "/d"
    cost_hint: float = 1.0
    cost_jitter: float = 0.0           # lognormal sigma on cost_hint
    num_streams: int | None = None
    deadline_s: float | None = None
    client_id: str | None = None       # defaults to the population name
    start_beat: int = 0                # first active beat (inclusive)
    stop_beat: int | None = None       # first inactive beat (exclusive)
    squat_servers: tuple = ()

    def __post_init__(self):
        if self.arrival not in ("burst", "uniform", "poisson"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.rate_per_beat < 0:
            raise ValueError("rate_per_beat must be >= 0")

    def active(self, beat: int) -> bool:
        return (beat >= self.start_beat
                and (self.stop_beat is None or beat < self.stop_beat))

    def draw(self, rng: np.random.Generator, window_lo_s: float,
             window_hi_s: float) -> list[dict]:
        """One beat's submissions as ``ScanRequest`` kwargs, arrival-sorted.

        Deterministic per rng state; ``"burst"``/``"uniform"`` with zero
        cost jitter never touch the rng at all.
        """
        if self.arrival == "poisson":
            count = int(rng.poisson(self.rate_per_beat))
        else:
            count = int(round(self.rate_per_beat))
        if count <= 0:
            return []
        span = max(0.0, window_hi_s - window_lo_s)
        if self.arrival == "burst":
            offsets = [window_hi_s] * count
        elif self.arrival == "uniform":
            offsets = [window_lo_s + span * (i + 1) / count
                       for i in range(count)]
        else:
            offsets = sorted(window_lo_s + span * float(u)
                             for u in rng.uniform(0.0, 1.0, size=count))
        cid = self.client_id if self.client_id is not None else self.name
        out = []
        for at_s in offsets:
            cost = self.cost_hint
            if self.cost_jitter > 0.0:
                cost *= float(np.exp(
                    self.cost_jitter * rng.standard_normal()))
            out.append(dict(client_id=cid, klass=self.name, sql=self.sql,
                            dataset=self.dataset, cost_hint=cost,
                            deadline_s=self.deadline_s, arrival_s=at_s,
                            num_streams=self.num_streams))
        return out


def population_classes(populations):
    """The ``ClientClass`` list a gateway needs to queue these populations
    (one class per population, weight carried over)."""
    from ..qos import ClientClass
    return [ClientClass(p.name, p.weight) for p in populations]


class SideWorkload:
    """Protocol for background traffic riding a measured scenario.

    A side workload owns *what* to submit; the caller owns *when*: each
    ``submit(gateway)`` call stamps one beat's worth of requests onto the
    gateway's current modeled clock and returns the accepted requests
    (``None`` entries were shed at submit). Implementations must not drain
    the gateway — the measured scenario decides when ``run()`` happens.
    """

    name = "side"

    def submit(self, gateway, now_s: float | None = None) -> list:
        raise NotImplementedError


class InteractiveSideLoad(SideWorkload):
    """The reference side workload: ``count`` light interactive lookups at
    the current modeled instant — exactly the PR 7
    ``transport_bench.submit_side_load`` shape, now behind the protocol."""

    def __init__(self, sql: str, dataset: str = "/d", *, count: int = 2,
                 client_id: str = "side", klass: str = "interactive",
                 cost_hint: float = 1.0, num_streams: int | None = 2):
        self.name = client_id
        self.sql = sql
        self.dataset = dataset
        self.count = count
        self.client_id = client_id
        self.klass = klass
        self.cost_hint = cost_hint
        self.num_streams = num_streams

    def submit(self, gateway, now_s: float | None = None) -> list:
        now = gateway.clock_s if now_s is None else now_s
        reqs = []
        for _ in range(self.count):
            reqs.append(gateway.submit(_request(
                client_id=self.client_id, klass=self.klass, sql=self.sql,
                dataset=self.dataset, cost_hint=self.cost_hint,
                arrival_s=now, num_streams=self.num_streams)))
        return reqs


class PopulationSideWorkload(SideWorkload):
    """One :class:`ClientPopulation` run as a side workload.

    Keeps a window cursor: each ``submit`` stamps the arrivals that landed
    in ``(last_submit_clock, now]``, so back-to-back beats tile modeled
    time with no gaps and no overlap. ``schedule`` accumulates every
    submitted request's kwargs — the determinism test's witness.
    """

    def __init__(self, population: ClientPopulation, seed: int = 0):
        self.population = population
        self.name = population.name
        self.rng = np.random.default_rng(
            [seed & 0xFFFFFFFF, zlib.crc32(population.name.encode())])
        self.beat = 0
        self.schedule: list[dict] = []
        self._last_s: float | None = None

    def submit(self, gateway, now_s: float | None = None) -> list:
        now = gateway.clock_s if now_s is None else now_s
        # min(): a fresh gateway's clock restarts at 0 (the slo scenario
        # swaps gateways between phases) — never stamp arrivals after `now`
        lo = now if self._last_s is None else min(self._last_s, now)
        reqs = []
        if self.population.active(self.beat):
            for kw in self.population.draw(self.rng, lo, now):
                self.schedule.append(dict(kw))
                reqs.append(gateway.submit(_request(**kw)))
        self._last_s = now
        self.beat += 1
        return reqs


@dataclasses.dataclass
class BeatReport:
    """One driver heartbeat's outcome."""

    index: int
    now_s: float
    submitted: int
    granted: int
    shed: int
    declined: int
    alerts: list = dataclasses.field(default_factory=list)
    migrations: int = 0     # leases failed over to a replica this beat
    membership: list = dataclasses.field(default_factory=list)


class StressDriver:
    """Submits a population mix through one gateway, beat by beat.

    Each :meth:`beat` stamps every active population's arrivals into the
    window since the previous beat, drains the gateway, heartbeats the
    coordinator, rebuilds :attr:`registry` (the ``workload.*`` namespace
    via :func:`record_workload`) and — when an ``SloEngine`` is attached —
    feeds it the snapshot so burn-rate objectives judge the mix.

    Shed/decline attribution rides the coordinator's flight recorder:
    ``qos.shed`` events (deadline sheds) and ``qos.backpressure`` events
    (admission declines) carry ``klass=`` attrs, so the driver splits each
    population's ``ClassStats.shed`` total causally. Squatting populations
    seize/release their admission slots at their activation edges.

    Everything here is modeled time on the gateway's own clock; with the
    same seed and the same fabric the whole run — schedule, telemetry,
    alerts — replays identically.
    """

    def __init__(self, gateway, populations, *, seed: int = 0, slo=None,
                 recorder=None, nemesis=None, membership=None,
                 inflation_pair: tuple[str, str] = ("interactive", "batch")):
        self.gateway = gateway
        self.populations = list(populations)
        self.loads = [PopulationSideWorkload(p, seed=seed)
                      for p in self.populations]
        self.slo = slo
        # optional chaos loop (both duck-typed): the nemesis injects its
        # scheduled faults at the top of each beat, the membership
        # controller acts on health verdicts right after the heartbeat
        self.nemesis = nemesis
        self.membership = membership
        self.migrations = 0      # cumulative stream.migrate events observed
        self.beat_migrations = 0
        self.recorder = (recorder if recorder is not None else
                         getattr(getattr(gateway, "coordinator", None),
                                 "recorder", None))
        self.inflation_pair = inflation_pair
        self.registry = MetricsRegistry()
        self.alerts: list = []
        self.reports: list[BeatReport] = []
        self.beats = 0
        self.sheds: dict[str, int] = {p.name: 0 for p in self.populations}
        self.declines: dict[str, int] = {p.name: 0
                                         for p in self.populations}
        self.beat_stats: dict[str, dict] = {}
        self._start_clock_s = gateway.clock_s
        self._event_seq = (-1 if self.recorder is None
                           else self.recorder.next_seq - 1)
        self._held: dict[str, list] = {}

    # ------------------------------------------------------------- windows
    @property
    def window_s(self) -> float:
        """The modeled span the driver has been submitting over."""
        return self.gateway.clock_s - self._start_clock_s

    # ---------------------------------------------------------------- beat
    def beat(self) -> BeatReport:
        gw = self.gateway
        index = self.beats
        if self.nemesis is not None:
            self.nemesis.beat(index, gw.clock_s)
        self._squat(index)
        before = {p.name: self._class_counts(p.name)
                  for p in self.populations}
        migrate_seq = (self.recorder.next_seq
                       if self.recorder is not None else 0)
        submitted = []
        for load in self.loads:
            submitted.extend(load.submit(gw, now_s=gw.clock_s))
        gw.run()
        now = gw.clock_s
        heartbeat = getattr(getattr(gw, "coordinator", None),
                            "heartbeat", None)
        if callable(heartbeat):
            heartbeat(now)
        transitions = (self.membership.heartbeat(now)
                       if self.membership is not None else [])
        migrations = 0
        if self.recorder is not None:
            migrations = sum(
                1 for ev in self.recorder.events(kinds=("stream.migrate",))
                if ev.seq >= migrate_seq)
            self.migrations += migrations
        self.beat_migrations = migrations
        shed_d, decl_d = self._attribute_events()
        self.beat_stats = {}
        for p in self.populations:
            b0 = before[p.name]
            b1 = self._class_counts(p.name)
            fresh = self._class_latencies(p.name)[b0["latencies"]:]
            self.beat_stats[p.name] = {
                "submitted": b1["submitted"] - b0["submitted"],
                "granted": b1["granted"] - b0["granted"],
                "shed": b1["shed"] - b0["shed"],
                "declines": decl_d.get(p.name, 0),
                "deadline_sheds": shed_d.get(p.name, 0),
                "p50_grant_us": _p50(fresh) * 1e6,
            }
        reg = MetricsRegistry()
        record_workload(reg, self)
        self.registry = reg
        fired = (list(self.slo.observe(now, reg.snapshot()))
                 if self.slo is not None else [])
        self.alerts.extend(fired)
        gw.stats.alerts += len(fired)
        report = BeatReport(
            index=index, now_s=now, submitted=len(submitted),
            granted=sum(s["granted"] for s in self.beat_stats.values()),
            shed=sum(s["shed"] for s in self.beat_stats.values()),
            declined=sum(s["declines"] for s in self.beat_stats.values()),
            alerts=fired, migrations=migrations,
            membership=list(transitions))
        self.reports.append(report)
        self.beats += 1
        return report

    # ------------------------------------------------------------ fairness
    def fairness(self) -> dict:
        """Cross-population fairness over the driver's modeled window:
        Jain's index over per-class throughput (populations that have
        submitted at least once), and the latency-inflation ratio between
        ``inflation_pair`` (p50 grant latency of the first over the
        second; 1.0 when either side has no samples)."""
        window = self.window_s
        tputs: dict[str, float] = {}
        for p in self.populations:
            c = self.gateway.stats.classes.get(p.name)
            if c is None or c.submitted == 0:
                continue
            tputs[p.name] = c.throughput_over(window)
        hi, lo = self.inflation_pair
        hi_p50 = _p50(self._class_latencies(hi))
        lo_p50 = _p50(self._class_latencies(lo))
        inflation = (hi_p50 / lo_p50) if hi_p50 > 0 and lo_p50 > 0 else 1.0
        return {"jain": jain_index(tputs.values()),
                "throughput_bps": tputs,
                "latency_inflation": inflation}

    # ------------------------------------------------------------- helpers
    def _class_counts(self, name: str) -> dict:
        c = self.gateway.stats.classes.get(name)
        if c is None:
            return {"submitted": 0, "granted": 0, "shed": 0, "latencies": 0}
        return {"submitted": c.submitted, "granted": c.granted,
                "shed": c.shed, "latencies": len(c.grant_latency_s)}

    def _class_latencies(self, name: str) -> list[float]:
        c = self.gateway.stats.classes.get(name)
        return [] if c is None else c.grant_latency_s

    def _attribute_events(self) -> tuple[dict, dict]:
        """Split this beat's recorder window into per-population deadline
        sheds (``qos.shed``) and admission declines (``qos.backpressure``),
        keyed by the event's ``klass`` attr."""
        shed_d: dict[str, int] = {}
        decl_d: dict[str, int] = {}
        if self.recorder is None:
            return shed_d, decl_d
        names = {p.name for p in self.populations}
        for ev in self.recorder.events(
                kinds=("qos.shed", "qos.backpressure")):
            if ev.seq <= self._event_seq:
                continue
            klass = ev.attrs.get("klass", "")
            if klass not in names:
                continue
            bucket = shed_d if ev.kind == "qos.shed" else decl_d
            bucket[klass] = bucket.get(klass, 0) + 1
        self._event_seq = self.recorder.next_seq - 1
        for name, n in shed_d.items():
            self.sheds[name] = self.sheds.get(name, 0) + n
        for name, n in decl_d.items():
            self.declines[name] = self.declines.get(name, 0) + n
        return shed_d, decl_d

    def _squat(self, beat: int) -> None:
        """Seize/release squatting populations' admission slots at their
        activation edges. A denied squat is counted as that population's
        own decline — the squatter lost, everyone else is safe."""
        admission = getattr(getattr(self.gateway, "coordinator", None),
                            "admission", None)
        if admission is None:
            return
        from ..qos import Backpressure
        for p in self.populations:
            if not p.squat_servers:
                continue
            cid = p.client_id if p.client_id is not None else p.name
            if p.active(beat) and p.name not in self._held:
                held = []
                for sid in p.squat_servers:
                    try:
                        admission.acquire_stream(cid, server_id=sid)
                        held.append(sid)
                    except Backpressure:
                        self.declines[p.name] = (
                            self.declines.get(p.name, 0) + 1)
                self._held[p.name] = held
            elif not p.active(beat) and p.name in self._held:
                for sid in self._held.pop(p.name):
                    admission.release_stream(cid, server_id=sid)


def _p50(values) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1,
                       max(0, int(round(0.5 * (len(ordered) - 1)))))]


def record_workload(reg: MetricsRegistry, driver,
                    prefix: str = "workload") -> None:
    """A :class:`StressDriver` → the ``workload.*`` namespace.

    Per population: cumulative counters (submitted/granted/shed plus the
    recorder-attributed deadline-shed vs admission-decline split), the
    grant-latency histogram in µs (snapshot expands to ``.p50/.p95/.p99``),
    window throughput, and per-beat gauges (``.beat.*``) the SLO engine's
    burn-rate objectives watch. Cross-population: Jain's fairness index and
    the latency-inflation ratio. Everything recorded is modeled — two runs
    with the same seed and fabric snapshot identically.
    """
    classes = driver.gateway.stats.classes
    window_s = driver.window_s
    for p in driver.populations:
        pp = f"{prefix}.{p.name}"
        c = classes.get(p.name)
        if c is not None:
            reg.counter(f"{pp}.submitted", c.submitted)
            reg.counter(f"{pp}.granted", c.granted)
            reg.counter(f"{pp}.shed", c.shed)
            reg.counter(f"{pp}.bytes", c.bytes)
            reg.histogram(f"{pp}.grant_latency",
                          [v * 1e6 for v in c.grant_latency_s])
            reg.gauge(f"{pp}.throughput_bps", c.throughput_over(window_s))
        reg.counter(f"{pp}.shed.deadline", driver.sheds.get(p.name, 0))
        reg.counter(f"{pp}.declines", driver.declines.get(p.name, 0))
        beat = driver.beat_stats.get(p.name, {})
        reg.gauge(f"{pp}.beat.submitted", beat.get("submitted", 0))
        reg.gauge(f"{pp}.beat.granted", beat.get("granted", 0))
        reg.gauge(f"{pp}.beat.shed", beat.get("shed", 0))
        reg.gauge(f"{pp}.beat.declines", beat.get("declines", 0))
        reg.gauge(f"{pp}.beat.p50_grant_us", beat.get("p50_grant_us", 0.0))
    reg.counter(f"{prefix}.migrations", getattr(driver, "migrations", 0))
    reg.gauge(f"{prefix}.beat.migrations",
              float(getattr(driver, "beat_migrations", 0)))
    fair = driver.fairness()
    reg.gauge(f"{prefix}.fairness.jain", fair["jain"])
    reg.gauge(f"{prefix}.fairness.latency_inflation",
              fair["latency_inflation"])
    reg.gauge(f"{prefix}.window.us", window_s * 1e6)
    reg.gauge(f"{prefix}.populations", float(len(driver.populations)))
