# Copy of src/repro/obs/trace.py, kept numpy-only; change both copies together.
"""Distributed scan tracing in modeled time.

A :class:`TraceContext` is created at ``ScanGateway.submit`` and rides the
scan down through the scheduler, the stream pullers and the coordinator.
Every layer records spans against it — admission wait, WFQ queueing, lease
RPC, RDMA pull, prefetch overlap, steal/decline/re-steal, park/unpark,
reassembly — all on the **modeled** clock (the same deterministic clock the
qos/sched/cluster layers advance), so a trace is exactly reproducible.

Clock domains. Per-stream pullers keep a local ``clock_s`` that starts at 0
and is later *placed* on the scan timeline via ``stats.start_s`` (thieves
spawn mid-scan) and on the gateway timeline via the request's grant clock.
Spans therefore carry a ``group`` label: spans in a group share a shift
(``set_shift``) applied on top of the context-wide ``base_s`` at commit
time; group-``None`` spans are already absolute. ``StreamTrace`` binds a
fresh group + track per stream so layers below never deal with shifts.

Export: :meth:`Tracer.to_chrome` emits Chrome ``trace_event`` JSON
("X" complete + "i" instant events, µs units) loadable in
``chrome://tracing`` / Perfetto; :meth:`Tracer.summary` aggregates per
(category, name) for ``utils.report.trace_table``.
"""
from __future__ import annotations

import dataclasses
import itertools
import typing


@dataclasses.dataclass
class Span:
    """One traced interval (or instant) in modeled seconds.

    ``start_s`` is group-relative until :meth:`TraceContext.commit`
    resolves it onto the scan timeline; ``phase`` follows the Chrome
    trace_event convention ("X" complete, "i" instant).
    """

    track: str                      # tid: which lane the span renders on
    name: str
    cat: str
    start_s: float
    dur_s: float = 0.0
    phase: str = "X"
    args: dict = dataclasses.field(default_factory=dict)
    group: str | None = None        # shift-group; None = already absolute


class StreamTrace:
    """A per-stream view of a :class:`TraceContext`: a bound track and a
    fresh shift-group, so stream-local code records spans on its local
    clock (starting at 0) and placement happens once, at commit."""

    def __init__(self, ctx: "TraceContext", track: str, group: str):
        self.ctx = ctx
        self.track = track
        self.group = group

    def span(self, name: str, start_s: float, dur_s: float, *,
             cat: str = "stream", track_suffix: str = "", **args) -> None:
        self.ctx.span(name, start_s, dur_s, track=self.track + track_suffix,
                      cat=cat, group=self.group, **args)

    def instant(self, name: str, at_s: float, *, cat: str = "stream",
                track_suffix: str = "", **args) -> None:
        self.ctx.instant(name, at_s, track=self.track + track_suffix,
                         cat=cat, group=self.group, **args)


class TraceContext:
    """The trace of one scan: spans collected across layers, plus the
    shift bookkeeping that places per-stream local clocks on the scan
    timeline. Committing is idempotent (shed/failed/multicast paths and
    the normal finalize may race to commit)."""

    def __init__(self, tracer: "Tracer", trace_id: int, name: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.base_s = 0.0               # gateway grant clock, set at finalize
        self.spans: list[Span] = []
        self._shifts: dict[str, float] = {}
        self._groups = itertools.count()
        self._committed = False

    # ------------------------------------------------------------ recording
    def span(self, name: str, start_s: float, dur_s: float, *,
             track: str = "scan", cat: str = "scan",
             group: str | None = None, **args) -> None:
        self.spans.append(Span(track, name, cat, start_s, max(dur_s, 0.0),
                               "X", dict(args), group))

    def instant(self, name: str, at_s: float, *, track: str = "scan",
                cat: str = "scan", group: str | None = None, **args) -> None:
        self.spans.append(Span(track, name, cat, at_s, 0.0, "i",
                               dict(args), group))

    def stream(self, track: str) -> StreamTrace:
        """A child view with its own track + shift-group (one per
        stream-puller; thieves get their own at spawn time)."""
        return StreamTrace(self, track, f"g{next(self._groups)}")

    # ---------------------------------------------------------- placement
    def set_shift(self, group: str, offset_s: float) -> None:
        """Place a group's local clock at ``offset_s`` on the scan
        timeline (e.g. a thief stream spawned at its steal epoch)."""
        self._shifts[group] = offset_s

    def resolve_s(self, span: Span) -> float:
        """The span's absolute modeled start time."""
        if span.group is None:
            return span.start_s
        return span.start_s + self.base_s + self._shifts.get(span.group, 0.0)

    # ------------------------------------------------------------- commit
    def commit(self) -> None:
        """Resolve every span onto the scan timeline and hand the trace to
        the tracer. Safe to call more than once; later calls are no-ops."""
        if self._committed:
            return
        self._committed = True
        for span in self.spans:
            span.start_s = self.resolve_s(span)
            span.group = None
        self.tracer._collect(self)


class Tracer:
    """Collects committed scan traces and exports them.

    One ``Tracer`` spans many scans (attach it to a ``ScanGateway``); each
    scan becomes one Chrome *process* (pid = trace_id) with per-stream
    *threads*, so concurrent scans render as parallel process groups.
    """

    def __init__(self):
        self._ids = itertools.count(1)
        self.contexts: list[TraceContext] = []

    def begin(self, name: str) -> TraceContext:
        return TraceContext(self, next(self._ids), name)

    def _collect(self, ctx: TraceContext) -> None:
        self.contexts.append(ctx)

    # -------------------------------------------------------------- export
    def spans(self) -> typing.Iterator[tuple[TraceContext, Span]]:
        for ctx in self.contexts:
            for span in ctx.spans:
                yield ctx, span

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON (the ``traceEvents`` array form),
        timestamps in microseconds of modeled time."""
        events: list[dict] = []
        for ctx in self.contexts:
            events.append({"ph": "M", "name": "process_name",
                           "pid": ctx.trace_id, "tid": 0,
                           "args": {"name": ctx.name}})
            tids: dict[str, int] = {}
            for span in ctx.spans:
                tid = tids.get(span.track)
                if tid is None:
                    tid = tids[span.track] = len(tids) + 1
                    events.append({"ph": "M", "name": "thread_name",
                                   "pid": ctx.trace_id, "tid": tid,
                                   "args": {"name": span.track}})
                ev = {"ph": span.phase, "name": span.name, "cat": span.cat,
                      "pid": ctx.trace_id, "tid": tid,
                      "ts": span.start_s * 1e6}
                if span.phase == "X":
                    ev["dur"] = span.dur_s * 1e6
                if span.phase == "i":
                    ev["s"] = "t"       # thread-scoped instant
                if span.args:
                    ev["args"] = span.args
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def summary(self) -> dict[tuple[str, str], dict]:
        """Aggregate spans per (category, name): count / total_s / max_s
        for complete spans, count only for instants. Feeds
        ``utils.report.trace_table``."""
        agg: dict[tuple[str, str], dict] = {}
        for _, span in self.spans():
            row = agg.setdefault((span.cat, span.name),
                                 {"count": 0, "total_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            if span.phase == "X":
                row["total_s"] += span.dur_s
                row["max_s"] = max(row["max_s"], span.dur_s)
        return agg
