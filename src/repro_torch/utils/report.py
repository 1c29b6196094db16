# Copy of src/repro/utils/report.py, kept numpy-only; change both copies together.
"""Render EXPERIMENTS.md tables: dryrun/roofline artifacts, plus the
transport-side buffer-pool and qos summaries (duck-typed against
``repro.cluster.PoolStats`` / ``repro.qos.QosStats`` so this module stays
dependency-free)."""
from __future__ import annotations

import glob
import json
import os


def load_artifacts(art_dir: str = "artifacts/dryrun") -> list[dict]:
    arts = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            arts.append(json.load(f))
    return arts


def mesh_tag(art: dict) -> str:
    return "x".join(str(v) for v in art["mesh"].values())


def roofline_table(arts: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | fits | peak GiB/dev | C (ms) | M (ms) | "
            "M fused (ms) | X (ms) | bottleneck | useful | MFU bound | "
            "one-line lever |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    levers = {
        "collective": "cut TP activation/weight gathers (layout or replication)",
        "memory": "fuse attention interior into VMEM (Pallas splash) / smaller dtype",
        "compute": "already MXU-bound: raise per-chip batch or quit early",
    }
    for a in arts:
        if mesh_tag(a) != mesh:
            continue
        if a["status"] == "skipped":
            rows.append(f"| {a['arch']} | {a['shape']} | — | — | — | — | — | "
                        f"— | skipped | — | — | {a['skip_reason']} |")
            continue
        if a["status"] == "error":
            rows.append(f"| {a['arch']} | {a['shape']} | — | — | — | — | — | "
                        f"— | ERROR | — | — | {a['error'][:60]} |")
            continue
        r = a["roofline"]
        rf = a.get("roofline_fused", r)
        m = a["memory"]
        rows.append(
            f"| {a['arch']} | {a['shape']} | "
            f"{'✓' if m.get('fits_hbm') else '✗'} | "
            f"{m['peak_bytes_per_device']/2**30:.2f} | "
            f"{r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} | "
            f"{rf['memory_s']*1e3:.1f} | "
            f"{r['collective_s']*1e3:.1f} | {rf['bottleneck']} | "
            f"{r['useful_flops_ratio']:.2f} | {rf['mfu_bound']:.3f} | "
            f"{levers[rf['bottleneck']]} |")
    return "\n".join(rows)


def dryrun_table(arts: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | status | compile s | args GiB | temp GiB | "
            "flops/dev | bytes/dev | collectives (count) | wire MiB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for a in arts:
        if mesh_tag(a) != mesh:
            continue
        if a["status"] != "ok":
            rows.append(f"| {a['arch']} | {a['shape']} | {a['status']} | — | — "
                        f"| — | — | — | — | — |")
            continue
        lc = a["loop_cost"]
        counts = ", ".join(f"{k}:{int(v)}" for k, v in
                           sorted(lc["collective_counts"].items()))
        rows.append(
            f"| {a['arch']} | {a['shape']} | ok | {a['compile_s']:.0f} | "
            f"{a['memory']['argument_bytes']/2**30:.2f} | "
            f"{a['memory']['temp_bytes']/2**30:.2f} | "
            f"{lc['flops']:.2e} | {lc['bytes']:.2e} | {counts} | "
            f"{lc['collective_wire_bytes']/2**20:.0f} |")
    return "\n".join(rows)


def render_table(columns, rows) -> str:
    """The one markdown table builder every ``*_table`` helper sits on:
    a header row, the ``|---|`` separator, one row per cell list. Cells
    are stringified as-is — formatting (units, precision) stays with the
    callers, which own their stats' semantics."""
    out = ["| " + " | ".join(str(c) for c in columns) + " |",
           "|" + "---|" * len(columns)]
    for row in rows:
        out.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(out)


def pool_table(stats) -> str:
    """One-row markdown table for a ``repro.cluster.PoolStats``."""
    return render_table(
        ["hit rate", "hits", "misses", "slabs", "resident MiB",
         "evictions", "evicted MiB", "registered segs", "register us"],
        [[f"{stats.hit_rate:.2f}", stats.hits, stats.misses,
          stats.slabs_created, f"{stats.bytes_resident / 2**20:.2f}",
          stats.evictions, f"{stats.bytes_evicted / 2**20:.2f}",
          stats.registered_segments,
          f"{stats.modeled_register_s * 1e6:.1f}"]])


def qos_table(qos) -> str:
    """Per-class markdown table for a ``repro.qos.QosStats`` (grant latency,
    sheds, throughput), with the gateway-level counters in a footer row."""
    rows = []
    for name in sorted(qos.classes):
        c = qos.classes[name]
        rows.append([name, f"{c.granted}/{c.submitted}", c.shed,
                     f"{c.p50_grant_latency_s * 1e3:.3f}",
                     f"{c.max_grant_latency_s * 1e3:.3f}",
                     f"{c.throughput_bytes_per_s / 1e6:.1f}", c.bytes])
    rows.append(["*gateway*", f"{qos.granted}/{qos.submitted}", qos.shed,
                 f"depth_max={qos.queue_depth_max}",
                 f"throttle={qos.throttle_wait_s * 1e3:.3f}",
                 f"makespan={qos.makespan_s * 1e3:.3f}", qos.bytes])
    return render_table(
        ["class", "granted", "shed", "p50 grant ms", "max grant ms",
         "throughput MB/s", "bytes"], rows)


def sched_table(qos) -> str:
    """Per-class markdown table for the adaptive-scheduler counters a
    ``repro.qos.QosStats`` carries (steals / shared-ticket hits /
    preemptions), rendered alongside :func:`pool_table` / :func:`qos_table`.
    Duck-typed like its siblings so this module stays dependency-free."""
    rows = []
    for name in sorted(qos.classes):
        c = qos.classes[name]
        rows.append([name, f"{c.granted}/{c.submitted}", c.ticket_hits,
                     c.preemptions, f"{c.p50_grant_latency_s * 1e3:.3f}",
                     f"{c.service_s * 1e3:.3f}"])
    hit_rate = qos.ticket_hits / qos.granted if qos.granted else 0.0
    rows.append(["*sched*", f"steals={qos.steals}",
                 f"hit_rate={hit_rate:.2f}", f"preempt={qos.preemptions}",
                 f"fanouts={len(qos.cluster)}",
                 f"makespan={qos.makespan_s * 1e3:.3f}"])
    return render_table(
        ["class", "granted", "ticket hits", "preemptions",
         "p50 grant ms", "service ms"], rows)


def steal_table(stats) -> str:
    """Per-shard markdown table of work-stealing decisions — steals landed,
    batches moved, admission declines and re-steals, attributed by each
    event's ``server_id`` (events recorded before the field existed fall
    back to their thief). Accepts a ``repro.qos.QosStats`` (aggregates its
    per-request clusters) or a single ``repro.cluster.ClusterStats``.
    Duck-typed like its siblings so this module stays dependency-free."""
    clusters = getattr(stats, "cluster", None)
    if clusters is None:
        clusters = [stats]
    agg: dict = {}
    for c in clusters:   # ClusterStats owns the per-event attribution rule
        for sid, per in c.steal_attribution().items():
            row = agg.setdefault(sid, {})
            for key, count in per.items():
                row[key] = row.get(key, 0) + count
    keys = ("steal", "batches", "decline", "re_steal")
    rows = [[sid] + [agg[sid].get(k, 0) for k in keys]
            for sid in sorted(agg)]
    rows.append(["*total*"] + [sum(r.get(k, 0) for r in agg.values())
                               for k in keys])
    return render_table(
        ["shard", "steals in", "batches in", "declines", "re-steals in"],
        rows)


def admission_table(stats) -> str:
    """Per-shard markdown table for a ``repro.qos.DistributedStats`` —
    grant/denial/borrow/reconcile counters plus the token-bucket traffic —
    with the cluster-wide aggregate in a footer row. Also accepts a plain
    ``AdmissionStats`` (centralized controller): one ``*global*`` row.
    Duck-typed like its siblings so this module stays dependency-free."""
    columns = ["shard", "grants", "denials (quota/total/mem)", "borrows",
               "lends", "reconciles", "tokens in/out", "throttle ms",
               "peak"]

    def denials(s) -> str:
        return (f"{s.stream_denials}/{s.total_denials}/{s.memory_denials}")

    shards = getattr(stats, "shards", None)
    if not shards:
        return render_table(columns, [
            ["*global*", stats.stream_grants, denials(stats), "—", "—",
             "—", "—", f"{stats.throttle_wait_s * 1e3:.3f}",
             stats.peak_active]])
    rows = []
    for sid in sorted(shards):
        s = shards[sid]
        rows.append([sid, s.stream_grants, denials(s), s.borrows, s.lends,
                     s.reconciles, f"{s.tokens_in:.1f}/{s.tokens_out:.1f}",
                     f"{s.throttle_wait_s * 1e3:.3f}", s.peak_active])
    rows.append(["*cluster*", stats.stream_grants, denials(stats),
                 stats.borrows, stats.lends, stats.reconciles,
                 f"moved={stats.tokens_rebalanced:.1f}",
                 f"{stats.throttle_wait_s * 1e3:.3f}", stats.peak_total])
    return render_table(columns, rows)


def trace_table(tracer) -> str:
    """Per-(category, name) span aggregates for an ``obs.Tracer`` — count,
    total and max modeled duration — the textual companion to the Chrome
    trace export. Duck-typed on ``tracer.summary()`` so this module stays
    dependency-free."""
    rows = []
    for (cat, name), agg in sorted(tracer.summary().items()):
        rows.append([cat, name, agg["count"],
                     f"{agg['total_s'] * 1e6:.1f}",
                     f"{agg['max_s'] * 1e6:.1f}"])
    return render_table(["cat", "span", "count", "total us", "max us"],
                        rows)


def health_table(monitor) -> str:
    """Per-server health verdicts for an ``obs.HealthMonitor`` — state,
    when it last changed, the signals behind it — plus the cluster-wide
    pool-pressure/heartbeat footer. Duck-typed on ``monitor.snapshot()``
    so this module stays dependency-free."""
    snap = monitor.snapshot()
    rows = []
    for sid, h in snap.get("servers", {}).items():
        rate = h.get("rate_us_per_batch")
        rows.append([
            sid, h.get("state", "?"),
            f"{h.get('since_s', 0.0) * 1e3:.3f}",
            "-" if rate is None else f"{rate:.1f}",
            h.get("flaps", 0), h.get("faults", 0), h.get("denials", 0),
            h.get("declines", 0), h.get("transitions", 0),
            h.get("reason", ""),
        ])
    table = render_table(
        ["server", "state", "since ms", "rate us/b", "flaps", "faults",
         "denials", "declines", "trans", "reason"], rows)
    footer = (f"heartbeats={snap.get('heartbeats', 0)} "
              f"pool_pressure={snap.get('pool_pressure', 0.0):.2f}")
    return f"{table}\n{footer}"


def workload_table(driver) -> str:
    """Per-population markdown table for an ``obs.StressDriver`` — grants,
    causally attributed deadline sheds vs admission declines, grant-latency
    p50/p99 and window throughput — with the cross-population fairness
    verdict (Jain's index, latency inflation) in the footer. Duck-typed on
    the driver's ``populations``/``gateway.stats``/``fairness()`` surface
    so this module stays dependency-free."""
    fair = driver.fairness()
    window_s = driver.window_s
    rows = []
    for pop in driver.populations:
        c = driver.gateway.stats.classes.get(pop.name)
        if c is None or c.submitted == 0:
            rows.append([pop.name, "0/0", 0, 0, "-", "-", "-"])
            continue
        rows.append([
            pop.name, f"{c.granted}/{c.submitted}",
            driver.sheds.get(pop.name, 0),
            driver.declines.get(pop.name, 0),
            f"{c.p50_grant_latency_s * 1e6:.1f}",
            f"{c.p99_grant_latency_s * 1e6:.1f}",
            f"{c.throughput_over(window_s) / 1e6:.1f}",
        ])
    table = render_table(
        ["population", "granted", "shed", "declined", "p50 grant us",
         "p99 grant us", "throughput MB/s"], rows)
    footer = (f"jain={fair['jain']:.3f} "
              f"latency_inflation={fair['latency_inflation']:.2f} "
              f"beats={driver.beats} window_us={window_s * 1e6:.1f}")
    return f"{table}\n{footer}"


def export_trace(tracer, path: str) -> str:
    """Write an ``obs.Tracer``'s collected scans as Chrome ``trace_event``
    JSON (load in ``chrome://tracing`` or https://ui.perfetto.dev).
    Returns ``path``. Duck-typed on ``tracer.to_chrome()``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(tracer.to_chrome(), f)
    return path


def summary_stats(arts: list[dict]) -> dict:
    ok = sum(1 for a in arts if a["status"] == "ok")
    skip = sum(1 for a in arts if a["status"] == "skipped")
    err = sum(1 for a in arts if a["status"] == "error")
    return {"ok": ok, "skipped": skip, "errors": err, "total": len(arts)}
