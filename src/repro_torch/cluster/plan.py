# Copy of src/repro/cluster/plan.py, kept numpy-only; change both copies together.
"""Partitioned-scan planning: one query → many endpoints.

Arrow Flight amortizes per-stream setup costs by answering ``GetFlightInfo``
with a *list of endpoints*, each a (ticket, location) pair the client pulls
in parallel ("Benchmarking Apache Arrow Flight", arXiv:2204.03032). This
module is the Thallus analogue: :func:`plan_scan` turns ``(sql, dataset)``
plus a placement map into a deterministic :class:`ScanPlan` whose
:class:`Endpoint`\\ s are independent resumable scans (``init_scan`` args),
one per stream.

Two placements are planned:

* ``shard`` — each server holds a *disjoint shard* of the dataset under the
  same path. One endpoint per shard-holding server, full query, no overlap.
* ``replica`` — every server holds a full copy. The planner probes the
  result-batch count once (server-side planning RPC, the analogue of
  Flight's schema/stats in ``FlightInfo``) and splits the batch range into
  contiguous ``init_scan(start_batch=…) × max_batches`` slices.
"""
from __future__ import annotations

import dataclasses
import hashlib

from ..core.protocol import ThallusServer


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One stream of the partitioned scan — exactly the arguments a client
    needs to drive ``init_scan``/``iterate`` against one server.

    ``global_batches`` carries the *dataset-global* batch indices this
    stream's shard holds, in shard-local order. A fresh round-robin deal
    leaves it ``None`` (the classic ``i::n`` interleave reassembly applies);
    after a membership change re-deals orphaned batches, shards hold
    irregular index sets and reassembly must order by these global indices
    instead.
    """

    server_id: str
    sql: str
    dataset: str
    start_batch: int = 0
    max_batches: int | None = None   # None == drain to end-of-stream
    global_batches: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The FlightInfo analogue: what a coordinator hands back for a query."""

    query_id: str
    sql: str
    dataset: str
    placement: str                   # "shard" | "replica"
    endpoints: tuple[Endpoint, ...]

    @property
    def num_streams(self) -> int:
        return len(self.endpoints)


def _query_id(sql: str, dataset: str, placement: str,
              server_ids: tuple[str, ...]) -> str:
    h = hashlib.sha1()
    for part in (sql, dataset, placement, *server_ids):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def probe_batches(server: ThallusServer, sql: str, dataset: str) -> int:
    """Count result batches without shipping data — the planner's one
    server-side statistics pass (a planning RPC, charged to the fabric).
    Engines that expose ``estimate_batches`` answer from table statistics;
    otherwise the probe drains a planning-only reader (a real extra scan,
    the price of an exact count under filters)."""
    server.fabric.rpc(len(sql) + len(dataset) + 64)
    estimate = getattr(server.engine, "estimate_batches", None)
    if estimate is not None:
        n = estimate(sql, dataset)
        if n is not None:
            return n
    reader = server.engine.execute(sql, dataset)
    n = 0
    while reader.read_next() is not None:
        n += 1
    return n


def plan_scan(sql: str, dataset: str,
              servers: dict[str, ThallusServer],
              placement: str = "shard",
              num_streams: int | None = None,
              assignment: dict[str, tuple[int, ...]] | None = None) -> ScanPlan:
    """Deterministic partitioned-scan plan.

    ``servers`` maps server_id → server for every server hosting ``dataset``
    (the coordinator's placement lookup). Endpoints are emitted in sorted
    server_id order so the same inputs always produce the same plan.

    ``assignment`` (shard placement only) maps server_id → the dataset-global
    batch indices its shard holds. Servers whose shard is empty — the common
    case right after a member joins a small dataset, or when there are more
    servers than batches — get no endpoint: an empty shard owns no rows, so
    skipping it cannot drop data, and a stream pinned to it would only burn
    an admission slot to deliver nothing.
    """
    if not servers:
        raise ValueError(f"no servers host dataset {dataset!r}")
    ids = tuple(sorted(servers))
    if placement == "shard":
        if assignment is not None:
            ids = tuple(sid for sid in ids if assignment.get(sid))
            if not ids:
                raise ValueError(
                    f"every shard of dataset {dataset!r} is empty")
        if num_streams is not None and num_streams < len(ids):
            # every (non-empty) shard-holding server owns rows nobody else
            # has; fewer streams than shards would silently drop data
            raise ValueError(
                f"shard placement needs one stream per shard: {dataset!r} "
                f"lives on {len(ids)} servers, num_streams={num_streams}")
        endpoints = tuple(
            Endpoint(sid, sql, dataset,
                     global_batches=(tuple(assignment[sid])
                                     if assignment is not None else None))
            for sid in ids)
    elif placement == "replica":
        streams = num_streams or len(ids)
        total = probe_batches(servers[ids[0]], sql, dataset)
        streams = max(1, min(streams, total)) if total else 1
        base, extra = divmod(total, streams)
        endpoints, start = [], 0
        for i in range(streams):
            count = base + (1 if i < extra else 0)
            endpoints.append(Endpoint(ids[i % len(ids)], sql, dataset,
                                      start_batch=start, max_batches=count))
            start += count
        endpoints = tuple(endpoints)
    else:
        raise ValueError(f"unknown placement {placement!r} "
                         "(want 'shard' or 'replica')")
    return ScanPlan(_query_id(sql, dataset, placement, ids),
                    sql, dataset, placement, endpoints)
