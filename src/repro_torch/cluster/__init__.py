# Copy of src/repro/cluster/__init__.py, kept numpy-only; change both copies together.
"""repro.cluster: the partitioned, pooled, multi-stream dataplane.

Turns the single client↔server scan of :mod:`repro.core.protocol` into a
cluster-scale transport: a FlightInfo-style planner (:mod:`.plan`), a
coordinator owning placement and lease lifecycle (:mod:`.coordinator`), a
registered buffer pool amortizing allocation + registration
(:mod:`.mempool`), and a multi-stream puller with bounded leases and
per-stream fault recovery (:mod:`.streams`).
"""
from __future__ import annotations

from typing import Callable

from ..core.recordbatch import RecordBatch
from .coordinator import (  # noqa: F401
    ClusterCoordinator, MigrationError, PlacementError,
)
from .membership import MembershipController, MembershipEvent  # noqa: F401
from .mempool import BufferPool, PoolStats, size_class  # noqa: F401
from .nemesis import FaultSpec, Nemesis, seeded_schedule  # noqa: F401
from .plan import Endpoint, ScanPlan, plan_scan, probe_batches  # noqa: F401
from .repair import RepairConfig, RepairStats, ShardRepairer  # noqa: F401
from .streams import (  # noqa: F401
    ClusterStats, MultiStreamPuller, StreamPuller, StreamStats,
)


def cluster_scan(coordinator: ClusterCoordinator, sql: str, dataset: str,
                 num_streams: int | None = None,
                 pool: BufferPool | None = None,
                 lease_batches: int = 1, schedule: str = "round_robin",
                 prefetch: bool = True, client_id: str = "default",
                 sink: Callable[[int, RecordBatch], None] | None = None,
                 ) -> ClusterStats:
    """One-call partitioned scan: plan → pull all streams → stats.

    With a ``pool``, batches are recycled after ``sink`` returns — the sink
    must copy anything it wants to keep (the streaming contract).
    """
    scan_plan = coordinator.plan(sql, dataset, num_streams=num_streams)
    puller = MultiStreamPuller(coordinator, scan_plan, pool=pool,
                               lease_batches=lease_batches, schedule=schedule,
                               prefetch=prefetch, client_id=client_id)
    return puller.run(sink)
