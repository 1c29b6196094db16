# Copy of src/repro/qos/__init__.py, kept numpy-only; change both copies together.
"""repro.qos: admission control + flow control for the cluster dataplane.

The layer between clients and the
:class:`~repro.cluster.coordinator.ClusterCoordinator`: per-client stream
quotas, a registered-memory budget, and token-bucket lease metering
(:mod:`.admission`); the same budget sharded per server with borrowing and
modeled-time reconciliation (:mod:`.distributed`); weighted-fair queueing
across client classes with deadline shedding (:mod:`.queue`); a
request-level scatter-gather gateway (:mod:`.gateway`); and per-class
metrics that compose with ``ClusterStats`` (:mod:`.metrics`).
"""
from __future__ import annotations

from .admission import (  # noqa: F401
    AdmissionConfig, AdmissionController, AdmissionStats, Backpressure,
)
from .distributed import (  # noqa: F401
    AdmissionShard, DistributedConfig, DistributedStats, ReconcileReport,
    ShardStats, ShardedAdmission,
)
from .gateway import (  # noqa: F401
    ScanGateway, ScanRequest, ScanResult, reassemble,
)
from .metrics import ClassStats, QosStats  # noqa: F401
from .queue import (  # noqa: F401
    BATCH, INTERACTIVE, ClientClass, FifoQueue, WeightedFairQueue,
)
