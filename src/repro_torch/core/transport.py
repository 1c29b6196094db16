# Copy of src/repro/core/transport.py, kept numpy-only; change both copies together.
"""The two transports under study.

* :class:`RpcTransport` — the baseline: serialize the record batch into one
  contiguous buffer (full copy of every column buffer), ship it as an RPC
  payload, deserialize zero-copy on the receiver.
* :class:`ThallusTransport` — the paper's protocol: expose the batch's
  buffers as a scatter-gather bulk (no copies), ship only descriptors over
  RPC, RDMA-pull each segment one-to-one into freshly allocated client
  buffers, assemble the batch as views (no copies).

Both return ``(batch, TransportStats)`` so every benchmark decomposition in
the paper (§2 serialization fraction, Fig. 2 transport duration) is
reproducible from the same code path.
"""
from __future__ import annotations

import dataclasses
import time

from . import bulk as bulk_mod
from . import serialize
from .fabric import Fabric, WireStats
from .recordbatch import RecordBatch


@dataclasses.dataclass
class TransportStats:
    serialize_s: float = 0.0       # measured: pack copies (baseline only)
    expose_s: float = 0.0          # measured: bulk expose / descriptor build
    alloc_s: float = 0.0           # measured: client buffer allocation
    wire: WireStats = dataclasses.field(default_factory=WireStats)
    deserialize_s: float = 0.0     # measured: receiver batch assembly
    control_rpcs: int = 0

    @property
    def total_s(self) -> float:
        return (self.serialize_s + self.expose_s + self.alloc_s
                + self.wire.total_s + self.deserialize_s)

    @property
    def serialize_fraction(self) -> float:
        return self.serialize_s / self.total_s if self.total_s else 0.0


def rdma_pull_batch(fabric: Fabric, schema, num_rows: int,
                    remote: bulk_mod.BulkHandle, pool=None, pin: bool = False
                    ) -> tuple[RecordBatch, bulk_mod.BulkHandle, "TransportStats"]:
    """The client-side data plane every puller shares: allocate a matching
    local bulk (``pool.acquire`` checkout when a buffer pool is given, else a
    fresh allocation — ``pin=True`` faults the pages like registration must),
    RDMA-pull one-to-one, assemble the batch zero-copy. One implementation so
    the single-stream and cluster decompositions can never drift apart.

    Returns ``(batch, local_handle, stats)``; pooled callers release
    ``local_handle`` once the batch is consumed."""
    stats = TransportStats()
    t0 = time.perf_counter()
    if pool is not None:
        local = pool.acquire(remote.descs)
    else:
        local = bulk_mod.allocate_like(remote.descs, pin=pin)
    stats.alloc_s = time.perf_counter() - t0
    try:
        stats.wire = fabric.rdma_pull(remote.segments, local.segments,
                                      registered=local.registered)
        t0 = time.perf_counter()
        batch = bulk_mod.assemble_batch(schema, num_rows, local.segments)
        stats.deserialize_s = time.perf_counter() - t0
    except BaseException:
        # a failed pull must hand its checkout back, or fault-resume loops
        # leak one slab set per fault
        if pool is not None:
            pool.release(local)
        raise
    return batch, local, stats


class Transport:
    name = "abstract"

    def __init__(self, fabric: Fabric | None = None):
        self.fabric = fabric or Fabric()

    def send_batch(self, batch: RecordBatch) -> tuple[RecordBatch, TransportStats]:
        raise NotImplementedError


class RpcTransport(Transport):
    """Baseline: data-over-RPC with mandatory serialization."""

    name = "rpc"

    def send_batch(self, batch: RecordBatch) -> tuple[RecordBatch, TransportStats]:
        stats = TransportStats(control_rpcs=1)
        t0 = time.perf_counter()
        wire_buf = serialize.pack(batch)               # full staging copy
        stats.serialize_s = time.perf_counter() - t0
        stats.wire = self.fabric.rpc_payload(wire_buf)  # one big RPC payload
        t0 = time.perf_counter()
        out = serialize.unpack(wire_buf, zero_copy=True)  # views: ~free
        stats.deserialize_s = time.perf_counter() - t0
        return out, stats


class ThallusTransport(Transport):
    """The paper's protocol: metadata over RPC, data over RDMA, zero copies."""

    name = "thallus"

    def send_batch(self, batch: RecordBatch) -> tuple[RecordBatch, TransportStats]:
        stats = TransportStats()
        # -- server: expose segments in place (no copies) ------------------
        t0 = time.perf_counter()
        remote = bulk_mod.expose_batch(batch, mode="read_only")
        sizes = bulk_mod.size_vectors(batch)
        stats.expose_s = time.perf_counter() - t0
        # -- control plane: handle + size vectors + num_rows over RPC ------
        meta_bytes = 64 + 8 * sum(len(v) for v in sizes)  # descriptor payload
        rpc = self.fabric.rpc(meta_bytes)
        stats.control_rpcs = 1
        # -- client: allocate matching layout, write-only local bulk -------
        t0 = time.perf_counter()
        local = bulk_mod.allocate_like(remote.descs)
        stats.alloc_s = time.perf_counter() - t0
        # -- data plane: scatter-gather pull, one-to-one --------------------
        stats.wire = self.fabric.rdma_pull(remote.segments, local.segments)
        stats.wire.modeled_wire_s += rpc.modeled_wire_s  # control rides along
        # -- client: zero-copy assembly (buffers+sizes+dtypes -> batch) -----
        t0 = time.perf_counter()
        out = bulk_mod.assemble_batch(batch.schema, batch.num_rows, local.segments)
        stats.deserialize_s = time.perf_counter() - t0
        return out, stats


def make_transport(name: str, fabric: Fabric | None = None) -> Transport:
    if name == "rpc":
        return RpcTransport(fabric)
    if name == "thallus":
        return ThallusTransport(fabric)
    raise ValueError(f"unknown transport {name!r} (want 'rpc' or 'thallus')")
