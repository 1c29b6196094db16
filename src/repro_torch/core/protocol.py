# Copy of src/repro/core/protocol.py, kept numpy-only; change both copies together.
"""The Thallus client/server protocol state machine.

Mirrors the paper §3 exactly:

* ``init_scan(query, dataset)`` → server instantiates an engine session,
  wraps its cursor in a ``RecordBatchReader``, stores it in the **reader
  map** under a fresh UUID, returns ``(uuid, schema)``.
* ``iterate(uuid)`` → server walks the reader; for every batch it *exposes*
  the buffers and invokes the client's ``do_rdma`` callback with
  ``(num_rows, size_vectors, bulk_handle)``.
* client ``do_rdma`` → allocates a matching write-only local bulk, RDMA-pulls
  the remote bulk one-to-one, assembles an Arrow batch from views, hands it
  to the client's output sink.
* ``finalize(uuid)`` → frees buffers / evicts the reader-map entry.

Fault-tolerance extensions beyond the paper (needed at cluster scale):

* readers are *resumable*: ``init_scan(..., start_batch=k)`` fast-forwards a
  restarted client to where it died (positions are tracked in the reader
  map);
* ``iterate`` takes ``max_batches`` so a client can pull in bounded leases —
  a lease that is never finalized is reclaimable;
* multiple servers can serve the same dataset; the client-side
  :class:`repro.data.loader.ThallusLoader` issues backup requests to the
  first-ready replica (straggler mitigation), and :mod:`repro.cluster`
  builds partitioned multi-stream scans out of these resumable leases.
"""
from __future__ import annotations

import dataclasses
import time
import uuid as _uuid
from typing import Callable, Iterator, Protocol, Sequence

import numpy as np

from . import bulk as bulk_mod
from .fabric import Fabric
from .recordbatch import RecordBatch
from .schema import Schema
from .transport import TransportStats


class ServerCrashedError(ConnectionError):
    """The server process died mid-conversation — every in-flight lease on
    it is gone and the client must fail over to a replica (or give up).
    Subclasses ``ConnectionError`` so generic fault-handling loops that
    already catch connection trouble treat a crash the same way."""


class RecordBatchReader(Protocol):
    """Streaming access to result batches (Arrow's reader interface)."""

    schema: Schema

    def read_next(self) -> RecordBatch | None: ...


class QueryEngine(Protocol):
    """Anything that can turn (sql, dataset) into a RecordBatchReader —
    DuckDB in the paper, :mod:`repro.engine` here, Polars/Velox in spirit."""

    def execute(self, sql: str, dataset: str) -> RecordBatchReader: ...


@dataclasses.dataclass
class _ReaderEntry:
    reader: RecordBatchReader
    schema: Schema
    batches_sent: int = 0
    created_at: float = 0.0
    last_activity: float = 0.0
    finalized: bool = False

    def touch(self, now: float) -> None:
        self.last_activity = now


@dataclasses.dataclass
class ScanHandle:
    """What init_scan returns to the client (control-plane payload)."""

    uuid: str
    schema: Schema


class ThallusServer:
    """Server half: owns the engine and the reader map.

    ``clock`` is the lease-staleness timebase: a zero-arg callable returning
    seconds. Plain deployments leave it ``None`` and get ``time.monotonic``
    (wall clock); modeled-time stacks (QoS/sched/obs layers) plumb their
    modeled timeline in so :meth:`reclaim_stale` judges staleness on the
    same clock everything else runs on.
    """

    def __init__(self, engine: QueryEngine, fabric: Fabric | None = None,
                 clock: Callable[[], float] | None = None):
        self.engine = engine
        self.fabric = fabric or Fabric()
        self.clock = clock
        self.reader_map: dict[str, _ReaderEntry] = {}
        self._crashed = False
        self._crash_after: int | None = None

    def _now(self) -> float:
        return self.clock() if self.clock is not None else time.monotonic()

    # ----------------------------------------------------- crash semantics
    @property
    def crashed(self) -> bool:
        return self._crashed

    def crash(self, after_batches: int = 0) -> None:
        """Kill the server process (nemesis hook).

        ``after_batches=0`` dies immediately; ``after_batches=n`` dies after
        shipping ``n`` more batches across all leases — mid-``iterate``, the
        realistic failure a lease-migration path must survive. Either way
        the reader map is wiped: leases do not survive a process death."""
        if after_batches <= 0:
            self._die()
        else:
            self._crash_after = after_batches

    def restore(self) -> None:
        """Bring the process back up (empty reader map — leases are gone)."""
        self._crashed = False
        self._crash_after = None

    def _die(self) -> None:
        self._crashed = True
        self._crash_after = None
        self.reader_map.clear()

    def _check_alive(self) -> None:
        if self._crashed:
            raise ServerCrashedError("server is down")

    # ------------------------------------------------------------ init_scan
    def init_scan(self, sql: str, dataset: str, start_batch: int = 0) -> ScanHandle:
        self._check_alive()
        reader = self.engine.execute(sql, dataset)
        uid = str(_uuid.uuid4())
        now = self._now()
        entry = _ReaderEntry(reader=reader, schema=reader.schema,
                             created_at=now, last_activity=now)
        # resumability: fast-forward a restarted client
        for _ in range(start_batch):
            if reader.read_next() is None:
                break
            entry.batches_sent += 1
        self.reader_map[uid] = entry
        self.fabric.rpc(len(sql) + len(dataset) + 64)
        return ScanHandle(uid, entry.schema)

    # -------------------------------------------------------------- iterate
    def iterate(self, uid: str,
                do_rdma: Callable[[int, tuple[list[int], list[int], list[int]],
                                   bulk_mod.BulkHandle], TransportStats],
                max_batches: int | None = None) -> int:
        """Walk the reader; for each batch expose a read-only bulk and invoke
        the client's do_rdma. Returns number of batches shipped."""
        self._check_alive()
        entry = self._entry(uid)
        entry.touch(self._now())
        shipped = 0
        while max_batches is None or shipped < max_batches:
            batch = entry.reader.read_next()
            if batch is None:
                break
            handle = bulk_mod.expose_batch(batch, mode="read_only")
            sizes = bulk_mod.size_vectors(batch)
            self.fabric.rpc(64 + 8 * sum(len(v) for v in sizes))  # control msg
            do_rdma(batch.num_rows, sizes, handle)
            entry.batches_sent += 1
            entry.touch(self._now())
            shipped += 1
            if self._crash_after is not None:
                self._crash_after -= 1
                if self._crash_after <= 0:
                    self._die()
                    raise ServerCrashedError(
                        f"server died mid-iterate after shipping {shipped} "
                        "batch(es) of this lease")
        return shipped

    # ----------------------------------------------------------- next_batch
    def next_batch(self, uid: str) -> RecordBatch | None:
        """Public single-batch cursor advance (the ``iterate`` equivalent for
        clients that ship data some other way, e.g. the RPC baseline). Keeps
        the reader-map bookkeeping — cursor position, lease activity — in one
        place instead of clients reaching into server internals."""
        self._check_alive()
        entry = self._entry(uid)
        entry.touch(self._now())
        batch = entry.reader.read_next()
        if batch is not None:
            entry.batches_sent += 1
        return batch

    # ------------------------------------------------------------- finalize
    def finalize(self, uid: str) -> None:
        entry = self._entry(uid)
        entry.finalized = True
        del self.reader_map[uid]
        self.fabric.rpc(64)

    # ------------------------------------------------------------ utilities
    def _entry(self, uid: str) -> _ReaderEntry:
        if uid not in self.reader_map:
            raise KeyError(f"unknown reader uuid {uid!r} (finalized or bogus)")
        return self.reader_map[uid]

    def cursor_position(self, uid: str) -> int:
        """For checkpointing the data pipeline: batches already sent."""
        return self._entry(uid).batches_sent

    def reclaim_stale(self, older_than_s: float,
                      now_s: float | None = None) -> int:
        """Evict leases whose client died without finalize (fault tolerance).

        Staleness is judged by ``last_activity`` — refreshed on every
        ``iterate``/``next_batch`` — not ``created_at``, so a long-running
        but actively-pulling scan is never evicted out from under its client.

        ``now_s`` overrides the sweep's notion of *now* for one call;
        otherwise the server's ``clock`` (modeled timeline when plumbed,
        wall clock by default) supplies it. Passing modeled time matters:
        a whole modeled scan elapses in sub-ms of wall time, so a
        wall-clock sweep can never reclaim a modeled dead lease."""
        now = self._now() if now_s is None else now_s
        stale = [u for u, e in self.reader_map.items()
                 if now - e.last_activity > older_than_s]
        for u in stale:
            del self.reader_map[u]
        return len(stale)


class ThallusClient:
    """Client half: drives the scan and pulls batches via RDMA."""

    def __init__(self, server: ThallusServer, fabric: Fabric | None = None,
                 sink: Callable[[RecordBatch], None] | None = None):
        self.server = server
        self.fabric = fabric or server.fabric
        self.sink = sink
        self.batches: list[RecordBatch] = []
        self.stats: list[TransportStats] = []
        self._schema: Schema | None = None

    # ------------------------------------------------------------- do_rdma
    def do_rdma(self, num_rows: int,
                sizes: tuple[list[int], list[int], list[int]],
                remote: bulk_mod.BulkHandle) -> TransportStats:
        from .transport import rdma_pull_batch  # shared client data plane

        batch, _, stats = rdma_pull_batch(self.fabric, self._schema,
                                          num_rows, remote)
        self.batches.append(batch)
        self.stats.append(stats)
        if self.sink is not None:
            self.sink(batch)
        return stats

    # ------------------------------------------------------------ full run
    def run_query(self, sql: str, dataset: str, start_batch: int = 0,
                  max_batches: int | None = None) -> list[RecordBatch]:
        """init_scan → iterate(→do_rdma per batch) → finalize.

        ``start_batch``/``max_batches`` bound the scan to a batch range —
        a backup request for one batch pulls exactly one batch."""
        handle = self.server.init_scan(sql, dataset, start_batch=start_batch)
        self._schema = handle.schema
        self.server.iterate(handle.uuid, self.do_rdma,
                            max_batches=max_batches)
        self.server.finalize(handle.uuid)
        return self.batches

    def transport_seconds(self) -> float:
        return sum(s.total_s for s in self.stats)


class RpcClient:
    """Baseline client: identical protocol shape, but every batch rides an
    RPC payload after full serialization (see §2 of the paper)."""

    def __init__(self, server: ThallusServer, fabric: Fabric | None = None,
                 sink: Callable[[RecordBatch], None] | None = None):
        self.server = server
        self.fabric = fabric or server.fabric
        self.sink = sink
        self.batches: list[RecordBatch] = []
        self.stats: list[TransportStats] = []

    def run_query(self, sql: str, dataset: str, start_batch: int = 0,
                  max_batches: int | None = None) -> list[RecordBatch]:
        from . import serialize  # local import to keep module edges clean

        handle = self.server.init_scan(sql, dataset, start_batch=start_batch)
        pulled = 0
        while (max_batches is None or pulled < max_batches) and \
                (batch := self.server.next_batch(handle.uuid)) is not None:
            pulled += 1
            stats = TransportStats(control_rpcs=1)
            t0 = time.perf_counter()
            wire_buf = serialize.pack(batch)               # staging copy
            stats.serialize_s = time.perf_counter() - t0
            stats.wire = self.fabric.rpc_payload(wire_buf)
            t0 = time.perf_counter()
            out = serialize.unpack(wire_buf, zero_copy=True)
            stats.deserialize_s = time.perf_counter() - t0
            self.batches.append(out)
            self.stats.append(stats)
            if self.sink is not None:
                self.sink(out)
        self.server.finalize(handle.uuid)
        return self.batches

    def transport_seconds(self) -> float:
        return sum(s.total_s for s in self.stats)
