# Copy of src/repro/cluster/mempool.py, kept numpy-only; change both copies together.
"""Registered buffer pool: pre-pinned size-class slabs + a registration cache.

The paper's own cost decomposition makes two per-batch constants the enemy of
small result sets: the client-side buffer allocation (``alloc_s``, measured)
and the per-segment registration (``seg_register_s``, modeled) charged on
every RDMA pull. Real RDMA systems amortize both the same way ("High-Speed
Query Processing over High-Speed Networks", arXiv:1502.07169): allocate and
register buffers *once*, then recycle them. This module does exactly that:

* slabs are uint8 arrays rounded up to power-of-two **size classes**, created
  (and faulted in — registration pins pages) on first miss;
* ``acquire(descs)`` checks out one slab per segment and returns a
  write-only :class:`~repro.core.bulk.BulkHandle` whose segments are dtype
  views into the slabs, flagged ``registered=True``;
* ``release(handle)`` returns the slabs to their free lists, so the next
  ``acquire`` with a similar layout is a list-pop, not a malloc;
* each slab's registration is charged to the fabric **once** (via
  :meth:`Fabric.register`); pulls into pooled buffers then take the
  ``registered=True`` fast path of :meth:`Fabric.rdma_pull` and skip the
  per-segment term entirely;
* resident slab bytes are bounded by an optional global **memory budget**
  (``max_bytes``): when creating a slab pushes the pool over budget, the
  least-recently-released free slabs are evicted — dropped *and
  unregistered* (:meth:`Fabric.unregister`), since a pinned-but-idle slab is
  exactly the registered memory an admission controller must reclaim. Slabs
  checked out to in-flight pulls are never evicted, so the budget is a
  high-water mark the pool converges back under as handles are released.
"""
from __future__ import annotations

import dataclasses
import time
import uuid as _uuid
from typing import Sequence

import numpy as np

from ..core.bulk import BulkHandle, SegmentDesc
from ..core.fabric import Fabric

_MIN_CLASS = 64  # bytes; keeps tiny validity/offset segments from fragmenting


def size_class(nbytes: int) -> int:
    """Round up to the pool's power-of-two size class."""
    if nbytes <= _MIN_CLASS:
        return _MIN_CLASS
    return 1 << (int(nbytes) - 1).bit_length()


@dataclasses.dataclass
class PoolStats:
    hits: int = 0                   # checkouts served from a free list
    misses: int = 0                 # checkouts that had to create a slab
    slabs_created: int = 0
    bytes_pooled: int = 0           # total slab bytes ever created
    bytes_resident: int = 0         # live slab bytes (free + checked out)
    evictions: int = 0              # slabs dropped + unregistered
    bytes_evicted: int = 0
    adopted: int = 0                # slabs promoted to long-lived storage
    bytes_adopted: int = 0
    registered_segments: int = 0    # slabs currently pinned with the fabric
    modeled_register_s: float = 0.0  # one-time pinning cost (amortized)
    acquire_s: float = 0.0          # measured wall time inside acquire()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def delta_since(self, baseline: "PoolStats") -> "PoolStats":
        """This pool's activity since ``baseline`` (a ``replace()`` copy
        taken earlier). Counters are subtracted; the two *levels* —
        ``bytes_resident`` and ``registered_segments`` — stay current.
        A scan over a shared pool attributes exactly its own slab creation
        (and registration cost) this way, instead of re-reporting the
        pool's whole cumulative history per scan."""
        return PoolStats(
            hits=self.hits - baseline.hits,
            misses=self.misses - baseline.misses,
            slabs_created=self.slabs_created - baseline.slabs_created,
            bytes_pooled=self.bytes_pooled - baseline.bytes_pooled,
            bytes_resident=self.bytes_resident,
            evictions=self.evictions - baseline.evictions,
            bytes_evicted=self.bytes_evicted - baseline.bytes_evicted,
            adopted=self.adopted - baseline.adopted,
            bytes_adopted=self.bytes_adopted - baseline.bytes_adopted,
            registered_segments=self.registered_segments,
            modeled_register_s=(self.modeled_register_s
                                - baseline.modeled_register_s),
            acquire_s=self.acquire_s - baseline.acquire_s)


class BufferPool:
    """Size-class pool of pre-registered client buffers.

    ``fabric`` is optional: without one the pool still recycles memory, it
    just has nothing to charge registrations to (unit tests use this).
    """

    def __init__(self, fabric: Fabric | None = None,
                 max_free_per_class: int = 64,
                 max_bytes: int | None = None):
        self.fabric = fabric
        self.max_free_per_class = max_free_per_class
        self.max_bytes = max_bytes
        self.stats = PoolStats()
        self._free: dict[int, list[np.ndarray]] = {}
        self._checked_out: dict[str, list[np.ndarray]] = {}
        self._lru_seq = 0
        self._release_seq: dict[int, int] = {}   # id(slab) -> release order
        # optional obs.FlightRecorder (duck-typed): evictions land in the
        # postmortem ring when one is attached
        self.recorder = None

    # ----------------------------------------------------------- checkout
    def _slab(self, cls: int) -> np.ndarray:
        free = self._free.get(cls)
        if free:
            self.stats.hits += 1
            slab = free.pop()
            self._release_seq.pop(id(slab), None)
            return slab
        self.stats.misses += 1
        self.stats.slabs_created += 1
        self.stats.bytes_pooled += cls
        self.stats.bytes_resident += cls
        slab = np.zeros(cls, dtype=np.uint8)   # zeros == fault pages in (pin)
        if self.fabric is not None:
            self.stats.modeled_register_s += self.fabric.register(1)
        self.stats.registered_segments += 1
        self._evict_over_budget()
        return slab

    def acquire(self, descs: Sequence[SegmentDesc]) -> BulkHandle:
        """Pool-backed ``allocate_like``: same layout, recycled memory."""
        t0 = time.perf_counter()
        slabs = [self._slab(size_class(d.nbytes)) for d in descs]
        segs = tuple(s[:d.nbytes].view(d.dtype)
                     for s, d in zip(slabs, descs))
        handle = BulkHandle(str(_uuid.uuid4()), tuple(descs), "write_only",
                            segments=segs, registered=True)
        self._checked_out[handle.handle_id] = slabs
        self.stats.acquire_s += time.perf_counter() - t0
        return handle

    # ------------------------------------------------------------ release
    def release(self, handle: BulkHandle) -> None:
        """Return a checked-out handle's slabs to the free lists. The
        handle's segments (and any batch assembled from them) must not be
        read afterwards — the memory will be recycled."""
        slabs = self._checked_out.pop(handle.handle_id, None)
        if slabs is None:
            raise KeyError(f"handle {handle.handle_id!r} not checked out")
        for slab in slabs:
            free = self._free.setdefault(slab.nbytes, [])
            if len(free) < self.max_free_per_class:
                self._lru_seq += 1
                self._release_seq[id(slab)] = self._lru_seq
                free.append(slab)
            else:
                self._drop(slab)     # class list full: evict outright
        self._evict_over_budget()

    def adopt(self, handle: BulkHandle) -> None:
        """Promote a checked-out handle's slabs to long-lived storage: they
        leave the checkout ledger *without* returning to the free lists, so
        the batch assembled from them stays valid forever (a repaired
        shard's resident memory). The slabs stay registered and keep
        counting toward ``bytes_resident``, but — like checkouts — they are
        never evicted: only ``_drop``-able free slabs are budget fodder."""
        slabs = self._checked_out.pop(handle.handle_id, None)
        if slabs is None:
            raise KeyError(f"handle {handle.handle_id!r} not checked out")
        self.stats.adopted += len(slabs)
        self.stats.bytes_adopted += sum(s.nbytes for s in slabs)

    # ------------------------------------------------------------ eviction
    def _drop(self, slab: np.ndarray) -> None:
        """Unpin one slab and forget it (memory goes back to the OS)."""
        self._release_seq.pop(id(slab), None)
        self.stats.evictions += 1
        self.stats.bytes_evicted += slab.nbytes
        self.stats.bytes_resident -= slab.nbytes
        self.stats.registered_segments -= 1
        if self.fabric is not None:
            self.fabric.unregister(1)
        if self.recorder is not None:
            self.recorder.record("pool.eviction", nbytes=int(slab.nbytes),
                                 resident=int(self.stats.bytes_resident))

    def _evict_over_budget(self) -> None:
        """LRU eviction: while resident bytes exceed the budget, drop the
        least-recently-released free slab (any size class). Checked-out
        slabs are untouchable, so an over-budget pool with everything in
        flight converges back under budget as handles are released."""
        if self.max_bytes is None:
            return
        while self.stats.bytes_resident > self.max_bytes:
            victim: tuple[int, int, int] | None = None   # (seq, cls, index)
            for cls, lst in self._free.items():
                for i, slab in enumerate(lst):
                    seq = self._release_seq.get(id(slab), 0)
                    if victim is None or seq < victim[0]:
                        victim = (seq, cls, i)
            if victim is None:
                return     # nothing free to evict right now
            _, cls, i = victim
            self._drop(self._free[cls].pop(i))

    # ---------------------------------------------------------- inspection
    @property
    def outstanding(self) -> int:
        return len(self._checked_out)

    def free_bytes(self) -> int:
        return sum(s.nbytes for lst in self._free.values() for s in lst)
