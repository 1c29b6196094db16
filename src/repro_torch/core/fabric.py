# Copy of src/repro/core/fabric.py, kept numpy-only; change both copies together.
"""Network fabric: measured copies + modeled wire.

This container has no NIC/InfiniBand, so the *wire* is modeled while every
*memory operation* (serialization pack, per-segment DMA placement) is executed
for real and timed. The model constants come from the paper's hardware class
(InfiniBand, Thallium/Mercury on verbs):

* ``RPC_RTT_S``        — per-RPC round-trip software+fabric latency.
* ``RPC_BW``           — effective RPC *payload* bandwidth. The Mercury RPC
  data path stages payloads through bounce buffers / flow control, so its
  effective large-message throughput is well below line rate.
* ``RDMA_BW``          — RDMA READ throughput (near line rate).
* ``RDMA_SETUP_S``     — per-bulk-op constant (handle exchange + post).
* ``SEG_REGISTER_S``   — per-segment registration/pinning cost. This is the
  constant that makes *small* result sets lose the Thallus advantage, exactly
  the trend in the paper's Figures 2–3.

Every transfer returns a :class:`WireStats` so benchmarks can decompose
duration into serialize / wire / deserialize the way the paper's §2 does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class FabricConfig:
    rpc_rtt_s: float = 2.0e-6          # 2 us RPC round trip
    rpc_bw: float = 2.2e9              # 2.2 GB/s effective RPC payload path
    rdma_bw: float = 12.0e9            # 12 GB/s RDMA READ (HDR-100 class)
    rdma_setup_s: float = 3.0e-6       # per bulk operation
    seg_register_s: float = 0.4e-6     # per segment registration/pinning
    execute_copies: bool = True        # actually perform DMA placement memcpys


@dataclasses.dataclass
class WireStats:
    """One transfer, decomposed.

    ``measured_copy_s`` is the wall-clock of the host memcpys this simulation
    executes to stand in for the NIC DMA engine — it keeps the data movement
    real (tests check the bytes), but it is NOT part of the transfer time:
    on real hardware the DMA engine does the placement, which is what
    ``modeled_wire_s`` accounts for. Host-CPU costs that are real in the
    actual system (the baseline's serialization pack) are measured and
    charged in TransportStats, not here.
    """

    bytes_moved: int = 0
    num_segments: int = 0
    measured_copy_s: float = 0.0      # diagnostic only
    modeled_wire_s: float = 0.0
    modeled_register_s: float = 0.0   # registration share of modeled_wire_s

    @property
    def total_s(self) -> float:
        return self.modeled_wire_s


class Fabric:
    """An in-process stand-in for the cluster fabric."""

    def __init__(self, config: FabricConfig | None = None):
        self.config = config or FabricConfig()
        self.rpc_count = 0
        self.rdma_count = 0
        self.bytes_over_rpc = 0
        self.bytes_over_rdma = 0
        self.registrations = 0         # segments pinned via register()
        self.modeled_wire_s = 0.0      # cumulative wire time this fabric modeled

    # ------------------------------------------------------------------ RPC
    def rpc(self, payload_bytes: int = 0) -> WireStats:
        """A control-plane RPC carrying ``payload_bytes`` of (meta)data."""
        self.rpc_count += 1
        self.bytes_over_rpc += payload_bytes
        wire = self.config.rpc_rtt_s + payload_bytes / self.config.rpc_bw
        self.modeled_wire_s += wire
        return WireStats(bytes_moved=payload_bytes, num_segments=1,
                         modeled_wire_s=wire)

    # ----------------------------------------------------------- registration
    def register(self, num_segments: int) -> float:
        """Pin ``num_segments`` memory regions up front (a buffer pool filling
        its registration cache). Returns the modeled one-time cost so callers
        can account for it; subsequent ``rdma_pull(..., registered=True)``
        calls skip the per-segment term those pins amortize."""
        self.registrations += num_segments
        return num_segments * self.config.seg_register_s

    def unregister(self, num_segments: int) -> None:
        """Unpin memory regions (pool eviction under a memory budget).
        Deregistration is a local verbs call — no wire time is modeled,
        only the registration census moves."""
        self.registrations -= num_segments

    # ----------------------------------------------------------------- RDMA
    def rdma_pull(self, src: Sequence[np.ndarray],
                  dst: Sequence[np.ndarray],
                  registered: bool = False) -> WireStats:
        """Scatter-gather RDMA READ: each remote segment lands in the matching
        local segment, one-to-one. The placement memcpy is executed for real
        (it stands in for the DMA engine write into client memory); the wire
        time is modeled at RDMA bandwidth + per-segment registration.

        ``registered=True`` is the registration-cache fast path: the local
        segments came from a pre-registered pool (and the remote table memory
        is pinned server-side), so the per-segment registration term — the
        constant that erodes the small-batch advantage — is not charged."""
        if len(src) != len(dst):
            raise ValueError("segment count mismatch")
        nbytes = 0
        t0 = time.perf_counter()
        if self.config.execute_copies:
            for s, d in zip(src, dst):
                if s.nbytes != d.nbytes:
                    raise ValueError(
                        f"segment size mismatch: {s.nbytes} != {d.nbytes}")
                if s.nbytes:
                    d.view(np.uint8).reshape(-1)[:] = s.view(np.uint8).reshape(-1)
                nbytes += s.nbytes
        else:
            nbytes = sum(int(s.nbytes) for s in src)
        copy_s = time.perf_counter() - t0
        self.rdma_count += 1
        self.bytes_over_rdma += nbytes
        register_s = 0.0 if registered else len(src) * self.config.seg_register_s
        wire = (self.config.rdma_setup_s
                + register_s
                + nbytes / self.config.rdma_bw)
        self.modeled_wire_s += wire
        return WireStats(bytes_moved=nbytes, num_segments=len(src),
                         measured_copy_s=copy_s, modeled_wire_s=wire,
                         modeled_register_s=register_s)

    # ------------------------------------------------------------ RPC bulk
    def rpc_payload(self, wire_buffer: np.ndarray) -> WireStats:
        """Data-over-RPC (the baseline): the contiguous serialized buffer is
        the RPC response payload. One message, RPC-path bandwidth."""
        self.rpc_count += 1
        self.bytes_over_rpc += wire_buffer.nbytes
        wire = self.config.rpc_rtt_s + wire_buffer.nbytes / self.config.rpc_bw
        self.modeled_wire_s += wire
        return WireStats(bytes_moved=int(wire_buffer.nbytes), num_segments=1,
                         modeled_wire_s=wire)

    def reset_counters(self) -> None:
        self.rpc_count = self.rdma_count = 0
        self.bytes_over_rpc = self.bytes_over_rdma = 0
        self.registrations = 0
        self.modeled_wire_s = 0.0


class FlappingFabric(Fabric):
    """A fabric whose RDMA link speed follows a per-pull slowdown schedule.

    The chaos/bench harness for time-varying replicas: each ``rdma_pull``
    consumes the next factor from ``schedule`` (cycling once exhausted) and
    models the wire at ``base_bw / factor`` for that pull only — a schedule
    of ``[4, 1]`` is a link oscillating 4×-slow ↔ full-speed every pull, a
    ramp ``[1, 2, 4, 8]`` is a degrading thief. Only the modeled RDMA data
    path flaps (the signal the steal scheduler's rate history watches);
    control RPCs stay at the base config. Swap ``schedule`` between scans to
    model persistent degradation (the repeat-straggler case)."""

    def __init__(self, config: FabricConfig | None = None,
                 schedule: Sequence[float] = (1.0,)):
        super().__init__(config)
        if not schedule or any(f <= 0 for f in schedule):
            raise ValueError("schedule must be non-empty positive factors")
        self.schedule = list(schedule)
        self.pulls = 0

    def rdma_pull(self, src: Sequence[np.ndarray],
                  dst: Sequence[np.ndarray],
                  registered: bool = False) -> WireStats:
        base = self.config
        factor = self.schedule[self.pulls % len(self.schedule)]
        self.pulls += 1
        if factor != 1.0:
            self.config = dataclasses.replace(base,
                                              rdma_bw=base.rdma_bw / factor)
        try:
            return super().rdma_pull(src, dst, registered=registered)
        finally:
            self.config = base
