# Copy of src/repro/cluster/repair.py, kept numpy-only; change both copies together.
"""Peer-to-peer shard migration & replica repair over the RDMA fast path.

Until now every membership re-placement (join slice, leave re-deal, replica
copy, re-admit pre-warm) re-registered shard slices from the *coordinator's*
stored source table — a coordinator-held copy, not a network transfer, which
cannot exist at production scale. This module makes the cluster's registered
memory one shared repair substrate: the bytes a joiner needs already live,
pinned, in some peer's engine-registered shard, so the peer *donates* them
over the same registered-buffer RDMA path the client scan plane uses.

One repair of one batch is exactly the paper's transport, server→server:

* the **donor** (best-health live holder of the batch, picked off the
  repairer's segment directory) exposes its registered batch buffers as a
  read-only bulk — zero copies;
* the descriptor table crosses the control plane as one small RPC;
* the **target** checks pooled slabs out of its per-server registered
  :class:`~repro.cluster.mempool.BufferPool` and ``rdma_pull``s the segments
  with ``registered=True`` (both ends pinned: no per-segment registration);
* the pulled slabs are **adopted** — they leave the pool's checkout ledger
  and become the shard's long-lived storage — and the batch is assembled
  zero-copy and ``engine.register``ed under the dataset path.

Only when *no* live registered peer holds a batch (the dead server was its
sole holder) does the repairer fall back to the coordinator's stored source
table: the durability story. The fallback's cost is modeled honestly — the
batch streams over the RPC payload path and the target pins fresh segments —
so benchmarks can show what the peer path saves.

Repair traffic is a **background QoS class**: each pull first leases tokens
from the donor's admission shard (``lease_wait_s`` on the repair clock), and
while the donor's bucket sits below a small reserve the repairer *yields* —
backs off on its own modeled clock instead of draining tokens interactive
arrivals are about to claim. A rebalance storm therefore cannot starve
foreground scans; it waits for them.

Everything is reported through the obs spine: ``repair.pull`` /
``repair.fallback`` / ``repair.complete`` notify events, ``repair.*``
registry metrics (:func:`repro.obs.record_repair`), and optional trace spans
on the repair clock.
"""
from __future__ import annotations

import dataclasses

from ..core import bulk as bulk_mod
from ..core.recordbatch import RecordBatch
from ..engine.table import Table
from .coordinator import _HEALTH_RANK, ClusterCoordinator, _Placement
from .mempool import BufferPool


@dataclasses.dataclass
class RepairConfig:
    """Knobs for the background-class metering and the target-side pools."""

    tokens_per_batch: int = 1        # lease cost of one repaired batch
    reserve_tokens: float = 1.0      # donor-bucket floor kept for foreground
    backoff_s: float = 1.0e-3        # modeled yield while under the reserve
    max_yields_per_batch: int = 8    # bounded politeness: then pull anyway
    pool_max_bytes: int | None = None  # per-target pool budget (None = open)


@dataclasses.dataclass
class RepairStats:
    """Cumulative repair activity (``clock_s`` is a level, not a counter)."""

    repairs: int = 0                 # reshard/replicate operations completed
    batches_pulled: int = 0          # peer-to-peer RDMA pulls
    bytes_pulled: int = 0
    segments_pulled: int = 0
    batches_reused: int = 0          # already registered locally: zero movement
    table_copies: int = 0            # durability fallbacks to the source table
    bytes_copied: int = 0
    modeled_wire_s: float = 0.0      # peer path: descriptor RPC + RDMA wire
    modeled_copy_s: float = 0.0      # fallback path: RPC payload + fresh pins
    throttle_wait_s: float = 0.0     # admission lease waits (background class)
    yield_s: float = 0.0             # modeled backoff under the token reserve
    yields: int = 0
    clock_s: float = 0.0             # the repairer's modeled timeline

    def delta_since(self, baseline: "RepairStats") -> "RepairStats":
        """Activity since ``baseline`` (a ``replace()`` copy taken earlier);
        ``clock_s`` stays current, everything else is subtracted."""
        return RepairStats(
            repairs=self.repairs - baseline.repairs,
            batches_pulled=self.batches_pulled - baseline.batches_pulled,
            bytes_pulled=self.bytes_pulled - baseline.bytes_pulled,
            segments_pulled=self.segments_pulled - baseline.segments_pulled,
            batches_reused=self.batches_reused - baseline.batches_reused,
            table_copies=self.table_copies - baseline.table_copies,
            bytes_copied=self.bytes_copied - baseline.bytes_copied,
            modeled_wire_s=self.modeled_wire_s - baseline.modeled_wire_s,
            modeled_copy_s=self.modeled_copy_s - baseline.modeled_copy_s,
            throttle_wait_s=self.throttle_wait_s - baseline.throttle_wait_s,
            yield_s=self.yield_s - baseline.yield_s,
            yields=self.yields - baseline.yields,
            clock_s=self.clock_s)


class ShardRepairer:
    """Peer-to-peer re-placement engine, attached to a coordinator.

    Constructing one self-registers as ``coordinator.repairer`` (duck-typed:
    the coordinator only ever calls ``observe``/``forget``/``reshard``/
    ``replicate`` on it) and seeds the segment directory from the placements
    already recorded. From then on every re-placement site — ``_join_shard``,
    ``_redeal``, the ``add_server`` replica copy, and the membership
    controller's re-admit pre-warm riding ``add_server(rebalance=True)`` —
    routes its byte movement through here instead of the stored source table.
    """

    def __init__(self, coordinator: ClusterCoordinator,
                 config: RepairConfig | None = None,
                 client_id: str = "repair", tracer=None) -> None:
        self.coordinator = coordinator
        self.config = config or RepairConfig()
        self.client_id = client_id
        self.tracer = tracer           # obs.Tracer (duck-typed), optional
        self.stats = RepairStats()
        self.pools: dict[str, BufferPool] = {}   # target sid -> its pool
        # the segment directory: dataset -> server_id -> {global batch index
        # -> the batch object registered (pinned) on that server}. Donor
        # selection consults this, never the engines, so a dead server's
        # entries can be purged the moment it leaves.
        self._held: dict[str, dict[str, dict[int, RecordBatch]]] = {}
        coordinator.repairer = self
        for dataset, placement in coordinator._placements.items():
            self.observe(dataset, placement)

    # ------------------------------------------------------------ directory
    def observe(self, dataset: str, placement: _Placement) -> None:
        """Seed/refresh the directory from a freshly recorded placement:
        every named server holds its registered slice of the source table."""
        table = placement.table
        if table is None:
            return
        held = self._held.setdefault(dataset, {})
        if placement.mode == "replica":
            for sid in placement.server_ids:
                held[sid] = dict(enumerate(table.batches))
        else:
            for sid, idxs in (placement.assignment or {}).items():
                held[sid] = {i: table.batches[i] for i in idxs}

    def forget(self, server_id: str) -> None:
        """Drop a departed server from the directory — its pinned memory is
        gone, so it can never again be picked as a donor."""
        for held in self._held.values():
            held.pop(server_id, None)

    def holders(self, dataset: str, idx: int) -> tuple[str, ...]:
        """Which live, non-crashed servers hold batch ``idx`` registered."""
        held = self._held.get(dataset, {})
        live = []
        for sid, batches in held.items():
            if idx not in batches:
                continue
            server = self.coordinator.servers.get(sid)
            if server is None or getattr(server, "crashed", False):
                continue
            live.append(sid)
        return tuple(sorted(live))

    def _pick_donor(self, dataset: str, idx: int,
                    exclude: str) -> str | None:
        """Best-health live holder of ``idx`` (ties by sorted server_id)."""
        candidates = [sid for sid in self.holders(dataset, idx)
                      if sid != exclude]
        if not candidates:
            return None
        health = getattr(self.coordinator, "health", None)
        state = getattr(health, "state", None) if health is not None else None
        if state is not None:
            return min(candidates,
                       key=lambda sid: (_HEALTH_RANK.get(state(sid), 0), sid))
        return min(candidates)

    # ------------------------------------------------------------- repairs
    def reshard(self, dataset: str, placement: _Placement, server_id: str,
                *, now_s: float = 0.0) -> None:
        """Materialize ``server_id``'s assigned shard slice: reuse what it
        already holds, peer-pull what a live donor holds, fall back to the
        stored source table for sole-holder losses."""
        indices = tuple((placement.assignment or {}).get(server_id, ()))
        self._materialize(dataset, placement, server_id, indices, now_s,
                          action="reshard")

    def replicate(self, dataset: str, placement: _Placement, server_id: str,
                  *, now_s: float = 0.0) -> None:
        """Materialize a full replica on ``server_id`` (the join copy and
        the re-admit pre-warm), batch by batch from the best live donors."""
        table = placement.table
        if table is None:
            return
        self._materialize(dataset, placement, server_id,
                          tuple(range(len(table.batches))), now_s,
                          action="replicate")

    def _materialize(self, dataset: str, placement: _Placement,
                     server_id: str, indices: tuple[int, ...],
                     now_s: float, action: str) -> None:
        table = placement.table
        server = self.coordinator.servers.get(server_id)
        if table is None or server is None:
            return
        # the repair clock never runs behind the caller's modeled time
        self.stats.clock_s = max(self.stats.clock_s, now_s)
        trace = (self.tracer.begin(f"repair:{dataset}:{server_id}")
                 if self.tracer is not None else None)
        held = self._held.setdefault(dataset, {})
        mine = dict(held.get(server_id, {}))
        pulled = copied = reused = 0
        out: dict[int, RecordBatch] = {}
        for idx in indices:
            if idx in mine:
                out[idx] = mine[idx]       # already pinned here: zero movement
                reused += 1
                continue
            donor = self._pick_donor(dataset, idx, exclude=server_id)
            if donor is not None:
                out[idx] = self._peer_pull(dataset, server_id, donor, idx,
                                           trace)
                pulled += 1
            else:
                out[idx] = self._table_copy(dataset, server_id, table, idx,
                                            trace)
                copied += 1
        held[server_id] = out
        shard = Table(table.name, table.schema,
                      batches=[out[i] for i in indices])
        server.engine.register(dataset, shard)
        self.stats.repairs += 1
        self.stats.batches_reused += reused
        if trace is not None:
            trace.commit()
        self.coordinator.notify("repair.complete", server_id=server_id,
                                now_s=self.stats.clock_s, dataset=dataset,
                                action=action, pulled=pulled, copied=copied,
                                reused=reused)

    # ------------------------------------------------------------ data plane
    def _peer_pull(self, dataset: str, target_sid: str, donor_sid: str,
                   idx: int, trace) -> RecordBatch:
        """One batch over the registered fast path, donor → target."""
        donor = self.coordinator.servers[donor_sid]
        batch = self._held[dataset][donor_sid][idx]
        self._meter(donor_sid)
        # donor exposes its pinned shard buffers in place — zero copies
        remote = bulk_mod.expose_batch(batch, mode="read_only")
        # descriptor exchange: handle + the three size vectors
        rpc = donor.fabric.rpc(64 + 8 * 3 * len(batch.columns))
        pool = self._pool(target_sid)
        local = pool.acquire(remote.descs)
        try:
            wire = donor.fabric.rdma_pull(remote.segments, local.segments,
                                          registered=True)
        except BaseException:
            pool.release(local)
            raise
        out = bulk_mod.assemble_batch(batch.schema, batch.num_rows,
                                      local.segments)
        pool.adopt(local)      # the slabs ARE the shard's storage now
        wire_s = wire.modeled_wire_s + rpc.modeled_wire_s
        self.stats.batches_pulled += 1
        self.stats.bytes_pulled += wire.bytes_moved
        self.stats.segments_pulled += wire.num_segments
        self.stats.modeled_wire_s += wire_s
        if trace is not None:
            trace.span("repair.pull", self.stats.clock_s, wire_s,
                       cat="repair", donor=donor_sid, batch=idx)
        self.stats.clock_s += wire_s
        self.coordinator.notify("repair.pull", server_id=target_sid,
                                now_s=self.stats.clock_s, dataset=dataset,
                                donor=donor_sid, batch=idx,
                                nbytes=wire.bytes_moved)
        return out

    def _table_copy(self, dataset: str, target_sid: str, table: Table,
                    idx: int, trace) -> RecordBatch:
        """Durability fallback: no live peer holds the batch, so the
        coordinator streams its stored copy over the RPC payload path and
        the target pins fresh segments — the honest price of losing every
        registered holder."""
        batch = table.batches[idx]
        server = self.coordinator.servers[target_sid]
        wire = server.fabric.rpc(batch.nbytes)
        register_s = server.fabric.register(3 * len(batch.columns))
        cost = wire.modeled_wire_s + register_s
        self.stats.table_copies += 1
        self.stats.bytes_copied += batch.nbytes
        self.stats.modeled_copy_s += cost
        if trace is not None:
            trace.span("repair.copy", self.stats.clock_s, cost,
                       cat="repair", batch=idx)
        self.stats.clock_s += cost
        self.coordinator.notify("repair.fallback", server_id=target_sid,
                                now_s=self.stats.clock_s, dataset=dataset,
                                batch=idx, nbytes=int(batch.nbytes))
        return batch

    # ------------------------------------------------------------- metering
    def _meter(self, donor_sid: str) -> None:
        """Charge one pull to the donor's admission shard as background
        traffic: yield (modeled backoff) while the donor's token bucket sits
        below the foreground reserve, then lease the tokens and absorb the
        wait on the repair clock. Repair never consumes stream slots, so
        foreground admission quota is untouched."""
        admission = getattr(self.coordinator, "admission", None)
        if admission is None:
            return
        cfg = self.config
        shards = getattr(admission, "shards", None)
        if shards and donor_sid in shards:
            peek = shards[donor_sid].tokens_at
        else:
            peek = getattr(admission, "tokens_at", None)
        if peek is not None:
            for _ in range(cfg.max_yields_per_batch):
                if peek(self.stats.clock_s) >= (cfg.reserve_tokens
                                                + cfg.tokens_per_batch):
                    break
                self.stats.yields += 1
                self.stats.yield_s += cfg.backoff_s
                self.stats.clock_s += cfg.backoff_s
        wait = admission.lease_wait_s(self.stats.clock_s,
                                      cfg.tokens_per_batch,
                                      server_id=donor_sid)
        self.stats.throttle_wait_s += wait
        self.stats.clock_s += wait

    # --------------------------------------------------------------- pools
    def _pool(self, target_sid: str) -> BufferPool:
        """The target's registered pool: slab registrations are charged to
        the *target's* fabric once and amortized across every repair that
        lands there."""
        server = self.coordinator.servers[target_sid]
        pool = self.pools.get(target_sid)
        if pool is None or pool.fabric is not server.fabric:
            pool = BufferPool(server.fabric,
                              max_bytes=self.config.pool_max_bytes)
            self.pools[target_sid] = pool
        return pool
