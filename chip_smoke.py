#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Thallus (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases:

1. set-up: the card's name and power limit, and the build of every CUDA
   kernel from ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, bit for bit, at
   the main path's shapes and at the edge shapes of the CPU tests, then timed
   (CUDA events, cold L2) beside its byte bound, its plain version and one
   PyTorch call as a yardstick, at the main path's shapes and at those of
   ``benchmarks/kernel_bench.py``;
3. the slice at real size: a 2^24-row x 8 float64 table (1 GiB) scanned
   with ``ThallusClient`` and landed by ``batch_to_device`` (kept resident),
   scanned again with ``RpcClient`` and landed by ``batch_to_device_packed``
   (compared with the resident copy); then device pack/unpack of every
   landed batch, device selection ``c0 > 1.5`` against the engine's
   ``WHERE`` scan, and the validity expand of a nullable landed column
   against the host's. Kernel launch counts are read from this phase alone;
4. report: a ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.

Any mismatch raises: the script then exits non-zero and prints no result
line. It also fails without a CUDA card, and outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
ROWS = 1 << 24              # 8 float64 columns: 1 GiB
BATCH_ROWS = 1 << 18        # benchmarks/query_bench.py's batch: 2 MiB per f64 column
N_COLS = 8
MIXED_ROWS = 1 << 20
WHERE_SQL = "SELECT " + ", ".join(f"c{i}" for i in range(N_COLS)) + " FROM t WHERE c0 > 1.5"
MIXED_FIXED = ["id", "val", "flag"]

KERNELS = {
    "pack_tiles": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/pack.py:51"),
    "unpack_tiles": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/pack.py:87"),
    "take_rows": ("src/repro_torch/csrc/take.cu", "src/repro/kernels/take/take.py:50"),
    "bitmap_expand": ("src/repro_torch/csrc/take.cu", "src/repro/kernels/take/take.py:72"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- checking
def bits(t):
    flat = t.reshape(-1)
    if flat.numel() == 0:
        return flat.new_empty(0, dtype=torch.uint8)
    return flat.contiguous().view(torch.uint8)


def same_bits(what: str, got, want) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what}: kernel and plain version differ")


def kernel_case(errs: dict, kernel: str, what: str, got, want) -> None:
    """One kernel-against-plain case: bit equality, and the largest absolute
    difference for the report's ``max_abs_err``."""
    same_bits(what, got, want)
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    errs[kernel].append(err)


# ------------------------------------------------------------------ timing
class Timer:
    """Median device time of one call, by CUDA events, with the L2 cache
    flushed before every call (a 256 MiB write, longer on the card than the
    host needs to enqueue the call, so the events bracket device time)."""

    def __init__(self, device, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(self.reps)]
        for start, end in pairs:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------------ phases
def phase_setup() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[setup] nvidia-smi: {smi}")
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[setup] nvcc {name}: {line.strip()}")
    log(f"[setup] built {sorted(logs) or 'nothing (cached)'} in {build_s:.2f} s")
    return {"smi": smi, "build_s": build_s}


def check_pack(rng, dev, errs) -> None:
    from repro_torch.kernels.pack import (pack_ref, pack_segments, routing,
                                          stage_segments, unpack_gather_ref,
                                          unpack_ref, unpack_segments,
                                          unpack_tiles, inverse_routing,
                                          tiles_for)
    dtypes = (np.float16, np.float32, np.float64, np.int32, np.int64, np.uint8)
    sizes = ([1], [4096], [4096, 4096], [1, 5000, 17], [0, 100],
             [8192, 64, 3, 4097], [BATCH_ROWS] * N_COLS)
    for dtype in dtypes:
        for sz in sizes:
            if sz[0] == BATCH_ROWS and dtype is not np.float64:
                continue
            segs = [torch.from_numpy((rng.standard_normal(n) * 100).astype(dtype)).to(dev)
                    for n in sz]
            what = f"pack {np.dtype(dtype).name} {sz if len(sz) < 8 else '8x2MiB'}"
            packed, lens = pack_segments(segs)
            staged, _ = stage_segments(segs)
            seg_ids, tile_ids = (torch.from_numpy(a).to(dev) for a in routing(lens))
            kernel_case(errs, "pack_tiles", what, packed, pack_ref(staged, seg_ids, tile_ids))
            outs = unpack_segments(packed, lens)
            for s, o in zip(segs, outs):
                same_bits(what + " round trip", o, bits(s))
            max_tiles = max(tiles_for(n) for n in lens)
            padded = torch.cat([packed, torch.zeros_like(packed[:1])])
            inv = torch.from_numpy(inverse_routing(lens, max_tiles)).to(dev)
            ragged = unpack_tiles(padded, inv, n_seg=len(lens), max_tiles=max_tiles)
            kernel_case(errs, "unpack_tiles", what + " unpack", ragged,
                        unpack_gather_ref(padded, inv, len(lens), max_tiles))
            same_bits(what + " unpack vs scatter", ragged,
                      unpack_ref(packed, seg_ids, tile_ids, len(lens), max_tiles))


def check_take(rng, dev, errs) -> None:
    from repro_torch.kernels.take import (bitmap_expand_ref, expand_validity,
                                          take_column, take_ref)
    dtypes = (np.float16, np.float32, np.int32, np.int64, np.float64)
    for dtype in dtypes:
        for n, w in ((64, 1), (130, 3), (512, 128), (300, 200), (777, None),
                     (BATCH_ROWS, None)):
            shape = (n,) if w is None else (n, w)
            vals = torch.from_numpy((rng.standard_normal(shape) * 1000).astype(dtype)).to(dev)
            idx = np.concatenate([rng.integers(0, n, 97),
                                  [-1, -n, -(n + 2), n, n + 2, 0, n - 1]]).astype(np.int32)
            idx_t = torch.from_numpy(idx).to(dev)
            what = f"take {np.dtype(dtype).name} {shape}"
            got = take_column(vals, idx_t)
            kernel_case(errs, "take_rows", what, got, take_ref(vals, idx_t))
            rows = np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)
            same_bits(what + " vs numpy", got.cpu(), torch.from_numpy(vals.cpu().numpy()[rows]))
    for n in (1, 7, 8, 100, 1024, 4096, 10000, (1 << 14) + 3):
        mask = rng.integers(0, 2, n).astype(bool)
        bm = torch.from_numpy(np.packbits(mask, bitorder="little")).to(dev)
        got = expand_validity(bm, n)
        kernel_case(errs, "bitmap_expand", f"bitmap n={n}", got, bitmap_expand_ref(bm, n))
        same_bits(f"bitmap n={n} vs numpy", got.cpu(), torch.from_numpy(mask))


def time_kernels(rng, dev, timer) -> dict:
    """Kernel, plain and library times at the main path's shapes (returned
    per kernel) and at kernel_bench.py's (printed only)."""
    from repro_torch.kernels.pack import (pack_ref, pack_tiles, routing,
                                          stage_segments, unpack_gather_ref,
                                          unpack_tiles, inverse_routing)
    from repro_torch.kernels.take import (bitmap_expand, bitmap_expand_ref,
                                          take_ref, take_rows)

    def pack_case(n_seg, seg_bytes):
        segs = [torch.from_numpy(rng.integers(0, 255, seg_bytes, dtype=np.uint8)).to(dev)
                for _ in range(n_seg)]
        staged, lens = stage_segments(segs)
        lens = [int(n) for n in lens]
        sid, tid = (torch.from_numpy(a).to(dev) for a in routing(lens))
        sid_l, tid_l = sid.long(), tid.long()
        n_out = sid.shape[0]
        pack = dict(ms=timer.ms(lambda: pack_tiles(staged, sid, tid)),
                    plain_ms=timer.ms(lambda: pack_ref(staged, sid, tid)),
                    library_ms=timer.ms(lambda: staged[sid_l, tid_l]),
                    nbytes=2 * n_out * 4096 + 8 * n_out)
        packed = pack_tiles(staged, sid, tid)
        padded = torch.cat([packed, torch.zeros_like(packed[:1])])
        max_tiles = staged.shape[1]
        inv = torch.from_numpy(inverse_routing(lens, max_tiles)).to(dev)
        inv_l = inv.long()
        n_total = inv.shape[0]
        unpack = dict(ms=timer.ms(lambda: unpack_tiles(padded, inv, n_seg=n_seg, max_tiles=max_tiles)),
                      plain_ms=timer.ms(lambda: unpack_gather_ref(padded, inv, n_seg, max_tiles)),
                      library_ms=timer.ms(lambda: torch.index_select(padded, 0, inv_l)),
                      nbytes=2 * n_total * 4096 + 4 * n_total)
        return pack, unpack

    def take_case(n, width, n_sel, dtype):
        vals = torch.from_numpy(rng.standard_normal((n, width)).astype(dtype)).to(dev)
        idx = torch.from_numpy(np.sort(rng.choice(n, n_sel, replace=False)).astype(np.int32)).to(dev)
        idx_l = idx.long()
        row_bytes = width * vals.element_size()
        return dict(ms=timer.ms(lambda: take_rows(vals, idx)),
                    plain_ms=timer.ms(lambda: take_ref(vals, idx)),
                    library_ms=timer.ms(lambda: torch.index_select(vals, 0, idx_l)),
                    nbytes=n_sel * (2 * row_bytes + 4))

    def bitmap_case(n_bytes):
        bm = torch.from_numpy(rng.integers(0, 256, n_bytes, dtype=np.uint8)).to(dev)
        return dict(ms=timer.ms(lambda: bitmap_expand(bm)),
                    plain_ms=timer.ms(lambda: bitmap_expand_ref(bm, 8 * n_bytes)),
                    library_ms=None, nbytes=9 * n_bytes)

    main = {}
    # The main path: 8 landed float64 columns of 2^18 rows (2 MiB each); the
    # selection c0 > 1.5 keeps about 6.7 % of a batch's rows; the mixed
    # table's batches hold 2^14 rows, 2 KiB of validity bitmap.
    main["pack_tiles"], main["unpack_tiles"] = pack_case(N_COLS, BATCH_ROWS * 8)
    main["take_rows"] = take_case(BATCH_ROWS, 1, int(BATCH_ROWS * 0.0668), np.float64)
    main["bitmap_expand"] = bitmap_case((1 << 14) // 8)
    bench = []
    for n_seg, seg_bytes in ((8, 1 << 16), (32, 1 << 20)):
        p, u = pack_case(n_seg, seg_bytes)
        bench += [(f"pack_tiles {n_seg}x{seg_bytes}B", p), (f"unpack_tiles {n_seg}x{seg_bytes}B", u)]
    bench.append(("take_rows 4096 of 16384 rows x128 f32", take_case(1 << 14, 128, 1 << 12, np.float32)))
    bench.append(("bitmap_expand 1 Mbit", bitmap_case((1 << 20) // 8)))
    for name, row in [(f"{k} (main path)", v) for k, v in main.items()] + bench:
        row["bound_ms"] = bound_ms(row["nbytes"])
        log(f"[kernels] {name}: ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
            f"library_ms={row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)} "
            f"bound_ms={row['bound_ms']:.5f} bytes={row['nbytes']} "
            f"share_of_bound={row['bound_ms'] / row['ms']:.3f}")
    return main


def phase_slice(dev, rows: int) -> dict:
    from repro_torch.core import RpcClient, ThallusClient, ThallusServer, unpack_validity
    from repro_torch.core.device_transport import batch_to_device, batch_to_device_packed
    from repro_torch.engine import Engine, make_mixed_table, make_numeric_table
    from repro_torch.kernels.pack import (pack_ref, pack_segments, routing,
                                          stage_segments, unpack_segments)
    from repro_torch.kernels.take import expand_validity, take_column

    names = [f"c{i}" for i in range(N_COLS)]
    t0 = time.perf_counter()
    table = make_numeric_table("t", rows, N_COLS, batch_rows=BATCH_ROWS, seed=0)
    mixed = make_mixed_table("m", MIXED_ROWS, seed=1)
    engine = Engine()
    engine.register("t", table)
    engine.register("m", mixed)
    server = ThallusServer(engine)
    log(f"[slice] tables: {rows} x {N_COLS} float64 ({table.nbytes} B, "
        f"{len(table.batches)} batches) and {MIXED_ROWS}-row mixed, made in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def timed(key, nbytes, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        out[key] = {"s": s, "bytes": nbytes, "GB_per_s": nbytes / s / 1e9}
        log(f"[slice] {key}: {s:.4f} s, {nbytes} B, {nbytes / s / 1e9:.3f} GB/s")
        return result

    # 1. Thallus scan, landed column by column, kept resident.
    resident = []
    thallus = ThallusClient(server, sink=lambda b: resident.append(batch_to_device(b)))
    timed("scan_thallus_batch_to_device", table.nbytes,
          lambda: thallus.run_query("SELECT * FROM t", "t"))
    thallus.batches.clear()
    if len(resident) != len(table.batches):
        raise AssertionError(f"thallus scan landed {len(resident)} of {len(table.batches)} batches")
    for db, hb in ((resident[0], table.batches[0]), (resident[-1], table.batches[-1])):
        for name in names:
            same_bits("landed vs table " + name, db[name].cpu(),
                      torch.from_numpy(hb.column(name).values))

    # 2. RPC scan, landed from one packed wire, compared with the resident copy.
    seen = [0]

    def rpc_sink(batch):
        db = batch_to_device_packed(batch)
        ref = resident[seen[0]]
        for name in names:
            same_bits(f"rpc batch {seen[0]} {name}", db[name], ref[name])
        seen[0] += 1

    rpc = RpcClient(server, sink=rpc_sink)
    timed("scan_rpc_batch_to_device_packed_and_compare", table.nbytes,
          lambda: rpc.run_query("SELECT * FROM t", "t"))
    rpc.batches.clear()
    if seen[0] != len(resident):
        raise AssertionError(f"rpc scan landed {seen[0]} of {len(resident)} batches")

    # 3. Device pack / unpack of every landed batch's 8 column buffers.
    # Reserve the device ops' working memory once, untimed and with no
    # kernel, so that each timed line below pays for its own work and not
    # for the caching allocator's first cudaMalloc of the blocks it keeps.
    reserve = torch.empty(3 * table.nbytes, dtype=torch.uint8, device=dev)
    del reserve
    timed("device_stage_segments_alone", table.nbytes,
          lambda: [stage_segments([db[n] for n in names]) for db in resident])
    packs = timed("device_pack_segments", table.nbytes,
                  lambda: [pack_segments([db[n] for n in names]) for db in resident])
    unpacked = timed("device_unpack_segments", table.nbytes,
                     lambda: [unpack_segments(p, lens) for p, lens in packs])
    for i, (db, (packed, lens), outs) in enumerate(zip(resident, packs, unpacked)):
        segs = [db[n] for n in names]
        staged, _ = stage_segments(segs)
        sid, tid = (torch.from_numpy(a).to(dev) for a in routing(lens))
        same_bits(f"batch {i} packed vs pack_ref", packed, pack_ref(staged, sid, tid))
        for n, s, o in zip(names, segs, outs):
            same_bits(f"batch {i} {n} round trip", o, bits(s))
    del packs, unpacked

    # 4. Selection on the device against the engine's WHERE scan.
    def select_all():
        picked = []
        for db in resident:
            sel = torch.nonzero(db["c0"] > 1.5).squeeze(1).to(torch.int32)
            picked.append({n: take_column(db[n], sel) for n in names})
        return picked

    picked = timed("device_select_take_column", table.nbytes, select_all)
    where = []
    ThallusClient(server, sink=lambda b: where.append(batch_to_device(b))).run_query(WHERE_SQL, "t")
    n_sel = 0
    for n in names:
        got = torch.cat([p[n] for p in picked])
        want = torch.cat([w[n] for w in where])
        same_bits(f"selection {n} vs WHERE scan", got, want)
        n_sel = got.shape[0]
    log(f"[slice] selection c0 > 1.5: {n_sel} of {rows} rows, equal to the WHERE scan")
    del picked, where

    # 5. Validity of a nullable landed column against the host.
    host, landed = [], []

    def mixed_sink(batch):
        host.append(batch)
        landed.append(batch_to_device(batch.select(MIXED_FIXED)))

    ThallusClient(server, sink=mixed_sink).run_query("SELECT * FROM m", "m")
    masks = timed("device_expand_validity", sum(len(d.validity["val"]) for d in landed),
                  lambda: [expand_validity(d.validity["val"], d.num_rows) for d in landed])
    nulls = 0
    for i, (hb, db, mask) in enumerate(zip(host, landed, masks)):
        col = hb.column("val")
        want = torch.from_numpy(unpack_validity(col.validity, hb.num_rows))
        same_bits(f"mixed batch {i} validity", mask.cpu(), want)
        for n in MIXED_FIXED:
            same_bits(f"mixed batch {i} {n}", db[n].cpu(), torch.from_numpy(hb.column(n).values))
        nulls += int((~want).sum())
    if sum(len(h.columns[0].values) for h in host) != MIXED_ROWS or nulls == 0:
        raise AssertionError("mixed scan lost rows or nulls")
    log(f"[slice] validity: {len(landed)} batches, {nulls} nulls, equal to the host")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[slice] torch.cuda.max_memory_allocated: {out['max_memory_allocated']} B")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.pack import pack as pack_mod
    from repro_torch.kernels.take import take as take_mod
    wrappers = {"pack_tiles": pack_mod.pack_tiles, "unpack_tiles": pack_mod.unpack_tiles,
                "take_rows": take_mod.take_rows, "bitmap_expand": take_mod.bitmap_expand}
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    setup = phase_setup()

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    errs = {k: [] for k in KERNELS}
    check_pack(rng, dev, errs)
    check_take(rng, dev, errs)
    torch.cuda.synchronize()
    log(f"[kernels] every kernel equals its plain version bit for bit "
        f"({sum(map(len, errs.values()))} cases) in {time.perf_counter() - t0:.2f} s")
    timer = Timer(dev)
    main_times = time_kernels(rng, dev, timer)
    del timer

    for w in wrappers.values():
        w.launches = 0
    slice_out = phase_slice(dev, ROWS)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[slice] launches in the slice phase: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    report = []
    for name, (source, replaces) in KERNELS.items():
        t = main_times[name]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "bit_equal": True, "max_abs_err": max(errs[name]),
                       "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": "bytes",
                       "library_ms": t["library_ms"]})
    log(f"[report] build_s={setup['build_s']:.3f} total_s={time.perf_counter() - t_start:.2f} "
        f"phases={json.dumps({k: v for k, v in slice_out.items()})}")
    print(json.dumps({"kernels": report}))
    print(setup["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
