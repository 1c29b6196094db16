#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Thallus (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --one-column [DIR]   # see below

Phases:

1. set-up: the card's name and power limit, and the build of every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version on the card (the datapath
   kernels bit for bit, flash attention within a stated tolerance, in
   float32 at every head dim and at shapes that straddle its tiles, in
   bfloat16, and its gradients) at the main paths' shapes and at edge
   shapes, then timed (CUDA events, cold L2) beside its bound, its plain
   version and one PyTorch call as a yardstick, with the SM clock, power
   draw and temperature sampled by ``nvidia-smi`` right after each timing.
   The take kernel is timed on the main path's 8-column launch, on one
   column and on one row of one column (its launch floor), each with the
   host time of a call;
3. slice 1 at real size: a 2^24-row x 8 float64 table (1 GiB) scanned
   with ``ThallusClient`` and landed by ``batch_to_device`` (kept resident),
   scanned again with ``RpcClient`` and landed by ``batch_to_device_packed``
   (compared with the resident copy); then device pack/unpack of every
   landed batch, device selection ``c0 > 1.5`` against the engine's
   ``WHERE`` scan through both routes (one ``take_columns`` call per
   batch, and one ``take_column`` call per column, in turns, 5 runs each),
   and the validity expand of a nullable landed column against the host's.
   The datapath kernels' launch counts are read from this phase alone;
4. slice 2: granite-3-2b at full width and depth (40 layers, float32, seeded
   random weights with norm weights ``1 + 0.1 N(0, 1)``) serves two request
   sets through ``repro_torch.launch.serve.serve``; the flash-attention
   launch count is read from this phase alone. Then every cohort's prefill
   through the kernel is held to a prefill through the plain attention.
   Every ``[serve]`` line carries an ``nvidia-smi`` sample;
5. report: a ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.

Any mismatch raises: the script then exits non-zero and prints no result
line. It also fails without a CUDA card, and outside a checkout.

``--one-column [DIR]`` only times the one-column take route
(``take_column`` at the main path's shape: device ms, and host ms per call
without a synchronize) of this checkout's port and, with DIR, of the port
in checkout DIR (a parent commit unpacked under ``build/``, say), the two
in turns in one process, and prints the rows as its last line.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
ROWS = 1 << 24              # 8 float64 columns: 1 GiB
BATCH_ROWS = 1 << 18        # benchmarks/query_bench.py's batch: 2 MiB per f64 column
N_COLS = 8
SEL_ROWS = int(BATCH_ROWS * 0.0668)  # about the rows of a batch that c0 > 1.5 keeps
HOST_CALLS = 400            # calls per host-time median
SLICE_RUNS = 5              # runs per selection line
MIXED_ROWS = 1 << 20
WHERE_SQL = "SELECT " + ", ".join(f"c{i}" for i in range(N_COLS)) + " FROM t WHERE c0 > 1.5"
MIXED_FIXED = ["id", "val", "flag"]

KERNELS = {
    "pack_tiles": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/pack.py:51"),
    "unpack_tiles": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/pack.py:87"),
    "take_rows": ("src/repro_torch/csrc/take.cu", "src/repro/kernels/take/take.py:50"),
    "bitmap_expand": ("src/repro_torch/csrc/take.cu", "src/repro/kernels/take/take.py:72"),
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/attention/attention.py:75"),
}
BIT_EXACT = ("pack_tiles", "unpack_tiles", "take_rows", "bitmap_expand")

# Flash attention against its plain version: float32 in another summation
# order (online softmax over 64- or 32-key tiles, FMAs), so |kernel - plain| <=
# ATT_ATOL + ATT_RTOL |plain| elementwise; differences are ~1e-6 on
# unit-normal inputs, a wrong mask or tile gives O(1).
ATT_ATOL = ATT_RTOL = 1e-4
# bfloat16 in and out: the same float32 result rounded once on each side, so
# the two may differ by one more bf16 ulp, at most 2^-7 |plain| (7 stored
# significand bits).
BF16_ULP = 2.0 ** -7
# Served prefill through the kernel against prefill through the plain
# attention: max |kernel - plain| <= SERVE_REL x max |plain|, over the real
# vocabulary's logits and over each of the k and v caches. 40 float32
# layers carry the attention's rounding differences through depth; a wrong
# kernel gives differences of the order of the values.
SERVE_REL = 1e-3
ARCH = "granite-3-2b"


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


def max_abs_diff(got, want) -> float:
    """Largest elementwise |got - want| in the values' own type (integers and
    bools as integers); equal values, NaN at the same place, count 0."""
    if got.is_floating_point():
        g, w = got.double(), want.double()
        both_nan = torch.isnan(g) & torch.isnan(w)
        d = torch.where((g == w) | both_nan, torch.zeros_like(g), (g - w).abs())
    else:
        d = (got.long() - want.long()).abs()
    return float(d.max()) if d.numel() else 0.0


def kernel_case(cases: dict, kernel: str, what: str, got, want) -> None:
    """One kernel-against-plain case of a data-movement kernel: bit equality,
    and the largest difference measured on the values."""
    same_bits(what, got, want)
    cases[kernel]["n"] += 1
    cases[kernel]["max_abs_err"] = max(cases[kernel]["max_abs_err"], max_abs_diff(got, want))


# ------------------------------------------------------------------ timing
def gpu_state() -> str:
    """The card's SM clock, power draw and temperature, as ``nvidia-smi``
    reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return "[" + out.replace(", ", " ") + "]"


class Timer:
    """Median device time of one call, by CUDA events, with the L2 cache
    flushed before every call (a 256 MiB write). After the flush the device
    spins for ``HOLD_CYCLES`` (about 1 ms), so that the host has enqueued the
    whole call before the start event fires and the events bracket device
    time alone, also for a call whose host side outlasts the flush (8
    take_column calls, or a plain version of a dozen PyTorch ops).
    ``smi`` is the card's state sampled right after the last timing."""

    HOLD_CYCLES = 2_000_000

    def __init__(self, device, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        self.smi = ""

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(self.reps)]
        for start, end in pairs:
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        self.smi = gpu_state()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(*fns, calls: int = HOST_CALLS) -> list[float]:
    """Median host-clock time of one call of each of ``fns`` over ``calls``
    calls each, made back to back without a synchronize and, for several
    functions, in turns call by call (so that a change of the host's pace
    meets all of them alike): what the caller's thread pays to enqueue the
    work, the wrapper's Python and the launch included."""
    for fn in fns:
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(calls):
        for fn, ts in zip(fns, times):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return [statistics.median(ts) * 1e3 for ts in times]


def bound_ms(nbytes: int, flops: float = 0.0) -> float:
    """The least time for the work: bytes over HBM rate or float32 operations
    over the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3


# ------------------------------------------------------------------ phases
def phase_setup(sources: tuple[str, ...] | None = None) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[setup] nvidia-smi: {smi}")
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(sources or _build.SOURCES)
    build_s = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "Function properties")):
                log(f"[setup] nvcc {name}: {line.strip()}")
    log(f"[setup] built {sorted(logs) or 'nothing (cached)'} in {build_s:.2f} s")
    return {"smi": smi, "build_s": build_s}


def check_pack(rng, dev, cases) -> None:
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
            kernel_case(cases, "pack_tiles", what, packed, pack_ref(staged, seg_ids, tile_ids))
            outs = unpack_segments(packed, lens)
            for s, o in zip(segs, outs):
                same_bits(what + " round trip", o, bits(s))
            max_tiles = max(tiles_for(n) for n in lens)
            padded = torch.cat([packed, torch.zeros_like(packed[:1])])
            inv = torch.from_numpy(inverse_routing(lens, max_tiles)).to(dev)
            ragged = unpack_tiles(padded, inv, n_seg=len(lens), max_tiles=max_tiles)
            kernel_case(cases, "unpack_tiles", what + " unpack", ragged,
                        unpack_gather_ref(padded, inv, len(lens), max_tiles))
            same_bits(what + " unpack vs scatter", ragged,
                      unpack_ref(packed, seg_ids, tile_ids, len(lens), max_tiles))


def check_take(rng, dev, cases) -> None:
    from repro_torch.kernels.take import (MAX_COLUMNS, bitmap_expand_ref, expand_validity,
                                          take, take_column, take_columns, take_ref,
                                          take_rows)
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
            kernel_case(cases, "take_rows", what, got, take_ref(vals, idx_t))
            rows = np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)
            same_bits(what + " vs numpy", got.cpu(), torch.from_numpy(vals.cpu().numpy()[rows]))

    def table_case(what, cols, idx):
        launches = take_rows.launches
        got = take_columns(cols, idx)
        want_launches = -(-len(cols) // MAX_COLUMNS) if idx.shape[0] else 0
        if take_rows.launches - launches != want_launches:
            raise AssertionError(f"{what}: {take_rows.launches - launches} launches for "
                                 f"{len(cols)} columns, expected {want_launches}")
        for k, (c, o) in enumerate(zip(cols, got)):
            kernel_case(cases, "take_rows", f"{what} column {k}", o, take_ref(c, idx))

    # Tables: every dtype, 1-D and 2-D columns of 1, 3, 128 and 200 units
    # in one table (25 columns: two launches), pinned out-of-range indices.
    n = 777
    pinned = [-1, -n, -(n + 2), n, n + 2, 0, n - 1]
    idx = torch.from_numpy(np.concatenate([rng.integers(0, n, 300), pinned])
                           .astype(np.int32)).to(dev)
    mixed = [torch.from_numpy((rng.standard_normal((n,) if w is None else (n, w)) * 1000)
                              .astype(dtype)).to(dev)
             for dtype in dtypes for w in (None, 1, 3, 128, 200)]
    table_case("table of 25 mixed columns", mixed, idx)
    table_case(f"table of {MAX_COLUMNS} mixed columns", mixed[:MAX_COLUMNS], idx)
    table_case("table, empty selection", mixed[:7], idx[:0])
    narrow = [c for c in mixed if c.dim() == 1]
    table_case("table of 1-D columns of every dtype", narrow, idx)
    table_case("table of 17 1-D float64 columns", [mixed[20] + k for k in range(17)], idx)
    table_case("table, one row of one column", mixed[:1], idx[:1])
    own = [torch.from_numpy(rng.standard_normal(shape)).to(dev)
           for shape in ((n,), (40, 3), (7,), (1, 5))]
    table_case("table, columns of 777, 40, 7 and 1 rows", own, idx)
    sel = torch.from_numpy(np.sort(rng.choice(BATCH_ROWS, SEL_ROWS, replace=False))
                           .astype(np.int32)).to(dev)
    batch = [torch.from_numpy(rng.standard_normal(BATCH_ROWS)).to(dev) for _ in range(N_COLS)]
    table_case(f"table, main path: {SEL_ROWS} of {BATCH_ROWS} rows x {N_COLS} float64",
               batch, sel)
    # A column a 6-byte row into its storage (a 2-byte vector) and an output
    # 4 bytes into its storage (a 4-byte vector for that column alone).
    base = torch.from_numpy(rng.standard_normal(3 * (n + 1)).astype(np.float16)).to(dev)
    raw = [c.view(torch.uint8).view(c.shape[0], -1)
           for c in (base.view(n + 1, 3)[1:], mixed[14], mixed[3])]
    outs = [torch.empty((idx.shape[0], r.shape[1]), dtype=torch.uint8, device=dev) for r in raw]
    shifted = torch.empty(outs[1].numel() + 16, dtype=torch.uint8, device=dev)
    outs[1] = shifted[4:4 + outs[1].numel()].view(outs[1].shape)
    vec = [take.vector_bytes(r.shape[1], r.data_ptr(), o.data_ptr()) for r, o in zip(raw, outs)]
    if vec != [2, 4, 16]:
        raise AssertionError(f"unaligned table case: vectors {vec}, expected [2, 4, 16]")
    take._gather(raw, outs, idx)
    for k, (r, o) in enumerate(zip(raw, outs)):
        kernel_case(cases, "take_rows", f"table, unaligned, column {k} ({vec[k]}-byte vectors)",
                    o, take_ref(r, idx))
    for n in (1, 7, 8, 100, 1024, 4096, 10000, (1 << 14) + 3):
        mask = rng.integers(0, 2, n).astype(bool)
        bm = torch.from_numpy(np.packbits(mask, bitorder="little")).to(dev)
        got = expand_validity(bm, n)
        kernel_case(cases, "bitmap_expand", f"bitmap n={n}", got, bitmap_expand_ref(bm, n))
        same_bits(f"bitmap n={n} vs numpy", got.cpu(), torch.from_numpy(mask))


def time_one_column(dev, timer, take_pkg) -> dict:
    """The one-column take route as the main path calls it, ``take_column``
    of ``take_pkg`` (a port's ``kernels.take``) on a landed 1-D float64
    column of 2^18 rows with 17511 int32 indices (seed 1, so that every tree
    times the same data): device ms, host ms per call, the launch floor (one
    index), plain and ``index_select`` ms. It uses only what the port has
    had since its first slice, so that it also times an older checkout's."""
    take_column, take_ref = take_pkg.take_column, take_pkg.take_ref
    rng = np.random.default_rng(1)
    col = torch.from_numpy(rng.standard_normal(BATCH_ROWS)).to(dev)
    idx = torch.from_numpy(np.sort(rng.choice(BATCH_ROWS, SEL_ROWS, replace=False))
                           .astype(np.int32)).to(dev)
    idx_l = idx.long()
    one = idx[:1]
    return dict(ms=timer.ms(lambda: take_column(col, idx)), smi=timer.smi,
                host_ms=host_ms(lambda: take_column(col, idx))[0],
                floor_ms=timer.ms(lambda: take_column(col, one)),
                plain_ms=timer.ms(lambda: take_ref(col, idx)),
                library_ms=timer.ms(lambda: torch.index_select(col, 0, idx_l)),
                nbytes=SEL_ROWS * (2 * 8 + 4))


def time_kernels(rng, dev, timer) -> dict:
    """Kernel, plain and library times at the main path's shapes (returned
    per kernel) and at kernel_bench.py's (printed only)."""
    from repro_torch.kernels.pack import (pack_ref, pack_tiles, routing,
                                          stage_segments, unpack_gather_ref,
                                          unpack_tiles, inverse_routing)
    import repro_torch.kernels.take as take_pkg
    from repro_torch.kernels.take import (bitmap_expand, bitmap_expand_ref, take_column,
                                          take_columns, take_ref, take_rows, take_table)

    def pack_case(n_seg, seg_bytes):
        segs = [torch.from_numpy(rng.integers(0, 255, seg_bytes, dtype=np.uint8)).to(dev)
                for _ in range(n_seg)]
        staged, lens = stage_segments(segs)
        lens = [int(n) for n in lens]
        sid, tid = (torch.from_numpy(a).to(dev) for a in routing(lens))
        sid_l, tid_l = sid.long(), tid.long()
        n_out = sid.shape[0]
        pack = dict(ms=timer.ms(lambda: pack_tiles(staged, sid, tid)), smi=timer.smi,
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
                      smi=timer.smi,
                      plain_ms=timer.ms(lambda: unpack_gather_ref(padded, inv, n_seg, max_tiles)),
                      library_ms=timer.ms(lambda: torch.index_select(padded, 0, inv_l)),
                      nbytes=2 * n_total * 4096 + 4 * n_total)
        return pack, unpack

    def take_case(n, width, n_sel, dtype):
        vals = torch.from_numpy(rng.standard_normal((n, width)).astype(dtype)).to(dev)
        idx = torch.from_numpy(np.sort(rng.choice(n, n_sel, replace=False)).astype(np.int32)).to(dev)
        idx_l = idx.long()
        row_bytes = width * vals.element_size()
        return dict(ms=timer.ms(lambda: take_rows(vals, idx)), smi=timer.smi,
                    host_ms=host_ms(lambda: take_rows(vals, idx))[0],
                    plain_ms=timer.ms(lambda: take_ref(vals, idx)),
                    library_ms=timer.ms(lambda: torch.index_select(vals, 0, idx_l)),
                    nbytes=n_sel * (2 * row_bytes + 4))

    def take_table_case():
        """The main path's launch: one take_columns call over a batch's 8
        float64 columns; its floor is the same kernel on one row of one
        column; no one PyTorch call gathers 8 tensors, so the yardstick is
        8 index_select calls."""
        cols = {f"c{i}": torch.from_numpy(rng.standard_normal(BATCH_ROWS)).to(dev)
                for i in range(N_COLS)}
        idx = torch.from_numpy(np.sort(rng.choice(BATCH_ROWS, SEL_ROWS, replace=False))
                               .astype(np.int32)).to(dev)
        idx_l, one = idx.long(), idx[:1]
        return dict(ms=timer.ms(lambda: take_columns(cols, idx)), smi=timer.smi,
                    **dict(zip(("host_ms", "per_column_host_ms"), host_ms(
                        lambda: take_columns(cols, idx),
                        lambda: [take_column(c, idx) for c in cols.values()]))),
                    floor_ms=timer.ms(lambda: take_table([cols["c0"]], one)),
                    plain_ms=timer.ms(lambda: [take_ref(c, idx) for c in cols.values()]),
                    library_ms=None,
                    yardstick_ms=timer.ms(lambda: [torch.index_select(c, 0, idx_l)
                                                   for c in cols.values()]),
                    yardstick=f"{N_COLS} torch.index_select calls",
                    nbytes=N_COLS * SEL_ROWS * 2 * 8 + SEL_ROWS * 4)

    def bitmap_case(n_bytes):
        bm = torch.from_numpy(rng.integers(0, 256, n_bytes, dtype=np.uint8)).to(dev)
        return dict(ms=timer.ms(lambda: bitmap_expand(bm)), smi=timer.smi,
                    floor_ms=timer.ms(lambda: bitmap_expand(bm[:1])),
                    plain_ms=timer.ms(lambda: bitmap_expand_ref(bm, 8 * n_bytes)),
                    library_ms=None, nbytes=9 * n_bytes)

    main = {}
    # The main path: 8 landed float64 columns of 2^18 rows (2 MiB each); the
    # selection c0 > 1.5 keeps about 6.7 % of a batch's rows, gathered from
    # all 8 columns in one launch; the mixed table's batches hold 2^14 rows,
    # 2 KiB of validity bitmap.
    main["pack_tiles"], main["unpack_tiles"] = pack_case(N_COLS, BATCH_ROWS * 8)
    main["take_rows"] = take_table_case()
    main["take_rows"]["one_column"] = one = time_one_column(dev, timer, take_pkg)
    main["bitmap_expand"] = bitmap_case((1 << 14) // 8)
    bench = [(f"take_rows one column, {SEL_ROWS} of {BATCH_ROWS} rows x 1 float64 "
              f"(take_column; runs 1-4's main-path row)", one)]
    for n_seg, seg_bytes in ((8, 1 << 16), (32, 1 << 20)):
        p, u = pack_case(n_seg, seg_bytes)
        bench += [(f"pack_tiles {n_seg}x{seg_bytes}B", p), (f"unpack_tiles {n_seg}x{seg_bytes}B", u)]
    bench.append(("take_rows 4096 of 16384 rows x128 f32", take_case(1 << 14, 128, 1 << 12, np.float32)))
    bench.append(("bitmap_expand 1 Mbit", bitmap_case((1 << 20) // 8)))
    main_names = {"take_rows": f"take_rows (main path: {SEL_ROWS} of {BATCH_ROWS} rows x "
                                f"{N_COLS} float64, one take_columns launch)"}
    for name, row in [(main_names.get(k, f"{k} (main path)"), v) for k, v in main.items()] + bench:
        row["bound_ms"] = bound_ms(row["nbytes"])
        extra = "".join(f" {k}={row[k]:.5f}" for k in ("host_ms", "per_column_host_ms", "floor_ms",
                                                       "yardstick_ms") if k in row)
        if "yardstick" in row:
            extra += f" (yardstick: {row['yardstick']})"
        log(f"[kernels] {name}: ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
            f"library_ms={row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)} "
            f"bound_ms={row['bound_ms']:.5f} bytes={row['nbytes']} "
            f"share_of_bound={row['bound_ms'] / row['ms']:.3f}{extra} smi={row['smi']}")
    table, one = main["take_rows"], main["take_rows"]["one_column"]
    log(f"[kernels] take_rows: one {N_COLS}-column launch / {N_COLS} one-column launches = "
        f"{table['ms']:.5f} / {N_COLS * one['ms']:.5f} ms = {table['ms'] / (N_COLS * one['ms']):.4f}; "
        f"host ms per batch {table['host_ms']:.5f} (take_columns) against "
        f"{table['per_column_host_ms']:.5f} ({N_COLS} take_column calls)")
    return main


def phase_slice(dev, rows: int) -> dict:
    from repro_torch.core import RpcClient, ThallusClient, ThallusServer, unpack_validity
    from repro_torch.core.device_transport import batch_to_device, batch_to_device_packed
    from repro_torch.engine import Engine, make_mixed_table, make_numeric_table
    from repro_torch.kernels.pack import (pack_ref, pack_segments, routing,
                                          stage_segments, unpack_segments)
    from repro_torch.kernels.take import expand_validity, take_column, take_columns, take_rows

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

    # 4. Selection on the device against the engine's WHERE scan, through
    # both routes in turns: one take_column call per column, and one
    # take_columns call per batch (the main path: one launch per batch).
    def select_per_column():
        picked = []
        for db in resident:
            sel = torch.nonzero(db["c0"] > 1.5).squeeze(1).to(torch.int32)
            picked.append({n: take_column(db[n], sel) for n in names})
        return picked

    def select_per_batch():
        picked = []
        for db in resident:
            sel = torch.nonzero(db["c0"] > 1.5).squeeze(1).to(torch.int32)
            picked.append(take_columns({n: db[n] for n in names}, sel))
        return picked

    routes = {"device_select_take_column": (select_per_column, N_COLS * len(resident)),
              "device_select_take_columns": (select_per_batch, len(resident))}
    secs = {key: [] for key in routes}
    picked = {}
    for _ in range(SLICE_RUNS):
        for key, (select, want_launches) in routes.items():
            launches = take_rows.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            picked[key] = select()
            torch.cuda.synchronize()
            secs[key].append(time.perf_counter() - t)
            if take_rows.launches - launches != want_launches:
                raise AssertionError(f"{key}: {take_rows.launches - launches} take_rows launches "
                                     f"per scan, expected {want_launches}")
    for key, (_, want_launches) in routes.items():
        med = statistics.median(secs[key])
        out[key] = {"s": med, "s_min": min(secs[key]), "s_max": max(secs[key]), "runs": secs[key],
                    "bytes": table.nbytes, "GB_per_s": table.nbytes / med / 1e9,
                    "take_rows_launches_per_scan": want_launches}
        log(f"[slice] {key}: {med:.4f} s (median of {SLICE_RUNS}, min {min(secs[key]):.4f}, "
            f"max {max(secs[key]):.4f}), {table.nbytes} B, {table.nbytes / med / 1e9:.3f} GB/s, "
            f"{want_launches} take_rows launches per scan")
    where = []
    ThallusClient(server, sink=lambda b: where.append(batch_to_device(b))).run_query(WHERE_SQL, "t")
    n_sel = 0
    for key in routes:
        for n in names:
            got = torch.cat([p[n] for p in picked[key]])
            want = torch.cat([w[n] for w in where])
            same_bits(f"selection {n} through {key} vs WHERE scan", got, want)
            n_sel = got.shape[0]
    log(f"[slice] selection c0 > 1.5: {n_sel} of {rows} rows, equal to the WHERE scan "
        f"through both routes")
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


# --------------------------------------------------------------- attention
# (BH, Sq, Sk, hd, KV rows, causal): the JAX kernel tests' shapes, causal
# with Sq != Sk both ways, ragged lengths, shared K/V rows, and granite's
# prefill (B 4 x H 32 query rows, B 4 x KV 8 K/V rows, S 1024, hd 64).
ATT_CASES = ([(2, 128, 128, 64, 2, c) for c in (True, False)]
             + [(1, 256, 256, 32, 1, c) for c in (True, False)]
             + [(1, 128, 384, 128, 1, False),
                (2, 100, 300, 64, 2, True), (2, 300, 100, 64, 2, True)]
             + [(2, n, n, 64, 2, c) for n in (1, 7, 12, 129, 1000) for c in (True, False)]
             + [(8, 77, 77, 64, 2, True), (2, 45, 45, 16, 2, True), (1, 40, 70, 256, 1, True)]
             # the kernel's tiles: 64 query rows, 64 keys (hd <= 64) or 32 (hd 128, 256)
             + [(2, n, n, 64, 2, c) for n in (63, 65) for c in (True, False)]
             + [(2, 63, 129, 64, 1, True), (2, 129, 63, 64, 1, False), (4, 65, 129, 16, 2, True),
                (1, 63, 65, 32, 1, True), (1, 65, 33, 128, 1, True), (1, 33, 65, 128, 1, False),
                (1, 65, 65, 256, 1, True), (1, 31, 97, 256, 1, False)]
             + [(128, 1024, 1024, 64, 32, True)])
# bfloat16 through the kernel (widened to float32, narrowed back) and the
# gradients through its autograd function: (BH, Sq, Sk, hd, KV rows, causal).
ATT_BF16_CASES = [(8, 65, 65, 64, 2, True), (2, 129, 63, 128, 1, False), (128, 1024, 1024, 64, 32, True)]
ATT_GRAD_CASES = [(8, 130, 97, 64, 2, True), (4, 65, 65, 16, 2, False)]
GRANITE_ATT = (128, 1024, 1024, 64, 32, True)


def attention_inputs(dev, bh, sq, sk, hd, bkv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(bh, sq, hd, generator=g, device=dev),
            torch.randn(bkv, sk, hd, generator=g, device=dev),
            torch.randn(bkv, sk, hd, generator=g, device=dev))


def within(what: str, got, want, rtol: float) -> float:
    """Raise unless |got - want| <= ATT_ATOL + rtol |want| elementwise;
    returns the largest |got - want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = ~(diff <= ATT_ATOL + rtol * want.abs())
    if got.shape != want.shape or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond atol={ATT_ATOL} "
                             f"rtol={rtol}, max |diff| {float(diff.max())}")
    return float(diff.max())


def check_attention(dev) -> dict:
    """The kernel against its plain version on every case, in float32 and
    bfloat16, and its gradients against the plain version's; raises on the
    first miss. Returns the largest absolute difference in float32 and in
    bfloat16."""
    from repro_torch.kernels.attention import attention_ref, flash_attention
    worst = 0.0
    for i, (bh, sq, sk, hd, bkv, causal) in enumerate(ATT_CASES):
        q, k, v = attention_inputs(dev, bh, sq, sk, hd, bkv, seed=100 + i)
        what = f"flash_attention BH={bh} Sq={sq} Sk={sk} hd={hd} kv_rows={bkv} causal={causal}"
        worst = max(worst, within(what, flash_attention(q, k, v, causal=causal),
                                  attention_ref(q, k, v, causal=causal), ATT_RTOL))
    log(f"[kernels] flash_attention within atol=rtol={ATT_ATOL} of attention_ref in "
        f"{len(ATT_CASES)} cases, max |diff| {worst:.3e}")
    worst_bf16 = 0.0
    for i, (bh, sq, sk, hd, bkv, causal) in enumerate(ATT_BF16_CASES):
        q, k, v = (t.bfloat16() for t in attention_inputs(dev, bh, sq, sk, hd, bkv, seed=200 + i))
        got = flash_attention(q, k, v, causal=causal)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"flash_attention on bfloat16 returned {got.dtype}")
        what = f"flash_attention bf16 BH={bh} Sq={sq} Sk={sk} hd={hd} causal={causal}"
        worst_bf16 = max(worst_bf16, within(what, got, attention_ref(q, k, v, causal=causal),
                                            ATT_RTOL + BF16_ULP))
    log(f"[kernels] flash_attention bf16 within atol={ATT_ATOL} rtol={ATT_RTOL}+2^-7 of "
        f"attention_ref in {len(ATT_BF16_CASES)} cases, max |diff| {worst_bf16:.3e}")
    worst_grad = 0.0
    for i, (bh, sq, sk, hd, bkv, causal) in enumerate(ATT_GRAD_CASES):
        inputs = attention_inputs(dev, bh, sq, sk, hd, bkv, seed=300 + i)
        w = torch.randn(bh, sq, hd, generator=torch.Generator(device=dev).manual_seed(i),
                        device=dev)
        grads = []
        for attend in (flash_attention, attention_ref):
            leaves = [t.clone().requires_grad_() for t in inputs]
            (attend(*leaves, causal=causal) * w).sum().backward()
            grads.append([t.grad for t in leaves])
        for name, got, want in zip("qkv", *grads):
            if got is None:
                raise AssertionError(f"flash_attention gave no gradient for {name}")
            what = f"flash_attention d{name} BH={bh} Sq={sq} Sk={sk} hd={hd} causal={causal}"
            worst_grad = max(worst_grad, within(what, got, want, ATT_RTOL))
    log(f"[kernels] flash_attention gradients within atol=rtol={ATT_ATOL} of attention_ref's "
        f"in {len(ATT_GRAD_CASES)} cases, max |diff| {worst_grad:.3e} (the backward recomputes "
        f"attention_ref, so this checks that the kernel's path carries a gradient)")
    return {"float32": worst, "bfloat16": worst_bf16}


def attention_work(bh, sq, sk, hd, bkv, causal) -> tuple[int, float]:
    """Bytes (q, k, v read once, o written once, float32) and float32
    operations (QK^T and PV over the pairs the mask keeps) of one call."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4 * hd * (2 * bh * sq + 2 * bkv * sk), 4.0 * bh * hd * pairs


def time_attention(dev, timer) -> dict:
    from repro_torch.kernels.attention import attention_ref, flash_attention
    bh, sq, sk, hd, bkv, causal = GRANITE_ATT
    q, k, v = attention_inputs(dev, bh, sq, sk, hd, bkv, seed=7)
    B, H, KV = 4, bh // 4, bkv // 4
    q4, k4, v4 = q.view(B, H, sq, hd), k.view(B, KV, sk, hd), v.view(B, KV, sk, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, flops = attention_work(*GRANITE_ATT)
    row = dict(ms=timer.ms(lambda: flash_attention(q, k, v, causal=causal)), smi=timer.smi,
               plain_ms=timer.ms(lambda: attention_ref(q, k, v, causal=causal)),
               library_ms=timer.ms(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)),
               nbytes=nbytes, flops=flops)
    row["bound_ms"] = bound_ms(nbytes, flops)
    row["bound_by"] = "operations" if flops / FP32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
    log(f"[kernels] flash_attention (main path, BH={bh} S={sq} hd={hd} kv_rows={bkv} causal): "
        f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
        f"(scaled_dot_product_attention) bound_ms={row['bound_ms']:.5f} bytes={nbytes} "
        f"flops={flops:.6e} share_of_bound={row['bound_ms'] / row['ms']:.3f} "
        f"achieved_TFLOP_per_s={flops / row['ms'] / 1e9:.3f} smi={row['smi']}")
    return row


# ------------------------------------------------------------------- serve
def perturbed_params(cfg, dev):
    """The port's init at ``cfg`` (seed 0) with every norm weight set to
    1 + 0.1 N(0, 1) (seed 1): the init's zero norms make every logit 0."""
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for tree, key in ((params["layers"], "ln1"), (params["layers"], "ln2"),
                      (params, "final_norm")):
        tree[key] = 1.0 + 0.1 * torch.randn(tree[key].shape, generator=g, device=dev)
    return params


def profile_device(label: str, fn) -> dict:
    """Device time of ``fn`` by kernel, from a ``torch.profiler`` window:
    the flash kernel, matrix products (cuBLAS/CUTLASS kernels) and the rest,
    against the window's host-clock time (ending in a synchronize). Kernels
    of one stream do not overlap, so their sum is the device's busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    groups = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("flash_attention" if "flash_fwd" in low else
               "matmul" if any(w in low for w in ("gemm", "gemv", "cutlass", "xmma", "cublas")) else
               "other")
        groups[key] += ms
    busy = sum(groups.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None, **{f"{k}_ms": v for k, v in groups.items()}}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = "not measured" if out["idle_share"] is None else f"{out['idle_share']:.4f}"
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{idle}; flash {groups['flash_attention']:.3f} ms, matmul {groups['matmul']:.3f} ms, "
        f"other {groups['other']:.3f} ms; top kernels "
        + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in top))
    return out


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def check_cohorts(cfg, params, label, res, prof: dict) -> list[dict]:
    """Each cohort's prefill through the kernel (rerun on the cohort's
    tokens) against a prefill through the plain attention, swapped in here
    and restored; the kernel rerun's greedy first tokens are the served
    ones. The first cohort's prefill and one decode step are also profiled
    into ``prof``."""
    from repro_torch.kernels.attention import flash_gqa_ref
    from repro_torch.models import decode, prefill, transformer
    first = {c.request_id: c.tokens[0] for c in res.completions}
    out, rid = [], 0
    for i, toks in enumerate(res.cohort_tokens):
        tokens = torch.from_numpy(toks).to(params["embed"].device)
        logits, cache = prefill(cfg, params, {"tokens": tokens})
        greedy = torch.argmax(logits[:, -1], -1).tolist()
        served = [first[rid + j] for j in range(len(toks))]
        if greedy != served:
            raise AssertionError(f"{label} cohort {i}: rerun first tokens {greedy} != served {served}")
        rid += len(toks)
        kernel_fn = transformer.flash_gqa
        transformer.flash_gqa = flash_gqa_ref
        try:
            want_logits, want_cache = prefill(cfg, params, {"tokens": tokens})
        finally:
            transformer.flash_gqa = kernel_fn
        real, want_real = logits[..., :cfg.vocab_size], want_logits[..., :cfg.vocab_size]
        errs = {"logits": rel_err(real, want_real),
                "k": rel_err(cache["k"], want_cache["k"]),
                "v": rel_err(cache["v"], want_cache["v"])}
        std = float(want_real.std())
        if not torch.equal(logits[..., cfg.vocab_size:], want_logits[..., cfg.vocab_size:]):
            raise AssertionError(f"{label} cohort {i}: padded vocabulary not masked alike")
        if std <= 0 or not want_cache["k"].any() or not want_cache["v"].any():
            raise AssertionError(f"{label} cohort {i}: degenerate prefill (logit std {std})")
        bad = {k: e for k, e in errs.items() if not e <= SERVE_REL}
        if bad:
            raise AssertionError(f"{label} cohort {i}: kernel vs plain prefill beyond "
                                 f"{SERVE_REL} relative: {bad}")
        if i == 0:
            prof[f"{label} prefill {tuple(toks.shape)}"] = profile_device(
                f"{label} prefill {tuple(toks.shape)}",
                lambda: prefill(cfg, params, {"tokens": tokens}))
            grown = {k: torch.cat([c, torch.zeros_like(c[:, :, :1])], 2) for k, c in cache.items()}
            step = torch.tensor(greedy, device=tokens.device)[:, None]
            prof[f"{label} decode step"] = profile_device(
                f"{label} decode step at position {toks.shape[1]}",
                lambda: decode(cfg, params, grown, step, toks.shape[1]))
            del grown
        log(f"[serve] {label} cohort {i} {tuple(toks.shape)}: kernel vs plain prefill "
            f"max rel err logits {errs['logits']:.3e} k {errs['k']:.3e} v {errs['v']:.3e} "
            f"(limit {SERVE_REL}); logit std {std:.4f} smi={gpu_state()}")
        out.append(dict(shape=list(toks.shape), logit_std=std, **errs))
        del logits, cache, want_logits, want_cache
    return out


def phase_serve(dev, cfg, wrappers) -> dict:
    """Serve the launcher's default request set and a long-prompt set through
    ``serve()``; the flash launches are counted over these two runs alone."""
    from repro_torch.launch.serve import make_requests, serve
    t0 = time.perf_counter()
    params = perturbed_params(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}); {n_params} float32 parameters "
        f"made in {time.perf_counter() - t0:.2f} s smi={gpu_state()}")
    sets = {
        "a_defaults": (make_requests(cfg, 8, 12, 8), 4),
        "b_long_prompts": (make_requests(cfg, 4, 1024, 8, min_len=900, seed=1), 4),
    }
    serve(cfg, params, make_requests(cfg, 1, 4, 2, seed=2), 1, dev)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    results = {label: serve(cfg, params, reqs, bs, dev) for label, (reqs, bs) in sets.items()}
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    out = {"launches": launches, "max_memory_allocated": peak, "sets": {}}
    for label, res in results.items():
        tokens = [t for c in res.completions for t in c.tokens]
        if len(set(tokens)) < 2:
            raise AssertionError(f"{label}: every served token is {tokens[:1]}")
        if res.delivered.to_pydict()["token"] != tokens:
            raise AssertionError(f"{label}: the response batch lost tokens")
        row = {"requests": len(res.completions), "tokens": res.num_tokens,
               "seconds": res.seconds, "tokens_per_s": res.num_tokens / res.seconds,
               "prefill_ms": [s * 1e3 for s in res.prefill_s],
               "decode_ms": [s * 1e3 for s in res.decode_s],
               "prompt_lens": [c.shape[1] for c in res.cohort_tokens]}
        log(f"[serve] {label}: {row['requests']} requests, {row['tokens']} tokens in "
            f"{row['seconds']:.4f} s ({row['tokens_per_s']:.3f} tok/s); cohorts padded to "
            f"{row['prompt_lens']}; prefill ms per cohort {[round(x, 3) for x in row['prefill_ms']]}; "
            f"decode ms per step median {statistics.median(row['decode_ms']):.3f} "
            f"(min {min(row['decode_ms']):.3f}, max {max(row['decode_ms']):.3f}, "
            f"{len(row['decode_ms'])} steps) smi={gpu_state()}")
        for c in res.completions[:4]:
            log(f"[serve] {label} req {c.request_id}: {c.tokens} smi={gpu_state()}")
        out["sets"][label] = row
    log(f"[serve] launches in the serve phase: {launches}; "
        f"torch.cuda.max_memory_allocated {peak} B smi={gpu_state()}")
    out["profile"] = {}
    for label, res in results.items():
        out["sets"][label]["cohorts"] = check_cohorts(cfg, params, label, res, out["profile"])
    del params, results
    torch.cuda.empty_cache()
    return out


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def import_port(tree: Path, name: str):
    """The port's package in checkout ``tree``, imported under ``name``, so
    that the ports of two checkouts load into one process."""
    src = tree / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(name, src / "__init__.py",
                                                  submodule_search_locations=[str(src)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def one_column(other: Path | None) -> int:
    """``--one-column [DIR]``: time the one-column take route of this
    checkout's port, or, with DIR, of DIR's port and this one's in turns in
    one process (DIR, this, this, DIR), and print the rows as the last line."""
    import repro_torch.kernels.take as this_take
    smi = phase_setup(("take",))["smi"]
    ports = {"this": this_take}
    if other is not None:
        import_port(other, "other_port")
        importlib.import_module("other_port.kernels._build").build_all(("take",))
        ports["other"] = importlib.import_module("other_port.kernels.take")
    order = ["other", "this", "this", "other"] if other is not None else ["this"]
    timer = Timer(torch.device("cuda"))
    rows = []
    for label in order:
        row = time_one_column(torch.device("cuda"), timer, ports[label])
        row.update(port=label, tree=str(Path(ports[label].__file__).resolve().parents[4]),
                   bound_ms=bound_ms(row["nbytes"]))
        log(f"[one-column] {label} ({row['tree']}) take_column {SEL_ROWS} of {BATCH_ROWS} rows "
            f"x 1 float64: ms={row['ms']:.5f} host_ms={row['host_ms']:.5f} "
            f"floor_ms={row['floor_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
            f"library_ms={row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} smi={row['smi']}")
        rows.append(row)
    out = {"one_column": rows}
    if other is not None:
        # Host time of the two routes call by call in turns, twice (the
        # host's pace moves within a process), on time_one_column's data.
        rng = np.random.default_rng(1)
        col = torch.from_numpy(rng.standard_normal(BATCH_ROWS)).cuda()
        idx = torch.from_numpy(np.sort(rng.choice(BATCH_ROWS, SEL_ROWS, replace=False))
                               .astype(np.int32)).cuda()
        calls = {label: (lambda take=ports[label].take_column: take(col, idx)) for label in ports}
        out["host_ms_in_turns"] = []
        for pair in (("other", "this"), ("this", "other")):
            ms = dict(zip(pair, host_ms(*(calls[label] for label in pair))))
            out["host_ms_in_turns"].append(ms)
            log(f"[one-column] host ms per take_column call, the two ports in turns call by "
                f"call ({HOST_CALLS} calls each): this {ms['this']:.5f}, other {ms['other']:.5f}")
    print(smi)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--one-column", nargs="?", const=True, type=Path, metavar="DIR",
                    help="only time the one-column take route of this checkout's port and, "
                         "in turns in one process, of the port in checkout DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    other = args.one_column.resolve() if isinstance(args.one_column, Path) else None
    for tree in (ROOT, other):
        if tree is not None and not (tree / "src" / "repro_torch").is_dir():
            print(f"chip_smoke: {tree} holds no src/repro_torch; run from a checkout",
                  file=sys.stderr)
            return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.one_column:
        return one_column(other)
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import attention as attention_mod
    from repro_torch.kernels.pack import pack as pack_mod
    from repro_torch.kernels.take import take as take_mod
    wrappers = {"pack_tiles": pack_mod.pack_tiles, "unpack_tiles": pack_mod.unpack_tiles,
                "take_rows": take_mod.take_rows, "bitmap_expand": take_mod.bitmap_expand,
                "flash_attention": attention_mod.flash_attention}
    torch.backends.cuda.matmul.allow_tf32 = False  # the model's products in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    setup = phase_setup()

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = {k: {"n": 0, "max_abs_err": 0.0} for k in BIT_EXACT}
    check_pack(rng, dev, cases)
    check_take(rng, dev, cases)
    torch.cuda.synchronize()
    log(f"[kernels] every datapath kernel equals its plain version bit for bit "
        f"({sum(c['n'] for c in cases.values())} cases) in {time.perf_counter() - t0:.2f} s")
    held = torch.cuda.memory_allocated()
    att_err = check_attention(dev)
    torch.cuda.synchronize()
    # The gradient cases' backward runs on autograd's device thread, whose
    # cuBLAS handle keeps a workspace of its own; free it so that the serve
    # phase's peak holds only what serving holds.
    after = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    log(f"[kernels] memory_allocated before the attention checks {held} B, after {after} B, "
        f"after clearing the cuBLAS workspaces {torch.cuda.memory_allocated()} B")
    timer = Timer(dev)
    main_times = time_kernels(rng, dev, timer)
    main_times["flash_attention"] = time_attention(dev, timer)
    del timer

    for w in wrappers.values():
        w.launches = 0
    slice_out = phase_slice(dev, ROWS)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[slice] launches in the slice phase: {launches}")
    missing = [k for k in BIT_EXACT if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on slice 1's path: {missing}")
    torch.cuda.empty_cache()

    cfg = get_config(ARCH)
    serve_out = phase_serve(dev, cfg, wrappers)
    expected = sum(len(c["cohorts"]) for c in serve_out["sets"].values()) * cfg.num_layers
    launches["flash_attention"] = serve_out["launches"]["flash_attention"]
    if launches["flash_attention"] != expected:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"on the served path, expected {expected}")

    report = []
    for name, (source, replaces) in KERNELS.items():
        t = main_times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name]}
        if name in BIT_EXACT:
            row.update(bit_equal=True, max_abs_err=cases[name]["max_abs_err"], bound_by="bytes")
            row.update({k: t[k] for k in ("host_ms", "floor_ms", "yardstick_ms", "yardstick")
                        if k in t})
        else:
            row.update(max_abs_err=att_err["float32"], bf16_max_abs_err=att_err["bfloat16"],
                       grad_wired=True, grad_backward="attention_ref recompute",
                       tolerance={"atol": ATT_ATOL, "rtol": ATT_RTOL,
                                  "bf16_rtol": ATT_RTOL + BF16_ULP},
                       bound_by=t["bound_by"])
        row.update(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                   library_ms=t["library_ms"])
        if name == "take_rows":
            one = t["one_column"]
            row.update(shape=f"{SEL_ROWS} of {BATCH_ROWS} rows x {N_COLS} float64 columns, "
                             f"one launch",
                       launches_per_scan={k: slice_out[k]["take_rows_launches_per_scan"]
                                          for k in ("device_select_take_columns",
                                                    "device_select_take_column")},
                       one_column={k: one[k] for k in ("ms", "host_ms", "floor_ms", "plain_ms",
                                                       "library_ms", "bound_ms")})
        report.append(row)
    log(f"[report] build_s={setup['build_s']:.3f} total_s={time.perf_counter() - t_start:.2f} "
        f"phases={json.dumps({'slice': slice_out, 'serve': serve_out})}")
    print(json.dumps({"kernels": report}))
    print(setup["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
