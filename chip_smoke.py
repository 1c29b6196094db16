#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Thallus (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --one-column [DIR]   # see below
    python3 chip_smoke.py --decode-host DIR    # see below

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
   host time of a call; flash attention also at phase 7's long prefills
   (olmoe's head dim 128, gemma's 256), at zamba2's (phase 8: 32 query
   heads over 32 K/V heads of 64) and at whisper's (phase 9, non-causal:
   the encoder's 1500 x 1500, the cross-attention's 224 x 1500);
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
5. train: granite-3-2b at full width and depth again. One loss and gradient
   of a 4 x 1024 batch (``remat="full"``) through the kernel is held to the
   same through the plain attention, before any optimizer state exists.
   Then the launcher's pipeline (2 replicated ``ThallusServer``s,
   ``ThallusLoader(transport="thallus")``, the batch to the card,
   ``make_train_step``, AdamW at a constant 1e-3) at its default shape, 8 x
   128 with remat none, and at 4 x 1024 with remat full: one warm-up step,
   three timed steps (host seconds, tokens/s, loss, gradient norm, loader
   transport seconds, peak memory, an ``nvidia-smi`` sample and the card's
   name and power limit on each line; the flash launches counted over these
   alone; the loss must be finite and fall) and one step under
   ``torch.profiler`` (device time by kernel class and the idle share).
   Last, ``python -m repro_torch.launch.train --reduced`` is run, killed
   after its step-4 checkpoint and resumed: the resumed losses must equal
   an uninterrupted run's within 1e-6 relative. No full-width checkpoint is
   written;
6. the qos gateway: (e) two serving ``Batcher``s fetch granite's prompts
   through one ``ScanGateway`` scan and serve them; (f) training from
   ``ThallusLoader(transport="gateway")`` with int8 error-feedback
   gradient compression;
7. the other families: olmoe-1b-7b (MoE, 64 experts top-8, head dim 128)
   and gemma-2b (MQA, head dim 256, GeGLU, 256000-word vocabulary) at full
   width and depth, float32, serve phase 4's two request sets one model at
   a time, each cohort's prefill held to the plain attention's as in phase
   4. For olmoe the plain prefill routes as the kernel prefill did, layer
   by layer (its experts and capacity's keep mask forced): its own top-k
   may differ from the forced one only at a near-tie of the k-th and
   (k+1)-th probabilities, and every token is held to the limit; an
   unforced plain prefill's count of tokens routed otherwise is printed,
   with no limit. One MoE layer at the long cohort's 4096 tokens is also
   held to the same layer on the CPU. Each cohort's dropped
   (token, expert) pairs and a profile of one prefill and one decode step
   (products, flash, MoE dispatch, other, idle share) are printed;
8. the SSM families: mamba2-780m (48 Mamba2 layers, no attention) and
   zamba2-1.2b (38 Mamba2 layers and 6 calls of one shared attention block,
   whose prefill attention is the flash kernel) at full width and depth,
   float32, serve phase 4's two request sets and a third of 4 prompts of
   exactly 1024 tokens, where the SSD scan runs at its chunk of 256 (an odd
   cohort length runs it at Q = 1: the JAX package's chunk rule). Checks:
   the served tokens are not all one; every decode step's logits (and the
   prefill's last) agree with a teacher-forced ``forward`` over prompt and
   served tokens, whose argmax is the served token (or ties it); the SSD
   at chunk 256 agrees with chunk 1 on the 1024-token cohort's first layer
   input (both timed); one Mamba2 block on the card agrees with the CPU on
   the 4 x 1003-token cohort's first layer input; zamba2's prefill through
   the kernel agrees with the plain attention's; flash launches 6 times a
   zamba2 cohort, never for mamba2 nor in a plain rerun. A profile of one
   prefill per set and one decode step splits products, flash, the SSD
   scan (``ssd_chunked``'s profiler range) and the rest;
9. the audio family: whisper-small (12 encoder layers over 1500 frames, 12
   decoder layers, d_model 768, 12 heads padded to 16 of 64, 2.93e8
   float32 parameters) at full width and depth, seeded weights with layer
   norms ``w = 1 + 0.1 N(0, 1)``, ``b = 0.1 N(0, 1)``, serves two sets
   by the port's ``Batcher`` over the model API (``prefill`` on N(0, 1)
   frames, greedy ``decode`` against the self and cross caches), batch 4:
   (w-a) 8 clips with the
   4-token start-of-transcript prompt and 32 new tokens, (w-b) 4 clips with
   224-token previous-text prompts and 8. Each cohort's prefill launches
   flash 36 times (the encoder non-causal over 1500 x 1500, the decoder's
   causal self-attention, its non-causal cross-attention with Sq != Sk),
   a decode step never; each is held to a prefill through the plain
   attention, every served position's logits to a teacher-forced
   ``forward``, each set's first cohort decoded on random text (each step
   fed another token id) to the forward, and one 2 x 448-token loss and
   gradient (remat full)
   through the kernel to the plain attention's. ``[serve]`` lines give
   tok/s, prefill ms with the encoder's share, decode ms, the peak memory,
   and a profile of one prefill per set and one decode step;
10. the mesh: a one-rank NCCL process group (an in-process ``HashStore``)
   and its ``make_host_mesh()``, (1, 1); granite-3-2b at full width and
   depth as phase 4 seeds it, its parameters DTensors by ``param_specs``,
   serves phase 4's two request sets through ``launch.serve.serve(...,
   mesh=)``: the served tokens must be phase 4's, flash launch once per
   layer per cohort (through ``local_map``), and each cohort's prefill
   logits and cache lie within the serve limit of the same prefill on
   plain tensors. A decode step's host ms and kernel launches on DTensors
   and on plain tensors (the host cost of DTensor dispatch); the (c) 8 x
   128 loss and gradients on DTensors against plain tensors at phase 5's
   limits, then one AdamW step on a DTensor train state;
   ``compressed_psum_pod`` over a one-pod mesh bit for bit against
   ``compress_decompress``;
11. cost: granite-3-2b at full width and depth as phase 4 seeds it, set
   (b)'s cohort prefill (4 x its 1003 tokens) and one (c) train step (8 x
   128, remat none, AdamW) counted by the port's cost counter
   (``repro_torch.utils.cost``) on the card, the flash kernel on, and on
   the meta device: FLOPs, transcendentals and both byte accountings must
   be equal. ``[roofline]`` lines give the counts, the roofline at the
   H100's float32 peak (``repro_torch.utils.roofline``), ``model_flops``
   (2·N·D, 6·N·D) and, beside phase 4's prefill ms and phase 5's median
   step, bound / measured and the share of the float32 peak;
12. report: a ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.

Any mismatch raises: the script then exits non-zero and prints no result
line. It also fails without a CUDA card, and outside a checkout.

``--one-column [DIR]`` only times the one-column take route
(``take_column`` at the main path's shape: device ms, and host ms per call
without a synchronize) of this checkout's port and, with DIR, of the port
in checkout DIR (a parent commit unpacked under ``build/``, say), the two
in turns in one process, and prints the rows as its last line.

``--decode-host DIR`` only times phase 2's plain decode step (granite-3-2b
at full width and depth, 4 rows at position 4, plain tensors, no process
group) through the port in checkout DIR and through this one, in turns in
one process on the same weights and cache, and prints the rows as its last
line: the host cost of the models' sharding hooks where no mesh is in use.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# Training: one loss through the kernel against one through the plain
# attention, within TRAIN_LOSS_REL relative (the forward's ~1e-6 differences
# summed over 4096 tokens), and every gradient leaf within SERVE_REL of the
# plain leaf's largest value. The shapes: the launcher's default (8 x 128,
# remat none) and slice 2's long prompt (4 x 1024, remat full); AdamW at a
# constant 1e-3 (no warm-up, so that every timed step moves the weights).
TRAIN_LOSS_REL = 1e-4
TRAIN_OPT = dict(learning_rate=1e-3, warmup_steps=0, decay_steps=100)
TRAIN_SHAPES = {"c_default": (8, 128, "none"), "d_long": (4, 1024, "full")}
TRAIN_STEPS = 3
RESUME_ARGS = ["--arch", ARCH, "--reduced", "--steps", "8", "--ckpt-every", "4",
               "--log-every", "1", "--lr", "1e-2"]
# Phase 6 (the qos gateway): the prompt table two serving replicas fetch
# through one gateway scan (sequences x tokens), their cohort size and the
# tokens each request decodes.
GATEWAY_PROMPTS = (8, 128)
GATEWAY_BATCH = 4
GATEWAY_NEW_TOKENS = 8


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
# whisper-small's non-causal shapes (batch 4 x 16 heads of 64, as many K/V
# rows, 1500 frames = 23 key tiles of 64 and a ragged one of 28): the
# encoder's self-attention, the cross-attention from set (w-b)'s 224-token
# prompts and from set (w-a)'s 4-token ones.
WHISPER_ATT_CASES = [(64, 1500, 1500, 64, 64, False), (64, 224, 1500, 64, 64, False),
                     (64, 4, 1500, 64, 64, False)]
# (BH, Sq, Sk, hd, KV rows, causal): the JAX kernel tests' shapes, causal
# with Sq != Sk both ways, ragged lengths, shared K/V rows, granite's
# prefill (B 4 x H 32 query rows, B 4 x KV 8 K/V rows, S 1024, hd 64),
# zamba2's and whisper's.
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
             + [(128, 1024, 1024, 64, 32, True), (128, 1024, 1024, 64, 128, True)]
             + WHISPER_ATT_CASES)
# bfloat16 through the kernel (widened to float32, narrowed back) and the
# gradients through its autograd function: (BH, Sq, Sk, hd, KV rows, causal).
ATT_BF16_CASES = [(8, 65, 65, 64, 2, True), (2, 129, 63, 128, 1, False), (128, 1024, 1024, 64, 32, True)]
ATT_GRAD_CASES = [(8, 130, 97, 64, 2, True), (4, 65, 65, 16, 2, False),
                  (16, 224, 1500, 64, 16, False)]   # whisper's cross-attention
GRANITE_ATT = (128, 1024, 1024, 64, 32, True)
GRANITE_TRAIN_ATT = (256, 128, 128, 64, 64, True)  # 8 x 32 query rows, 8 x 8 K/V rows
# Phase 7's long prefills (batch 4, S 1024): olmoe-1b-7b, 16 heads of 128 over
# 16 K/V heads; gemma-2b, 8 heads padded to 16, of 256, over one K/V head;
# phase 8's: zamba2-1.2b's shared block, 32 heads of 64 over 32 K/V heads;
# phase 9's (batch 4, whisper-small's 12 heads padded to 16, of 64, over 16
# K/V heads): the encoder's self-attention over its 1500 frames and the
# decoder's cross-attention from set (w-b)'s 224-token prompts, non-causal.
FAMILY_ATT = {"olmoe-1b-7b": (64, 1024, 1024, 128, 64, True),
              "gemma-2b": (64, 1024, 1024, 256, 4, True),
              "zamba2-1.2b": (128, 1024, 1024, 64, 128, True),
              "whisper-small encoder": (64, 1500, 1500, 64, 64, False),
              "whisper-small cross": (64, 224, 1500, 64, 64, False)}


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
    diffs = []
    for i, (bh, sq, sk, hd, bkv, causal) in enumerate(ATT_CASES):
        q, k, v = attention_inputs(dev, bh, sq, sk, hd, bkv, seed=100 + i)
        what = f"flash_attention BH={bh} Sq={sq} Sk={sk} hd={hd} kv_rows={bkv} causal={causal}"
        diffs.append(within(what, flash_attention(q, k, v, causal=causal),
                            attention_ref(q, k, v, causal=causal), ATT_RTOL))
    worst = max(diffs)
    whisper = {str(case): d for case, d in zip(ATT_CASES, diffs) if case in WHISPER_ATT_CASES}
    log(f"[kernels] flash_attention within atol=rtol={ATT_ATOL} of attention_ref in "
        f"{len(ATT_CASES)} cases, max |diff| {worst:.3e}; at whisper's shapes "
        + ", ".join(f"{case} {d:.3e}" for case, d in whisper.items()))
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
    return {"float32": worst, "bfloat16": worst_bf16, "gradients": worst_grad,
            "float32_whisper": whisper}


def attention_work(bh, sq, sk, hd, bkv, causal) -> tuple[int, float]:
    """Bytes (q, k, v read once, o written once, float32) and float32
    operations (QK^T and PV over the pairs the mask keeps) of one call."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4 * hd * (2 * bh * sq + 2 * bkv * sk), 4.0 * bh * hd * pairs


def time_attention_at(dev, timer, shape, batch, label) -> dict:
    """The kernel, its plain version and SDPA at ``shape`` (BH, Sq, Sk, hd,
    K/V rows, causal), ``batch`` sequences of BH / batch heads."""
    from repro_torch.kernels.attention import attention_ref, flash_attention
    bh, sq, sk, hd, bkv, causal = shape
    q, k, v = attention_inputs(dev, bh, sq, sk, hd, bkv, seed=7)
    B, H, KV = batch, bh // batch, bkv // batch
    q4, k4, v4 = q.view(B, H, sq, hd), k.view(B, KV, sk, hd), v.view(B, KV, sk, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, flops = attention_work(*shape)
    row = dict(ms=timer.ms(lambda: flash_attention(q, k, v, causal=causal)), smi=timer.smi,
               plain_ms=timer.ms(lambda: attention_ref(q, k, v, causal=causal)),
               library_ms=timer.ms(lambda: sdpa(q4, k4, v4, is_causal=causal, enable_gqa=True)),
               nbytes=nbytes, flops=flops, shape=list(shape))
    row["bound_ms"] = bound_ms(nbytes, flops)
    row["bound_by"] = "operations" if flops / FP32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
    log(f"[kernels] flash_attention ({label}, BH={bh} Sq={sq} Sk={sk} hd={hd} kv_rows={bkv} "
        f"causal={causal}): "
        f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} library_ms={row['library_ms']:.5f} "
        f"(scaled_dot_product_attention) bound_ms={row['bound_ms']:.5f} bytes={nbytes} "
        f"flops={flops:.6e} share_of_bound={row['bound_ms'] / row['ms']:.3f} "
        f"achieved_TFLOP_per_s={flops / row['ms'] / 1e9:.3f} smi={row['smi']}")
    return row


def time_attention(dev, timer) -> dict:
    """The kernel at granite's long prefill (the serve path's and the 4 x
    1024 train shape's), under ``train_default`` at the launcher's default
    train shape (8 x 128), and under ``families`` at phase 7's long
    prefills (head dims 128 and 256), phase 8's (zamba2, MHA) and phase 9's
    (whisper's encoder and cross-attention, non-causal)."""
    row = time_attention_at(dev, timer, GRANITE_ATT, 4, "main path")
    row["train_default"] = time_attention_at(dev, timer, GRANITE_TRAIN_ATT, 8, "train 8 x 128")
    row["families"] = {arch: time_attention_at(dev, timer, shape, 4, f"{arch} prefill")
                       for arch, shape in FAMILY_ATT.items()}
    return row


# ------------------------------------------------------------------- serve
def norm_nodes(params) -> list:
    """Every norm weight of a family's tree, as (node, key): a transformer's
    ``ln1``, ``ln2``, ``final_norm``, then ``q_norm`` and ``k_norm`` where
    the config has them; an SSM's ``ln`` and gated ``norm`` per layer; the
    hybrid's also its shared block's ``ln1`` and ``ln2``."""
    if "mamba_layers" in params:
        layers, shared = params["mamba_layers"], params["shared"]
        return [(layers, "ln"), (layers, "norm"), (shared, "ln1"), (shared, "ln2"),
                (params, "final_norm")]
    layers = params["layers"]
    if "attn" not in layers:
        return [(layers, "ln"), (layers, "norm"), (params, "final_norm")]
    attn = layers["attn"]
    return [(tree, key) for tree, key in ((layers, "ln1"), (layers, "ln2"), (params, "final_norm"),
                                          (attn, "q_norm"), (attn, "k_norm")) if key in tree]


def perturbed_params(cfg, dev):
    """The port's init at ``cfg`` (seed 0) with every norm weight set to
    1 + 0.1 N(0, 1) (seed 1), in :func:`norm_nodes`' order: the init's zero
    norms make every logit 0. An encoder-decoder's layer norms (which start
    at w = 1, b = 0) get w = 1 + 0.1 N(0, 1) and b = 0.1 N(0, 1), so that a
    swapped or dropped bias shows."""
    from repro_torch.models import encdec, init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    if "encoder" in params:
        for node in encdec.layer_norm_nodes(params):
            node["w"] = 1.0 + 0.1 * torch.randn(node["w"].shape, generator=g, device=dev)
            node["b"] = 0.1 * torch.randn(node["b"].shape, generator=g, device=dev)
        return params
    for tree, key in norm_nodes(params):
        tree[key] = 1.0 + 0.1 * torch.randn(tree[key].shape, generator=g, device=dev)
    return params


KERNEL_CLASSES = ("flash_attention", "matmul", "dispatch", "ssd", "attention_backward",
                  "optimizer", "compression", "other")
# The port's profiler ranges (user annotations, not kernels).
RANGES = ("adamw_update", "compress_decompress", "ssd_chunked", "flash_attention")
# The ops of the MoE dispatch and combine (models/moe.py): the sorts, the
# expert counts and their prefix sum, the gathers, the scatter into the
# expert buffer and the scatter-add back to the tokens.
DISPATCH_OPS = ("aten::sort", "aten::argsort", "aten::bincount", "aten::cumsum", "aten::index",
                "aten::index_put", "aten::index_put_", "aten::_index_put_impl_",
                "aten::index_add", "aten::index_add_")


def _phase_of(event) -> str | None:
    """The phase that launched a profiled op: the SSD scan (any op under
    ``ssd_chunked``'s profiler range, its cumsum too); else the nearest of
    the flash kernel's backward (autograd's node of the plain recompute),
    the optimizer (``adamw_update``'s profiler range), the gradient
    compression (``compress_decompress``'s) and the MoE dispatch (an op of
    ``DISPATCH_OPS``); None elsewhere."""
    chain = []
    while event is not None:
        chain.append(event)
        event = event.cpu_parent
    if any(e.name == "ssd_chunked" for e in chain):
        return "ssd"
    for event in chain:
        if event.name in DISPATCH_OPS:
            return "dispatch"
        if "_FlashAttentionBackward" in event.name:
            return "attention_backward"
        if event.name == "adamw_update":
            return "optimizer"
        if event.name == "compress_decompress":
            return "compression"
    return None


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def profile_device(label: str, fn) -> dict:
    """Device time of ``fn`` by kernel class, from a ``torch.profiler``
    window: the flash kernel's forward, matrix products (cuBLAS/CUTLASS
    kernels), the MoE dispatch (every kernel of an op in ``DISPATCH_OPS``),
    the attention backward (every kernel of the flash kernel's
    plain-recompute backward), the optimizer (every kernel under
    ``adamw_update``), the gradient compression (every kernel under
    ``compress_decompress``), the SSD scan (every kernel under
    ``ssd_chunked``) and the rest, against the window's host-clock time
    (ending in a synchronize). Kernels of one stream do not overlap, so
    their sum is the device's busy time. A kernel is put in a phase by the
    op that launched it; one no op launched, by its name alone, and then
    only its time is counted, not its launch."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    by_name: dict[str, float] = {}
    groups = dict.fromkeys(KERNEL_CLASSES, 0.0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation \
                and e.name not in RANGES:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    unplaced = dict(by_name)
    launches = dict.fromkeys(KERNEL_CLASSES, 0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            phase = _phase_of(e)
            for k in e.kernels:
                kind = phase or _kernel_class(k.name)
                groups[kind] += k.duration / 1e3
                launches[kind] += 1
                unplaced[k.name] = unplaced.get(k.name, 0.0) - k.duration / 1e3
    for name, ms in unplaced.items():
        if ms > 1e-6:
            groups[_kernel_class(name)] += ms
    busy = sum(by_name.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           **{f"{k}_ms": v for k, v in groups.items()},
           **{f"{k}_launches": n for k, n in launches.items()}}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = "not measured" if out["idle_share"] is None else f"{out['idle_share']:.4f}"
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{idle}; " + ", ".join(f"{k} {v:.3f} ms ({launches[k]} launches)"
                                for k, v in groups.items())
        + "; top kernels " + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in top))
    return out


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


# The kernel prefill's MoE routing is forced on the plain prefill, layer by
# layer (:class:`ForcedRoutes`), so that both runs mix the same experts and
# their logits and caches differ by the attention's rounding alone. In the
# forced run each layer's own top-k, from its own router probabilities, may
# differ from the forced one only where its k-th and (k+1)-th probabilities
# lie within ROUTE_GAP of each other, relative to the k-th (in either run):
# the kernel and the plain attention differ by ~1e-6, which moves a
# probability by a few 1e-6 and can swap two experts that tie to within it.
ROUTE_GAP = 1e-5
# One MoE layer on the card against the same layer on the CPU from the same
# input: the CPU tests' LAYER_TOL, |card - cpu| <= tol + tol |cpu|.
MOE_LAYER_TOL = 3e-5


def _gaps(xt, router, k: int):
    """Each token's gap between its k-th and (k+1)-th router probabilities,
    relative to the k-th."""
    probs = torch.softmax(torch.einsum("td,de->te", xt.float(), router.float()), -1)
    top = torch.sort(probs, -1, descending=True).values
    return probs, (top[:, k - 1] - top[:, k]) / top[:, k - 1]


class RouteRecorder:
    """While active, records every routing of the port's MoE layers (the
    ``moe.route`` that ``_dispatch_one_group`` calls) and, for each, every
    token's gap between its k-th and (k+1)-th router probabilities."""

    def __enter__(self):
        from repro_torch.models import moe
        self.routes, self.gaps = [], []
        self._moe, self._route = moe, moe.route
        moe.route = self.route
        return self

    def route(self, xt, router, m, C):
        r = self._route(xt, router, m, C)
        self.routes.append(r)
        self.gaps.append(_gaps(xt, router, m.top_k)[1])
        return r

    def __exit__(self, *exc):
        self._moe.route = self._route

    def dropped(self) -> int:
        return sum(int((~r.keep).sum()) for r in self.routes)


class ForcedRoutes(RouteRecorder):
    """While active, every MoE layer routes as the recorded run ``forced``
    did, call for call: its experts, their order and capacity's keep mask;
    the gate weights are this run's own router probabilities at those
    experts, renormalised. Records this run's own routing (what it would
    have chosen) and gaps, as :class:`RouteRecorder` does."""

    def __init__(self, forced: RouteRecorder):
        self.forced = forced

    def route(self, xt, router, m, C):
        own = super().route(xt, router, m, C)
        r = self.forced.routes[len(self.routes) - 1]
        if r.gate_ids.shape != own.gate_ids.shape:
            raise AssertionError(f"forced routing {len(self.routes) - 1} is for "
                                 f"{tuple(r.gate_ids.shape)}, the layer routes "
                                 f"{tuple(own.gate_ids.shape)}")
        probs = _gaps(xt, router, m.top_k)[0]
        gate_w = probs.gather(-1, r.gate_ids)
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        return dataclasses.replace(r, gate_w=gate_w, w_sorted=gate_w.reshape(-1)[r.sort_idx])


def token_routing(r):
    """One routing's experts per token and whether each pair was kept, each
    (T, K), the experts in ascending order: the order of a token's top k
    does not change which pairs capacity keeps, nor the output."""
    keep = torch.empty_like(r.keep)
    keep[r.sort_idx] = r.keep
    ids, order = torch.sort(r.gate_ids, -1)
    return ids, keep.view(r.gate_ids.shape).gather(-1, order)


def check_forced_routing(kernel: RouteRecorder, forced: ForcedRoutes, where: str) -> dict:
    """The forced plain run's own top-k against the kernel's, layer by
    layer: every token whose own experts differ sits at a near-tie (gap
    under ROUTE_GAP in either run), in every layer, or this raises. Returns
    the count of such (token, layer) flips."""
    flips = 0
    for layer, (rk, rp, gk, gp) in enumerate(zip(kernel.routes, forced.routes,
                                                 kernel.gaps, forced.gaps)):
        gate = (token_routing(rk)[0] != token_routing(rp)[0]).any(-1)
        far = gate & ~(torch.minimum(gk, gp) < ROUTE_GAP)
        if far.any():
            t = int(torch.nonzero(far)[0])
            raise AssertionError(
                f"{where}: layer {layer} token {t} chose {token_routing(rp)[0][t].tolist()} in the "
                f"forced plain run, {token_routing(rk)[0][t].tolist()} through the kernel, at a "
                f"gap of {float(torch.minimum(gk, gp)[t]):.3e} (limit {ROUTE_GAP})")
        flips += int(gate.sum())
    if len(kernel.routes) != len(forced.routes):
        raise AssertionError(f"{where}: {len(kernel.routes)} routings through the kernel, "
                             f"{len(forced.routes)} in the forced plain run")
    return {"flips_at_near_ties": flips}


def routed_otherwise(a: RouteRecorder, b: RouteRecorder) -> int:
    """Tokens whose experts or kept pairs differ between two runs in some
    layer."""
    differ = None
    for ra, rb in zip(a.routes, b.routes):
        (ia, ka), (ib, kb) = token_routing(ra), token_routing(rb)
        d = (ia != ib).any(-1) | (ka != kb).any(-1)
        differ = d if differ is None else differ | d
    return int(differ.sum())


def check_cohorts(cfg, params, label, res, prof: dict) -> list[dict]:
    """Each cohort's prefill through the kernel (rerun on the cohort's
    tokens) against a prefill through the plain attention, swapped in here
    and restored, over every token's logits and every cache leaf (an SSM's
    state and conv taps too); the kernel rerun's greedy first tokens are the
    served ones, it launches the kernel once per K/V row of its cache (per
    layer, or per shared-block call), and the plain reruns never. An SSM
    without attention has no plain rerun. For an MoE config the plain rerun
    routes as the kernel rerun did (:class:`ForcedRoutes`), its own choices
    differing only at near-ties (:func:`check_forced_routing`); an unforced
    plain rerun's count of tokens routed otherwise is printed, with no
    limit, and the kernel rerun's dropped (token, expert) pairs are counted.
    The first cohort's prefill and one decode step are also profiled into
    ``prof``."""
    from repro_torch.kernels.attention import flash_attention, flash_gqa_ref
    from repro_torch.models import decode, prefill, transformer
    first = {c.request_id: c.tokens[0] for c in res.completions}
    out, rid = [], 0
    for i, toks in enumerate(res.cohort_tokens):
        tokens = torch.from_numpy(toks).to(params["embed"].device)
        before = flash_attention.launches
        with RouteRecorder() as kernel_routes:
            logits, cache = prefill(cfg, params, {"tokens": tokens})
        launches = {"kernel_rerun": flash_attention.launches - before}
        kv_rows = cache["k"].shape[0] if "k" in cache else 0
        if launches["kernel_rerun"] != kv_rows:
            raise AssertionError(f"{label} cohort {i}: the kernel rerun launched flash "
                                 f"{launches['kernel_rerun']} times, expected {kv_rows}")
        greedy = torch.argmax(logits[:, -1], -1).tolist()
        served = [first[rid + j] for j in range(len(toks))]
        if greedy != served:
            raise AssertionError(f"{label} cohort {i}: rerun first tokens {greedy} != served {served}")
        rid += len(toks)
        routing = {}
        if kv_rows == 0:   # no attention: nothing to swap
            want_logits, want_cache = logits, cache
        else:
            kernel_fn = transformer.flash_gqa
            transformer.flash_gqa = flash_gqa_ref
            before = flash_attention.launches
            try:
                if cfg.moe is None:
                    want_logits, want_cache = prefill(cfg, params, {"tokens": tokens})
                else:
                    with ForcedRoutes(kernel_routes) as forced:
                        want_logits, want_cache = prefill(cfg, params, {"tokens": tokens})
                    with RouteRecorder() as unforced:
                        prefill(cfg, params, {"tokens": tokens})
            finally:
                transformer.flash_gqa = kernel_fn
            launches["plain_rerun"] = flash_attention.launches - before
            if launches["plain_rerun"]:
                raise AssertionError(f"{label} cohort {i}: the plain rerun launched the flash "
                                     f"kernel {launches['plain_rerun']} times")
            if cfg.moe is not None:
                routing = check_forced_routing(kernel_routes, forced, f"{label} cohort {i}")
                routing["unforced_tokens_routed_otherwise"] = routed_otherwise(kernel_routes,
                                                                               unforced)
                routing["dropped_pairs"] = kernel_routes.dropped()
                routing["pairs"] = toks.size * cfg.moe.top_k * cfg.num_layers
                del forced, unforced
        del kernel_routes
        real, want_real = logits[..., :cfg.vocab_size], want_logits[..., :cfg.vocab_size]
        errs = {"logits": rel_err(real, want_real),
                **{name: rel_err(cache[name], want_cache[name]) for name in cache}} if kv_rows else {}
        std = float(want_real.std())
        if not torch.equal(logits[..., cfg.vocab_size:], want_logits[..., cfg.vocab_size:]):
            raise AssertionError(f"{label} cohort {i}: padded vocabulary not masked alike")
        if std <= 0 or not all(c.any() for c in want_cache.values()):
            raise AssertionError(f"{label} cohort {i}: degenerate prefill (logit std {std})")
        bad = {k: e for k, e in errs.items() if not e <= SERVE_REL}
        if bad:
            raise AssertionError(f"{label} cohort {i}: kernel vs plain prefill beyond "
                                 f"{SERVE_REL} relative: {bad}")
        if i == 0:
            prof[f"{label} prefill {tuple(toks.shape)}"] = profile_device(
                f"{cfg.name} {label} prefill {tuple(toks.shape)}",
                lambda: prefill(cfg, params, {"tokens": tokens}))
            grown = {k: torch.cat([c, torch.zeros_like(c[:, :, :1])], 2) if k in ("k", "v")
                     else c for k, c in cache.items()}
            step = torch.tensor(greedy, device=tokens.device)[:, None]
            prof[f"{label} decode step"] = profile_device(
                f"{cfg.name} {label} decode step at position {toks.shape[1]}",
                lambda: decode(cfg, params, grown, step, toks.shape[1]))
            del grown
        moe_note = "" if not routing else (
            f"; routing forced on the plain rerun: {routing['dropped_pairs']} of "
            f"{routing['pairs']} (token, expert) pairs dropped by capacity, "
            f"{routing['flips_at_near_ties']} (token, layer)s whose own experts differ, all at "
            f"near-ties (gap < {ROUTE_GAP}); unforced, {routing['unforced_tokens_routed_otherwise']}"
            f" of {toks.size} tokens routed otherwise (no limit)")
        compared = "no attention, no plain rerun" if not errs else (
            "kernel vs plain prefill max rel err "
            + " ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (limit {SERVE_REL})")
        log(f"[serve] {cfg.name} {label} cohort {i} {tuple(toks.shape)}: {compared}; flash launches "
            f"{launches}; logit std {std:.4f}{moe_note} smi={gpu_state()}")
        out.append(dict(shape=list(toks.shape), logit_std=std, flash_launches=launches,
                        **errs, **routing))
        del logits, cache, want_logits, want_cache
    return out


def check_moe_layer(cfg, params, tokens) -> dict:
    """One MoE layer at a long cohort's shape on the card against the same
    layer on the CPU, from identical inputs: layer 0's weights and its input
    in a prefill of ``tokens``. Every token whose k-th and (k+1)-th
    probabilities lie more than ROUTE_GAP apart gets the same experts on
    both; every token routed alike (experts and capacity) gets its output
    within MOE_LAYER_TOL. Raises on a miss."""
    from repro_torch.models import moe, prefill, transformer
    inputs = []
    moe_ffn = transformer.moe_ffn

    def capture(x, p, m, activation):
        if not inputs:
            inputs.append(x.detach().clone())
        return moe_ffn(x, p, m, activation)

    transformer.moe_ffn = capture
    try:
        prefill(cfg, params, {"tokens": tokens})
    finally:
        transformer.moe_ffn = moe_ffn
    x = inputs[0]
    layer0 = transformer.layer_params(params["layers"], 0)["moe"]

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    runs = []
    t0 = time.perf_counter()
    for dev in (x.device, torch.device("cpu")):
        with RouteRecorder() as rec:
            y = moe.moe_ffn(x.to(dev), to(layer0, dev), cfg.moe, cfg.activation)
        runs.append((y.cpu().reshape(-1, x.shape[-1]), rec.routes[0], rec.gaps[0].cpu()))
    (y, r_card, _), (want, r_cpu, gap) = runs
    (ic, kc), (ip, kp) = token_routing(r_card), token_routing(r_cpu)
    same_ids = (ic.cpu() == ip).all(-1)
    alike = same_ids & (kc.cpu() == kp).all(-1)
    if (~same_ids & (gap > ROUTE_GAP)).any():
        t = int(torch.nonzero(~same_ids & (gap > ROUTE_GAP))[0])
        raise AssertionError(f"MoE layer: token {t} routed {ic[t].tolist()} on the card, "
                             f"{ip[t].tolist()} on the CPU, at a gap of {float(gap[t]):.3e}")
    diff = (y - want).abs()[alike]
    bad = ~(diff <= MOE_LAYER_TOL + MOE_LAYER_TOL * want.abs()[alike])
    if bad.any() or not float(want.abs().max()) > 0:
        raise AssertionError(f"MoE layer: {int(bad.sum())} elements beyond {MOE_LAYER_TOL}, "
                             f"max |diff| {float(diff.max())}")
    out = {"tokens": x.shape[0] * x.shape[1],
           "capacity": moe.capacity_for(x.shape[0] * x.shape[1], cfg.moe),
           "dropped_pairs": int((~r_cpu.keep).sum()), "near_ties": int((gap <= ROUTE_GAP).sum()),
           "routed_otherwise": int((~alike).sum()), "max_abs_err": float(diff.max()),
           "seconds": time.perf_counter() - t0}
    log(f"[serve] {cfg.name} MoE layer 0 on {out['tokens']} tokens, card against CPU: "
        f"{out['routed_otherwise']} tokens routed otherwise ({out['near_ties']} near-ties under "
        f"{ROUTE_GAP}), {out['dropped_pairs']} pairs dropped by capacity, max |diff| "
        f"{out['max_abs_err']:.3e} over the rest (limit {MOE_LAYER_TOL} + {MOE_LAYER_TOL} |cpu|) "
        f"in {out['seconds']:.2f} s smi={gpu_state()}")
    return out


# Phase 8. Decode against the chunked form: every served position's logits
# (the prefill's last, then each decode step's) against a teacher-forced
# ``forward`` over the cohort's prompts and served tokens, max |decode -
# forward| <= SERVE_REL x max |forward| over the real vocabulary; the
# recurrence and the chunked SSD differ by float32 rounding through 38-48
# layers, a wrong state by the order of the values. The served token must
# be the forward's argmax, or its logit within that limit of the argmax's
# (a tie to rounding, counted). Two chunkings of one SSD input (chunk 256
# against chunk 1, the 1024-step recurrence): max |diff| <= SSD_CHUNK_REL x
# max |chunk-1 value|, for the output and the final state. One Mamba2 block
# on the card against the CPU from one input: |card - cpu| <= SSM_LAYER_TOL
# + SSM_LAYER_TOL |cpu| elementwise (float32 in other summation orders).
SSD_CHUNK_REL = 1e-4
SSM_LAYER_TOL = 1e-4


class _Captured(Exception):
    """Stops a prefill once the wrapped call has been captured."""


def first_call_args(module, name: str, run) -> tuple:
    """The arguments (tensors detached and copied) of the first call of
    ``module.name`` in ``run()``, which is stopped right there."""
    fn, got = getattr(module, name), []

    def capture(*args, **kwargs):
        got.extend(a.detach().clone() if torch.is_tensor(a) else a for a in args)
        raise _Captured

    setattr(module, name, capture)
    try:
        run()
    except _Captured:
        pass
    finally:
        setattr(module, name, fn)
    if not got:
        raise AssertionError(f"{name} was never called")
    return tuple(got)


def hold_to_forward(what: str, fwd, got, gen) -> tuple[float, int]:
    """Served logits ``got`` (B, n, V) against a teacher-forced forward's
    ``fwd`` at the same positions, and the served tokens ``gen`` (B, n)
    against its argmax (or a tie within the limit); raises on a miss.
    Returns the max relative error and the count of ties."""
    if got.shape != fwd.shape:
        raise AssertionError(f"{what}: {tuple(got.shape)} served logits against "
                             f"{tuple(fwd.shape)} of the forward")
    scale = float(fwd.abs().max())
    err = float((got - fwd).abs().max()) / scale
    top = fwd.max(-1)
    at_served = fwd.gather(-1, gen[..., None])[..., 0]
    is_max = top.indices == gen
    tie = (top.values - at_served) <= SERVE_REL * scale
    if not err <= SERVE_REL or not bool((is_max | tie).all()):
        raise AssertionError(f"{what}: decode against the forward: max rel err {err:.3e} "
                             f"(limit {SERVE_REL}), {int((~(is_max | tie)).sum())} served "
                             f"tokens not the argmax")
    return err, int((~is_max).sum())


def check_decode_against_forward(cfg, params, label, res, recorded) -> dict:
    """Each cohort's served logits (``recorded``, per cohort the prefill's
    last position and each decode step's) against ``forward`` over its
    prompts and served tokens; raises on a miss (the limits above)."""
    from repro_torch.models import forward
    served = {c.request_id: c.tokens for c in res.completions}
    dev = params["embed"].device
    worst, ties, rid, positions = 0.0, 0, 0, 0
    t0 = time.perf_counter()
    for i, toks in enumerate(res.cohort_tokens):
        B, S0 = toks.shape
        gen = torch.tensor([served[rid + j] for j in range(B)], dtype=torch.int64, device=dev)
        rid += B
        full = torch.cat([torch.from_numpy(toks).to(dev).long(), gen[:, :-1]], 1)
        fwd = forward(cfg, params, {"tokens": full}, remat="none")[:, S0 - 1:, :cfg.vocab_size]
        got = torch.stack(recorded[i], 1)[..., :cfg.vocab_size]
        err, n_ties = hold_to_forward(f"{cfg.name} {label} cohort {i}", fwd, got, gen)
        worst = max(worst, err)
        ties += n_ties
        positions += gen.numel()
        del fwd, got
    out = {"max_rel_err": worst, "positions": positions, "ties": ties,
           "seconds": time.perf_counter() - t0}
    log(f"[serve] {cfg.name} {label}: decode against the teacher-forced forward at "
        f"{positions} served positions: max rel err {worst:.3e} (limit {SERVE_REL}), served "
        f"token the forward's argmax at all but {ties} (ties within the limit) in "
        f"{out['seconds']:.2f} s smi={gpu_state()}")
    return out


def check_ssd_chunks(cfg, params, tokens) -> dict:
    """``ssd_chunked`` on the first layer's input of a prefill of ``tokens``
    (the 1024-token cohort) at the config's chunk and at chunk 1, each
    profiled once (device busy time and idle share: at chunk 1 the host
    enqueues a launch a chunk, longer than CUDA events can bracket); raises
    beyond SSD_CHUNK_REL."""
    from repro_torch.models import mamba2, prefill
    args = first_call_args(mamba2, "ssd_chunked",
                           lambda: prefill(cfg, params, {"tokens": tokens}))
    inputs, S = args[:6], args[0].shape[1]
    runs = {c: mamba2.ssd_chunked(*inputs, c, return_final_state=True)
            for c in (cfg.ssm.chunk, 1)}
    (y, state), (y1, state1) = runs[cfg.ssm.chunk], runs[1]
    errs = {"y": rel_err(y, y1), "state": rel_err(state, state1)}
    if not all(e <= SSD_CHUNK_REL for e in errs.values()):
        raise AssertionError(f"{cfg.name}: ssd_chunked at chunk {cfg.ssm.chunk} against chunk 1: "
                             f"{errs} beyond {SSD_CHUNK_REL}")
    out = {"shape": list(inputs[0].shape), "state_dim": int(inputs[3].shape[-1]), **errs,
           "q": mamba2.chunk_len(S, cfg.ssm.chunk)}
    for chunk in (cfg.ssm.chunk, 1):
        out[f"profile_chunk_{chunk}"] = profile_device(
            f"{cfg.name} ssd_chunked {tuple(inputs[0].shape)} at chunk {chunk}",
            lambda: mamba2.ssd_chunked(*inputs, chunk))
    log(f"[serve] {cfg.name} ssd_chunked on layer 0's input {tuple(inputs[0].shape)} (B, S, H, "
        f"P), N {out['state_dim']}: chunk {cfg.ssm.chunk} (Q {out['q']}) against chunk 1 (Q 1): "
        f"max rel err y {errs['y']:.3e} state {errs['state']:.3e} (limit {SSD_CHUNK_REL}) "
        f"smi={gpu_state()}")
    return out


def check_mamba_layer(cfg, params, tokens) -> dict:
    """One Mamba2 block (layer 0's weights) at a long cohort's shape on the
    card against the same block on the CPU, from layer 0's input in a
    prefill of ``tokens``; raises beyond SSM_LAYER_TOL."""
    from repro_torch.models import mamba2, prefill, transformer
    _, _, u = first_call_args(mamba2, "mamba_block",
                              lambda: prefill(cfg, params, {"tokens": tokens}))
    layers = params["mamba_layers"] if "mamba_layers" in params else params["layers"]
    layer0 = transformer.layer_params(layers, 0)
    t0 = time.perf_counter()
    y = mamba2.mamba_block(cfg, layer0, u).cpu()
    want = mamba2.mamba_block(cfg, {k: v.cpu() for k, v in layer0.items()}, u.cpu())
    diff = (y - want).abs()
    bad = ~(diff <= SSM_LAYER_TOL + SSM_LAYER_TOL * want.abs())
    if bad.any() or not float(want.abs().max()) > 0:
        raise AssertionError(f"{cfg.name} Mamba2 layer: {int(bad.sum())} elements beyond "
                             f"{SSM_LAYER_TOL}, max |diff| {float(diff.max())}")
    out = {"shape": list(u.shape), "max_abs_err": float(diff.max()),
           "max_abs_cpu": float(want.abs().max()), "seconds": time.perf_counter() - t0}
    log(f"[serve] {cfg.name} Mamba2 layer 0 on {tuple(u.shape)}, card against CPU: max |diff| "
        f"{out['max_abs_err']:.3e} (limit {SSM_LAYER_TOL} + {SSM_LAYER_TOL} |cpu|, max |cpu| "
        f"{out['max_abs_cpu']:.3f}) in {out['seconds']:.2f} s smi={gpu_state()}")
    return out


def describe(cfg) -> str:
    """A config's shape, as a ``[serve]`` line gives it."""
    from repro_torch.models.mamba2 import ssm_dims
    head = f"{cfg.num_layers} layers, d_model {cfg.d_model}"
    if cfg.ssm is not None:
        d_inner, H, P, N, conv_ch = ssm_dims(cfg)
        head += (f", Mamba2 d_inner {d_inner}, {H} SSM heads of {P}, state {N}, "
                 f"{cfg.ssm.ngroups} group(s), conv width {cfg.ssm.conv_width} over {conv_ch} "
                 f"channels, chunk {cfg.ssm.chunk}")
    if cfg.hybrid is not None:
        head += (f"; a shared block after every {cfg.hybrid.shared_every} layers at width "
                 f"{2 * cfg.d_model}")
    if cfg.num_heads:
        ffn = (f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff {cfg.moe.d_ff_expert}, "
               f"capacity factor {cfg.moe.capacity_factor}" if cfg.moe else f"d_ff {cfg.d_ff}")
        padded = f" padded to {cfg.eff_heads}" if cfg.eff_heads != cfg.num_heads else ""
        head += (f", heads {cfg.num_heads}{padded}/{cfg.eff_kv}, head_dim "
                 f"{cfg.resolved_head_dim}, {ffn}, {cfg.activation}")
    return f"{head}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab})"


class LogitRecorder:
    """While active, keeps the logits the served path produces, cohort by
    cohort: the prefill's last position (a copy) and every decode step's,
    each (B, V), by wrapping the model calls of ``repro_torch.launch.serve``."""

    def __enter__(self):
        from repro_torch.launch import serve as launch_serve
        self._mod = launch_serve
        self._prefill, self._decode = launch_serve.prefill, launch_serve.decode
        self.cohorts = []

        def prefill(cfg, params, batch):
            logits, cache = self._prefill(cfg, params, batch)
            self.cohorts.append([logits[:, -1].clone()])
            return logits, cache

        def decode(cfg, params, cache, tokens, position):
            logits, cache = self._decode(cfg, params, cache, tokens, position)
            self.cohorts[-1].append(logits[:, -1])
            return logits, cache

        launch_serve.prefill, launch_serve.decode = prefill, decode
        return self

    def __exit__(self, *exc):
        self._mod.prefill, self._mod.decode = self._prefill, self._decode


def phase_serve(dev, cfg, wrappers) -> dict:
    """Serve the launcher's default request set and a long-prompt set through
    ``serve()`` (for an SSM family also ``b2_exact_1024``, whose cohort
    length is a multiple of the SSD chunk); the flash launches are counted
    over these runs alone."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models.mamba2 import chunk_len
    t0 = time.perf_counter()
    params = perturbed_params(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {describe(cfg)}; {n_params} float32 parameters made in "
        f"{time.perf_counter() - t0:.2f} s smi={gpu_state()}")
    sets = {
        "a_defaults": (make_requests(cfg, 8, 12, 8), 4),
        "b_long_prompts": (make_requests(cfg, 4, 1024, 8, min_len=900, seed=1), 4),
    }
    if cfg.ssm is not None:
        sets["b2_exact_1024"] = (make_requests(cfg, 4, 1024, 8, min_len=1024, seed=1), 4)
    serve(cfg, params, make_requests(cfg, 1, 4, 2, seed=2), 1, dev)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    results, recorded = {}, {}
    for label, (reqs, bs) in sets.items():
        if cfg.ssm is None:
            results[label] = serve(cfg, params, reqs, bs, dev)
            continue
        with LogitRecorder() as rec:
            results[label] = serve(cfg, params, reqs, bs, dev)
        recorded[label] = rec.cohorts
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
        ssd = ""
        if cfg.ssm is not None:
            row["ssd_q_nc"] = [(chunk_len(n, cfg.ssm.chunk), n // chunk_len(n, cfg.ssm.chunk))
                               for n in row["prompt_lens"]]
            ssd = f" (SSD chunk Q, chunks nc per cohort {row['ssd_q_nc']})"
        log(f"[serve] {cfg.name} {label}: {row['requests']} requests, {row['tokens']} tokens in "
            f"{row['seconds']:.4f} s ({row['tokens_per_s']:.3f} tok/s); cohorts padded to "
            f"{row['prompt_lens']}{ssd}; prefill ms per cohort "
            f"{[round(x, 3) for x in row['prefill_ms']]}; "
            f"decode ms per step median {statistics.median(row['decode_ms']):.3f} "
            f"(min {min(row['decode_ms']):.3f}, max {max(row['decode_ms']):.3f}, "
            f"{len(row['decode_ms'])} steps) smi={gpu_state()}")
        for c in res.completions[:4]:
            log(f"[serve] {cfg.name} {label} req {c.request_id}: {c.tokens} smi={gpu_state()}")
        row["served"] = [c.tokens for c in res.completions]
        out["sets"][label] = row
    log(f"[serve] {cfg.name}: launches in the serve phase: {launches}; "
        f"torch.cuda.max_memory_allocated {peak} B smi={gpu_state()}")
    out["profile"] = {}
    for label, res in results.items():
        out["sets"][label]["cohorts"] = check_cohorts(cfg, params, label, res, out["profile"])
    if cfg.moe is not None:
        long_cohort = results["b_long_prompts"].cohort_tokens[0]
        out["moe_layer"] = check_moe_layer(cfg, params, torch.from_numpy(long_cohort).to(dev))
    if cfg.ssm is not None:
        for label, res in results.items():
            out["sets"][label]["decode_vs_forward"] = check_decode_against_forward(
                cfg, params, label, res, recorded[label])
        del recorded
        cohort = {label: torch.from_numpy(results[label].cohort_tokens[0]).to(dev)
                  for label in ("b_long_prompts", "b2_exact_1024")}
        out["ssd_chunks"] = check_ssd_chunks(cfg, params, cohort["b2_exact_1024"])
        out["mamba_layer"] = check_mamba_layer(cfg, params, cohort["b_long_prompts"])
    del params, results
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- families
FAMILY_ARCHS = ("olmoe-1b-7b", "gemma-2b")


def phase_families(dev, wrappers) -> dict:
    """Phase 7: olmoe-1b-7b and gemma-2b at full width and depth, one model
    on the card at a time, serve phase 4's request sets through ``serve()``
    with the same checks (olmoe's routing-aware); each served path launches
    the flash kernel once per layer per cohort."""
    from repro_torch.configs import get_config
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        run = phase_serve(dev, cfg, wrappers)
        expected = sum(len(r["cohorts"]) for r in run["sets"].values()) * cfg.num_layers
        if run["launches"]["flash_attention"] != expected:
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{run['launches']['flash_attention']} times on the served "
                                 f"path, expected {expected}")
        out[arch] = run
    return out


SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")


def phase_ssm(dev, wrappers) -> dict:
    """Phase 8: mamba2-780m and zamba2-1.2b at full width and depth, one
    model on the card at a time, serve phase 4's request sets and
    ``b2_exact_1024`` through ``serve()``; zamba2 launches the flash kernel
    once per shared-block call per cohort, mamba2 never."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import hybrid_structure
    out = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        run = phase_serve(dev, cfg, wrappers)
        per_cohort = hybrid_structure(cfg)[0] if cfg.hybrid is not None else 0
        expected = sum(len(r["cohorts"]) for r in run["sets"].values()) * per_cohort
        if run["launches"]["flash_attention"] != expected:
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{run['launches']['flash_attention']} times on the served "
                                 f"path, expected {expected}")
        out[arch] = run
    return out


# ------------------------------------------------------------------- audio
AUDIO_ARCH = "whisper-small"
# Whisper's special tokens in its 51865-word vocabulary: start of transcript,
# English, transcribe, no timestamps (the usual transcription request), and
# start of the previous window's text (long-form transcription's
# conditioning); ids below TEXT_TOKENS are text.
SOT_PROMPT = (50258, 50259, 50359, 50363)
START_OF_PREV = 50361
TEXT_TOKENS = 50257
# (clips, prompt tokens, new tokens) at batch AUDIO_BATCH: (w-a) the
# start-of-transcript prompt; (w-b) 219 tokens of the previous window's
# text between START_OF_PREV and it.
AUDIO_SETS = {"w_a_sot": (8, 4, 32), "w_b_prev_text": (4, 224, 8)}
AUDIO_BATCH = 4
AUDIO_TRAIN = (2, 448)   # batch, decoder tokens (Whisper's decoder context)


def audio_prompts(clips: int, length: int, seed: int) -> np.ndarray:
    """``clips`` equal-length prompts: the start-of-transcript request, or
    with ``length - 5`` random text tokens of a previous window before it."""
    sot = np.tile(np.asarray(SOT_PROMPT, np.int32), (clips, 1))
    if length == len(SOT_PROMPT):
        return sot
    text = np.random.default_rng(seed).integers(0, TEXT_TOKENS, (clips, length - 1 - sot.shape[1]))
    return np.concatenate([np.full((clips, 1), START_OF_PREV), text, sot], 1).astype(np.int32)


def audio_frames(cfg, dev, batch: int, seed: int):
    """N(0, 1) frame embeddings (batch, encoder_seq, d_model): the conv
    front end's output, which the model takes as its input."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(batch, cfg.encdec.encoder_seq, cfg.d_model, generator=g, device=dev)


def serve_audio_cohort(cfg, params, frames, prompt, new_tokens: int, flash, dev) -> dict:
    """Greedy decoding of one cohort by the port's ``Batcher`` over the
    model API, with closures that bind the cohort's frames: ``prefill`` on
    the frames and the prompts, the batcher's cache growth, ``new_tokens -
    1`` decode steps. Each call is timed on the host clock to a synchronize
    around it; the served logits (the prefill's last position, then each
    step's), the flash launches of the prefill and of the decode steps, and
    the last cache are recorded."""
    from repro_torch.models import decode, prefill
    from repro_torch.serving import Batcher, Request
    rec = {"prefill_s": [], "decode_s": [], "prefill_launches": 0, "decode_launches": 0,
           "logits": []}

    def timed(kind, call):
        torch.cuda.synchronize()
        before, t = flash.launches, time.perf_counter()
        logits, cache = call()
        torch.cuda.synchronize()
        rec[kind + "_s"].append(time.perf_counter() - t)
        rec[kind + "_launches"] += flash.launches - before
        rec["logits"].append(logits[:, -1].clone())
        rec["cache"] = cache
        return logits, cache

    def prefill_fn(tokens):
        return timed("prefill", lambda: prefill(cfg, params, {"frames": frames, "tokens": tokens}))

    def decode_fn(cache, tokens, position):
        return timed("decode", lambda: decode(cfg, params, cache, tokens, position))

    batcher = Batcher(prefill_fn, decode_fn, batch_size=prompt.shape[0], device=dev)
    for i, row in enumerate(prompt.cpu().numpy()):
        batcher.submit(Request(i, row, max_new_tokens=new_tokens))
    done = batcher.run()
    rec["prefill_s"] = rec["prefill_s"][0]
    rec.update(tokens=torch.tensor([c.tokens for c in done], device=dev),
               logits=torch.stack(rec["logits"], 1))
    return rec


def check_teacher_forced(cfg, params, frames, prompt, text, what: str, flash) -> dict:
    """Decode fed the next tokens of a random ``text`` (B, n) in place of
    its own argmax, so that every step reads other token ids (greedy
    decoding on random tied weights repeats one token): prefill on the
    prompt, the self caches grown by n, n decode steps; the prefill's last
    logits and every step's held to a forward over prompt + text with
    :func:`hold_to_forward` (the served argmax the forward's or a tie). No
    decode step launches flash."""
    from repro_torch.models import decode, forward, prefill
    S, n = prompt.shape[1], text.shape[1]
    logits, cache = prefill(cfg, params, {"frames": frames, "tokens": prompt})
    cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (n,) + v.shape[3:])], 2)
             if k.startswith("self") else v for k, v in cache.items()}
    got = [logits[:, -1].clone()]
    del logits
    before = flash.launches
    for step in range(n):
        logits, cache = decode(cfg, params, cache, text[:, step:step + 1], S + step)
        got.append(logits[:, -1])
    launched = flash.launches - before
    if launched:
        raise AssertionError(f"{what}: {launched} flash launches in {n} decode steps")
    V = cfg.vocab_size
    got = torch.stack(got, 1)[..., :V]
    full = torch.cat([prompt.long(), text.long()], 1)
    fwd = forward(cfg, params, {"frames": frames, "tokens": full}, remat="none")[:, S - 1:, :V]
    err, ties = hold_to_forward(what, fwd, got, got.argmax(-1))
    fed = len(set(text.flatten().tolist()))
    argmaxes = len(set(got.argmax(-1).flatten().tolist()))
    log(f"[serve] {what}: decode fed {n} tokens of random text ({fed} distinct ids) against "
        f"the teacher-forced forward at {got.shape[0] * got.shape[1]} positions: max rel err "
        f"{err:.3e} (limit {SERVE_REL}), {argmaxes} distinct argmaxes, {ties} ties; 0 flash "
        f"launches smi={gpu_state()}")
    return {"max_rel_err": err, "ties": ties, "positions": got.shape[0] * got.shape[1],
            "distinct_fed": fed, "distinct_argmax": argmaxes}


def check_audio_prefill(cfg, params, frames, prompt, first, what: str, flash) -> dict:
    """A cohort's prefill through the kernel (rerun) against one through the
    plain attention (``transformer.flash_gqa`` swapped for ``flash_gqa_ref``
    and restored): the real vocabulary's logits and the four cache leaves
    within SERVE_REL x max |plain|; the kernel rerun launches flash once per
    encoder layer and twice per decoder layer, the plain rerun never; the
    rerun's greedy first tokens are the served ``first``."""
    from repro_torch.kernels.attention import flash_gqa_ref
    from repro_torch.models import prefill, transformer
    batch = {"frames": frames, "tokens": prompt}
    before = flash.launches
    logits, cache = prefill(cfg, params, batch)
    launches = {"kernel_rerun": flash.launches - before}
    kernel_fn = transformer.flash_gqa
    transformer.flash_gqa = flash_gqa_ref
    before = flash.launches
    try:
        want_logits, want_cache = prefill(cfg, params, batch)
    finally:
        transformer.flash_gqa = kernel_fn
    launches["plain_rerun"] = flash.launches - before
    if launches != {"kernel_rerun": flash_per_pass(cfg), "plain_rerun": 0}:
        raise AssertionError(f"{what}: flash launches {launches}, expected "
                             f"{flash_per_pass(cfg)} in the kernel rerun and 0 in the plain one")
    V = cfg.vocab_size
    if not torch.equal(torch.argmax(logits[:, -1], -1), first):
        raise AssertionError(f"{what}: the rerun's first tokens are not the served ones")
    if not torch.equal(logits[..., V:], want_logits[..., V:]):
        raise AssertionError(f"{what}: padded vocabulary not masked alike")
    std = float(want_logits[..., :V].std())
    if not std > 0 or not all(c.any() for c in want_cache.values()):
        raise AssertionError(f"{what}: degenerate prefill (logit std {std})")
    errs = {"logits": rel_err(logits[..., :V], want_logits[..., :V]),
            **{name: rel_err(cache[name], want_cache[name]) for name in cache}}
    bad = {k: e for k, e in errs.items() if not e <= SERVE_REL}
    if bad:
        raise AssertionError(f"{what}: kernel vs plain prefill beyond {SERVE_REL} relative: {bad}")
    log(f"[serve] {what}: kernel vs plain prefill max rel err "
        + " ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (limit {SERVE_REL}); flash "
        f"launches {launches}; logit std {std:.4f}; cache "
        f"{ {k: tuple(v.shape) for k, v in cache.items()} } smi={gpu_state()}")
    return {"flash_launches": launches, "logit_std": std, **errs}


def phase_audio(dev, wrappers) -> dict:
    """Phase 9: whisper-small at full width and depth serves sets (w-a) and
    (w-b) by the port's ``Batcher`` over the model API (``prefill``, then
    ``decode`` against the self and cross caches), batch AUDIO_BATCH,
    greedy, each cohort on its own seeded frames; the flash launches are
    counted over the serving alone (36 a cohort prefill, none in a decode
    step). Then the checks: each cohort's kernel prefill against the plain
    attention's, every served position's logits against a teacher-forced
    ``forward``, each set's first cohort decoded on random text against the
    forward (varied token ids), one loss and gradient at AUDIO_TRAIN
    through the kernel against the plain attention (remat full); and the
    encoder's share of a prefill, a profile of one prefill per set and one
    decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, forward
    from repro_torch.models import decode as decode_step
    from repro_torch.models import prefill as prefill_fn
    cfg = get_config(AUDIO_ARCH)
    flash = wrappers["flash_attention"]
    t0 = time.perf_counter()
    params = perturbed_params(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {cfg.encdec.num_encoder_layers} encoder layers over "
        f"{cfg.encdec.encoder_seq} frames, {describe(cfg)}; {n_params} float32 parameters made "
        f"in {time.perf_counter() - t0:.2f} s smi={gpu_state()}")
    cohorts = {}
    for s, (label, (clips, length, new)) in enumerate(AUDIO_SETS.items()):
        prompts = audio_prompts(clips, length, seed=s)
        cohorts[label] = [(torch.from_numpy(prompts[i:i + AUDIO_BATCH]).to(dev),
                           audio_frames(cfg, dev, len(prompts[i:i + AUDIO_BATCH]),
                                        seed=100 * (s + 1) + i), new)
                          for i in range(0, clips, AUDIO_BATCH)]
    warm = cohorts["w_a_sot"][0]
    serve_audio_cohort(cfg, params, warm[1][:1], warm[0][:1], 2, flash, dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    runs = {}
    for label, group in cohorts.items():
        t = time.perf_counter()
        runs[label] = [serve_audio_cohort(cfg, params, frames, prompt, new, flash, dev)
                       for prompt, frames, new in group]
        runs[label + "_seconds"] = time.perf_counter() - t
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    out = {"launches": {"serve": launches["flash_attention"]}, "max_memory_allocated": peak,
           "sets": {}, "profile": {}}
    for label, group in cohorts.items():
        res, seconds = runs[label], runs.pop(label + "_seconds")
        n_tokens = sum(r["tokens"].numel() for r in res)
        for i, r in enumerate(res):
            if r["prefill_launches"] != flash_per_pass(cfg) or r["decode_launches"]:
                raise AssertionError(f"{label} cohort {i}: flash launched {r['prefill_launches']} "
                                     f"times in the prefill (expected {flash_per_pass(cfg)}) "
                                     f"and {r['decode_launches']} in the decode steps (0)")
        tokens = torch.cat([r["tokens"] for r in res]).tolist()
        encode_ms = []
        for prompt, frames, _ in group:
            torch.cuda.synchronize()
            t = time.perf_counter()
            encdec.encode(cfg, params, frames, remat="none")
            torch.cuda.synchronize()
            encode_ms.append((time.perf_counter() - t) * 1e3)
        decode_ms = [s * 1e3 for r in res for s in r["decode_s"]]
        # random weights with a tied embedding repeat a clip's last token;
        # the checks below hold every position's logits to the forward, and
        # feed decode random text
        row = {"requests": len(tokens), "tokens": n_tokens, "seconds": seconds,
               "distinct_tokens": len({t for r in tokens for t in r}),
               "tokens_per_s": n_tokens / seconds, "prompt_len": group[0][0].shape[1],
               "prefill_ms": [r["prefill_s"] * 1e3 for r in res], "encode_ms": encode_ms,
               "decode_ms": decode_ms,
               "flash_launches": {"prefill": [r["prefill_launches"] for r in res],
                                  "decode": [r["decode_launches"] for r in res]}}
        row["encoder_share"] = [e / p for e, p in zip(encode_ms, row["prefill_ms"])]
        log(f"[serve] {cfg.name} {label}: {row['requests']} clips, {n_tokens} tokens in "
            f"{seconds:.4f} s ({row['tokens_per_s']:.3f} tok/s), {row['distinct_tokens']} distinct; "
            f"prompts of {row['prompt_len']} "
            f"tokens; prefill ms per cohort {[round(x, 3) for x in row['prefill_ms']]}, the "
            f"encoder alone {[round(x, 3) for x in encode_ms]} (share "
            f"{[round(x, 3) for x in row['encoder_share']]}); decode ms per step median "
            f"{statistics.median(decode_ms):.3f} (min {min(decode_ms):.3f}, max "
            f"{max(decode_ms):.3f}, {len(decode_ms)} steps); flash launches "
            f"{row['flash_launches']} smi={gpu_state()}")
        for i, r in enumerate(tokens[:4]):
            log(f"[serve] {cfg.name} {label} clip {i}: {r} smi={gpu_state()}")
        out["sets"][label] = row
    log(f"[serve] {cfg.name}: launches in the serve phase: {launches}; "
        f"torch.cuda.max_memory_allocated {peak} B smi={gpu_state()}")
    for s, (label, group) in enumerate(cohorts.items()):
        checks, worst, ties = [], 0.0, 0
        for i, ((prompt, frames, _), r) in enumerate(zip(group, runs[label])):
            what = f"{cfg.name} {label} cohort {i} {tuple(prompt.shape)}"
            checks.append(check_audio_prefill(cfg, params, frames, prompt, r["tokens"][:, 0],
                                              what, flash))
            S, gen = prompt.shape[1], r["tokens"]
            full = torch.cat([prompt.long(), gen[:, :-1]], 1)
            fwd = forward(cfg, params, {"frames": frames, "tokens": full},
                          remat="none")[:, S - 1:, :cfg.vocab_size]
            err, n_ties = hold_to_forward(what, fwd, r["logits"][..., :cfg.vocab_size], gen)
            worst, ties = max(worst, err), ties + n_ties
            del fwd
        row = out["sets"][label]
        row["cohorts"] = checks
        row["decode_vs_forward"] = {"max_rel_err": worst, "ties": ties,
                                    "positions": sum(r["tokens"].numel() for r in runs[label])}
        log(f"[serve] {cfg.name} {label}: decode against the teacher-forced forward at "
            f"{row['decode_vs_forward']['positions']} served positions: max rel err {worst:.3e} "
            f"(limit {SERVE_REL}), served token the forward's argmax at all but {ties} (ties "
            f"within the limit) smi={gpu_state()}")
        prompt, frames, new = group[0]
        text = np.random.default_rng(50 + s).integers(
            0, TEXT_TOKENS, (prompt.shape[0], new))
        row["teacher_forced"] = check_teacher_forced(
            cfg, params, frames, prompt, torch.from_numpy(text).to(dev),
            f"{cfg.name} {label} cohort 0 {tuple(prompt.shape)}", flash)
        out["profile"][f"{label} prefill"] = profile_device(
            f"{cfg.name} {label} prefill {tuple(prompt.shape)} on {tuple(frames.shape)} frames",
            lambda: prefill_fn(cfg, params, {"frames": frames, "tokens": prompt}))
    r, (prompt, _, new) = runs["w_a_sot"][0], cohorts["w_a_sot"][0]
    step, position = r["tokens"][:, -1:], prompt.shape[1] + new - 1
    out["profile"]["decode step"] = profile_device(
        f"{cfg.name} decode step at position {position}",
        lambda: decode_step(cfg, params, r["cache"], step, position))
    del runs, cohorts, r
    torch.cuda.empty_cache()

    batch_rows, length = AUDIO_TRAIN
    prompts = audio_prompts(batch_rows, length, seed=7)
    tokens = torch.from_numpy(prompts).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], 1)
    batch = {"frames": audio_frames(cfg, dev, batch_rows, seed=900), "tokens": tokens,
             "labels": labels}
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    g = check_train_grads(cfg, params, batch, wrappers)
    g["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["grad_check"] = g
    out["launches"]["train_check"] = g["flash_launches"]
    log(f"[train] {cfg.name} kernel vs plain attention, {batch_rows} x {length} tokens on "
        f"{cfg.encdec.encoder_seq} frames, remat full: loss {g['loss']:.6f} against "
        f"{g['plain_loss']:.6f} (rel err {g['loss_rel_err']:.3e}, limit {TRAIN_LOSS_REL}); worst "
        f"gradient {g['worst_grad']} rel err {g['grad_rel_err'][g['worst_grad']]:.3e} (limit "
        f"{SERVE_REL} x max |plain|); {g['flash_launches']} flash launches (forward and "
        f"recompute); max_memory_allocated {g['max_memory_allocated']} B smi={gpu_state()}")
    del params, batch
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- train
def flash_per_pass(cfg) -> int:
    """Flash launches of one forward pass: one per attention layer; for an
    encoder-decoder one per encoder layer and two per decoder layer (self
    and cross)."""
    if cfg.encdec is not None:
        return cfg.encdec.num_encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def train_grads(cfg, params, batch, remat):
    """(loss, {leaf name: gradient}) of ``loss_fn`` at ``params``."""
    from repro_torch.models import loss_fn
    from repro_torch.training.tree import flatten_with_paths, tree_unflatten
    names, leaves_ = zip(*[(n, p.detach().requires_grad_())
                           for n, p in flatten_with_paths(params)])
    loss = loss_fn(cfg, tree_unflatten(params, list(leaves_)), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves_)
    return loss.detach(), dict(zip(names, grads))


def check_train_grads(cfg, params, batch, wrappers) -> dict:
    """One loss and gradient through the kernel against the same through
    the plain attention (swapped in here and restored), ``remat="full"``:
    loss within TRAIN_LOSS_REL relative, each gradient leaf within
    SERVE_REL x max |plain leaf|. Raises on a miss."""
    from repro_torch.kernels.attention import flash_gqa_ref
    from repro_torch.models import transformer
    launches = wrappers["flash_attention"].launches
    loss, grads = train_grads(cfg, params, batch, "full")
    torch.cuda.synchronize()
    launched = wrappers["flash_attention"].launches - launches
    if launched != 2 * flash_per_pass(cfg):
        raise AssertionError(f"train check: {launched} flash launches, expected "
                             f"{2 * flash_per_pass(cfg)} (forward and recompute)")
    kernel_fn = transformer.flash_gqa
    transformer.flash_gqa = flash_gqa_ref
    try:
        want_loss, want = train_grads(cfg, params, batch, "full")
    finally:
        transformer.flash_gqa = kernel_fn
    loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    errs = {}
    for name, w in want.items():
        scale = float(w.abs().max())
        if not scale > 0 or not torch.isfinite(grads[name]).all():
            raise AssertionError(f"train check: degenerate gradient of {name} (max {scale})")
        errs[name] = float((grads[name] - w).abs().max()) / scale
    worst = max(errs, key=errs.get)
    if not loss_err <= TRAIN_LOSS_REL or errs[worst] > SERVE_REL:
        raise AssertionError(f"train check: kernel vs plain loss rel err {loss_err:.3e} (limit "
                             f"{TRAIN_LOSS_REL}), worst gradient {worst} {errs[worst]:.3e} "
                             f"(limit {SERVE_REL})")
    return {"loss": float(loss), "plain_loss": float(want_loss), "loss_rel_err": loss_err,
            "grad_rel_err": errs, "worst_grad": worst, "flash_launches": launched}


def train_shape(dev, cfg, state, label, batch_seqs, seq_len, remat, wrappers, card) -> dict:
    """The launcher's pipeline at one shape: replicated ThallusServers over
    the launcher's token table, ``ThallusLoader(transport="thallus")``, each
    batch to the card, ``make_train_step``. One warm-up step, TRAIN_STEPS
    timed steps (the flash launches counted over these alone), then one
    profiled step; the loss must be finite and fall over the timed steps."""
    from repro_torch.launch.train import batch_to_device, make_loader
    from repro_torch.training import OptimizerConfig, TrainConfig, make_train_step
    loader = make_loader(cfg, num_seqs=4096, seq_len=seq_len, batch_seqs=batch_seqs,
                         replicas=2, transport="thallus")
    step_fn = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**TRAIN_OPT),
                                               remat=remat))
    batches = iter(loader)
    rows = []

    def one_step():
        torch.cuda.synchronize()
        transport = loader.stats.transport_s
        t = time.perf_counter()
        batch = batch_to_device(next(batches), dev)
        _, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        s = time.perf_counter() - t
        rows.append(dict(step=int(state["step"]), host_s=s, tokens_per_s=metrics["tokens"] / s,
                         transport_s=loader.stats.transport_s - transport, **metrics))

    one_step()  # warm-up: cuBLAS handles and workspaces, the loader's first pull
    for w in wrappers.values():
        w.launches = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        one_step()
        r = rows[-1]
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"[train] {label} ({batch_seqs} x {seq_len}, remat {remat}) step {r['step']}: "
            f"host {r['host_s']:.4f} s, {r['tokens_per_s']:.3f} tok/s, loss {r['loss']:.6f}, "
            f"grad_norm {r['grad_norm']:.6f}, lr {r['lr']:.3e}, loader transport_s "
            f"{r['transport_s']:.6f}, max_memory_allocated {r['max_memory_allocated']} B "
            f"smi={gpu_state()} card={card}")
    launches = {k: w.launches for k, w in wrappers.items()}
    per_step = cfg.num_layers * (2 if remat in ("full", "dots") else 1)
    if launches["flash_attention"] != TRAIN_STEPS * per_step:
        raise AssertionError(f"{label}: {launches['flash_attention']} flash launches in "
                             f"{TRAIN_STEPS} steps, expected {TRAIN_STEPS * per_step}")
    timed = rows[1:]
    losses = [r["loss"] for r in timed]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} are not finite and falling")
    prof = profile_device(f"train {label} step {int(state['step']) + 1} "
                          f"({batch_seqs} x {seq_len}, remat {remat}) card={card}", one_step)
    out = {"shape": [batch_seqs, seq_len], "remat": remat, "steps": timed,
           "warm_up": rows[0], "profiled_step": rows[-1], "profile": prof,
           "flash_launches": launches["flash_attention"],
           "median_host_s": statistics.median(r["host_s"] for r in timed),
           "median_tokens_per_s": statistics.median(r["tokens_per_s"] for r in timed)}
    log(f"[train] {label}: median host step {out['median_host_s']:.4f} s, "
        f"{out['median_tokens_per_s']:.3f} tok/s, losses {[round(x, 6) for x in losses]} "
        f"then {rows[-1]['loss']:.6f} (profiled), {launches['flash_attention']} flash launches "
        f"in the timed steps card={card}")
    return out


def check_resume(card) -> dict:
    """``python -m repro_torch.launch.train`` on reduced granite on the
    card: an uninterrupted run, a run killed after a checkpoint, and its
    resume, each into a temporary ``--ckpt-dir``; the resumed steps' losses
    equal the uninterrupted run's within 1e-6 relative. The kill falls on a
    record-batch boundary (4 training batches each): the loader's cursor
    counts record batches, as the JAX package's does."""
    import tempfile

    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as tmp:
        whole = train_main(RESUME_ARGS + ["--ckpt-dir", f"{tmp}/whole"])
        killed = train_main(RESUME_ARGS + ["--ckpt-dir", f"{tmp}/killed", "--kill-at", "4"])
        resumed = train_main(RESUME_ARGS + ["--ckpt-dir", f"{tmp}/killed"])
    got = [h["loss"] for h in killed + resumed]
    want = [h["loss"] for h in whole]
    steps = [h["step"] for h in killed + resumed]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if steps != list(range(1, 9)) or not rel <= 1e-6 or not want[-1] < want[0] - 1e-3:
        raise AssertionError(f"resume: steps {steps}, losses {got} against {want} "
                             f"(max rel err {rel:.3e}, limit 1e-6)")
    log(f"[train] kill-and-resume (reduced, {' '.join(RESUME_ARGS)}): losses {got} equal the "
        f"uninterrupted run's within {rel:.3e} relative (limit 1e-6) card={card}")
    return {"losses": got, "uninterrupted": want, "max_rel_err": rel}


def phase_train(dev, cfg, wrappers, card) -> dict:
    """Train granite-3-2b at full width and depth: the kernel-path check of
    one loss and gradient, then the launcher's pipeline at its default shape
    (remat none) and at 4 x 1024 (remat full), then the reduced
    kill-and-resume through the launcher. Returns the flash launches of the
    two shapes' timed steps under ``launches``."""
    from repro_torch.launch.train import batch_to_device, make_loader
    from repro_torch.training import OptimizerConfig, init_opt_state
    t0 = time.perf_counter()
    params = perturbed_params(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[train] {cfg.name}: {n_params} float32 parameters made in "
        f"{time.perf_counter() - t0:.2f} s card={card}")
    batch = batch_to_device(next(iter(make_loader(cfg, num_seqs=64, seq_len=1024, batch_seqs=4,
                                                  replicas=1, transport="thallus"))), dev)
    torch.cuda.reset_peak_memory_stats()
    out = {"grad_check": check_train_grads(cfg, params, batch, wrappers)}
    out["grad_check"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    g = out["grad_check"]
    log(f"[train] kernel vs plain attention, 4 x 1024, remat full: loss {g['loss']:.6f} against "
        f"{g['plain_loss']:.6f} (rel err {g['loss_rel_err']:.3e}, limit {TRAIN_LOSS_REL}); worst "
        f"gradient {g['worst_grad']} rel err {g['grad_rel_err'][g['worst_grad']]:.3e} (limit "
        f"{SERVE_REL} x max |plain|); max_memory_allocated {g['max_memory_allocated']} B "
        f"smi={gpu_state()} card={card}")
    del batch
    state = {"params": params, "opt": init_opt_state(OptimizerConfig(**TRAIN_OPT), params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    out["shapes"] = {label: train_shape(dev, cfg, state, label, *shape, wrappers, card)
                     for label, shape in TRAIN_SHAPES.items()}
    out["launches"] = {label: r["flash_launches"] for label, r in out["shapes"].items()}
    del state, params
    torch.cuda.empty_cache()
    out["resume"] = check_resume(card)
    return out


# ----------------------------------------------------------------- gateway
def gateway_for(table, dataset: str):
    """Two replicated ``ThallusServer``s holding ``table`` behind one
    ``ScanGateway`` with an admission controller and an adaptive scheduler
    whose ticket table coalesces identical scans; the gateway's clock is the
    fabric's modeled one."""
    from repro_torch.cluster import ClusterCoordinator
    from repro_torch.core import Fabric, ThallusServer
    from repro_torch.engine import Engine
    from repro_torch.qos import AdmissionController, ScanGateway
    from repro_torch.sched import AdaptiveScheduler, TicketTable
    coord = ClusterCoordinator()
    for i in range(2):
        eng = Engine()
        eng.register(dataset, table)
        coord.add_server(f"s{i}", ThallusServer(eng, Fabric()))
    coord.place_replicas(dataset, table)
    return ScanGateway(coord, admission=AdmissionController(),
                       scheduler=AdaptiveScheduler(tickets=TicketTable()), modeled_service=True)


def qos_counters(snapshot: dict) -> dict:
    return {k: v for k, v in sorted(snapshot.items()) if k.startswith(("qos.", "sched."))
            and not k.startswith("qos.class.")}


def gateway_serve(dev, cfg, wrappers, card) -> dict:
    """(e) Two ``Batcher``s (replicas of one service) fetch their prompts,
    GATEWAY_PROMPTS sequences from a token table on two replicated servers,
    with ``submit_scan``/``ingest_scan`` through one gateway: one fetch runs,
    the other rides its ticket. Both serve them on the card (the flash
    launches counted over these two runs alone); their completions must
    equal, token for token, those of a ``Batcher`` given the same rows by
    ``submit``."""
    from repro_torch.data import batch_to_tokens, make_token_table
    from repro_torch.launch.serve import timed_model
    from repro_torch.models import decode, prefill
    from repro_torch.serving import Batcher, Request
    n_seqs, seq_len = GATEWAY_PROMPTS
    table = make_token_table("prompts", n_seqs, seq_len, cfg.vocab_size, seqs_per_batch=4,
                             seed=0)
    gateway = gateway_for(table, "/prompts")
    params = perturbed_params(cfg, dev)
    prefill_fn, decode_fn, prefill_s, decode_s = timed_model(cfg, params, dev)
    replicas = [Batcher(prefill_fn, decode_fn, batch_size=GATEWAY_BATCH, device=dev)
                for _ in range(2)]
    requests = [b.submit_scan(gateway, "SELECT seq_id, tokens FROM prompts", "/prompts")
                for b in replicas]
    gateway.run()
    fetched = [b.ingest_scan(gateway, r, seq_len, max_new_tokens=GATEWAY_NEW_TOKENS)
               for b, r in zip(replicas, requests)]
    if sorted(s for _, s in fetched) != [False, True] or [n for n, _ in fetched] != [n_seqs] * 2 \
            or gateway.stats.ticket_hits != 1:
        raise AssertionError(f"gateway serve: fetches {fetched}, ticket hits "
                             f"{gateway.stats.ticket_hits}; expected one shared fetch of "
                             f"{n_seqs} prompts each")
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    done = [b.run() for b in replicas]
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    cohorts = sum(len(b.cohort_tokens) for b in replicas)
    if launches["flash_attention"] != cohorts * cfg.num_layers:
        raise AssertionError(f"gateway serve: {launches['flash_attention']} flash launches for "
                             f"{cohorts} cohorts of {cfg.num_layers} layers")
    direct = Batcher(lambda t: prefill(cfg, params, {"tokens": t}),
                     lambda c, t, p: decode(cfg, params, c, t, p),
                     batch_size=GATEWAY_BATCH, device=dev)
    rid = 0
    for rb in table.batches:
        for seq in batch_to_tokens(rb, seq_len):
            direct.submit(Request(rid, np.asarray(seq, np.int32).copy(),
                                  max_new_tokens=GATEWAY_NEW_TOKENS))
            rid += 1
    want = [(c.request_id, c.tokens) for c in direct.run()]
    for i, d in enumerate(done):
        if [(c.request_id, c.tokens) for c in d] != want:
            raise AssertionError(f"gateway serve: replica {i}'s completions differ from the "
                                 f"directly submitted rows': {d[:2]} against {want[:2]}")
    tokens = [t for _, toks in want for t in toks]
    if len(set(tokens)) < 2:
        raise AssertionError(f"gateway serve: every served token is {tokens[:1]}")
    n_tokens = sum(len(c.tokens) for d in done for c in d)
    grant_us = {name: [x * 1e6 for x in c.grant_latency_s]
                for name, c in sorted(gateway.stats.classes.items())}
    out = {"prompts": list(GATEWAY_PROMPTS), "batch": GATEWAY_BATCH,
           "new_tokens": GATEWAY_NEW_TOKENS, "fetches": fetched,
           "ticket_hits": gateway.stats.ticket_hits, "tokens": n_tokens, "seconds": seconds,
           "tokens_per_s": n_tokens / seconds, "prefill_ms": [x * 1e3 for x in prefill_s],
           "decode_ms": [x * 1e3 for x in decode_s], "modeled_grant_us": grant_us,
           "flash_launches": launches["flash_attention"]}
    log(f"[gateway] (e) serve: 2 replicas fetched {n_seqs} x {seq_len} prompts through one "
        f"gateway scan ({fetched}, ticket_hits {out['ticket_hits']}); {n_tokens} tokens in "
        f"{seconds:.4f} s ({out['tokens_per_s']:.3f} tok/s); prefill ms per cohort "
        f"{[round(x, 3) for x in out['prefill_ms']]}; decode ms per step median "
        f"{statistics.median(out['decode_ms']):.3f} ({len(decode_s)} steps); modeled grant "
        f"latency us per class {grant_us}; flash launches {launches['flash_attention']}; "
        f"completions equal a direct submit's token for token smi={gpu_state()} card={card}")
    del params, replicas, direct
    torch.cuda.empty_cache()
    return out


def check_compression_leaf(dev, params, card) -> dict:
    """``compress_decompress`` of one full-size stacked leaf's shape (a
    seeded gradient of unit-normal x 1e-3 and error feedback x 1e-5) on the
    card against the same on the CPU, bit for bit; then the card's in-place
    pass is timed by ``Timer`` (its work does not depend on the values, so
    each call may take the last one's output)."""
    from repro_torch.training.compression import compress_decompress, compress_decompress_
    name, leaf = max((("layers/mlp/" + k, v) for k, v in params["layers"]["mlp"].items()),
                     key=lambda nt: nt[1].numel())
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(leaf.shape, generator=gen, device=dev).mul_(1e-3)
    ef = torch.randn(leaf.shape, generator=gen, device=dev).mul_(1e-5)
    want_deq, want_ef = compress_decompress(g.cpu(), ef.cpu())
    deq = compress_decompress_(g, ef)
    same_bits(f"compress_decompress {name} deq, card vs CPU", deq.cpu(), want_deq)
    same_bits(f"compress_decompress {name} ef, card vs CPU", ef.cpu(), want_ef)
    del want_deq, want_ef
    timer = Timer(dev, reps=5)
    ms = timer.ms(lambda: compress_decompress_(g, ef))
    # read g and ef once, write deq and the new ef once: four float32 leaves
    out = {"leaf": name, "shape": list(leaf.shape), "ms": ms, "bit_equal": True,
           "bound_ms": bound_ms(16 * leaf.numel())}
    log(f"[gateway] compress_decompress of {name} {tuple(leaf.shape)} on the card equals the "
        f"CPU's bit for bit (deq and ef); {ms:.3f} ms on the card (one leaf, in place; byte "
        f"bound {out['bound_ms']:.3f} ms; median of 5) smi={timer.smi} card={card}")
    del g, ef, deq, timer
    torch.cuda.empty_cache()
    return out


def gateway_train(dev, cfg, wrappers, card, plain: dict) -> dict:
    """(f) The launcher's default shape (8 x 128, remat none) trained with
    ``compress_dp_grads=True`` from ``ThallusLoader(transport="gateway")``
    over the launcher's token table on two replicated servers behind a
    gateway. Its batches must equal a solo ``thallus`` loader's, bit for
    bit; one warm-up step, TRAIN_STEPS timed steps, one profiled step (the
    compression pass in its own range). ``plain`` is phase 5's run at this
    shape: the same seeded weights and the same batches, uncompressed. The
    warm-up step's loss is taken before any update, so it must equal
    ``plain``'s; the losses must be finite, and the last timed one below
    it. Each step sees new sequences, and after the first update the loss
    varies from batch to batch by more than the next three steps lower it,
    with compression and without; so the fall is read against the loss at
    the seeded weights."""
    from repro_torch.data import ThallusLoader, make_token_table
    from repro_torch.launch.train import batch_to_device, make_loader
    from repro_torch.training import (OptimizerConfig, TrainConfig, init_error_feedback,
                                      init_opt_state, make_train_step)
    batch_seqs, seq_len, remat = TRAIN_SHAPES["c_default"]
    table = make_token_table("tokens", 4096, seq_len, cfg.vocab_size,
                             seqs_per_batch=max(batch_seqs * 4, 32))
    gateway = gateway_for(table, "/data/tokens")
    loader = ThallusLoader([], "SELECT tokens FROM tokens", "/data/tokens", seq_len=seq_len,
                           batch_seqs=batch_seqs, transport="gateway", gateway=gateway,
                           client_id="trainer")
    solo = iter(make_loader(cfg, num_seqs=4096, seq_len=seq_len, batch_seqs=batch_seqs,
                            replicas=2, transport="thallus"))
    params = perturbed_params(cfg, dev)
    out = {"compress_leaf": check_compression_leaf(dev, params, card)}
    tcfg = TrainConfig(optimizer=OptimizerConfig(**TRAIN_OPT), remat=remat,
                       compress_dp_grads=True)
    state = {"params": params, "opt": init_opt_state(tcfg.optimizer, params),
             "ef": init_error_feedback(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step_fn = make_train_step(cfg, tcfg)
    batches = iter(loader)
    rows = []

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = next(batches)
        want = next(solo)
        for k in ("tokens", "labels"):
            if not np.array_equal(host[k], want[k]) or host[k].dtype != want[k].dtype:
                raise AssertionError(f"gateway loader batch {len(rows)} {k} differs from a "
                                     f"solo thallus loader's")
        _, metrics = step_fn(state, batch_to_device(host, dev))
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        s = time.perf_counter() - t
        rows.append(dict(step=int(state["step"]), host_s=s, tokens_per_s=metrics["tokens"] / s,
                         **metrics))

    one_step()
    for w in wrappers.values():
        w.launches = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        one_step()
        r = rows[-1]
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"[gateway] (f) train {batch_seqs} x {seq_len} remat {remat} compress_dp_grads step "
            f"{r['step']}: host {r['host_s']:.4f} s, {r['tokens_per_s']:.3f} tok/s, loss "
            f"{r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, max_memory_allocated "
            f"{r['max_memory_allocated']} B smi={gpu_state()} card={card}")
    launches = wrappers["flash_attention"].launches
    if launches != TRAIN_STEPS * cfg.num_layers:
        raise AssertionError(f"gateway train: {launches} flash launches in {TRAIN_STEPS} steps")
    timed = rows[1:]
    losses = [r["loss"] for r in rows]
    init_loss, plain_init = rows[0]["loss"], plain["warm_up"]["loss"]
    if not abs(init_loss - plain_init) <= 1e-6 * abs(plain_init):
        raise AssertionError(f"gateway train: loss at the seeded weights {init_loss} != phase "
                             f"5's {plain_init} on the same batch")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gateway train: losses {losses} are not finite and falling")
    prof = profile_device(f"gateway train step {int(state['step']) + 1} ({batch_seqs} x "
                          f"{seq_len}, remat {remat}, compress_dp_grads) card={card}", one_step)
    ef_max = max(float(e.abs().max()) for e in leaves(state["ef"]))
    if not 0 < ef_max < float("inf"):
        raise AssertionError(f"gateway train: error feedback max {ef_max}")
    counters = qos_counters(loader.metrics().snapshot())
    out.update(steps=timed, warm_up=rows[0], profiled_step=rows[-1], profile=prof,
               flash_launches=launches, loader_batches_checked=len(rows),
               shared_scans=loader.stats.shared_scans, ef_max=ef_max, counters=counters,
               median_host_s=statistics.median(r["host_s"] for r in timed),
               median_tokens_per_s=statistics.median(r["tokens_per_s"] for r in timed),
               peak_memory=max(r["max_memory_allocated"] for r in timed))
    plain_losses = [plain["warm_up"]["loss"]] + [r["loss"] for r in plain["steps"]] + \
        [plain["profiled_step"]["loss"]]
    out["plain_losses"] = plain_losses
    log(f"[gateway] (f) median host step {out['median_host_s']:.4f} s, "
        f"{out['median_tokens_per_s']:.3f} tok/s, losses (warm-up, timed, profiled) "
        f"{[round(r['loss'], 6) for r in rows]} against phase 5's uncompressed "
        f"{[round(x, 6) for x in plain_losses]} on the same batches; compression {prof['compression_ms']:.3f} ms, "
        f"optimizer {prof['optimizer_ms']:.3f} ms of device time, idle share "
        f"{prof['idle_share']}; peak {out['peak_memory']} B; {len(rows)} loader batches equal a "
        f"solo thallus loader's; max |ef| {ef_max:.3e} card={card}")
    log(f"[gateway] (f) loader.metrics() qos/sched counters: {json.dumps(counters)}")
    del state, params, step_fn
    torch.cuda.empty_cache()
    return out


def phase_gateway(dev, cfg, wrappers, card, plain: dict) -> dict:
    """Phase 6: serve (e) and train (f) through the qos gateway, one
    full-width model on the card at a time; ``plain`` is phase 5's run at
    (f)'s shape. Returns the flash launches of each under ``launches``."""
    out = {"serve": gateway_serve(dev, cfg, wrappers, card),
           "train": gateway_train(dev, cfg, wrappers, card, plain)}
    out["launches"] = {"gateway_serve": out["serve"]["flash_launches"],
                       "gateway_train": out["train"]["flash_launches"]}
    return out


# ---------------------------------------------------------------- mesh
MESH_SETS = ("a_defaults", "b_long_prompts")
MESH_TRAIN = (8, 128)          # phase 5's (c) shape


def one_rank_group(dev):
    """A one-rank NCCL process group from an in-process ``HashStore`` (no
    network, no port) and its ``make_host_mesh()``, which must be (1, 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_host_mesh()
    if tuple(mesh.mesh.shape) != (1, 1) or mesh.mesh_dim_names != ("data", "model"):
        raise AssertionError(f"make_host_mesh on one rank gave {mesh}")
    return mesh


def mesh_serve(cfg, params, dparams, mesh, served: dict, wrappers, dev) -> dict:
    """Phase 2's request sets served through ``launch.serve.serve`` on the
    DTensor parameters under the mesh: the same tokens, flash once per layer
    per cohort. Then each cohort's prefill on DTensors against the same
    prefill on plain tensors, logits and every cache leaf within SERVE_REL
    (bit for bit expected: a (1, 1) mesh runs every op on the whole
    tensor)."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import prefill
    from repro_torch.models.sharding import make_rules, mesh_context
    sets = {"a_defaults": (make_requests(cfg, 8, 12, 8), 4),
            "b_long_prompts": (make_requests(cfg, 4, 1024, 8, min_len=900, seed=1), 4)}
    serve(cfg, dparams, make_requests(cfg, 1, 4, 2, seed=2), 1, dev, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    wrappers["flash_attention"].launches = 0
    results = {label: serve(cfg, dparams, reqs, bs, dev, mesh=mesh)
               for label, (reqs, bs) in sets.items()}
    launches = wrappers["flash_attention"].launches
    cohorts = sum(len(r.cohort_tokens) for r in results.values())
    if launches != cohorts * cfg.num_layers:
        raise AssertionError(f"mesh serve: flash launched {launches} times, expected "
                             f"{cohorts} cohorts x {cfg.num_layers} layers")
    out = {"flash_launches": launches, "sets": {}}
    for label, res in results.items():
        got = [c.tokens for c in res.completions]
        if got != served[label]:
            raise AssertionError(f"mesh serve {label}: tokens {got} != phase 2's {served[label]}")
        errs, exact = [], True
        for toks in res.cohort_tokens:
            tokens = torch.from_numpy(toks).to(dev)
            want_logits, want_cache = prefill(cfg, params, {"tokens": tokens})
            with mesh_context(mesh, make_rules(cfg, mesh)):
                logits, cache = prefill(cfg, dparams, {"tokens": tokens})
            logits = logits.full_tensor()
            cache = {k: v.full_tensor() for k, v in cache.items()}
            e = {"logits": rel_err(logits[..., :cfg.vocab_size],
                                   want_logits[..., :cfg.vocab_size]),
                 **{k: rel_err(cache[k], want_cache[k]) for k in want_cache}}
            exact = exact and torch.equal(logits, want_logits) and all(
                torch.equal(cache[k], want_cache[k]) for k in want_cache)
            bad = {k: v for k, v in e.items() if not v <= SERVE_REL}
            if bad:
                raise AssertionError(f"mesh serve {label} cohort {tuple(toks.shape)}: DTensor vs "
                                     f"plain prefill beyond {SERVE_REL}: {bad}")
            errs.append(e)
            del want_logits, want_cache, logits, cache
        decode_ms = [x * 1e3 for x in res.decode_s]
        out["sets"][label] = {"tokens": res.num_tokens, "seconds": res.seconds,
                              "tokens_per_s": res.num_tokens / res.seconds,
                              "prefill_ms": [x * 1e3 for x in res.prefill_s],
                              "decode_ms_median": statistics.median(decode_ms),
                              "prefill_vs_plain": errs, "bit_equal": exact}
        log(f"[mesh] {cfg.name} {label} on DTensors: {res.num_tokens} tokens equal to phase 2's in "
            f"{res.seconds:.4f} s ({res.num_tokens / res.seconds:.3f} tok/s); prefill ms "
            f"{[round(x * 1e3, 3) for x in res.prefill_s]}; decode ms per step median "
            f"{statistics.median(decode_ms):.3f}; prefill vs plain tensors max rel err "
            f"{max(max(e.values()) for e in errs):.3e} (limit {SERVE_REL}), bit for bit "
            f"{exact} smi={gpu_state()}")
    return out


def mesh_decode_cost(cfg, params, dparams, mesh, dev) -> dict:
    """One decode step of set (a)'s shape on plain tensors and on DTensors:
    host ms (median of 9, each to a synchronize) and device kernels
    launched (a profiler window). The gap is DTensor's dispatch on the
    host, which every rank of a many-card run pays."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import decode, init_cache, prefill
    from repro_torch.models.sharding import make_rules, mesh_context
    toks = np.stack([r.prompt[:4] for r in make_requests(cfg, 4, 12, 8)])
    tokens = torch.from_numpy(toks).to(dev)
    step = tokens[:, -1:]
    out = {}
    for name, p, ctx in (("plain", params, None), ("dtensor", dparams, mesh)):
        def run():
            if ctx is None:
                return decode(cfg, p, grown, step, 4)
            with mesh_context(ctx, make_rules(cfg, ctx)):
                return decode(cfg, p, grown, step, 4)
        cache = prefill(cfg, params, {"tokens": tokens})[1]
        grown = init_cache(cfg, 4, 5, dtype=torch.float32, device=dev)
        for k in grown:
            grown[k][:, :, :4] = cache[k]
        if ctx is not None:
            from repro_torch.models import cache_pspecs, shard_params
            grown = shard_params(grown, cache_pspecs(cfg, grown, ctx), ctx)
        run()
        ms = []
        for _ in range(9):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        prof = profile_device(f"{cfg.name} decode step on {name} tensors", run)
        out[name] = {"host_ms": statistics.median(ms),
                     "launches": sum(v for k, v in prof.items() if k.endswith("_launches")),
                     "device_busy_ms": prof["device_busy_ms"]}
        del cache, grown
    log(f"[mesh] {cfg.name} decode step (4 rows at position 4): plain tensors "
        f"{out['plain']['host_ms']:.3f} ms host, {out['plain']['launches']} kernel launches; "
        f"DTensors {out['dtensor']['host_ms']:.3f} ms host, {out['dtensor']['launches']} "
        f"kernel launches smi={gpu_state()}")
    return out


def mesh_train(cfg, params, dparams, mesh, dev) -> dict:
    """(c) 8 x 128: the loss and gradient on DTensors under the mesh against
    the same on plain tensors, phase 5's limits (loss TRAIN_LOSS_REL, each
    gradient leaf SERVE_REL x max |plain leaf|); then one whole train step
    (AdamW) on a DTensor train state, whose loss is held to the plain loss
    too."""
    from repro_torch.models.sharding import make_rules, mesh_context
    from repro_torch.training import (OptimizerConfig, TrainConfig, global_norm,
                                      init_opt_state, make_train_step)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (MESH_TRAIN[0], MESH_TRAIN[1] + 1)).astype(np.int64)
    tokens = torch.from_numpy(toks[:, :-1].copy()).to(dev)
    labels = torch.from_numpy(toks[:, 1:].copy()).to(dev)
    batch = {"tokens": tokens, "labels": labels}
    want_loss, want = train_grads(cfg, params, batch, "none")
    want_norm = float(global_norm(want))
    with mesh_context(mesh, make_rules(cfg, mesh)):
        loss, grads = train_grads(cfg, dparams, batch, "none")
    loss_err = abs(float(loss.full_tensor()) - float(want_loss)) / abs(float(want_loss))
    errs = {}
    for name, w in want.items():
        g = grads[name].full_tensor() if hasattr(grads[name], "full_tensor") else grads[name]
        errs[name] = float((g - w).abs().max()) / float(w.abs().max())
    worst = max(errs, key=errs.get)
    del want, grads
    if not loss_err <= TRAIN_LOSS_REL or errs[worst] > SERVE_REL:
        raise AssertionError(f"mesh train: DTensor vs plain loss rel err {loss_err:.3e} (limit "
                             f"{TRAIN_LOSS_REL}), worst gradient {worst} {errs[worst]:.3e} "
                             f"(limit {SERVE_REL})")
    tc = TrainConfig(optimizer=OptimizerConfig(**TRAIN_OPT), remat="none")
    state = {"params": dparams, "opt": init_opt_state(tc.optimizer, dparams),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tuple(state["opt"]["m"]["embed"].placements) != tuple(dparams["embed"].placements):
        raise AssertionError("optimizer state not placed like the parameters")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with mesh_context(mesh, make_rules(cfg, mesh)):
        state, metrics = make_train_step(cfg, tc)(state, batch)
        step_loss = float(metrics["loss"].full_tensor())
        gnorm = float(metrics["grad_norm"].full_tensor())
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    step_err = abs(step_loss - float(want_loss)) / abs(float(want_loss))
    norm_err = abs(gnorm - want_norm) / want_norm
    if not step_err <= TRAIN_LOSS_REL or not norm_err <= SERVE_REL:
        raise AssertionError(f"mesh train step: loss rel err {step_err:.3e} (limit "
                             f"{TRAIN_LOSS_REL}), gradient norm rel err {norm_err:.3e} "
                             f"(limit {SERVE_REL})")
    out = {"loss": float(loss.full_tensor()), "plain_loss": float(want_loss),
           "loss_rel_err": loss_err, "worst_grad": worst, "worst_grad_rel_err": errs[worst],
           "step_loss": step_loss, "grad_norm": gnorm, "plain_grad_norm": want_norm,
           "step_s": step_s, "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[mesh] {cfg.name} train {MESH_TRAIN[0]} x {MESH_TRAIN[1]} on DTensors: loss "
        f"{out['loss']:.6f} vs plain {out['plain_loss']:.6f} (rel err {loss_err:.3e}, limit "
        f"{TRAIN_LOSS_REL}); worst gradient {worst} rel err {errs[worst]:.3e} (limit "
        f"{SERVE_REL}); one AdamW step on the DTensor state in {step_s:.4f} s, its loss "
        f"{step_loss:.6f}, gradient norm {gnorm:.6f} vs plain {want_norm:.6f}; peak "
        f"{out['peak_bytes']} B smi={gpu_state()}")
    del state, metrics
    return out


def mesh_pod_reduce(dev) -> dict:
    """``compressed_psum_pod`` over a one-pod mesh against
    ``compress_decompress``, bit for bit: at one pod the payload is the
    pod's own int8 values and the mean scale its own scale."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import compress_decompress, compressed_psum_pod
    pod = make_mesh((1,), ("pod",))
    g = torch.Generator(device=dev).manual_seed(3)
    grads = {"embed": torch.randn((49152, 2048), generator=g, device=dev),
             "ln": torch.randn((2048,), generator=g, device=dev) * 1e-3}
    ef = {k: 1e-2 * torch.randn(v.shape, generator=g, device=dev) for k, v in grads.items()}
    mean, new_ef = compressed_psum_pod(grads, ef, pod)
    for k in grads:
        deq, want_ef = compress_decompress(grads[k], ef[k])
        same_bits(f"compressed_psum_pod {k} mean", mean[k], deq)
        same_bits(f"compressed_psum_pod {k} error feedback", new_ef[k], want_ef)
    log(f"[mesh] compressed_psum_pod over a one-pod mesh equals compress_decompress bit for "
        f"bit on {sum(v.numel() for v in grads.values())} elements smi={gpu_state()}")
    return {"elements": sum(v.numel() for v in grads.values()), "bit_equal": True}


def phase_mesh(dev, wrappers, serve_out: dict) -> dict:
    """Phase 10: granite-3-2b at full width and depth served and trained as
    DTensors on the one-rank mesh, against phase 2's tokens and the same
    calls on plain tensors; the cross-pod reduce at one pod; the host cost
    of DTensor dispatch in a decode step."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import param_specs, shard_params
    t0 = time.perf_counter()
    mesh = one_rank_group(dev)
    try:
        cfg = get_config(ARCH)
        params = perturbed_params(cfg, dev)
        dparams = shard_params(params, param_specs(cfg, params, mesh), mesh)
        torch.cuda.synchronize()
        log(f"[mesh] {cfg.name}: parameters placed by param_specs on mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} in "
            f"{time.perf_counter() - t0:.2f} s; embed {dparams['embed'].placements}, "
            f"torch.cuda.memory_allocated {torch.cuda.memory_allocated()} B smi={gpu_state()}")
        served = {label: serve_out["sets"][label]["served"] for label in MESH_SETS}
        out = {"serve": mesh_serve(cfg, params, dparams, mesh, served, wrappers, dev)}
        launches = out["serve"]["flash_launches"]
        out["decode_cost"] = mesh_decode_cost(cfg, params, dparams, mesh, dev)
        torch.cuda.reset_peak_memory_stats()
        out["train"] = mesh_train(cfg, params, dparams, mesh, dev)
        del params, dparams
        torch.cuda.empty_cache()
        out["pod_reduce"] = mesh_pod_reduce(dev)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["launches"] = {"flash_attention": launches}
    out["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase 10 in {out['seconds']:.2f} s smi={gpu_state()}")
    return out


# ---------------------------------------------------------------- cost
def count_on(fn, *args) -> dict:
    """``fn(*args)`` under the port's cost counter: FLOPs, transcendentals,
    both byte accountings, product FLOPs and collective bytes."""
    from repro_torch.utils import cost
    with cost.Counter() as c:
        fn(*args)
    unfused, fused = c.cost(), c.cost(cost.FUSED_ATTENTION_FNS)
    return {"flops": unfused.flops, "transcendentals": unfused.transcendentals,
            "bytes": unfused.bytes, "fused_bytes": fused.bytes,
            "product_flops": c.product_flops,
            "collective_wire_bytes": unfused.collective_wire_bytes}


def synced_median_s(call, runs: int = 3) -> float:
    """The median host seconds of ``runs`` calls, each between two
    synchronizes."""
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def roofline_line(label: str, counted: dict, model_flops: float,
                  measured: list[tuple[str, float]], card: str) -> dict:
    """The roofline of a counted call at the float32 peak, in both byte
    accountings, and its bound over each measured time in ``measured``
    (what was timed, seconds)."""
    from repro_torch.utils.roofline import PEAK_FLOPS_FP32, Roofline
    out = {"counted": counted}
    for acc, key in (("unfused", "bytes"), ("fused", "fused_bytes")):
        r = Roofline(counted["flops"], counted[key], counted["collective_wire_bytes"],
                     model_flops, peak_flops=PEAK_FLOPS_FP32)
        out[acc] = r.to_dict()
    r = out["unfused"]
    line = (f"[roofline] {label}: {counted['flops']:.6e} FLOP ({counted['product_flops']:.6e} in "
            f"products), {counted['transcendentals']:.6e} transcendentals, {counted['bytes']:.6e} B "
            f"({counted['fused_bytes']:.6e} B fused); compute_s {r['compute_s']:.6f}, memory_s "
            f"{r['memory_s']:.6f} ({out['fused']['memory_s']:.6f} fused), bottleneck "
            f"{r['bottleneck']}; model_flops {model_flops:.6e} (useful ratio "
            f"{r['useful_flops_ratio']:.4f}); mfu_bound at the float32 peak "
            f"{r['mfu_bound']:.4f}")
    out["measured"] = []
    for what, secs in measured:
        m = {"what": what, "s": secs, "bound_over_measured": r["step_s"] / secs,
             "fp32_peak_share": counted["flops"] / (secs * PEAK_FLOPS_FP32)}
        out["measured"].append(m)
        line += (f"; {what} {secs:.6f} s, bound / measured {m['bound_over_measured']:.4f}, "
                 f"share of the float32 peak {m['fp32_peak_share']:.4f}")
    log(f"{line} card={card}")
    return out


def phase_cost(dev, cfg, wrappers, serve_out: dict, train_out: dict, card: str) -> dict:
    """Phase 11: count granite-3-2b's set-(b) cohort prefill and one (c)
    train step (8 x 128, remat none, AdamW) at full width with the port's
    cost counter, on the card (untimed, the flash kernel on) and on the meta
    device; the two counts must be equal. Prints the ``[roofline]`` lines
    at the float32 peak beside the counted call's own time (the median of
    three more runs on the same device-resident inputs, each between two
    synchronizes), and beside phase 4's prefill ms and phase 5's median
    step, whose host times also hold the loader and the batch's copy."""
    from repro_torch.launch.train import batch_to_device, make_loader
    from repro_torch.models import prefill
    from repro_torch.training import (OptimizerConfig, TrainConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.utils.cost import on_meta
    from repro_torch.utils.roofline import model_flops
    t0 = time.perf_counter()
    b = serve_out["sets"]["b_long_prompts"]
    seq = b["prompt_lens"][0]
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, seq)).astype(np.int32)).to(dev)
    params = perturbed_params(cfg, dev)
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**TRAIN_OPT),
                                            remat="none"))
    batch_seqs, seq_len, _ = TRAIN_SHAPES["c_default"]
    batch = batch_to_device(next(iter(make_loader(cfg, num_seqs=64, seq_len=seq_len,
                                                  batch_seqs=batch_seqs, replicas=1,
                                                  transport="thallus"))), dev)
    n = cfg.num_params(active_only=True)
    out, launches = {}, {}

    def count_both(label, run, meta_run, mf, phase_s, phase_what):
        wrappers["flash_attention"].launches = 0
        card_count = count_on(run)
        torch.cuda.synchronize()
        launches[label] = wrappers["flash_attention"].launches
        meta_count = count_on(meta_run)
        if card_count != meta_count:
            raise AssertionError(f"cost {label}: the card counts {card_count}, the meta "
                                 f"device {meta_count}")
        if launches[label] != cfg.num_layers:
            raise AssertionError(f"cost {label}: {launches[label]} flash launches under the "
                                 f"counter, expected {cfg.num_layers}")
        log(f"[cost] {label}: card and meta counts equal ({card_count['flops']:.6e} FLOP, "
            f"{card_count['bytes']:.6e} B, {card_count['fused_bytes']:.6e} B fused); "
            f"{launches[label]} flash launches on the card smi={gpu_state()} card={card}")
        measured = [("the counted call, median of 3", synced_median_s(run)),
                    (phase_what, phase_s)]
        out[label] = roofline_line(label, card_count, mf, measured, card)

    meta_params = on_meta(params)
    count_both("b_prefill", lambda: prefill(cfg, params, {"tokens": tokens}),
               lambda: prefill(cfg, meta_params, {"tokens": on_meta(tokens)}),
               model_flops(n, tokens.numel(), "prefill"), b["prefill_ms"][0] / 1e3,
               "phase 4's (b) prefill")
    state = {"params": params, "opt": init_opt_state(OptimizerConfig(**TRAIN_OPT), params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    meta_state = on_meta(state)
    count_both("c_train_step", lambda: step(state, batch),
               lambda: step(meta_state, on_meta(batch)),
               model_flops(n, batch["tokens"].numel(), "train"),
               train_out["shapes"]["c_default"]["median_host_s"],
               "phase 5's (c) median host step")
    del params, meta_params, state, meta_state, batch, tokens
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"[cost] phase 11 in {out['seconds']:.2f} s smi={gpu_state()}")
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


DECODE_HOST_STEPS = 30         # decode steps per median in --decode-host


def decode_host(other: Path) -> int:
    """``--decode-host DIR``: one decode step of granite-3-2b at full width
    and depth (float32, :func:`perturbed_params`; 4 rows at position 4, as
    set (a)'s cohorts) through DIR's port and this one's, in turns (DIR,
    this, this, DIR), each with its own config object, on the same weights
    and cache: host ms per step to a synchronize (median of
    ``DECODE_HOST_STEPS``), as phase 2 times a served step; then the host ms
    of the call alone, the two in turns call by call (:func:`host_ms`),
    which is the device time once the launch queue fills. The last line
    holds both."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[decode-host] nvidia-smi: {smi}")
    import_port(other, "other_port")
    pkgs = {"other": "other_port", "this": "repro_torch"}
    models = {k: importlib.import_module(f"{v}.models") for k, v in pkgs.items()}
    cfgs = {k: importlib.import_module(f"{v}.configs").get_config(ARCH) for k, v in pkgs.items()}
    dev = torch.device("cuda")
    params = perturbed_params(cfgs["this"], dev)
    cache = models["this"].init_cache(cfgs["this"], 4, 5, dtype=torch.float32, device=dev)
    step = torch.randint(0, cfgs["this"].vocab_size, (4, 1),
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    calls = {k: (lambda k=k: models[k].decode(cfgs[k], params, cache, step, 4)) for k in pkgs}
    want = calls["other"]()[0]
    log(f"[decode-host] decode logits, this port against DIR's: max abs difference "
        f"{float((calls['this']()[0] - want).abs().max())} of max |logit| "
        f"{float(want.abs().max())}")
    rows = []
    for label in ("other", "this", "this", "other"):
        for _ in range(3):
            calls[label]()
        ms = []
        for _ in range(DECODE_HOST_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            calls[label]()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        tree = str(Path(models[label].__file__).resolve().parents[3])
        rows.append({"port": label, "tree": tree, "step_ms": statistics.median(ms),
                     "step_ms_min": min(ms), "step_ms_max": max(ms)})
        log(f"[decode-host] {label} ({tree}) {ARCH} decode step, 4 rows at position 4, to a "
            f"synchronize: median {rows[-1]['step_ms']:.3f} ms (min {min(ms):.3f}, max "
            f"{max(ms):.3f}, {DECODE_HOST_STEPS} steps) smi={gpu_state()}")
    out = {"decode_host": rows, "call_ms_in_turns": []}
    for pair in (("other", "this"), ("this", "other")):
        ms = dict(zip(pair, host_ms(*(calls[k] for k in pair), calls=DECODE_HOST_STEPS)))
        out["call_ms_in_turns"].append(ms)
        log(f"[decode-host] host ms per decode call without a synchronize, the two ports in "
            f"turns ({DECODE_HOST_STEPS} calls each): this {ms['this']:.3f}, "
            f"other {ms['other']:.3f}")
    print(smi)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--one-column", nargs="?", const=True, type=Path, metavar="DIR",
                    help="only time the one-column take route of this checkout's port and, "
                         "in turns in one process, of the port in checkout DIR")
    ap.add_argument("--decode-host", type=Path, metavar="DIR",
                    help="only time phase 2's plain decode step through the port in "
                         "checkout DIR and this one's, in turns in one process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    other = args.one_column.resolve() if isinstance(args.one_column, Path) else None
    if args.decode_host is not None:
        other = args.decode_host.resolve()
    for tree in (ROOT, other):
        if tree is not None and not (tree / "src" / "repro_torch").is_dir():
            print(f"chip_smoke: {tree} holds no src/repro_torch; run from a checkout",
                  file=sys.stderr)
            return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.one_column:
        return one_column(other)
    if args.decode_host is not None:
        return decode_host(other)
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
    flash_paths = {"serve": serve_out["launches"]["flash_attention"]}
    if flash_paths["serve"] != expected:
        raise AssertionError(f"flash_attention launched {flash_paths['serve']} times "
                             f"on the served path, expected {expected}")
    train_out = phase_train(dev, cfg, wrappers, setup["smi"])
    flash_paths.update({f"train_{k}": n for k, n in train_out["launches"].items()})
    gateway_out = phase_gateway(dev, cfg, wrappers, setup["smi"],
                                train_out["shapes"]["c_default"])
    flash_paths.update(gateway_out["launches"])
    families_out = phase_families(dev, wrappers)
    flash_paths.update({f"serve_{arch}": r["launches"]["flash_attention"]
                        for arch, r in families_out.items()})
    ssm_out = phase_ssm(dev, wrappers)
    flash_paths.update({f"serve_{arch}": r["launches"]["flash_attention"]
                        for arch, r in ssm_out.items()})
    audio_out = phase_audio(dev, wrappers)
    flash_paths.update({f"{path}_{AUDIO_ARCH}": n for path, n in audio_out["launches"].items()})
    mesh_out = phase_mesh(dev, wrappers, serve_out)
    flash_paths["mesh_serve"] = mesh_out["launches"]["flash_attention"]
    cost_out = phase_cost(dev, cfg, wrappers, serve_out, train_out, setup["smi"])
    flash_paths.update({f"cost_{k}": n for k, n in cost_out["launches"].items()})
    launches["flash_attention"] = sum(flash_paths.values())

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
            row.update(launches_by_path=flash_paths, train_default_shape={
                           k: t["train_default"][k] for k in ("shape", "ms", "plain_ms",
                                                              "library_ms", "bound_ms")},
                       family_shapes={arch: {k: r[k] for k in ("shape", "ms", "plain_ms",
                                                               "library_ms", "bound_ms",
                                                               "bound_by")}
                                      for arch, r in t["families"].items()},
                       max_abs_err=att_err["float32"], bf16_max_abs_err=att_err["bfloat16"],
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
    phases = {"slice": slice_out, "serve": serve_out, "train": train_out,
              "gateway": gateway_out, "families": families_out, "ssm": ssm_out,
              "audio": audio_out, "mesh": mesh_out, "cost": cost_out}
    log(f"[report] build_s={setup['build_s']:.3f} total_s={time.perf_counter() - t_start:.2f} "
        f"phases={json.dumps(phases)}")
    print(json.dumps({"kernels": report}))
    print(setup["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
