"""Serving launcher: the port of :mod:`repro.launch.serve`. Batched greedy
inference on the card, results returned as record batches over the Thallus
transport.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --reduced --requests 8 --max-new 12 [--device cpu]

The flags are the JAX launcher's, plus ``--device`` (default ``cuda``).
Weights are drawn from seed 0 as the JAX launcher draws its own, so the norm
weights are zero, as there (see ROADMAP.md, faults of the reference).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import ArchConfig
from ..core import Fabric, ThallusTransport
from ..core.recordbatch import RecordBatch
from ..core.transport import TransportStats
from ..device import resolve
from ..models import decode, init_params, prefill
from ..serving import Batcher, Completion, Request, completions_to_batch


@dataclasses.dataclass
class ServeResult:
    completions: list[Completion]
    seconds: float                   # the whole batcher run
    prefill_s: list[float]           # per cohort, prefill to first tokens on the host
    decode_s: list[float]            # per decode step, to its tokens on the host
    cohort_tokens: list[np.ndarray]  # each cohort's left-padded prompts
    delivered: RecordBatch           # the response batch, after the transport
    transport: TransportStats

    @property
    def num_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.completions)


def make_requests(cfg: ArchConfig, num: int, prompt_len: int, max_new: int, *,
                  min_len: int = 4, seed: int = 0) -> list[Request]:
    """``num`` requests with prompts of ``min_len``..``prompt_len`` tokens
    drawn from ``seed``; the JAX launcher's draws for ``min_len=4``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        plen = int(rng.integers(min_len, prompt_len + 1))
        out.append(Request(request_id=i,
                           prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                           max_new_tokens=max_new))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_model(cfg: ArchConfig, params, device: torch.device):
    """A ``Batcher``'s ``prefill_fn`` and ``decode_fn`` for ``params``, and
    the lists they append each call's host seconds to (up to a synchronize
    on the card): ``(prefill_fn, decode_fn, prefill_s, decode_s)``."""
    prefill_s, decode_s = [], []

    def prefill_fn(tokens):
        t = time.perf_counter()
        out = prefill(cfg, params, {"tokens": tokens})
        _sync(device)
        prefill_s.append(time.perf_counter() - t)
        return out

    def decode_fn(cache, tokens, position):
        t = time.perf_counter()
        out = decode(cfg, params, cache, tokens, position)
        _sync(device)
        decode_s.append(time.perf_counter() - t)
        return out

    return prefill_fn, decode_fn, prefill_s, decode_s


def serve(cfg: ArchConfig, params, requests: list[Request], batch_size: int,
          device=None) -> ServeResult:
    """Serve ``requests`` with ``params`` on ``device`` and send the
    completions through ``ThallusTransport(Fabric())``."""
    device = resolve(device)
    prefill_fn, decode_fn, prefill_s, decode_s = timed_model(cfg, params, device)
    batcher = Batcher(prefill_fn, decode_fn, batch_size=batch_size, device=device)
    for r in requests:
        batcher.submit(r)
    t0 = time.perf_counter()
    completions = batcher.run()
    seconds = time.perf_counter() - t0
    delivered, stats = ThallusTransport(Fabric()).send_batch(completions_to_batch(completions))
    return ServeResult(completions, seconds, prefill_s, decode_s, batcher.cohort_tokens,
                       delivered, stats)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("serve example covers LM families; vlm/audio need "
                         "frontend inputs — see examples/")
    # float32 products in full float32, as the JAX package computes them
    # (PyTorch's default; TF32 would keep about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    res = serve(cfg, params, make_requests(cfg, args.requests, args.prompt_len,
                                           args.max_new),
                args.batch_size, device)
    dt = res.seconds
    print(f"served {len(res.completions)} requests, {res.num_tokens} tokens "
          f"in {dt:.2f}s ({res.num_tokens / max(dt, 1e-9):.1f} tok/s) on {device}")
    print(f"response batch: {res.delivered.num_rows} rows, "
          f"{res.delivered.nbytes} bytes, transport {res.transport.total_s * 1e6:.1f}us "
          f"(zero serialize copies: {res.transport.serialize_s == 0.0})")
    for c in res.completions[:4]:
        print(f"  req {c.request_id}: {c.tokens}")


if __name__ == "__main__":
    main()
