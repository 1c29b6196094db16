"""Request batcher for serving: the port of :mod:`repro.serving.batcher`.

Aligned-cohort batching, as in the JAX package: prompts padded left to a
common length, prefilled once, decoded in lockstep (the decode step is
batch-uniform), retired on EOS or ``max_new_tokens``; responses leave as
record batches over the Thallus transport.

Prompt ingestion rides the qos gateway, as in the JAX package:
:meth:`Batcher.submit_scan` turns a prompt-table query into one logical
:class:`~repro_torch.qos.ScanRequest`, and :meth:`Batcher.ingest_scan` feeds
the reassembled token batches of its result to :meth:`Batcher.ingest_batches`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..core.recordbatch import batch_from_pydict
from ..core.schema import schema as make_schema
from ..device import resolve

RESPONSE_SCHEMA = make_schema(("request_id", "int64"), ("token", "int32"),
                              ("position", "int32"))


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: list[int]


def _grow(cache, max_prompt: int, budget: int):
    """Every cache leaf of >= 4 dims whose axis 2 is the prompt length gains
    ``budget`` zero slots there (the JAX batcher's ``jnp.pad``)."""
    if isinstance(cache, dict):
        return {k: _grow(v, max_prompt, budget) for k, v in cache.items()}
    if cache.dim() >= 4 and cache.shape[2] == max_prompt:
        shape = list(cache.shape)
        shape[2] += budget
        out = cache.new_zeros(shape)
        out[:, :, :max_prompt] = cache
        return out
    return cache


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """Last position's argmax per row; ties go to the first index, as in jnp."""
    return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy().astype(np.int32)


class Batcher:
    """prefill_fn(tokens (B,S)) -> (logits, cache);
    decode_fn(cache, tokens (B,1), position) -> (logits, cache).
    Token tensors are made on ``device`` (the card unless given). Each
    cohort's left-padded prompts are kept, as built on the host, in
    ``cohort_tokens``."""

    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 batch_size: int, pad_id: int = 0, device=None):
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.device = resolve(device)
        self.queue: deque[Request] = deque()
        self.cohort_tokens: list[np.ndarray] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- qos-gateway ingestion ---------------------------------------------
    def submit_scan(self, gateway, sql: str, dataset: str, *,
                    client_id: str = "serving", klass: str = "interactive",
                    cost_hint: float = 1.0, deadline_s: float | None = None,
                    num_streams: int | None = None, start_batch: int = 0,
                    arrival_s: float = 0.0):
        """Submit the prompt-fetch scan as one logical gateway request.
        Returns the id-assigned :class:`~repro_torch.qos.ScanRequest`, or
        ``None`` when the gateway shed it at submit. Run the gateway, then
        call :meth:`ingest_scan`. Replicas that submit the same
        ``(sql, dataset, start_batch)`` under a gateway with a scheduler and
        a ticket table coalesce onto one shared fan-out."""
        from ..qos import ScanRequest   # serving -> qos only on this path
        return gateway.submit(ScanRequest(
            client_id=client_id, klass=klass, sql=sql, dataset=dataset,
            cost_hint=cost_hint, deadline_s=deadline_s,
            num_streams=num_streams, start_batch=start_batch,
            arrival_s=arrival_s))

    def ingest_scan(self, gateway, request, seq_len: int, *,
                    max_new_tokens: int = 16, eos_id: int | None = None,
                    start_id: int = 0) -> tuple[int, bool]:
        """Enqueue the sequences of a completed :meth:`submit_scan` result.
        Returns ``(num_requests, shared)``; ``shared`` is True when another
        subscriber's fan-out did the server-side work. A request that was
        shed or failed while queued gives ``(0, False)``."""
        result = gateway.result(request.request_id)
        if result is None:
            return 0, False
        n = self.ingest_batches(result.batches, seq_len,
                                max_new_tokens=max_new_tokens,
                                eos_id=eos_id, start_id=start_id)
        return n, result.shared

    def ingest_batches(self, batches, seq_len: int, *,
                       max_new_tokens: int = 16, eos_id: int | None = None,
                       start_id: int = 0) -> int:
        """Turn token record batches into decode requests, one per sequence,
        in scan order. Returns the number of requests enqueued."""
        from ..data.tokens import batch_to_tokens
        rid = start_id
        for rb in batches:
            for seq in batch_to_tokens(rb, seq_len):
                self.submit(Request(rid, np.asarray(seq, np.int32).copy(),
                                    max_new_tokens=max_new_tokens,
                                    eos_id=eos_id))
                rid += 1
        return rid - start_id

    def _next_cohort(self) -> list[Request]:
        cohort = []
        while self.queue and len(cohort) < self.batch_size:
            cohort.append(self.queue.popleft())
        return cohort

    def run(self) -> list[Completion]:
        """Drain the queue, cohort by cohort. Greedy decoding."""
        done: list[Completion] = []
        while self.queue:
            cohort = self._next_cohort()
            B = len(cohort)
            max_prompt = max(len(r.prompt) for r in cohort)
            toks = np.full((B, max_prompt), self.pad_id, np.int32)
            for i, r in enumerate(cohort):
                toks[i, max_prompt - len(r.prompt):] = r.prompt  # left pad
            self.cohort_tokens.append(toks)
            logits, cache = self.prefill_fn(torch.from_numpy(toks).to(self.device))
            budget = max(r.max_new_tokens for r in cohort)
            cache = _grow(cache, max_prompt, budget)
            outputs: list[list[int]] = [[] for _ in cohort]
            alive = np.ones(B, bool)
            next_tok = _greedy(logits)
            for step in range(budget):
                pos = max_prompt + step
                for i, r in enumerate(cohort):
                    if alive[i]:
                        outputs[i].append(int(next_tok[i]))
                        if ((r.eos_id is not None and next_tok[i] == r.eos_id)
                                or len(outputs[i]) >= r.max_new_tokens):
                            alive[i] = False
                if not alive.any() or step == budget - 1:
                    break
                logits, cache = self.decode_fn(
                    cache, torch.from_numpy(next_tok)[:, None].to(self.device), pos)
                next_tok = _greedy(logits)
            done.extend(Completion(r.request_id, outputs[i])
                        for i, r in enumerate(cohort))
        return done


def completions_to_batch(completions: list[Completion]):
    """Results as a record batch (rides the Thallus transport back)."""
    rid, tok, pos = [], [], []
    for c in completions:
        for j, t in enumerate(c.tokens):
            rid.append(c.request_id)
            tok.append(int(t))
            pos.append(j)
    return batch_from_pydict(RESPONSE_SCHEMA,
                             {"request_id": rid, "token": tok, "position": pos})
