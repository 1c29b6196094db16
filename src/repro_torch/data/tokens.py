# Copy of src/repro/data/tokens.py, kept numpy-only; change both copies together.
"""Columnar token datasets: LM training data stored Arrow-style.

A token shard is a table with columns (seq_id int64, tokens int32) where
``tokens`` holds ``rows × seq_len`` values flattened row-major — the layout
a tokenizer pipeline would emit into Arrow. Batches reshape *by view* (the
Thallus path keeps them zero-copy end to end).
"""
from __future__ import annotations

import numpy as np

from ..core.recordbatch import RecordBatch, batch_from_arrays
from ..core.schema import schema as make_schema
from ..engine.table import Table

TOKEN_SCHEMA = make_schema(("seq_id", "int64"), ("tokens", "int32"))


def make_token_table(name: str, num_seqs: int, seq_len: int,
                     vocab_size: int, seqs_per_batch: int = 64,
                     seed: int = 0) -> Table:
    """Synthetic tokenized corpus (markov-ish for non-uniform stats)."""
    rng = np.random.default_rng(seed)
    table = Table(name, TOKEN_SCHEMA)
    done = 0
    while done < num_seqs:
        n = min(seqs_per_batch, num_seqs - done)
        toks = rng.integers(0, vocab_size, (n, seq_len), dtype=np.int32)
        # inject local structure so loss curves move in the examples
        toks[:, 1::2] = (toks[:, ::2] * 31 + 7) % vocab_size
        seq_ids = (np.arange(n, dtype=np.int64) + done)
        batch = batch_from_arrays(
            TOKEN_SCHEMA, [np.repeat(seq_ids, seq_len),
                           toks.reshape(-1)])
        table.append(batch)
        done += n
    return table


def batch_to_tokens(batch: RecordBatch, seq_len: int) -> np.ndarray:
    """(rows*seq_len,) int32 column -> (rows, seq_len) view (zero-copy)."""
    col = batch.column("tokens").values
    if col.size % seq_len:
        raise ValueError(f"column size {col.size} not divisible by {seq_len}")
    return col.reshape(-1, seq_len)


def shift_labels(tokens: np.ndarray, pad_id: int = -1) -> np.ndarray:
    """Next-token labels: labels[t] = tokens[t+1]; last position masked."""
    labels = np.concatenate(
        [tokens[:, 1:], np.full((tokens.shape[0], 1), pad_id, tokens.dtype)],
        axis=1)
    return labels
