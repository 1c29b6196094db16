"""Columnar token datasets and the training input pipeline: copies of the
JAX package's ``data.tokens`` and ``data.loader``.

``ThallusLoader`` streams (tokens, labels) numpy batches over the
``thallus``, ``rpc``, ``cluster`` and ``gateway`` transports; the last one
submits its scan to a ``qos.ScanGateway``. Its ``obs`` and ``qos`` imports
are made lazily, inside ``metrics()``, ``health()`` and the gateway path.
"""
from .tokens import TOKEN_SCHEMA, batch_to_tokens, make_token_table, shift_labels  # noqa: F401
from .loader import LoaderStats, ThallusLoader  # noqa: F401
