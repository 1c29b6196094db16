"""Columnar token datasets (a copy of the JAX package's ``data.tokens``).

``data/loader.py`` (``ThallusLoader``) is not ported yet: ROADMAP item 6.
"""
from .tokens import TOKEN_SCHEMA, batch_to_tokens, make_token_table, shift_labels  # noqa: F401
