# Copy of src/repro/engine/__init__.py, kept numpy-only; change both copies together.
"""Columnar query engine (DuckDB stand-in for the Thallus server)."""
from .table import Catalog, Table, make_mixed_table, make_numeric_table  # noqa: F401
from .executor import Engine, QueryReader  # noqa: F401
from .sql import Query, parse  # noqa: F401
from .expressions import BinOp, Col, Expr, IsNull, Lit, Not, filter_mask  # noqa: F401
