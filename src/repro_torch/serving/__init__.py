"""Serving, in PyTorch: the port of :mod:`repro.serving`."""
from .batcher import Batcher, Completion, Request, completions_to_batch  # noqa: F401
