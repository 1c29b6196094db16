"""Thallus on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package imports ``torch`` and numpy and nothing of JAX or of the
``repro`` package. Its numpy-only modules (``core``, ``engine``) are copies
of the JAX package's, its device code lands record batches as torch tensors
(``core.device_transport``) and its kernels (``kernels.pack``,
``kernels.take``) are CUDA C++ for ``sm_90a`` under ``csrc/``, each with a
plain PyTorch version that runs for CPU tensors.
"""
from .device import default_device  # noqa: F401
