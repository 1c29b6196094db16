"""Thallus on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package imports ``torch`` and numpy and nothing of JAX or of the
``repro`` package. Its numpy-only modules (``core``, ``engine``, ``configs``,
``data.tokens``) are copies of the JAX package's; its device code lands
record batches as torch tensors (``core.device_transport``); its kernels
(``kernels.pack``, ``kernels.take``, ``kernels.attention``) are CUDA C++ for
``sm_90a`` under ``csrc/``, each with a plain PyTorch version that runs for
CPU tensors; ``models`` holds the dense transformer's prefill and decode,
``serving`` the cohort batcher, and ``launch`` the ``serve`` entry point
(``python -m repro_torch.launch.serve``).
"""
from .device import default_device  # noqa: F401
