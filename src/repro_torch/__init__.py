"""Thallus on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package imports ``torch`` and numpy and nothing of JAX or of the
``repro`` package. Its numpy-only modules (``core``, ``engine``, ``configs``,
``cluster``, ``obs``, ``sched``, ``qos``, ``data.tokens``, ``data.loader``)
are copies of the JAX package's; its device code lands record batches as
torch tensors (``core.device_transport``); its kernels (``kernels.pack``,
``kernels.take``, ``kernels.attention``) are CUDA C++ for ``sm_90a`` under
``csrc/``, each with a plain PyTorch version that runs for CPU tensors;
``models`` holds the dense transformer's prefill, decode and loss,
``serving`` the cohort batcher (prompts by ``submit`` or through a
``qos.ScanGateway`` by ``submit_scan``), ``training`` AdamW, the train step
with optional int8 error-feedback gradients, and checkpoints, and
``launch`` the ``serve`` and ``train`` entry points
(``python -m repro_torch.launch.serve``, ``python -m repro_torch.launch.train``).
"""
from .device import default_device  # noqa: F401
