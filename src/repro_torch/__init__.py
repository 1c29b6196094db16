"""Thallus on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package imports ``torch`` and numpy and nothing of JAX or of the
``repro`` package. Its numpy-only modules (``core``, ``engine``, ``configs``,
``cluster``, ``obs``, ``sched``, ``qos``, ``data.tokens``, ``data.loader``)
are copies of the JAX package's; its device code lands record batches as
torch tensors (``core.device_transport``); its kernels (``kernels.pack``,
``kernels.take``, ``kernels.attention``) are CUDA C++ for ``sm_90a`` under
``csrc/``, each with a plain PyTorch version that runs for CPU tensors;
``models`` holds every family's prefill, decode and loss, and the sharding
rules that run them as DTensors on a mesh (``models.sharding``),
``serving`` the cohort batcher (prompts by ``submit`` or through a
``qos.ScanGateway`` by ``submit_scan``), ``training`` AdamW, the train step
with optional int8 error-feedback gradients and the cross-pod reduce, and
checkpoints, and ``launch`` the meshes and the ``serve`` and ``train`` entry
points (``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``, or under ``torchrun`` for a sharded run).
"""
from .device import default_device  # noqa: F401
