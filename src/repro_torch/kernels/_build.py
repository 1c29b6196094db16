"""Build the CUDA sources under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, where ``<hash>`` covers the source and the flags: an edited
source builds anew, an unchanged one loads at once. :func:`build_all` starts
every compiler together and waits for all of them. Nothing is built when a
module is imported, only at a kernel's first launch or when a caller asks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pack", "take")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the "
                           "kernels under csrc/")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all at once. Returns each compiler's output (``-Xptxas -v`` prints
    registers and spills); raises if any compiler failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu``, built and loaded at
    first use, returning an ``int`` (a ``cudaError_t``)."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build_all((name,))
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
    return fn


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch(name: str, symbol: str, argtypes: list, device, *args) -> None:
    """Call ``symbol`` of ``csrc/<name>.cu`` with ``args`` and the current
    stream of ``device`` as its last argument, on that device; raise if the
    C function returns a non-zero ``cudaGetLastError()``."""
    fn = function(name, symbol, argtypes + [ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: "
                           f"cudaError_t {err}")
