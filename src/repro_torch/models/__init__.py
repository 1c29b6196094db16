"""Models, the dense, MoE, VLM, SSM (Mamba2) and hybrid (zamba2) families,
in PyTorch: the port of :mod:`repro.models`."""
from .model import (decode, forward, init_cache, init_params, loss_fn,  # noqa: F401
                    param_shapes, prefill)
from .convert import params_from_numpy, params_to_numpy  # noqa: F401
