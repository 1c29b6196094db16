"""Models, the dense, MoE, VLM, SSM (Mamba2), hybrid (zamba2) and audio
(whisper encoder-decoder) families, in PyTorch: the port of
:mod:`repro.models`."""
from .model import (FAMILIES, decode, forward, init_cache, init_params,  # noqa: F401
                    loss_fn, param_shapes, prefill)
from .convert import params_from_numpy, params_to_numpy  # noqa: F401
