"""Models, dense family, in PyTorch: the port of :mod:`repro.models`."""
from .model import decode, init_cache, init_params, prefill  # noqa: F401
from .convert import params_from_numpy, params_to_numpy  # noqa: F401
