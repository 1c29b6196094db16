"""Models, the dense, MoE, VLM, SSM (Mamba2), hybrid (zamba2) and audio
(whisper encoder-decoder) families, in PyTorch: the port of
:mod:`repro.models`."""
from .model import (FAMILIES, batch_pspecs, cache_pspecs, cache_spec,  # noqa: F401
                    decode, forward, init_cache, init_params, loss_fn,
                    param_shapes, param_specs, prefill, shard_params)
from .sharding import (DEFAULT_OPTIONS, constrain, dispatch_groups,  # noqa: F401
                       make_rules, mesh_context, placements, set_mesh_context,
                       spec_of)
from .convert import params_from_numpy, params_to_numpy  # noqa: F401
