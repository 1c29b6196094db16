"""Training, in PyTorch: the port of :mod:`repro.training`. The train
state may be plain tensors or DTensors on a mesh; ``compressed_psum_pod``
reduces over a mesh's ``pod`` dim."""
from .optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at  # noqa: F401
from .train_step import TrainConfig, init_train_state, make_train_step, train_state_shapes  # noqa: F401
from .checkpoint import CheckpointManager, batch_to_state, state_to_batch  # noqa: F401
from .compression import (compress_decompress, compressed_psum_pod,  # noqa: F401
                          compression_wire_bytes, dequantize_int8,
                          init_error_feedback, quantize_int8)
