"""Training, in PyTorch: the port of :mod:`repro.training` without
``compression`` (int8 error-feedback gradients, ROADMAP item 6e)."""
from .optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at  # noqa: F401
from .train_step import TrainConfig, init_train_state, make_train_step, train_state_shapes  # noqa: F401
from .checkpoint import CheckpointManager, batch_to_state, state_to_batch  # noqa: F401
