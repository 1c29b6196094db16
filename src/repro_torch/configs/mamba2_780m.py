# Copy of src/repro/configs/mamba2_780m.py, kept numpy-only; change both copies together.
"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    activation="silu", norm_eps=1e-5, tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2, chunk=256),
    sub_quadratic=True,
    source="[arXiv:2405.21060; unverified]",
)
