# Copy of src/repro/configs/deepseek_67b.py, kept numpy-only; change both copies together.
"""deepseek-67b [dense] — llama-arch, 95L GQA kv=8 [arXiv:2401.02954; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128,
    activation="swiglu", rope_theta=10000.0, norm_eps=1e-6,
    source="[arXiv:2401.02954; hf]",
)
