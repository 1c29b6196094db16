# Copy of src/repro/configs/granite_3_2b.py, kept numpy-only; change both copies together.
"""granite-3-2b [dense] — GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155, head_dim=64,
    activation="swiglu", rope_theta=10000.0, norm_eps=1e-5,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf]",
)
