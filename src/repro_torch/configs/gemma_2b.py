# Copy of src/repro/configs/gemma_2b.py, kept numpy-only; change both copies together.
"""gemma-2b [dense] — GeGLU, MQA (kv=1), head_dim=256 [arXiv:2403.08295; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    activation="geglu", rope_theta=10000.0, norm_eps=1e-6,
    tie_embeddings=True, zero_centered_norm=True, embed_scale=True,
    pad_heads_to=16,                 # 8 -> 16 MQA queries for 16-way TP
    source="[arXiv:2403.08295; hf]",
)
