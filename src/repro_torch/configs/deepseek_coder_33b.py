# Copy of src/repro/configs/deepseek_coder_33b.py, kept numpy-only; change both copies together.
"""deepseek-coder-33b [dense] — llama-arch, GQA kv=8 [arXiv:2401.14196; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128,
    activation="swiglu", rope_theta=100000.0, norm_eps=1e-6,
    pad_heads_to=64,                 # 56 -> 64 for 16-way TP (+14% attn)
    source="[arXiv:2401.14196; hf]",
)
