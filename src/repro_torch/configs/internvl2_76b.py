# Copy of src/repro/configs/internvl2_76b.py, kept numpy-only; change both copies together.
"""internvl2-76b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + LLaMA-arch 80L language backbone [arXiv:2404.16821; unverified]."""
from .base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    activation="swiglu", rope_theta=500000.0, norm_eps=1e-5,
    vlm=VLMConfig(num_patches=256),
    source="[arXiv:2404.16821; unverified]",
)
