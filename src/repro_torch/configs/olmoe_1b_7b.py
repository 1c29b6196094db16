# Copy of src/repro/configs/olmoe_1b_7b.py, kept numpy-only; change both copies together.
"""olmoe-1b-7b [moe] — 64 experts top-8, qk-norm [arXiv:2409.02060; hf]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    activation="swiglu", rope_theta=10000.0, norm_eps=1e-5,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25),
    source="[arXiv:2409.02060; hf]",
)
