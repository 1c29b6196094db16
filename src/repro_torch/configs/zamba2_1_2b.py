# Copy of src/repro/configs/zamba2_1_2b.py, kept numpy-only; change both copies together.
"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Per-invocation LoRA deltas omitted (DESIGN.md §8)."""
from .base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    activation="geglu", rope_theta=10000.0, norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2, chunk=256),
    hybrid=HybridConfig(shared_every=6, num_shared_blocks=1),
    sub_quadratic=True,
    source="[arXiv:2411.15242; hf]",
)
