# Copy of src/repro/configs/llama4_scout_17b_16e.py, kept numpy-only; change both copies together.
"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    activation="swiglu", rope_theta=500000.0, norm_eps=1e-5,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25, shared_expert_ff=8192),
    pad_heads_to=48,                 # 40 -> 48 for 16-way TP (+20% attn)
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
