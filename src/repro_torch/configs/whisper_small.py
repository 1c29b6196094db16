# Copy of src/repro/configs/whisper_small.py, kept numpy-only; change both copies together.
"""whisper-small [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings via input_specs()) [arXiv:2212.04356; unverified]."""
from .base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    activation="gelu", norm_eps=1e-5, tie_embeddings=True,
    encdec=EncDecConfig(num_encoder_layers=12, encoder_seq=1500),
    pad_heads_to=16, pad_kv_to=16,   # 12 -> 16 MHA for 16-way TP
    source="[arXiv:2212.04356; unverified]",
)
