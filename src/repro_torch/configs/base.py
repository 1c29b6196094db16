# Copy of src/repro/configs/base.py, kept numpy-only; change both copies together.
"""Architecture + shape configuration schema.

Every assigned architecture is an :class:`ArchConfig`; every input-shape set
entry is a :class:`ShapeConfig`. ``reduced()`` derives the small same-family
config used by the CPU smoke tests; the full config is only ever lowered
abstractly (dry-run) — never allocated on this container.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0       # >0 adds a dense shared expert (llama4)
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    shared_every: int = 6           # apply the shared attn block every N layers
    num_shared_blocks: int = 1      # distinct shared blocks cycled through


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int
    encoder_seq: int = 1500         # whisper: 30 s audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 256          # visual tokens prepended to the text


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    zero_centered_norm: bool = False
    qk_norm: bool = False
    embed_scale: bool = False       # gemma: embeddings * sqrt(d_model)
    logit_softcap: float | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    source: str = ""                # provenance note [arXiv/hf; tier]
    sub_quadratic: bool = False     # can run long_500k
    # TP-divisibility head padding (§Perf iteration): extra zero-init heads
    # so query/kv heads divide the 16-way model axis. Overhead is real
    # compute, visible in the useful-flops ratio; 0 = off.
    pad_heads_to: int = 0
    pad_kv_to: int = 0

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def eff_heads(self) -> int:
        return max(self.pad_heads_to, self.num_heads)

    @property
    def eff_kv(self) -> int:
        return max(self.pad_kv_to, self.num_kv_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a 256 multiple (Megatron-style) so
        the vocab dim shards across any mesh axis; padded logit rows are
        masked to -inf in logits_fn. num_params() stays at the true vocab."""
        return -(-self.vocab_size // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        small_moe = None
        if self.moe is not None:
            small_moe = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                shared_expert_ff=32 if self.moe.shared_expert_ff else 0)
        small_ssm = None
        if self.ssm is not None:
            small_ssm = dataclasses.replace(self.ssm, state_dim=16, head_dim=8,
                                            chunk=8)
        small_hybrid = self.hybrid
        small_encdec = None
        if self.encdec is not None:
            small_encdec = dataclasses.replace(self.encdec, num_encoder_layers=2,
                                               encoder_seq=24)
        small_vlm = None
        if self.vlm is not None:
            small_vlm = dataclasses.replace(self.vlm, num_patches=4)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads) if self.num_kv_heads else heads
        if heads and heads % kv:
            kv = 1
        return dataclasses.replace(
            self, num_layers=min(self.num_layers, 4) if self.hybrid is None
            else 7,  # hybrid: enough layers to hit a shared block
            d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
            d_ff=128, vocab_size=503, moe=small_moe, ssm=small_ssm,
            hybrid=small_hybrid, encdec=small_encdec, vlm=small_vlm,
            pad_heads_to=0, pad_kv_to=0)

    # -- parameter accounting (for MODEL_FLOPS = 6·N·D) --------------------
    def num_params(self, active_only: bool = False) -> int:
        D, hd = self.d_model, self.resolved_head_dim
        H, KV, L = self.num_heads, self.num_kv_heads, self.num_layers
        n = self.vocab_size * D                      # embed
        if not self.tie_embeddings:
            n += D * self.vocab_size                 # lm_head
        n += D                                       # final norm

        def attn_params() -> int:
            p = D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params() -> int:
            if self.activation in ("geglu", "swiglu"):
                return 3 * D * self.d_ff
            return 2 * D * self.d_ff

        def moe_params(active: bool) -> int:
            m = self.moe
            e = m.top_k if active else m.num_experts
            p = D * m.num_experts  # router (always resident)
            p += e * 3 * D * m.d_ff_expert
            if m.shared_expert_ff:
                p += 3 * D * m.shared_expert_ff
            return p

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * D
            nheads = d_in // s.head_dim
            conv_ch = d_in + 2 * s.ngroups * s.state_dim
            p = D * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)  # in_proj
            p += conv_ch * s.conv_width                                # conv
            p += nheads * 2 + d_in                                     # A, D, norm
            p += d_in * D                                              # out_proj
            return p

        if self.family in ("dense", "vlm"):
            n += L * (attn_params() + mlp_params() + 2 * D)
        elif self.family == "moe":
            n += L * (attn_params() + moe_params(active_only) + 2 * D)
        elif self.family == "ssm":
            n += L * (ssm_params() + D)
        elif self.family == "hybrid":
            n += L * (ssm_params() + D)
            shared = attn_params() + mlp_params() + 2 * D
            # shared block input is concat(hidden, embed) -> 2D projection
            shared += 2 * D * H * hd - D * H * hd  # wq from 2D
            shared += 2 * D * 2 * KV * hd - 2 * D * KV * hd
            n += self.hybrid.num_shared_blocks * shared
        elif self.family == "audio":
            enc = self.encdec.num_encoder_layers
            n += enc * (attn_params() + 2 * D * self.d_ff + 2 * D)
            n += L * (attn_params() * 2 + 2 * D * self.d_ff + 3 * D)  # +cross
            n += self.encdec.encoder_seq * D                          # enc pos
            n += 4096 * D                                             # dec pos
        else:
            raise ValueError(self.family)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch           # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Family rules from the assignment: long_500k only for sub-quadratic
    archs; decode shapes skipped for encoder-only archs (none assigned)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention family: long_500k skipped per assignment"
    return True, ""
