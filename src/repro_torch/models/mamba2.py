"""Mamba2 SSD (state-space duality) blocks, chunked scan and O(1) decode: the
port of :mod:`repro.models.mamba2`.

The chunked SSD algorithm (Dao & Gu 2024): the sequence is cut into chunks
of ``Q``; within a chunk the output is a masked quadratic form (the
"attention duality"), across chunks a small (H, P, N) state is carried by a
sequential recurrence, here a Python loop over the chunks (``lax.scan`` in
the JAX package) that autograd differentiates. Decode is a one-token state
update. State math runs in float32, products in the parameters' dtype, as
in the JAX package. The scan is plain PyTorch, as it is plain jnp there;
:func:`ssd_chunked` runs under the profiler range ``ssd_chunked`` so that a
profile can name its device time. Sharding constraints are dropped, as in
:mod:`.transformer`.

Decode writes each layer's new state and conv window into the cache in
place and returns the same dict, as :func:`.transformer.transformer_decode`
does.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import resolve
from .layers import rms_norm

Params = dict[str, Any]


def ssm_dims(cfg: ArchConfig) -> tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim P, state dim N, conv channels)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, s.head_dim, s.state_dim, conv_ch


def init_mamba_layer_params(cfg: ArchConfig, generator: torch.Generator | None, L: int,
                            dtype=torch.float32, device=None) -> Params:
    """Stacked (L, ...) parameters for L mamba2 blocks: the JAX package's
    tree, shapes and scales, drawn from ``generator`` (on ``device``;
    ``None`` on the meta device). ``A_log``, ``D`` and ``dt_bias`` are
    float32 whatever ``dtype`` is; ``norm`` and ``ln`` are zeros."""
    device = resolve(device)
    D = cfg.d_model
    s = cfg.ssm
    d_inner, H, P, N, conv_ch = ssm_dims(cfg)
    in_dim = 2 * d_inner + 2 * s.ngroups * N + H

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    a = torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device)
    return {
        "in_proj": normal((L, D, in_dim), 1.0 / math.sqrt(D)),
        "conv_w": normal((L, s.conv_width, conv_ch), 1.0 / math.sqrt(s.conv_width)),
        "conv_b": full((L, conv_ch), 0.0),
        "A_log": torch.log(a)[None].expand(L, H).clone(),
        "D": full((L, H), 1.0, torch.float32),
        "dt_bias": full((L, H), 0.0, torch.float32),
        "norm": full((L, d_inner), 0.0),
        "out_proj": normal((L, d_inner, D), 1.0 / math.sqrt(d_inner)),
        "ln": full((L, D), 0.0),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: xBC (B, S, C), w (W, C) ->
    silu(conv + b), (B, S, C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _split_zxbcdt(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_inner, H, P, N, _ = ssm_dims(cfg)
    G = cfg.ssm.ngroups
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * G * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * G * N:]
    return z, xBC, dt


def _split_xbc(cfg: ArchConfig, xBC: torch.Tensor):
    d_inner, H, P, N, _ = ssm_dims(cfg)
    G = cfg.ssm.ngroups
    x = xBC[..., :d_inner]
    B_ = xBC[..., d_inner:d_inner + G * N]
    C_ = xBC[..., d_inner + G * N:]
    return x, B_, C_


def chunk_len(S: int, chunk: int) -> int:
    """The JAX package's chunk rule: ``chunk`` when it divides ``S``, else
    ``gcd(S, chunk)`` (1 for an odd ``S``)."""
    return math.gcd(S, chunk) if S % chunk else chunk


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, D_skip: torch.Tensor, chunk: int,
                return_final_state: bool = False):
    """Chunked SSD scan.

    x (B, S, H, P); dt (B, S, H) float32 after softplus; A (H,) negative;
    B_/C_ (B, S, G, N); D_skip (H,). Returns (B, S, H, P) in ``x.dtype``
    (and the final (B, H, P, N) float32 state when ``return_final_state``:
    prefill hands it to decode). Group ``g`` serves heads ``g * H // G``
    to ``(g + 1) * H // G - 1`` (``jnp.repeat``, that is
    ``repeat_interleave``), but for the chunk-final states, which read the
    sum over the groups as the JAX package's do."""
    with torch.profiler.record_function("ssd_chunked"):
        Bb, S, H, P = x.shape
        G, N = B_.shape[2], B_.shape[3]
        Q = chunk_len(S, chunk)
        nc = S // Q
        hpg = H // G

        xf = x.float().reshape(Bb, nc, Q, H, P)
        dtc = dt.reshape(Bb, nc, Q, H)
        Bc = B_.float().reshape(Bb, nc, Q, G, N)
        Cc = C_.float().reshape(Bb, nc, Q, G, N)

        # intra-chunk: the masked quadratic form
        dA = dtc * A                                       # (B,nc,Q,H) <= 0
        dAcum = torch.cumsum(dA, dim=2)                    # within the chunk
        seg = dAcum[:, :, :, None, :] - dAcum[:, :, None, :, :]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        # mask before exp: the masked entries' exp may overflow, and inf
        # times a zero cotangent would make the gradient NaN
        Lmat = torch.exp(torch.where(causal[None, None, :, :, None], seg, -math.inf))
        CB = torch.einsum("bclgn,bcsgn->bclsg", Cc, Bc).repeat_interleave(hpg, dim=-1)
        scores = CB * Lmat * dtc[:, :, None, :, :]         # (B,nc,l,s,H)
        y_diag = torch.einsum("bclsh,bcshp->bclhp", scores, xf)

        # chunk-final states. The JAX package's einsum "bcsgn,bcsh,bcshp->
        # bchpn" sums B over the groups, so every head reads the sum of all
        # groups' B here (its own group's everywhere else): the same at
        # G = 1, a fault of the reference at G > 1, reproduced
        decay_end = torch.exp(dAcum[:, :, -1:, :] - dAcum)  # (B,nc,Q,H)
        Bx = torch.einsum("bcshp,bcsn->bchpn", xf * (decay_end * dtc)[..., None],
                          Bc.sum(3))                        # (B,nc,H,P,N)

        # inter-chunk recurrence over nc; each chunk reads the state that
        # enters it
        chunk_decay = torch.exp(dAcum[:, :, -1, :])[..., None, None]  # (B,nc,H,1,1)
        state = x.new_zeros((Bb, H, P, N), dtype=torch.float32)
        entering = []
        for c in range(nc):
            entering.append(state)
            state = torch.addcmul(Bx[:, c], state, chunk_decay[:, c])
        states_in = torch.stack(entering, dim=1)           # (B,nc,H,P,N)
        del entering, Bx

        # inter-chunk contribution: decay from the chunk's start, read with C
        Ch = Cc.repeat_interleave(hpg, dim=-2)             # (B,nc,Q,H,N)
        y_off = torch.einsum("bclhn,bchpn->bclhp", Ch * torch.exp(dAcum)[..., None],
                             states_in)

        y = y_diag + y_off + xf * D_skip[:, None]
        y = y.reshape(Bb, S, H, P).to(x.dtype)
    if return_final_state:
        return y, state
    return y


def mamba_block(cfg: ArchConfig, p: Params, u: torch.Tensor, return_cache: bool = False):
    """One mamba2 block over the whole sequence: u (B, S, D) -> (B, S, D)
    (and ``(state, conv_cache)`` when ``return_cache``: the prefill path)."""
    s = cfg.ssm
    d_inner, H, P, N, _ = ssm_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", u, p["in_proj"])
    z, xBC_raw, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    x, B_, C_ = _split_xbc(cfg, xBC)
    x = x.reshape(*x.shape[:2], H, P)
    B_ = B_.reshape(*B_.shape[:2], s.ngroups, N)
    C_ = C_.reshape(*C_.shape[:2], s.ngroups, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    res = ssd_chunked(x, dt, A, B_, C_, p["D"], s.chunk, return_final_state=return_cache)
    y, final_state = res if return_cache else (res, None)
    y = y.reshape(*y.shape[:2], d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if return_cache:
        conv_cache = xBC_raw[:, -(s.conv_width - 1):, :]   # the pre-activation taps
        return out, (final_state, conv_cache)
    return out


def mamba_decode_block(cfg: ArchConfig, p: Params, u: torch.Tensor,
                       state: torch.Tensor, conv_cache: torch.Tensor):
    """One block, one token. u (B, 1, D); state (B, H, P, N); conv_cache
    (B, W - 1, conv_ch). Returns (out (B, 1, D), new state, new conv
    cache); the conv runs in float32 on the cache's dtype."""
    s = cfg.ssm
    d_inner, H, P, N, _ = ssm_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", u, p["in_proj"])
    z, xBC, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    window = torch.cat([conv_cache, xBC[:, 0:1, :].to(conv_cache.dtype)], dim=1)  # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    x, B_, C_ = _split_xbc(cfg, conv_out[:, None, :].to(u.dtype))
    x = x.reshape(-1, H, P).float()                        # (B,H,P)
    hpg = H // s.ngroups
    Bh = B_.reshape(-1, s.ngroups, N).float().repeat_interleave(hpg, dim=1)  # (B,H,N)
    Ch = C_.reshape(-1, s.ngroups, N).float().repeat_interleave(hpg, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None])
    state = state * dA[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, x, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + x * p["D"][None, :, None]
    y = y.reshape(-1, 1, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"]), state, window[:, 1:, :]


# ---------------------------------------------------------------------------
# the whole model (family "ssm")
# ---------------------------------------------------------------------------


def init_mamba_params(cfg: ArchConfig, generator: torch.Generator | None,
                      dtype=torch.float32, device=None) -> Params:
    device = resolve(device)
    V, D = cfg.padded_vocab, cfg.d_model
    params: Params = {
        "embed": torch.randn((V, D), generator=generator, dtype=dtype, device=device),
        "layers": init_mamba_layer_params(cfg, generator, cfg.num_layers, dtype, device),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((D, V), generator=generator, dtype=dtype,
                                        device=device).mul_(1.0 / math.sqrt(D))
    return params


def _residual_layer(cfg: ArchConfig, layer_p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + mamba_block(cfg, layer_p, rms_norm(x, layer_p["ln"], cfg.norm_eps))


def mamba_stack(cfg: ArchConfig, layers: list[Params], x: torch.Tensor, remat: str,
                caches: dict | None = None) -> torch.Tensor:
    """``x + mamba_block(rms_norm(x))`` over ``layers`` (per-layer trees), each
    under ``remat``; with ``caches``, the prefill path, each layer's final
    state and conv taps are appended to ``caches["state"]`` and
    ``caches["conv"]`` (nothing is recomputed there)."""
    from .transformer import _maybe_remat
    layer = _maybe_remat(functools.partial(_residual_layer, cfg), remat)
    for layer_p in layers:
        if caches is None:
            x = layer(layer_p, x)
            continue
        out, (state, conv) = mamba_block(cfg, layer_p, rms_norm(x, layer_p["ln"], cfg.norm_eps),
                                         return_cache=True)
        x = x + out
        caches["state"].append(state)
        caches["conv"].append(conv)
    return x


def mamba_forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
                  remat: str = "full") -> torch.Tensor:
    from .transformer import embed_tokens, logits_fn, unbind_layers
    x = embed_tokens(cfg, params, tokens)
    x = mamba_stack(cfg, unbind_layers(params["layers"]), x, remat)
    return logits_fn(cfg, params, x)


def mamba_cache_spec(cfg: ArchConfig, batch: int, dtype=torch.float32) -> dict:
    """Leaf name -> (shape, dtype): the state is float32 whatever ``dtype``."""
    _, H, P, N, conv_ch = ssm_dims(cfg)
    L, W = cfg.num_layers, cfg.ssm.conv_width
    return {"state": ((L, batch, H, P, N), torch.float32),
            "conv": ((L, batch, W - 1, conv_ch), dtype)}


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> Params:
    device = resolve(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba_cache_spec(cfg, batch, dtype).items()}


def mamba_prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor):
    """The prompt -> (logits, decode cache ``{"state": (L, B, H, P, N)
    float32, "conv": (L, B, W - 1, conv_ch)}``). Nothing is recomputed:
    serving takes no gradient."""
    from .transformer import embed_tokens, logits_fn, unbind_layers
    x = embed_tokens(cfg, params, tokens)
    caches = {"state": [], "conv": []}
    x = mamba_stack(cfg, unbind_layers(params["layers"]), x, "none", caches)
    return logits_fn(cfg, params, x), {k: torch.stack(v) for k, v in caches.items()}


def mamba_decode_layer(cfg: ArchConfig, layer_p: Params, cache: Params, li: int,
                       x: torch.Tensor) -> torch.Tensor:
    """Layer ``li``'s decode step on ``x`` (B, 1, D), its state and conv
    window written into ``cache`` in place."""
    h = rms_norm(x, layer_p["ln"], cfg.norm_eps)
    out, state, conv = mamba_decode_block(cfg, layer_p, h, cache["state"][li],
                                          cache["conv"][li])
    cache["state"][li] = state
    cache["conv"][li] = conv
    return x + out


def mamba_decode(cfg: ArchConfig, params: Params, cache: Params, tokens: torch.Tensor,
                 position: int):
    """One decode step; ``position`` is unused by the state, kept for the
    API of attention decode. Returns (logits (B, 1, V), the same cache)."""
    from .transformer import embed_tokens, layer_params, logits_fn
    x = embed_tokens(cfg, params, tokens)
    for li in range(cfg.num_layers):
        x = mamba_decode_layer(cfg, layer_params(params["layers"], li), cache, li, x)
    return logits_fn(cfg, params, x), cache
