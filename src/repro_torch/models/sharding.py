"""Logical-axis sharding: rules, divisibility cascade, activation constraints.
The port of :mod:`repro.models.sharding`.

Weights and activations are annotated with *logical* axis names; a rule
table maps them onto mesh axes with divisibility checks (gemma's 8 query
heads cannot shard over a 16-way ``model`` axis, so attention falls back to
replicating, or to sharding ``head_dim``, instead; whisper's 12 heads
likewise).

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names, or ``None``; it equals ``tuple(P)`` of the JAX package's
``PartitionSpec``. The rules read a mesh through :func:`mesh_shape`, which
takes a ``torch.distributed.device_mesh.DeviceMesh`` or any object with
``.shape`` (``{name: size}``) and ``.axis_names``; it, :func:`placements`
and :func:`from_full` live in :mod:`repro_torch.core.placement`.

:func:`mesh_context` installs a (mesh, rules) pair consulted by
:func:`constrain` inside model code: a no-op without one, so one process
runs the models on plain tensors. Ops that DTensor has no sharding rule for
(the flash kernel, the MoE dispatch, the SSD scan) run on each rank's
shards through ``local_map`` (:func:`local_apply`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from ..configs.base import ArchConfig
from ..core.placement import from_full, is_dtensor, mesh_device, mesh_shape, placements  # noqa: F401

_local = threading.local()

Spec = tuple


def _mesh_axis_size(shape: Mapping[str, int], axis: str | tuple[str, ...]) -> int:
    if isinstance(axis, str):
        return shape[axis]
    n = 1
    for a in axis:
        n *= shape[a]
    return n


def _fits(dim: int, shape: Mapping[str, int], axis: str | tuple[str, ...] | None) -> bool:
    if axis is None:
        return True
    return dim % _mesh_axis_size(shape, axis) == 0


DEFAULT_OPTIONS: dict[str, Any] = {
    # what to do when query heads don't divide the model axis:
    #   "replicate" — attention weights replicate over `model` (FSDP on
    #                 `data` still shards storage); attention compute is
    #                 local, zero attention collectives.  [optimized default]
    #   "head_dim"  — contraction-shard head_dim; QK^T and PV carry a sum of
    #                 the partial products over the model axis.
    "attn_fallback": "replicate",
    # MoE dispatch scope: True = sort/capacity per batch-shard group (all
    # routing ops local to a rank); False = one global sort (baseline).
    "moe_local_dispatch": True,
    # "tp2d" (default): data x model 2D layout. "fsdp": pure ZeRO-3 — batch
    # spans every mesh axis whose prefix product divides global_batch,
    # weights fully sharded over those axes, no tensor parallelism.
    "layout": "tp2d",
    "global_batch": None,            # consulted by the fsdp layout
}


def make_rules(cfg: ArchConfig, mesh, options: dict[str, Any] | None = None) -> dict[str, Any]:
    """Concrete logical-axis -> mesh-axis assignment for this arch x mesh.

    The attention cascade: shard query heads on ``model`` when divisible,
    otherwise fall back per ``options['attn_fallback']`` (see
    :data:`DEFAULT_OPTIONS`)."""
    opts = dict(DEFAULT_OPTIONS)
    if options:
        opts.update(options)
    shape = mesh_shape(mesh)
    axes = tuple(shape)
    dp: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    hd = cfg.resolved_head_dim

    rules: dict[str, Any] = {
        "batch": dp if dp else None,
        "fsdp": "data" if "data" in axes else None,
        "model": model,
        "heads": None, "kv": None, "head_dim": None,
        "moe_local_dispatch": bool(opts["moe_local_dispatch"]),
        "attn_fallback": opts["attn_fallback"],
    }
    if model is not None:
        msize = shape[model]
        if cfg.eff_heads and cfg.eff_heads % msize == 0:
            rules["heads"] = model
            if cfg.eff_kv and cfg.eff_kv % msize == 0:
                rules["kv"] = model
            # else: kv replicated (GQA with few kv heads) — q-sharded mode
        elif (cfg.num_heads and opts["attn_fallback"] == "head_dim"
              and hd % msize == 0):
            rules["head_dim"] = model          # contraction-sharded attention
        if cfg.d_ff and cfg.d_ff % msize != 0:
            rules["model_ffn"] = None
        else:
            rules["model_ffn"] = model
        rules["vocab"] = model if cfg.padded_vocab % msize == 0 else None
        if cfg.moe is not None:
            rules["experts"] = model if cfg.moe.num_experts % msize == 0 else None
            rules["model_ffe"] = (model if cfg.moe.d_ff_expert % msize == 0
                                  and rules.get("experts") is None else None)
        if cfg.ssm is not None:
            d_in = cfg.ssm.expand * cfg.d_model
            nheads = d_in // cfg.ssm.head_dim
            rules["ssm_heads"] = model if nheads % msize == 0 else None
            rules["d_inner"] = model if d_in % msize == 0 else None
        # residual-stream activation sharding (megatron-SP style)
        rules["residual"] = model if cfg.d_model % msize == 0 else None
    else:
        rules["model_ffn"] = None
        rules["vocab"] = None
        rules["residual"] = None
        if cfg.moe is not None:
            rules["experts"] = None
            rules["model_ffe"] = None
        if cfg.ssm is not None:
            rules["ssm_heads"] = None
            rules["d_inner"] = None

    # -- pure-FSDP / ZeRO-3 layout override --------------------------------
    if opts.get("layout") == "fsdp":
        gb = opts.get("global_batch")
        chosen: list[str] = []
        prod = 1
        for a in ("pod", "data", "model"):
            if a not in axes:
                continue
            nxt = prod * shape[a]
            if gb is not None and gb % nxt != 0:
                break
            chosen.append(a)
            prod = nxt
        shard_axes = tuple(chosen) if chosen else (dp or None)
        rules["batch"] = shard_axes
        rules["fsdp"] = shard_axes
        for k in ("heads", "kv", "head_dim", "model_ffn", "vocab",
                  "residual", "experts", "model_ffe", "ssm_heads", "d_inner"):
            if k in rules:
                rules[k] = None
        rules["layout"] = "fsdp"

    return rules


def spec_of(logical: Sequence[str | None], rules: Mapping[str, Any],
            shape: Sequence[int] | None = None, mesh=None) -> Spec:
    """Map logical axis names to a spec (with the divisibility guard when
    ``shape`` and ``mesh`` are given)."""
    sizes = mesh_shape(mesh) if mesh is not None else None
    out = []
    for i, name in enumerate(logical):
        axis = None if name is None else rules.get(name)
        if axis is not None and shape is not None and sizes is not None \
                and not _fits(shape[i], sizes, axis):
            axis = None
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]                     # as PartitionSpec normalises it
        out.append(axis)
    return tuple(out)


# ---------------------------------------------------------------------------
# activation-constraint context
# ---------------------------------------------------------------------------


def set_mesh_context(mesh, rules: Mapping[str, Any] | None) -> None:
    _local.mesh = mesh
    _local.rules = rules


def current_mesh():
    """The (mesh, rules) pair of the current context, ``(None, None)``
    without one."""
    return getattr(_local, "mesh", None), getattr(_local, "rules", None)


@contextlib.contextmanager
def mesh_context(mesh, rules: Mapping[str, Any]):
    """Install (mesh, rules) for the block. Inside it a plain tensor that
    meets a DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``), as a constant does in a JAX program: the
    models make positions, masks and the optimizer's scalars as plain
    tensors."""
    prev = current_mesh()
    set_mesh_context(mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        set_mesh_context(*prev)


def dispatch_groups() -> int:
    """MoE local-dispatch group count = number of batch shards (1 when no
    mesh context or local dispatch disabled)."""
    mesh, rules = current_mesh()
    if mesh is None or rules is None or not rules.get("moe_local_dispatch"):
        return 1
    batch = rules.get("batch")
    if not batch:
        return 1
    axes = (batch,) if isinstance(batch, str) else batch
    return _mesh_axis_size(mesh_shape(mesh), axes)


def constrain(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """``x`` redistributed to the placements of its logical axes: a DTensor
    under a mesh context. A plain tensor, or any tensor without a context,
    is returned unchanged, as the JAX package's constraint is a no-op
    without one."""
    if not isinstance(x, DTensor):        # first: the one-card path's only cost
        return x
    mesh, rules = current_mesh()
    if mesh is None or rules is None:
        return x
    spec = spec_of(logical, rules, shape=x.shape, mesh=mesh)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank (a plain tensor unchanged): for
    the ops DTensor cannot run on a sharded operand, such as a lookup into
    a vocab-sharded table with batch-sharded ids."""
    if not is_dtensor(x):
        return x
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def placements_for(x, logical: Sequence[str | None]) -> tuple:
    """The placements of a tensor ``x`` (or of a shape) by its logical axes
    under the current context (the divisibility guard on the shape)."""
    mesh, rules = current_mesh()
    shape = tuple(getattr(x, "shape", x))
    return placements(spec_of(logical, rules, shape=shape, mesh=mesh), mesh)


def _grad_placements(in_placements: Sequence) -> tuple:
    """The placements of the gradients that a per-rank function gives its
    inputs. Where some input is split over a mesh dim, an input replicated
    over it gets only this rank's share of its gradient there: ``Partial``,
    which DTensor sums when it re-shards the gradient."""
    split = {m for ps in in_placements if ps is not None
             for m, pl in enumerate(ps) if isinstance(pl, Shard)}
    out = []
    for ps in in_placements:
        if ps is None:
            out.append(None)
            continue
        out.append(tuple(Partial() if isinstance(pl, Replicate) and m in split else pl
                         for m, pl in enumerate(ps)))
    return tuple(out)


def local_apply(fn, args: Sequence, in_placements: Sequence, out_placements):
    """``fn(*args)`` run by every rank on its own shards, through
    ``local_map``: each DTensor argument is first redistributed to its entry
    of ``in_placements`` (``None`` for an argument that is not a tensor),
    and ``fn``'s plain outputs become DTensors of ``out_placements`` (one
    output's placements, or a list of them for a tuple of outputs). The
    gradients of inputs replicated over a mesh dim that others are split on
    are summed over it (:func:`_grad_placements`)."""
    mesh, _ = current_mesh()
    if all(isinstance(pl, Placement) for pl in out_placements):
        out_placements = list(out_placements)              # one output
    else:
        out_placements = tuple(list(ps) for ps in out_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=_grad_placements(in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def replicate_all(mesh) -> tuple:
    return (Replicate(),) * len(mesh_shape(mesh))


def _kv_for_local_heads(k: torch.Tensor, heads: int, rank: int, parts: int) -> torch.Tensor:
    """The K/V heads (B, S, KV, hd) that query heads ``rank * heads`` to
    ``(rank + 1) * heads - 1`` of ``heads * parts`` read (query head ``h``
    reads K/V head ``h // G``): a slice when those heads cover whole K/V
    groups or sit in one, else each query head's K/V head, repeated."""
    H, KV = heads * parts, k.shape[2]
    G = H // KV
    lo, hi = rank * heads // G, ((rank + 1) * heads - 1) // G + 1
    if heads % G == 0 or G % heads == 0:
        return k[:, :, lo:hi]
    return k.repeat_interleave(G, dim=2)[:, :, rank * heads:(rank + 1) * heads]


def per_rank_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rows: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` (q (B, Sq, H, hd), k and v (B, Sk, KV, hd),
    ``rows`` plain tensors with one row per batch row) on each rank's own
    batch rows and heads through ``local_map``, q, k and v placed by
    ``heads`` and ``kv`` and their head dims made whole; -> placed like q.
    K/V heads the rules replicate while q's heads are sharded (GQA with few
    of them) are cut to the ones this rank's query heads read, and their
    gradient is summed over ``model``."""
    mesh, rules = current_mesh()
    qp = placements_for(q, ("batch", None, "heads", None))
    kp = placements_for(k, ("batch", None, "kv", None))
    model = rules.get("model")
    rank, parts = 0, 1
    if model is not None:
        m = list(mesh_shape(mesh)).index(model)
        if qp[m] == Shard(2) and kp[m] != Shard(2):     # K/V heads replicated
            rank, parts = mesh.get_local_rank(model), mesh_shape(mesh)[model]
    rows = [from_full(r, mesh, spec_of(("batch",) + (None,) * (r.dim() - 1), rules,
                                       r.shape, mesh), r.device) for r in rows]

    def local(q, k, v, *rows):
        if parts > 1:
            k = _kv_for_local_heads(k, q.shape[2], rank, parts)
            v = _kv_for_local_heads(v, q.shape[2], rank, parts)
        return fn(q, k, v, *rows)

    rp = [placements_for(r, ("batch",) + (None,) * (r.dim() - 1)) for r in rows]
    return local_apply(local, (q, k, v, *rows), (qp, kp, kp, *rp), qp)


def sharded_attention(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """``attend(q, k, v, causal=)`` (q (B, Sq, H, hd), k and v (B, Sk, KV,
    hd)) on DTensors under a mesh context: each rank calls ``attend`` on its
    own batch rows and heads (:func:`per_rank_heads`), so the flash kernel
    launches on every rank's shard and nothing moves where the rules shard
    heads on ``model``. Plain tensors go to ``attend`` as they are.

    - ``attn_fallback="replicate"``: q, k and v are whole on every rank.
    - ``attn_fallback="head_dim"``: the JAX package contracts the
      head-dim-sharded q k^T and p v on each shard and sums the partial
      products over ``model``. Here q, k and v are gathered over ``model``
      and each rank runs the kernel on whole heads: the same function, the
      sums taken in another order (float32 rounding). The output is cut
      back to the head-dim shards by the caller's constraint, a slice with
      no communication."""
    mesh, _ = current_mesh()
    if mesh is None or not is_dtensor(q):
        return attend(q, k, v, causal=causal)
    return per_rank_heads(lambda q, k, v: attend(q, k, v, causal=causal), q, k, v)


def local_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 a_logical: Sequence[str | None], b_logical: Sequence[str | None]) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; on DTensors under a mesh context, each
    rank's product of its shards through ``local_map``, ``a`` and ``b`` first placed by their
    logical axes. An output letter sharded in an operand is sharded in the
    output; a contracted letter sharded on a mesh dim leaves the output
    ``Partial`` there (summed by the next constraint).

    For the attention projections, whose einsum flattens (heads, head_dim):
    DTensor's own rule may shard that flat dim over ``model`` where the
    heads do not divide it, and then cannot unflatten it."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)) or current_mesh()[0] is None:
        return torch.einsum(eq, a, b)
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    ap, bp = placements_for(a, a_logical), placements_for(b, b_logical)
    outp = []
    for m, (pa, pb) in enumerate(zip(ap, bp)):
        letters = {lab[p.dim] for lab, p in ((la, pa), (lb, pb)) if isinstance(p, Shard)}
        for lab, p, other, po in ((la, pa, lb, pb), (lb, pb, la, pa)):
            if isinstance(p, Shard) and lab[p.dim] in other and po != Shard(other.index(lab[p.dim])):
                raise ValueError(f"{eq}: {lab[p.dim]!r} is sharded in one operand only "
                                 f"on mesh dim {m}")
        if len(letters) > 1:
            raise ValueError(f"{eq}: mesh dim {m} shards {sorted(letters)}")
        c = letters.pop() if letters else None
        outp.append(Replicate() if c is None else Shard(out.index(c)) if c in out else Partial())
    return local_apply(functools.partial(torch.einsum, eq), (a, b), (ap, bp), tuple(outp))


def whole_dim(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A DTensor with dim ``dim`` made whole on every rank (its other
    placements kept); a plain tensor unchanged. For reductions whose
    gradient DTensor cannot carry over a sharded dim (LayerNorm's mean and
    variance together)."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def whole(x):
    """The full tensor of a DTensor (a collective: every rank calls it), a
    plain tensor unchanged."""
    return x.full_tensor() if is_dtensor(x) else x
