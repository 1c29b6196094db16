"""Per-device FLOPs, bytes and collectives of a call: the port's
counterpart of :mod:`repro.utils.hlo_cost`.

The JAX package walks the compiled, partitioned HLO text. The port has no
HLO: :func:`analyze` runs the call under a ``TorchDispatchMode``
(:class:`Counter`) and counts every ATen op it sees, as ``hlo_cost.py``
counts its instructions:

  flops            2 · numel(result) · contraction for products (``mm``,
                   ``addmm``, ``bmm``, ``baddbmm``, convolutions: the
                   formulas of ``torch.utils.flop_counter``); 1 a result
                   element for elementwise arithmetic (2 for ``addcmul``
                   and ``addcdiv``, which XLA has as two ops); 1 an input
                   element for reductions, as XLA's ``reduce`` body.
  transcendentals  1 a result element for ``exp``, ``log``, ``tanh``,
                   ``rsqrt``, ``sqrt``, ``sigmoid``, ``erf``, ... apart,
                   as in ``hlo_cost.py``.
  bytes            each op's inputs plus its outputs. Views and
                   uninitialised allocations move nothing; a gather reads
                   and writes its result and reads its indices, a scatter
                   its updates twice and its result once (``hlo_cost.py``'s
                   slice-aware rules); ``copy_`` reads its source and
                   writes its destination.
  collectives      the functional collectives seen, in the ring model of
                   :mod:`repro_torch.utils.collectives`.

*Per device.* On DTensors the counter steps aside (as ``CommDebugMode``
does) and counts what DTensor runs on this rank: its local shards and the
collectives of its redistributions. A sharded product counts its local
shard and replicated work counts whole on every rank, as XLA's per-device
HLO does.

*Fused regions.* The JAX package marks three regions with
``jax.named_scope("vmem_fused_attention")`` (prefill attention, decode
attention, the SSD's intra-chunk form): on a TPU they run as kernels whose
interior tensors stay on chip. The port marks the same regions with
:func:`fused`. When ``analyze`` is given their name in
``fused_functions``, an op inside such a region is charged only the bytes
of the inputs it reads from outside the region; its interior tensors cost
nothing, and its outputs are charged as inputs of their consumers outside
(``hlo_cost.py``'s rule). :func:`fused` marks the region's backward too
(JAX's named scopes survive transposition). FLOPs are the same in both
accountings.

*Kernels.* A kernel launched through ``ctypes`` is invisible to a dispatch
mode, so its wrapper counts its plain version instead
(:func:`counted_as`): the plain function runs on meta copies of the
kernel's inputs under the counter, while the kernel's own ops are not
counted. A call counts the same on the CPU, on the meta device and on the
card. The flash kernel thus counts the full Sq x Sk square of its plain
version, as JAX's ``chunked_attention`` computes it and its cost model
counts it, not the causal half the kernel computes.

When no counter is active, :func:`fused` and :func:`counted_as` do
nothing but call through, after one test of a module-level count of the
counters entered and not yet left.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten, tree_map

from .collectives import Collective, collective_of, collective_stats

FUSED_ATTENTION = "vmem_fused_attention"     # JAX's named_scope
FUSED_ATTENTION_FNS = (FUSED_ATTENTION,)

# op names (overload packets, trailing "_" of in-place ops dropped) -> flops
# and transcendentals per result element
_ELEMENTWISE = {name: (1, 0) for name in (
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "floor",
    "ceil", "round", "sign", "remainder", "fmod", "pow", "reciprocal",
    "masked_fill", "atan2", "trunc", "isnan", "threshold_backward")}
_ELEMENTWISE.update({name: (0, 1) for name in (
    "exp", "log", "tanh", "rsqrt", "sqrt", "sigmoid", "erf", "expm1", "log1p",
    "sin", "cos", "exp2", "log2")})
_ELEMENTWISE.update({
    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (2, 0),
    "silu": (1, 1),                  # x * logistic(x)
    "gelu": (4, 1),
    "silu_backward": (4, 1),         # g * s * (1 + x (1 - s)), s = logistic(x)
    "sigmoid_backward": (3, 0),      # g * y * (1 - y)
    "tanh_backward": (3, 0),         # g * (1 - y * y)
})
# reductions: flops per input element (a mean also divides its result)
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
               "argmax", "argmin", "cumsum", "cumprod", "logsumexp", "norm",
               "linalg_vector_norm", "var", "std"}
# softmax over the last dim: max, subtract, exp, sum, divide
_SOFTMAX = {"_softmax": (4, 1), "_log_softmax": (4, 1),
            "_softmax_backward_data": (3, 0), "_log_softmax_backward_data": (3, 1)}
# no data moved, nothing computed
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "_unsafe_view", "lift_fresh", "lift_fresh_copy", "wait_tensor", "_wrap_tensor_autograd", "_local_scalar_dense",
         "set_", "resize_", "record_stream", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_record_function_enter_new",
         "_record_function_exit"}
# writes its result only
_WRITE_ONLY = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
               "new_ones", "new_full", "arange", "fill", "zero", "scalar_tensor", "randn",
               "rand", "randint", "normal", "uniform", "bernoulli", "tril_indices"}
_GATHERS = {"embedding": 1, "index_select": 2, "gather": 2, "index": 1, "take_along_dim": 1}
_SCATTERS = {"embedding_dense_backward": 0, "index_add": 3, "scatter_add": 3, "scatter": 3,
             "index_put": 2, "index_copy": 3, "scatter_reduce": 3}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes += other.bytes * mult
        self.collective_wire_bytes += other.collective_wire_bytes * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) + v * mult
        for k, v in other.collective_bytes_by_op.items():
            self.collective_bytes_by_op[k] = (
                self.collective_bytes_by_op.get(k, 0) + v * mult)


def _nbytes(x) -> int:
    return sum(t.numel() * t.dtype.itemsize for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _numel(x) -> int:
    return sum(t.numel() for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor))


def _key(t: torch.Tensor) -> int:
    """The storage a tensor reads: a view and its base share it."""
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """Counts the ATen ops run under it (see the module's docstring):
    ``with Counter() as c: ...``, then ``c.cost(fused_functions)`` in
    either byte accounting from the one run."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._products = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.product_flops = 0.0                 # the products' share of flops
        self.transcendentals = 0.0
        self.bytes_outside = 0.0                 # ops in no region
        self.region_bytes: dict[str, list] = {}  # name -> [unfused, fused]
        self.collectives: list[Collective] = []
        self._regions: list[tuple[str, dict]] = []   # open regions: name, interior storages
        self._paused = 0

    # -- regions and kernels ----------------------------------------------
    def enter(self, name: str) -> None:
        self._regions.append((name, {}))

    def exit(self, name: str) -> None:
        for i in range(len(self._regions) - 1, -1, -1):
            if self._regions[i][0] == name:
                del self._regions[i]
                return

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def interior(self, t: torch.Tensor) -> bool:
        return bool(self._regions) and _key(t) in self._regions[-1][1]

    def mark_interior(self, t: torch.Tensor) -> None:
        if self._regions:
            self._regions[-1][1][_key(t)] = t.untyped_storage()

    # -- the mode ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs, and its local ops come back here
        out = func(*args, **kwargs)
        if (not self._paused and isinstance(func, torch._ops.OpOverload)
                and _fake_mode() is self._fake):
            self._count(func, args, kwargs, out)
        return out

    def __enter__(self):
        global _entered
        # a fake mode entered later is DTensor's sharding propagation, which
        # runs each new op once on fake global tensors: not this rank's work
        self._fake = _fake_mode()
        out = super().__enter__()
        _entered += 1
        return out

    def __exit__(self, *exc):
        global _entered
        _entered -= 1
        return super().__exit__(*exc)

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        if func.is_view or base in _FREE:
            if self._regions and any(isinstance(a, torch.Tensor) and self.interior(a)
                                     for a in tree_flatten(args)[0]):
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self.mark_interior(t)
            return
        coll = collective_of(func, args, out)
        if coll is not None:
            self.collectives.append(coll)
        inputs = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        # flops
        if packet in self._products:
            f = self._products[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.product_flops += f
        elif base in _ELEMENTWISE:
            f, tr = _ELEMENTWISE[base]
            n = _numel(outputs)
            self.flops += f * n
            self.transcendentals += tr * n
        elif base in _SOFTMAX:
            f, tr = _SOFTMAX[base]
            n = _numel(outputs)
            self.flops += f * n
            self.transcendentals += tr * n
        elif base in _REDUCTIONS:
            self.flops += inputs[0].numel() if inputs else 0
            if base == "mean":
                self.flops += _numel(outputs)
        # bytes, unfused
        if base in _WRITE_ONLY:
            nbytes = _nbytes(outputs)
        elif base in _GATHERS:
            idx = args[_GATHERS[base]]
            nbytes = 2 * _nbytes(outputs) + _nbytes(idx)
        elif base in _SCATTERS:
            pos = _SCATTERS[base]
            upd = args[pos] if pos < len(args) else outputs
            nbytes = 2 * _nbytes(upd) + _nbytes(outputs)
        elif base == "copy":
            nbytes = _nbytes(args[1]) + _nbytes(args[0])
        else:
            nbytes = _nbytes(inputs) + _nbytes(outputs)
        if not self._regions:
            self.bytes_outside += nbytes
            return
        # fused: only the inputs read from outside the region
        fused_bytes = sum(_nbytes(t) for t in inputs if not self.interior(t))
        acc = self.region_bytes.setdefault(self._regions[-1][0], [0.0, 0.0])
        acc[0] += nbytes
        acc[1] += fused_bytes
        for t in outputs:
            self.mark_interior(t)

    # -- the result -------------------------------------------------------
    def cost(self, fused_functions: tuple[str, ...] = ()) -> Cost:
        stats = collective_stats(self.collectives)
        nbytes = self.bytes_outside + sum(
            fused if name in fused_functions else full
            for name, (full, fused) in self.region_bytes.items())
        return Cost(flops=float(self.flops), transcendentals=float(self.transcendentals),
                    bytes=float(nbytes), collective_wire_bytes=stats.total_wire_bytes,
                    collective_counts=dict(stats.counts),
                    collective_bytes_by_op=dict(stats.wire_bytes))


def _fake_mode():
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


_entered = 0     # Counters entered and not yet left, in any thread


def active() -> Counter | None:
    """The innermost :class:`Counter` in effect in this thread, or ``None``."""
    if not _entered:
        return None
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, Counter)), None)


def analyze(fn, *args, fused_functions: tuple[str, ...] = (), **kwargs) -> Cost:
    """The per-device :class:`Cost` of ``fn(*args, **kwargs)``, run once
    under a :class:`Counter`; bytes in the fused accounting of the regions
    named in ``fused_functions``."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.cost(fused_functions)


# ---------------------------------------------------------------- marks in the model

class _Mark(torch.autograd.Function):
    """Identity whose backward opens (``"enter"``) or closes (``"exit"``)
    the region ``name`` on the counter: put at a region's outputs, its
    backward opens the region's backward; at its inputs, closes it."""

    @staticmethod
    def forward(ctx, counter, name, what, *xs):
        ctx.counter, ctx.name, ctx.what = counter, name, what
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.what == "enter":
            ctx.counter.enter(ctx.name)
        else:
            ctx.counter.exit(ctx.name)
        return (None, None, None, *grads)


def fused(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the fused region ``name``, forward and,
    where autograd records it, backward."""
    c = active()
    if c is None:
        return fn(*args, **kwargs)

    def grads(xs):
        return [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor) and x.requires_grad]

    def mark(xs, what):
        xs, at = list(xs), grads(xs)
        for i, x in zip(at, _Mark.apply(c, name, what, *(xs[i] for i in at))):
            xs[i] = x
        return xs

    track = torch.is_grad_enabled() and grads(args)
    if track:
        args = mark(args, "exit")
    c.enter(name)
    try:
        out = fn(*args, **kwargs)
    finally:
        c.exit(name)
    if track:
        if isinstance(out, torch.Tensor):
            return mark([out], "enter")[0] if out.requires_grad else out
        if isinstance(out, tuple) and grads(out):
            return tuple(mark(out, "enter"))
    return out


def on_meta(tree):
    """The same tree with each tensor copied to the meta device: shape,
    strides and dtype, no data."""
    return tree_map(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                  device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def counted_as(plain, *args, **kwargs):
    """A context inside which a kernel runs that the counter cannot see:
    count ``plain(*args, **kwargs)`` on meta copies of the tensors in
    ``args`` instead, and none of the block's own ops."""
    c = active()
    return contextlib.nullcontext() if c is None else _counted_as(c, plain, args, kwargs)


@contextlib.contextmanager
def _counted_as(c: Counter, plain, args, kwargs):
    with c.paused():
        metas = on_meta(args)
        for t, m in zip(tree_flatten(args)[0], tree_flatten(metas)[0]):
            if isinstance(t, torch.Tensor) and c.interior(t):
                c.mark_interior(m)
    plain(*metas, **kwargs)
    with c.paused():
        yield
