"""The port's counters against the JAX package's, on the CPU:
``repro_torch.utils.roofline`` against ``repro.utils.roofline``,
``collectives`` against ``repro.utils.hlo`` and ``cost`` against
``repro.utils.hlo_cost``.

The JAX side compiles each call with ``jax.jit(...).lower(...).compile()``
and reads the HLO text with ``HloCostModel``; the port's side runs the same
call on the same inputs (JAX's init, converted by ``models/convert.py``;
batches from numpy seeds) under :class:`repro_torch.utils.cost.Counter`.
Cases, at reduced sizes: granite-3-2b's prefill, decode step (on the
prefill's cache grown by ``EXTRA`` slots) and train step (remat none,
AdamW), olmoe-1b-7b's prefill and mamba2-780m's prefill (``S = 24``: three
SSD chunks of 8).

*Products* are held exactly: the port's ``mm``/``bmm``/``addmm`` FLOPs
equal the FLOPs of JAX's ``dot`` instructions, summed through
``HloCostModel`` (loops multiplied by their trip counts). That holds for
mamba2 too: JAX's three-operand einsum for the chunk-final states
(``repro/models/mamba2.py:124-125``) lowers to a multiply and one product
over ``s``, as the port's multiply and two-operand einsum do
(``src/repro_torch/models/mamba2.py``), so no product is exempt. The
train step's flash backward skips the output product p v, as XLA's
recompute of the checkpointed ``chunked_attention`` does.

*Totals* are held within bands, as a count of ATen ops and a count of
optimised HLO differ in what is an op:
- FLOPs (``FLOP_BAND``): the elementwise and reduction ops. XLA can fold
  constant work (the rope's tables at positions known when compiling) and
  simplifies what it fuses; the port counts every ATen op as it runs: the
  rope's ``cos``/``sin`` and inverse frequencies on every call, a
  ``_softmax`` as 4 ops an element. JAX's ``lax.scan`` of the SSD's
  inter-chunk recurrence is a multiply and an add an element, the port's
  ``addcmul`` two; both are in the band.
- transcendentals (``TRANS_BAND``): the same folding, mostly of the
  rope's ``cos``/``sin``.
- bytes (``BYTES_BAND``, both accountings): XLA charges a fusion its
  boundary, the port every op its inputs and outputs, and the port's views
  move nothing where XLA's copies and ``dynamic-slice``s do. JAX's scan
  over the layers slices each layer's weights out of the stacked ones and
  writes each layer's cache slot into the whole stacked cache, and copies
  the cache; the port reads each layer's weights and cache as views and
  writes the slot in place. With one token a row those copies are most of
  JAX's decode bytes, so the decode step's band is wider
  (``DECODE_BYTES_BAND``).
The gaps measured are in ``CHANGES.md``.

*Per device.* On a ``fake`` process group of 4 ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``) and a (2, 2)
mesh of meta DTensors: a product sharded on both mesh dims counts a
quarter of the global FLOPs, replicated work counts whole, and a
Shard -> Replicate redistribution counts its all-gathers by the ring
model, equal to JAX's ``collective_stats`` on the same ops written as HLO.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import decode as jax_decode
from repro.models import prefill as jax_prefill
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro.utils import hlo as jhlo
from repro.utils import roofline as jroofline
from repro.utils.hlo_cost import FUSED_ATTENTION_FNS as JAX_FUSED
from repro.utils.hlo_cost import HloCostModel
from repro_torch.configs import get_config
from repro_torch.kernels import attention as tattn
from repro_torch.models import decode, params_from_numpy, prefill
from repro_torch.training import OptimizerConfig, TrainConfig, make_train_step
from repro_torch.utils import collectives, cost, roofline

from test_torch_families import ONE_STEP, _cfgs, _jax, _numpy_state, numpy_batch, numpy_params

S, EXTRA = 16, 4
FLOP_BAND = 0.12          # |port / JAX - 1| of total FLOPs
TRANS_BAND = 0.15
BYTES_BAND = 0.35
DECODE_BYTES_BAND = 0.75
CASES = ("granite-prefill", "granite-decode", "granite-train", "olmoe-prefill",
         "mamba2-prefill")
ARCH = {"granite": "granite-3-2b", "olmoe": "olmoe-1b-7b", "mamba2": "mamba2-780m"}


class _DotFlops(HloCostModel):
    """``HloCostModel`` counting the FLOPs of ``dot`` instructions only
    (through fusions, calls and loops, times their trip counts)."""
    _THROUGH = {"while", "call", "fusion", "conditional", "async-start", "custom-call"}

    def _instr_cost(self, comp, instr):
        c = super()._instr_cost(comp, instr)
        if instr.op != "dot" and instr.op not in self._THROUGH:
            c.flops = 0.0
        return c


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _case_calls(case):
    """(JAX's jitted function, its arguments, the port's call) of a case."""
    name, what = case.split("-")
    arch = ARCH[name]
    jcfg, tcfg = _cfgs(arch)
    tree = numpy_params(arch)
    length = 24 if name == "mamba2" else S
    batch = numpy_batch(tcfg, length=length)
    head = {k: v for k, v in batch.items() if k != "labels"}
    if what == "prefill":
        return (jax.jit(lambda p, b: jax_prefill(jcfg, p, b)), (_jax(tree), _jax(head)),
                lambda: prefill(tcfg, params_from_numpy(tree, "cpu"), _torch_tree(head)))
    if what == "decode":
        _, cache = jax.jit(lambda p, b: jax_prefill(jcfg, p, b))(_jax(tree), _jax(head))
        cache = {k: np.pad(np.asarray(v), [(0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)])
                 if k in ("k", "v") else np.asarray(v) for k, v in cache.items()}
        tok = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        return (jax.jit(lambda p, c, t, i: jax_decode(jcfg, p, c, t, i)),
                (_jax(tree), _jax(cache), jnp.asarray(tok), jnp.int32(S)),
                lambda: decode(tcfg, params_from_numpy(tree, "cpu"), _torch_tree(cache),
                               torch.from_numpy(tok), S))
    state = _numpy_state(arch)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**ONE_STEP), remat="none")))
    step = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**ONE_STEP),
                                             remat="none"))

    def port():
        st = {"params": params_from_numpy(state["params"], "cpu"),
              "opt": {k: params_from_numpy(v, "cpu") for k, v in state["opt"].items()},
              "step": torch.zeros((), dtype=torch.int32)}
        return step(st, _torch_tree(batch))

    return jstep, (_jax(state), _jax(batch)), port


_COUNTS = {}


def _counts(case):
    """JAX's costs (unfused, fused, dots only) and the port's counter."""
    if case not in _COUNTS:
        jfn, jargs, port = _case_calls(case)
        txt = jfn.lower(*jargs).compile().as_text()
        jax_costs = (HloCostModel(txt, 1).entry_cost(),
                     HloCostModel(txt, 1, JAX_FUSED).entry_cost(),
                     _DotFlops(txt, 1).entry_cost().flops)
        with cost.Counter() as counter:
            port()
        _COUNTS[case] = jax_costs, counter
    return _COUNTS[case]


# ---------------------------------------------------------------- counts against JAX's

@pytest.mark.parametrize("case", CASES)
def test_product_flops_equal_jax_dot_flops(case):
    (_, _, jax_dots), counter = _counts(case)
    assert jax_dots > 0
    assert counter.product_flops == jax_dots


@pytest.mark.parametrize("case", CASES)
def test_totals_fall_within_the_band_of_jax(case):
    (junf, jfus, _), counter = _counts(case)
    unf, fus = counter.cost(), counter.cost(cost.FUSED_ATTENTION_FNS)
    bytes_band = DECODE_BYTES_BAND if case.endswith("decode") else BYTES_BAND
    for what, got, want, band in (("flops", unf.flops, junf.flops, FLOP_BAND),
                                  ("transcendentals", unf.transcendentals,
                                   junf.transcendentals, TRANS_BAND),
                                  ("bytes", unf.bytes, junf.bytes, bytes_band),
                                  ("fused bytes", fus.bytes, jfus.bytes, bytes_band)):
        assert want > 0 and abs(got / want - 1) <= band, (what, got, want)
    assert unf.flops == fus.flops and unf.transcendentals == fus.transcendentals


@pytest.mark.parametrize("case", CASES)
def test_fused_bytes_fall_below_unfused_in_both_packages(case):
    (junf, jfus, _), counter = _counts(case)
    assert jfus.bytes < junf.bytes
    assert counter.cost(cost.FUSED_ATTENTION_FNS).bytes < counter.cost().bytes


def test_train_step_counts_the_attention_backward_as_a_fused_region():
    """The region's backward is marked too: at most its inputs from
    outside are charged, so the train step's fused saving exceeds its
    forward's (the prefill's, one layer stack of the same model)."""
    _, step = _counts("granite-train")
    _, fwd = _counts("granite-prefill")
    saved = step.cost().bytes - step.cost(cost.FUSED_ATTENTION_FNS).bytes
    saved_fwd = fwd.cost().bytes - fwd.cost(cost.FUSED_ATTENTION_FNS).bytes
    assert saved > 1.5 * saved_fwd


# ---------------------------------------------------------------- the op rules

_X = torch.ones(6, 5)
_IDX = torch.tensor([0, 2, 2, 5])
# name -> (call, flops, transcendentals, bytes): hlo_cost.py's rules on ATen ops
_RULES = {
    "elementwise": (lambda: _X + _X, 30, 0, 3 * 120),
    "in-place": (lambda: _X.clone().mul_(2.0), 30, 0, 120 + 120 + 2 * 120),
    "transcendental": (lambda: torch.exp(_X), 0, 30, 2 * 120),
    "reduction": (lambda: _X.sum(-1), 30, 0, 120 + 6 * 4),
    "mean": (lambda: _X.mean(-1), 30 + 6, 0, 120 + 6 * 4),
    "product": (lambda: _X @ _X.T, 2 * 6 * 6 * 5, 0, 2 * 120 + 36 * 4),
    "gather": (lambda: torch.index_select(_X, 0, _IDX), 0, 0, 2 * 4 * 5 * 4 + 4 * 8),
    "embedding": (lambda: torch.nn.functional.embedding(_IDX, _X), 0, 0, 2 * 4 * 5 * 4 + 4 * 8),
    "copy": (lambda: torch.empty(6, 5).copy_(_X), 0, 0, 2 * 120),
    "view": (lambda: _X.view(5, 6).transpose(0, 1), 0, 0, 0),
}


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_op_rules(rule):
    call, flops, trans, nbytes = _RULES[rule]
    got = _count(call)[0]
    assert (got.flops, got.transcendentals, got.bytes) == (flops, trans, nbytes)
    assert cost.analyze(call) == got


# ---------------------------------------------------------------- the flash kernel

def _qkv(device):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (q, k, v)]


def _count(fn, *args, **kwargs):
    with cost.Counter() as c:
        fn(*args, **kwargs)
    return c.cost(), c.cost(cost.FUSED_ATTENTION_FNS), c.product_flops


def test_flash_gqa_and_its_plain_version_count_the_same():
    q, k, v = _qkv("cpu")
    got = _count(cost.fused, cost.FUSED_ATTENTION, tattn.flash_gqa, q, k, v, causal=True)
    want = _count(cost.fused, cost.FUSED_ATTENTION, tattn.flash_gqa_ref, q, k, v, causal=True)
    assert got == want
    B, Sq, H, hd = q.shape
    assert got[2] == 2 * (2 * B * H * Sq * Sq * hd)     # the full square, both products


def test_a_kernel_launch_counts_as_its_plain_version(monkeypatch):
    """The card's path (the launch stood in for by an empty output) counts
    what the CPU and the meta device count, forward and backward."""
    from repro_torch.kernels import _build

    def train(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = cost.fused(cost.FUSED_ATTENTION, tattn.flash_gqa, q, k, v, causal=True)
        out.sum().backward()

    cpu, meta = _count(train, *_qkv("cpu")), _count(train, *_qkv("meta"))
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(tattn.attention, "_kernel_forward",
                        lambda q, k, v, causal: torch.zeros_like(q))
    card = _count(train, *_qkv("cpu"))
    assert cpu == meta == card
    assert cpu[1].bytes < cpu[0].bytes


def test_marks_call_through_without_a_counter():
    q, k, v = _qkv("cpu")
    assert cost.active() is None
    out = cost.fused(cost.FUSED_ATTENTION, tattn.flash_gqa_ref, q, k, v, causal=True)
    torch.testing.assert_close(out, tattn.flash_gqa_ref(q, k, v, causal=True), rtol=0, atol=0)
    with cost.counted_as(tattn.attention_ref, q, q, q):
        pass


def test_the_no_counter_test_follows_the_counters_entered():
    """Without a counter, ``active()`` answers from one module-level count
    that every Counter's ``with`` keeps, also when its block raises."""
    assert cost._entered == 0 and cost.active() is None
    with cost.Counter() as outer:
        with cost.Counter() as inner:
            assert cost._entered == 2 and cost.active() is inner
        assert cost._entered == 1 and cost.active() is outer
        with pytest.raises(RuntimeError, match="inside"):
            with cost.Counter():
                raise RuntimeError("inside")
        assert cost._entered == 1 and cost.active() is outer
    assert cost._entered == 0 and cost.active() is None


# ---------------------------------------------------------------- collectives

_JAX_DTYPES = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8, "s16": torch.int16,
               "u16": torch.uint16, "f16": torch.float16, "bf16": torch.bfloat16,
               "s32": torch.int32, "u32": torch.uint32, "f32": torch.float32,
               "s64": torch.int64, "u64": torch.uint64, "f64": torch.float64,
               "c64": torch.complex64, "c128": torch.complex128}


def test_every_jax_dtype_is_compared():
    assert set(_JAX_DTYPES) == set(jhlo._DTYPE_BYTES)


@pytest.mark.parametrize("name", sorted(_JAX_DTYPES))
def test_shape_bytes_match_jax(name):
    for shape in ((), (7,), (3, 5, 2)):
        assert (collectives.shape_bytes(_JAX_DTYPES[name], shape)
                == jhlo.shape_bytes(name, ",".join(map(str, shape))))


_HLO_OPS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute")


def _hlo_line(c: collectives.Collective, world: int = 16) -> str:
    n = c.result_bytes // 4
    return (f"  %{c.op}.1 = f32[{n}]{{0}} {c.op}(%p), "
            f"replica_groups=[{world // c.group_size},{c.group_size}]<=[{world}]")


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("op", _HLO_OPS)
def test_ring_model_matches_jax(op, group):
    record = [collectives.Collective(op, 4 * 4096, group),
              collectives.Collective(op, 4 * 96, group)]
    want = jhlo.collective_stats("\n".join(_hlo_line(c) for c in record), 16)
    got = collectives.collective_stats(record)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    assert (got.counts == {}) == (group == 1)


# ---------------------------------------------------------------- per device

@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh over a 4-rank ``fake`` process group, this process rank
    0; the group is destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _meta_dtensor(mesh, shape, placements):
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(dim)
    stride = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                              run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def test_counts_are_per_device_on_a_fake_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    M, K, N = 64, 32, 48
    x = _meta_dtensor(fake_mesh, (M, K), [Shard(0), Replicate()])
    w = _meta_dtensor(fake_mesh, (K, N), [Replicate(), Shard(1)])
    for _ in range(2):      # DTensor's first, uncached sharding propagation is not counted
        sharded = _count(torch.matmul, x, w)[0]
        assert sharded.flops == 2 * M * K * N / 4
        assert sharded.collective_counts == {}
    y = _meta_dtensor(fake_mesh, (M, K), [Replicate(), Replicate()])
    replicated = _count(torch.mul, y, 2.0)[0]
    assert replicated.flops == M * K
    assert _count(torch.matmul, torch.empty(M, K, device="meta"),
                  torch.empty(K, N, device="meta"))[0].flops == 2 * M * K * N


@pytest.mark.parametrize("placements", ["S0R", "S0S1"])
def test_a_redistribution_counts_its_collectives_by_the_ring_model(fake_mesh, placements):
    from torch.distributed.tensor import Replicate, Shard
    M, K = 64, 32
    start = [Shard(0), Replicate()] if placements == "S0R" else [Shard(0), Shard(1)]
    x = _meta_dtensor(fake_mesh, (M, K), start)
    with cost.Counter() as c:
        x.redistribute(fake_mesh, [Replicate(), Replicate()])
    got = c.cost()
    gathers = 1 if placements == "S0R" else 2
    assert got.collective_counts == {"all-gather": gathers}
    assert [r.group_size for r in c.collectives] == [2] * gathers
    want = sum(0.5 * r.result_bytes for r in c.collectives)
    assert got.collective_wire_bytes == want
    assert c.collectives[-1].result_bytes == M * K * 4     # the last gather's result is whole
    jax_stats = jhlo.collective_stats("\n".join(_hlo_line(r, 4) for r in c.collectives), 4)
    assert got.collective_wire_bytes == jax_stats.total_wire_bytes
    assert got.collective_counts == jax_stats.counts


# ---------------------------------------------------------------- roofline

def test_roofline_has_jax_keys_and_the_h100_constants():
    port = roofline.Roofline(2e12, 3e9, 4e8, 1e12)
    jax_r = jroofline.Roofline(2e12, 3e9, 4e8, 1e12)
    assert port.to_dict().keys() == jax_r.to_dict().keys()
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_FP32) == (989.4e12, 66.9e12)
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 450e9)
    assert port.compute_s == 2e12 / 989.4e12 and port.memory_s == 3e9 / 3.35e12
    assert port.collective_s == 4e8 / 450e9 and port.bottleneck == "compute"
    fp32 = roofline.Roofline(2e12, 3e9, 4e8, 1e12, peak_flops=roofline.PEAK_FLOPS_FP32)
    assert fp32.compute_s == 2e12 / 66.9e12
    assert fp32.mfu_bound == 1e12 / (fp32.step_s * 66.9e12)
    assert port.useful_flops_ratio == jax_r.useful_flops_ratio == 0.5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    """N from each package's own config (``num_params``, active for MoE),
    as the dry run takes it (``dryrun_lib.py:232-234``)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for kind, tokens in (("train", 8 * 128), ("prefill", 4 * 1024), ("decode", 4)):
        for active in (False, True):
            assert (roofline.model_flops(tcfg.num_params(active_only=active), tokens, kind)
                    == jroofline.model_flops(jcfg.num_params(active_only=active), tokens, kind))
