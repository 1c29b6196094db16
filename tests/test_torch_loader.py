"""The port's ``ThallusLoader`` (a copy of the JAX package's) against the
original, on the CPU: the same seeded token tables behind replicated
servers give the same (tokens, labels) batches bit for bit over the
``thallus``, ``rpc`` and ``cluster`` transports, the same cursors, and the
same batches after a resume from a cursor. Then the slice as a whole: each
package's loader feeds its own train step from the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.engine as jengine
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.engine as tengine
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro_torch.launch.train import batch_to_device, make_loader
from repro_torch.models import params_from_numpy
from repro_torch.training import OptimizerConfig, TrainConfig, make_train_step

from test_torch_train import OPT, _cfgs, numpy_state

SQL, DATASET = "SELECT tokens FROM tok", "/d"
SEQ_LEN, BATCH_SEQS = 16, 8


def _loader(core, engine, data, transport, replicas=2, **kw):
    servers = []
    for _ in range(replicas):
        eng = engine.Engine()
        eng.register(DATASET, data.make_token_table("tok", 96, SEQ_LEN, 503,
                                                    seqs_per_batch=32, seed=3))
        servers.append(core.ThallusServer(eng, core.Fabric()))
    return data.ThallusLoader(servers, SQL, DATASET, seq_len=SEQ_LEN,
                              batch_seqs=BATCH_SEQS, transport=transport, **kw)


def _pair(transport, **kw):
    return (_loader(jcore, jengine, jdata, transport, **kw),
            _loader(tcore, tengine, tdata, transport, **kw))


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


TRANSPORTS = [("thallus", {}), ("rpc", {}), ("thallus", {"straggler_deadline_s": 0.0}),
              ("cluster", {}), ("cluster", {"num_streams": 2, "use_pool": False})]


@pytest.mark.parametrize("transport, kw", TRANSPORTS)
def test_loader_batches_equal_the_jax_loaders(transport, kw):
    jl, tl = _pair(transport, **kw)
    want, got = list(jl), list(tl)
    _assert_same_batches(got, want)
    assert len(got) == 96 // BATCH_SEQS
    np.testing.assert_array_equal(got[0]["labels"][:, :-1], got[0]["tokens"][:, 1:])
    assert (got[0]["labels"][:, -1] == -1).all()
    assert tl.state_dict() == jl.state_dict()
    for field in ("batches", "backup_requests", "stream_resumes", "backpressures"):
        assert getattr(tl.stats, field) == getattr(jl.stats, field), field
    if kw.get("straggler_deadline_s") == 0.0:
        assert tl.stats.backup_requests > 0


@pytest.mark.parametrize("transport", ["thallus", "rpc", "cluster"])
def test_loader_resumes_from_a_cursor_like_the_jax_loader(transport):
    """Stop after 5 training batches (inside the second record batch of 4),
    save the cursor, and resume a fresh loader from it: both packages give
    the same cursor and the same batches after it. The cursor counts the
    record batches pulled, so the resumed loader starts at the third record
    batch, past the rest of the second (a property of the reference's
    loader, reproduced)."""
    jl, tl = _pair(transport)
    whole = list(_loader(tcore, tengine, tdata, transport))
    cursors = []
    for loader in (jl, tl):
        it = iter(loader)
        for _ in range(5):
            next(it)
        cursors.append(loader.state_dict())
        it.close()
    assert cursors[0] == cursors[1]
    assert cursors[1]["batch_offset"] == 2
    jr, tr = _pair(transport)
    jr.load_state_dict(cursors[0])
    tr.load_state_dict(cursors[1])
    want, got = list(jr), list(tr)
    _assert_same_batches(got, want)
    _assert_same_batches(got, whole[8:])


def test_launcher_loader_feeds_the_same_steps_as_jax():
    """The slice as a whole on reduced granite: the launcher's loader
    (2 replicas, thallus) → the device → 3 train steps, against the JAX
    loader's batches through ``make_train_step`` from the same weights."""
    jcfg, tcfg = _cfgs()
    tree = numpy_state(jcfg)
    loader = make_loader(tcfg, num_seqs=64, seq_len=SEQ_LEN, batch_seqs=4, replicas=2,
                         transport="thallus")
    jservers = []
    for _ in range(2):
        eng = jengine.Engine()
        eng.register("/data/tokens", jdata.make_token_table("tokens", 64, SEQ_LEN,
                                                            jcfg.vocab_size, seqs_per_batch=32))
        jservers.append(jcore.ThallusServer(eng, jcore.Fabric()))
    jloader = jdata.ThallusLoader(jservers, "SELECT tokens FROM tokens", "/data/tokens",
                                  seq_len=SEQ_LEN, batch_seqs=4)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**OPT), remat="full")))
    tstep = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**OPT), remat="full"))
    jstate = jax.tree.map(jnp.asarray, tree)
    tstate = params_from_numpy(tree, "cpu")
    losses = []
    for _, jb, tb in zip(range(3), jloader, loader):
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jb))
        tstate, tm = tstep(tstate, batch_to_device(tb, torch.device("cpu")))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        losses.append(float(tm["loss"]))
    assert int(tstate["step"]) == 3 and len(set(losses)) == 3 and min(losses) > 1
