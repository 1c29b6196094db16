"""The port's ``qos``, ``sched`` and ``obs`` copies against the JAX package's,
on the CPU, through the three callers that reach them: the ``ScanGateway``
itself, ``ThallusLoader(transport="gateway")`` (with ``metrics()`` and
``health()``), and the serving ``Batcher``'s ``submit_scan``/``ingest_scan``.

Every scenario runs the same seeded requests on the 64-sequence token table
of ``tests/test_sched.py`` behind two replicated servers, once in each
package. Batches and served tokens must be equal bit for bit; shared flags,
shed requests, grant order and counters equal; and the ``QosStats`` and
``MetricsRegistry`` snapshots equal key by key, except the keys named in
``WALL_CLOCK_*``/``PREEMPT_CLOCK_*`` below, which hold measured host time. Those
keys must be present in both snapshots and be finite.
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import decode as jax_decode
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.models import decode, params_from_numpy, prefill

PKGS = ("repro", "repro_torch")
SQL, SEQ_SQL, DATASET = "SELECT tokens FROM tok", "SELECT seq_id, tokens FROM tok", "/tok"

# Measured on the host clock, not modeled: each stream's transport clock
# (``StreamStats.clock_s`` with its ``alloc_s``/``deserialize_s``, and
# ``ClusterStats.critical_path_s`` over them) and the buffer pool's
# ``acquire_s`` (``cluster/mempool.py:137-144``).
WALL_CLOCK_FIELDS = ("alloc_s", "deserialize_s", "clock_s", "acquire_s")
WALL_CLOCK_KEYS = ("cluster.critical_path.us", "cluster.stream.clock.us.", "pool.acquire.us")
# ``modeled_service`` does not reach the preemptible path: each lease round of
# a parkable scan advances the gateway clock by the streams' measured clocks
# (``sched/preempt.py``, ``run_round``), so with a preemption the service and
# makespan, and the grant latency of every request granted after such a
# round, are measured time too (ROADMAP, faults of the reference).
PREEMPT_CLOCK_KEYS = ("qos.makespan.us", "qos.service.us", "qos.class.batch.service.us",
                      "qos.class.interactive.grant_latency.", "qos.grant_latency.")
PREEMPT_CLOCK_FIELDS = ("makespan_s", "classes.batch.service_s",
                        "classes.interactive.grant_latency_s.")


def _pkg(root):
    return {m: importlib.import_module(f"{root}.{m}")
            for m in ("core", "engine", "cluster", "data", "qos", "sched", "obs")}


def _token_cluster(P, health=False):
    table = P["data"].make_token_table("tok", num_seqs=64, seq_len=32, vocab_size=128,
                                       seqs_per_batch=16)
    coord = P["cluster"].ClusterCoordinator()
    for i in range(2):
        eng = P["engine"].Engine()
        eng.register(DATASET, table)
        coord.add_server(f"s{i}", P["core"].ThallusServer(eng, P["core"].Fabric()))
    coord.place_replicas(DATASET, table)
    if health:
        coord.recorder = P["obs"].FlightRecorder()
        coord.health = P["obs"].HealthMonitor(recorder=coord.recorder)
    return coord


def _gateway(P, coord, preempt=True, tickets=True, pool=True):
    q, s = P["qos"], P["sched"]
    return q.ScanGateway(
        coord, classes=[q.ClientClass("interactive", 4.0), q.ClientClass("batch", 1.0)],
        admission=q.AdmissionController(q.AdmissionConfig(max_streams_per_client=2)),
        scheduler=s.AdaptiveScheduler(tickets=s.TicketTable() if tickets else None,
                                      preempt=s.PreemptConfig() if preempt else None),
        pool=P["cluster"].BufferPool() if pool else None, modeled_service=True)


def _is_measured(key, prefixes):
    return any(key == p or (p.endswith(".") and key.startswith(p)) or key.endswith("." + p)
               for p in prefixes)


def assert_snapshots_equal(got, want, measured):
    """Equal key by key; a measured key present on both sides and finite."""
    assert got.keys() == want.keys()
    held = 0
    for key in want:
        if _is_measured(key, measured):
            assert math.isfinite(got[key]) and math.isfinite(want[key]), key
        else:
            assert got[key] == want[key], key
            held += 1
    assert held > 0.5 * len(want)   # the named keys are the exception


def _stats_snapshot(P, stats):
    reg = P["obs"].MetricsRegistry()
    P["obs"].registry.record_any(reg, "stats", stats)
    return {k[len("stats."):]: v for k, v in reg.snapshot().items()}


def _gateway_snapshot(P, gateway):
    reg = P["obs"].MetricsRegistry()
    P["obs"].registry.record_gateway(reg, gateway)
    return reg.snapshot()


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.schema.to_dict() == w.schema.to_dict() and g.num_rows == w.num_rows
        for cg, cw in zip(g.columns, w.columns):
            for x, y in ((cg.values, cw.values), (cg.offsets, cw.offsets),
                         (cg.validity, cw.validity)):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- gateway

def _run_gateway(root, preempt):
    """Two identical interactive scans that coalesce onto one ticket, a batch
    scan that (with ``preempt``) a later interactive arrival parks, and a
    batch scan whose deadline sheds it at submit."""
    P = _pkg(root)
    gw = _gateway(P, _token_cluster(P), preempt=preempt)
    R = P["qos"].ScanRequest
    submitted = [
        gw.submit(R("bulk", "batch", SEQ_SQL, DATASET, cost_hint=8.0)),
        gw.submit(R("u1", "interactive", SQL, DATASET, arrival_s=1e-6)),
        gw.submit(R("u2", "interactive", SQL, DATASET, arrival_s=1e-6)),
        gw.submit(R("late", "batch", "SELECT seq_id FROM tok", DATASET, cost_hint=4.0,
                    deadline_s=1e-7)),
    ]
    granted = gw.run()
    return P, gw, submitted, granted


@pytest.mark.parametrize("preempt", [False, True], ids=["coalesce-shed", "preempt"])
def test_gateway_matches_jax(preempt):
    runs = [_run_gateway(root, preempt) for root in PKGS]
    (_, jgw, jsub, jgranted), (_, tgw, tsub, tgranted) = runs
    shed = [[i for i, r in enumerate(sub) if r is None] for _, _, sub, _ in runs]
    assert shed[0] == shed[1] == [3]
    assert [r.request_id for r in tsub if r] == [r.request_id for r in jsub if r] == [0, 1, 2]

    def outcome(granted):
        return [(r.request.request_id, r.request.client_id, r.shared, r.preemptions)
                for r in granted]

    assert outcome(tgranted) == outcome(jgranted) == \
        [(1, "u1", False, 0), (2, "u2", True, 0), (0, "bulk", False, int(preempt))]
    for jr, tr in zip(jgranted, tgranted):
        assert_batches_equal(tr.batches, jr.batches)
        if not preempt:
            assert (tr.grant_latency_s, tr.service_s) == (jr.grant_latency_s, jr.service_s)
    # the coalesced pair read the same rows; the bulk scan its own columns
    assert_batches_equal(tgranted[1].batches, tgranted[0].batches)
    assert tgw.stats.ticket_hits == jgw.stats.ticket_hits == 1
    assert tgw.stats.preemptions == jgw.stats.preemptions == int(preempt)
    assert tgw.stats.shed == jgw.stats.shed == 1
    assert tgw.stats.summary().split()[:3] == jgw.stats.summary().split()[:3]

    fields = WALL_CLOCK_FIELDS + (PREEMPT_CLOCK_FIELDS if preempt else ())
    keys = WALL_CLOCK_KEYS + (PREEMPT_CLOCK_KEYS if preempt else ())
    assert_snapshots_equal(_stats_snapshot(runs[1][0], tgw.stats),
                           _stats_snapshot(runs[0][0], jgw.stats), fields)
    tsnap, jsnap = _gateway_snapshot(runs[1][0], tgw), _gateway_snapshot(runs[0][0], jgw)
    assert tsnap["qos.ticket_hits"] == 1 and tsnap["sched.tickets.hits"] == 1
    assert tsnap["pool.hits"] + tsnap["pool.misses"] > 0
    assert_snapshots_equal(tsnap, jsnap, keys)


def test_gateway_sheds_in_queue_and_fails_bad_sql_like_jax():
    """The drain's other exits: a deadline that expires while queued, and a
    malformed request that fails without taking the queue down."""
    out = []
    for root in PKGS:
        P = _pkg(root)
        gw = _gateway(P, _token_cluster(P), preempt=False, pool=False)
        R = P["qos"].ScanRequest
        # nothing is queued ahead of the batch request when it arrives, so it
        # passes the submit check; the interactive one then goes first
        late = gw.submit(R("b", "batch", SQL, DATASET, deadline_s=1e-9))
        first = gw.submit(R("a", "interactive", SEQ_SQL, DATASET))
        bad = gw.submit(R("c", "interactive", "SELECT nope FROM tok", DATASET))
        gw.run()
        out.append((P, gw, [gw.result(r.request_id) for r in (first, late, bad)]))
    (jP, jgw, jres), (tP, tgw, tres) = out
    assert [r is None for r in tres] == [r is None for r in jres] == [False, True, True]
    assert_batches_equal(tres[0].batches, jres[0].batches)
    assert (tgw.stats.shed, tgw.stats.failed) == (jgw.stats.shed, jgw.stats.failed) == (1, 1)
    assert_snapshots_equal(_gateway_snapshot(tP, tgw), _gateway_snapshot(jP, jgw),
                           WALL_CLOCK_KEYS)


# ---------------------------------------------------------------- loader

def _gateway_loader(P, gw, **kw):
    return P["data"].ThallusLoader([], SQL, DATASET, seq_len=32, batch_seqs=8,
                                   transport="gateway", gateway=gw, **kw)


def _solo_chunks(P, coord):
    return list(P["data"].ThallusLoader([coord.server("s0")], SQL, DATASET, seq_len=32,
                                        batch_seqs=8))


def assert_chunks_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _run_loader(root, mode):
    """``shared``: another tenant already queued the identical scan, so the
    loader's request rides its ticket. ``preempt``: the loader's batch-class
    scan is parked for an interactive lookup. A fault on s1 and a heartbeat
    give the attached health monitor something to report."""
    P = _pkg(root)
    coord = _token_cluster(P, health=True)
    if mode == "shared":
        gw = _gateway(P, coord, preempt=False)
        gw.submit(P["qos"].ScanRequest("tenant", "interactive", SQL, DATASET))
        loader = _gateway_loader(P, gw, client_id="trainer")
    else:
        gw = _gateway(P, coord, tickets=False)
        loader = _gateway_loader(P, gw, klass="batch")
        gw.submit(P["qos"].ScanRequest("ui", "interactive", "SELECT seq_id FROM tok",
                                       DATASET, arrival_s=1e-6))
    chunks = list(loader)
    coord.notify("stream.fault", server_id="s1", now_s=1.0)
    coord.heartbeat(1.0)
    return P, coord, loader, chunks


@pytest.mark.parametrize("mode", ["shared", "preempt"])
def test_gateway_loader_matches_jax(mode):
    (jP, jcoord, jl, jchunks), (tP, tcoord, tl, tchunks) = (_run_loader(r, mode) for r in PKGS)
    assert len(tchunks) == 8
    assert_chunks_equal(tchunks, jchunks)
    assert_chunks_equal(tchunks, _solo_chunks(tP, tcoord))
    assert (tl.stats.shared_scans, tl.stats.preemptions, tl.stats.batches) == \
        (jl.stats.shared_scans, jl.stats.preemptions, jl.stats.batches) == \
        ((1, 0, 4) if mode == "shared" else (0, 1, 4))
    assert tl.state_dict() == jl.state_dict() == {"batch_offset": 4, "stream_offsets": []}
    assert tl.health() == jl.health() and tl.health()["s1"] == "suspect"
    keys = WALL_CLOCK_KEYS + ("loader.transport.us",) + \
        (PREEMPT_CLOCK_KEYS if mode == "preempt" else ())
    if mode == "shared":
        # the ticket's fan-out ran for the tenant: the loader's share is modeled
        assert tl.stats.transport_s == jl.stats.transport_s == 0.0
    tsnap, jsnap = tl.metrics().snapshot(), jl.metrics().snapshot()
    assert tsnap["loader.batches"] == 4 and tsnap["health.server.s1.level"] == 2
    assert_snapshots_equal(tsnap, jsnap, keys)


def test_gateway_loader_resumes_from_its_cursor_like_jax():
    out = []
    for root in PKGS:
        P = _pkg(root)
        coord = _token_cluster(P)
        first = _gateway_loader(P, _gateway(P, coord))
        it = iter(first)
        head = [next(it) for _ in range(3)]    # the first record batch and half the second
        cursor = first.state_dict()
        rest = _gateway_loader(P, _gateway(P, coord))
        rest.load_state_dict(cursor)
        out.append((head, cursor, list(rest), _solo_chunks(P, coord)))
    (jhead, jcur, jrest, _), (thead, tcur, trest, solo) = out
    assert tcur == jcur == {"batch_offset": 2, "stream_offsets": []}
    assert_chunks_equal(thead, jhead)
    assert_chunks_equal(trest, jrest)
    # a resume starts at the next record batch (ROADMAP, faults of the reference)
    assert_chunks_equal(thead, solo[:3])
    assert_chunks_equal(trest, solo[4:])


def test_loader_metrics_without_a_gateway_match_jax():
    snaps = []
    for root in PKGS:
        P = _pkg(root)
        coord = _token_cluster(P)
        loader = P["data"].ThallusLoader([coord.server("s0")], SQL, DATASET, seq_len=32,
                                         batch_seqs=8)
        assert len(list(loader)) == 8 and loader.health() == {}
        snaps.append(loader.metrics().snapshot())
    assert snaps[1].keys() == snaps[0].keys() and snaps[1]["loader.batches"] == 4
    assert_snapshots_equal(snaps[1], snaps[0], ("loader.transport.us",))


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def model():
    """Reduced granite with GQA groups of 2, one numpy tree for both packages,
    norm weights ``1 + 0.1 N(0, 1)`` (the JAX init's zero norms make every
    logit 0)."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").reduced(), num_kv_heads=2)
    tcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_kv_heads=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for node, key in ((tree["layers"], "ln1"), (tree["layers"], "ln2"), (tree, "final_norm")):
        node[key] = (1.0 + 0.1 * rng.standard_normal(node[key].shape)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _batchers(root, model):
    jcfg, tcfg, jparams, tparams = model
    if root == "repro":
        from repro.serving import Batcher
        pf = jax.jit(lambda t: jax_prefill(jcfg, jparams, {"tokens": t}, remat="none"))
        dec = jax.jit(lambda c, t, p: jax_decode(jcfg, jparams, c, t, p))
        return [Batcher(pf, dec, batch_size=16) for _ in range(2)]
    from repro_torch.serving import Batcher
    return [Batcher(lambda t: prefill(tcfg, tparams, {"tokens": t}),
                    lambda c, t, p: decode(tcfg, tparams, c, t, p), batch_size=16,
                    device="cpu") for _ in range(2)]


def test_batchers_fetch_prompts_through_the_gateway_like_jax(model):
    out = []
    for root in PKGS:
        P = _pkg(root)
        gw = _gateway(P, _token_cluster(P))
        batchers = _batchers(root, model)
        reqs = [b.submit_scan(gw, SEQ_SQL, DATASET) for b in batchers]
        gw.run()
        got = [b.ingest_scan(gw, r, seq_len=32, max_new_tokens=4)
               for b, r in zip(batchers, reqs)]
        out.append((got, [b.run() for b in batchers], gw.stats.ticket_hits,
                    _gateway_snapshot(P, gw), P))
    (jgot, jdone, jhits, jsnap, _), (tgot, tdone, thits, tsnap, _) = out
    assert tgot == jgot == [(64, False), (64, True)]
    assert thits == jhits == 1
    for t, j in zip(tdone, jdone):
        assert [(c.request_id, c.tokens) for c in t] == [(c.request_id, c.tokens) for c in j]
    assert [c.tokens for c in tdone[0]] == [c.tokens for c in tdone[1]]
    tokens = {t for c in tdone[0] for t in c.tokens}
    assert len(tokens) > 1 and len(tdone[0]) == 64
    assert_snapshots_equal(tsnap, jsnap, WALL_CLOCK_KEYS)


def test_ingest_scan_of_a_shed_request_enqueues_nothing():
    from repro_torch.serving import Batcher
    P = _pkg("repro_torch")
    gw = _gateway(P, _token_cluster(P), preempt=False, pool=False)
    b = Batcher(None, None, batch_size=2, device="cpu")
    req = b.submit_scan(gw, "SELECT nope FROM tok", DATASET)
    assert req.klass == "interactive" and req.client_id == "serving"
    gw.run()
    assert b.ingest_scan(gw, req, seq_len=32) == (0, False) and not b.queue
    assert b.submit_scan(gw, SQL, DATASET, klass="batch", deadline_s=0.0,
                         arrival_s=-1.0) is None
