"""The port's checkpoints against the JAX package's, on the CPU, and the
launcher's kill-and-resume.

A reduced granite-3-2b train state (perturbed norms, as in
``test_torch_train.py``) saved by either package restores in the other
with bit-identical leaves; both write the same rows (paths in
``jax.tree_util`` order, dtype strings, shapes, bytes), the same wire
payload and the same manifest. A run interrupted and resumed from its
checkpoint gives the uninterrupted run's losses within ``rtol 1e-6``, as
``tests/test_training.py`` holds the JAX package.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import state_to_batch as jax_state_to_batch
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.training import (CheckpointManager, OptimizerConfig, TrainConfig,
                                  batch_to_state, init_train_state, make_train_step,
                                  state_to_batch, train_state_shapes)
from repro_torch.training.tree import flatten_with_paths

from test_torch_copies import _payload
from test_torch_train import OPT, _cfgs, numpy_batches, numpy_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def state_tree():
    """A numpy train state after the JAX init, with its step moved to 3 and
    random moments, so that no leaf is a copy of another."""
    jcfg, _ = _cfgs()
    tree = numpy_state(jcfg)
    rng = np.random.default_rng(5)
    for key in ("m", "v"):
        tree["opt"][key] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree["opt"][key])
    tree["step"] = np.asarray(3, np.int32)
    return tree


def _assert_trees_equal(got, want):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].numpy() if isinstance(got[name], torch.Tensor) else np.asarray(got[name])
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_state_to_batch_gives_the_jax_rows(state_tree):
    want = jax_state_to_batch(jax.tree.map(jnp.asarray, state_tree)).to_pydict()
    got = state_to_batch(params_from_numpy(state_tree, "cpu")).to_pydict()
    assert got["path"] == want["path"]
    assert got["path"][:2] == ["opt/m/embed", "opt/m/final_norm"] and got["path"][-1] == "step"
    assert got == want


def test_jax_checkpoint_restores_in_the_port(tmp_path, state_tree):
    JaxCheckpointManager(str(tmp_path)).save(3, jax.tree.map(jnp.asarray, state_tree),
                                            cursors={"batch_offset": 7})
    _, tcfg = _cfgs()
    for like in (params_from_numpy(state_tree, "cpu"),
                 train_state_shapes(tcfg, TrainConfig())):
        restored, man = CheckpointManager(str(tmp_path)).restore(3, like=like, device="cpu")
        assert man.step == 3 and man.cursors == {"batch_offset": 7}
        _assert_trees_equal(restored, state_tree)
        assert restored["step"].dtype == torch.int32 and restored["step"].dim() == 0


def test_port_checkpoint_restores_in_jax(tmp_path, state_tree):
    path = CheckpointManager(str(tmp_path)).save(3, params_from_numpy(state_tree, "cpu"),
                                                 cursors={"batch_offset": 7})
    like = jax.tree.map(jnp.asarray, state_tree)
    restored, man = JaxCheckpointManager(str(tmp_path)).restore(3, like=like)
    assert man.step == 3 and man.cursors == {"batch_offset": 7}
    _assert_trees_equal(jax.tree.map(np.asarray, restored), state_tree)
    assert os.path.basename(path) == "ckpt_00000003.thallus"


def test_both_packages_write_the_same_files(tmp_path, state_tree):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JaxCheckpointManager(str(jdir)).save(3, jax.tree.map(jnp.asarray, state_tree),
                                        cursors={"batch_offset": 1}, extra={"k": 1})
    CheckpointManager(str(tdir)).save(3, params_from_numpy(state_tree, "cpu"),
                                      cursors={"batch_offset": 1}, extra={"k": 1})
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    jw = np.fromfile(jdir / "ckpt_00000003.thallus", dtype=np.uint8)
    tw = np.fromfile(tdir / "ckpt_00000003.thallus", dtype=np.uint8)
    np.testing.assert_array_equal(_payload(tw), _payload(jw))
    jm, tm = (json.loads((d / "ckpt_00000003.json").read_text()) for d in (jdir, tdir))
    assert jm.pop("wall_time") > 0 and tm.pop("wall_time") > 0
    assert tm == jm


def test_batch_to_state_without_like_gives_numpy_rows(state_tree):
    rows = batch_to_state(state_to_batch(params_from_numpy(state_tree, "cpu")))
    _assert_trees_equal(rows, dict(flatten_with_paths(state_tree)))
    with pytest.raises(KeyError, match="missing leaf"):
        batch_to_state(state_to_batch({"a": torch.zeros(2)}), like={"b": torch.zeros(2)},
                       device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        batch_to_state(state_to_batch({"a": torch.zeros(2)}), like={"a": torch.zeros(3)},
                       device="cpu")


def test_bfloat16_leaves_round_trip(tmp_path):
    tree = {"w": torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16),
            "step": torch.tensor(1, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    assert state_to_batch(tree).to_pydict()["dtype"] == ["int32", "bfloat16"]
    restored, _ = mgr.restore(1, like=tree, device="cpu")
    assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], tree["w"])
    # the JAX package reads the same bits as its bfloat16
    jrestored, _ = JaxCheckpointManager(str(tmp_path)).restore(
        1, like={"w": jnp.zeros(3, jnp.bfloat16), "step": jnp.int32(0)})
    np.testing.assert_array_equal(np.asarray(jrestored["w"], np.float32), [1.5, -2.0, 3.25])


def test_checkpoint_gc_and_latest(tmp_path):
    cfg = get_config("granite-3-2b").reduced()
    state = init_train_state(cfg, TrainConfig(remat="none"), torch.Generator().manual_seed(0),
                             "cpu")
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        state["step"] = torch.tensor(s, dtype=torch.int32)
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr.restore_latest(device="cpu")[1].step == 4


def test_checkpoint_restart_loss_continuity(tmp_path):
    """Kill after 3 of 6 steps, restore, run 3 more: the uninterrupted
    run's losses, as tests/test_training.py holds the JAX package."""
    jcfg, tcfg = _cfgs()
    tree = numpy_state(jcfg)
    step_fn = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**OPT), remat="none"))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in numpy_batches(jcfg, 6, shape=(2, 16), seed=21)]
    ref, ref_losses = params_from_numpy(tree, "cpu"), []
    for b in batches:
        ref, m = step_fn(ref, b)
        ref_losses.append(float(m["loss"]))
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    cur = params_from_numpy(tree, "cpu")
    for b in batches[:3]:
        cur, _ = step_fn(cur, b)
    mgr.save(int(cur["step"]), cur, cursors={"batch_offset": 3})
    restored, man = mgr.restore_latest(like=train_state_shapes(tcfg, TrainConfig()),
                                       device="cpu")
    assert man.cursors["batch_offset"] == 3
    _assert_trees_equal(restored, params_to_numpy(cur))
    resumed = []
    for b in batches[3:]:
        restored, m = step_fn(restored, b)
        resumed.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, ref_losses[3:], rtol=1e-6)
    assert len(set(ref_losses)) == 6


LAUNCH = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu", "--steps", "4",
          "--seq-len", "16", "--num-seqs", "16", "--log-every", "1", "--ckpt-every", "2",
          "--lr", "1e-2"]


def test_launcher_kill_and_resume_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu --steps 4
    --kill-at 2``, then the same command without ``--kill-at``: the resumed
    run restores step 2 and gives the uninterrupted run's losses. 16
    sequences of 16 tokens make one record batch of two training batches,
    so the kill falls on a record-batch boundary (the loader's cursor
    counts record batches: a kill inside one would resume at the next, in
    both packages; ``test_torch_loader.py`` holds that). The launcher's zero
    norm weights leave every gradient but ``final_norm``'s 0 until a step
    moves it, so ``--lr 1e-2`` makes steps 3 and 4 move the loss."""
    whole = launch_train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "whole")])
    assert [h["step"] for h in whole] == [1, 2, 3, 4]
    assert whole[3]["loss"] < whole[2]["loss"] - 1e-3 < whole[0]["loss"] - 2e-3
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
                          "--ckpt-dir", str(tmp_path / "killed"), "--kill-at", "2"],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step     1 loss ") and "tok/s" in lines[0]
    assert any(line.startswith("[ckpt] step 2 -> ") for line in lines)
    assert lines[-1].startswith("[crash] simulated failure at step 2")
    ckpts = sorted(os.listdir(tmp_path / "killed" / "granite-3-2b"))
    assert ckpts == ["ckpt_00000002.json", "ckpt_00000002.thallus"]
    resumed = launch_train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "killed")])
    assert [h["step"] for h in resumed] == [3, 4]
    np.testing.assert_allclose([h["loss"] for h in resumed], [h["loss"] for h in whole[2:]],
                               rtol=1e-6)
    for got, want in zip(lines[:2], whole[:2]):
        assert f"loss {want['loss']:.4f}" in got
    man = json.loads((tmp_path / "killed" / "granite-3-2b" / "ckpt_00000004.json").read_text())
    assert man["step"] == 4 and man["cursors"]["batch_offset"] == 1
