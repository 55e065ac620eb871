"""The port's checkpoints against the reference's, on the CPU.

Both packages write the same layout (``step_%09d/``, ``arr_%05d.npy`` per
leaf in JAX's flatten order, ``meta.json`` with ``step``, ``paths``,
``shapes``, ``dtypes``, ``LATEST``), so a train state written by either
restores in the other, leaf for leaf and bit for bit.  The port writes
``treedef`` empty (it cannot write JAX's proto); the reference restores
with ``like=`` and never reads it.  The fault-tolerance helpers around
checkpoints (preemption, straggler watchdog, elastic plan, goodput) are
the reference's copied, and held to it exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.checkpoint import CheckpointManager as RefManager
from repro.runtime import fault as ref_fault
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, manager
from repro_torch.runtime import fault
from repro_torch.tree import tree_map


def _state(seed: int):
    """A train state as both packages build it: params, AdamW state (via
    ``_asdict``) and an error-feedback tree, float32 and an int32 step."""
    rng = np.random.default_rng(seed)
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "groups": {"b0": {"w": rng.standard_normal((2, 4, 3)
                                                         ).astype(np.float32)},
                         "a": rng.standard_normal((3,)).astype(np.float32)}}
    mu = tree_map(lambda a: a * 0.5, params)
    nu = tree_map(lambda a: a * a, params)
    step = np.asarray(seed + 3, np.int32)
    return {"params": params, "opt": {"step": step, "mu": mu, "nu": nu},
            "err": tree_map(lambda a: -a, params)}


def _ref_tree(state):
    s = jax.tree.map(jnp.asarray, state)
    opt = ref_optim.AdamWState(**s["opt"])
    return {"params": s["params"], "opt": opt._asdict(), "err": s["err"]}


def _port_tree(state):
    s = tree_map(lambda a: torch.from_numpy(np.array(a)), state)
    opt = optim.AdamWState(**s["opt"])
    return {"params": s["params"], "opt": opt, "err": s["err"]}


def _port_leaves(tree):
    return [leaf for _, leaf in manager._flatten(tree)]


def _leaves_equal(got, want):
    """``got``: a port tree; ``want``: a reference tree."""
    got = [np.asarray(t) for t in _port_leaves(got)]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_port_writes_and_the_reference_restores(tmp_path):
    """Written on the worker thread and in the caller's."""
    state = _state(1)
    for async_save in (False, True):
        out = tmp_path / f"async-{async_save}"
        mgr = CheckpointManager(str(out), async_save=async_save)
        mgr.save(12, _port_tree(state))
        mgr.wait()
        ref = RefManager(str(out))
        assert ref.latest_step() == 12 and ref.all_steps() == [12]
        restored = ref.restore(like=_ref_tree(_state(0)))
        _leaves_equal(_port_tree(state), restored)
    with open(out / "step_000000012" / "meta.json") as f:
        meta = json.load(f)
    ref_dir = tmp_path / "ref"
    RefManager(str(ref_dir)).save(12, _ref_tree(state), block=True)
    with open(ref_dir / "step_000000012" / "meta.json") as f:
        want = json.load(f)
    assert meta["treedef"] == "" and want["treedef"]
    for key in ("step", "paths", "shapes", "dtypes"):
        assert meta[key] == want[key], key


def test_reference_writes_and_the_port_restores(tmp_path):
    state = _state(2)
    RefManager(str(tmp_path)).save(7, _ref_tree(state), block=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    like = _port_tree(_state(0))
    got = mgr.restore(like=like)
    assert isinstance(got["opt"], optim.AdamWState)
    assert got["opt"].step.dtype == torch.int32 and \
        int(got["opt"].step) == 5
    _leaves_equal(got, _ref_tree(state))
    plain = mgr.restore()                   # no like=: dicts from paths
    assert sorted(plain) == ["err", "opt", "params"]
    assert sorted(plain["opt"]) == ["mu", "nu", "step"]
    _leaves_equal(plain, _ref_tree(state))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(like={"params": like["params"]})


def test_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(step, _port_tree(_state(step)))
    mgr.wait()
    assert mgr.all_steps() == [15, 20]
    assert open(tmp_path / "LATEST").read() == "step_000000020"
    assert RefManager(str(tmp_path)).latest_step() == 20
    _leaves_equal(mgr.restore(15), _ref_tree(_state(15)))
    # LATEST pointing at a step that is gone: the newest directory wins
    (tmp_path / "LATEST").write_text("step_000000099")
    assert mgr.latest_step() == 20
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_interrupted_write_leaves_the_previous_checkpoint(tmp_path):
    """A crash mid-write leaves ``step_*.tmp`` behind: neither package
    counts it, both restore the last published step, and the next save
    of that step replaces the stale directory."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _port_tree(_state(3)), block=True)
    tmp = tmp_path / "step_000000004.tmp"
    tmp.mkdir()
    (tmp / "arr_00000.npy").write_bytes(b"torn")
    for m in (mgr, RefManager(str(tmp_path))):
        assert m.all_steps() == [3] and m.latest_step() == 3
    _leaves_equal(mgr.restore(), _ref_tree(_state(3)))
    mgr.save(4, _port_tree(_state(4)), block=True)
    assert not tmp.exists() and mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "step_000000004")) == \
        sorted([f"arr_{i:05d}.npy" for i in range(13)] + ["meta.json"])


def test_fault_runtime_matches_the_reference():
    """The copied fault module (the train loop's preemption and
    straggler handling, the restart plan): the watchdog's events on one step-time
    trace, the preemption flag and its callback, the elastic plans and
    the goodput model."""
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 5.0, 1.0, 0.95, 4.2, 1.0]
    watch, ref_watch = fault.StragglerWatchdog(), \
        ref_fault.StragglerWatchdog()
    flags = [(watch.observe(i, t), ref_watch.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert watch.events == ref_watch.events
    calls = []
    pre = fault.PreemptionHandler(install=False,
                                  on_preempt=lambda: calls.append(1))
    assert not pre.preempted
    pre.trigger()
    pre.trigger()
    assert pre.preempted and calls == [1]
    for n, mp, gb in ((256, 8, 512), (100, 4, 96), (7, 1, 12)):
        assert fault.elastic_plan(n, mp, gb) == \
            ref_fault.elastic_plan(n, mp, gb)
    for w, r, m in ((0.0, 30.0, 3600.0), (12.0, 40.0, 7200.0),
                    (5.0, 1e4, 10.0)):
        assert fault.goodput_fraction(w, r, m) == \
            ref_fault.goodput_fraction(w, r, m)
        assert fault.availability(r, m) == ref_fault.availability(r, m)
        assert fault.fleet_mtbf_s(m, 64) == ref_fault.fleet_mtbf_s(m, 64)
