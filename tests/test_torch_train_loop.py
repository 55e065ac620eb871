"""The port's train loop on the CPU: ``launch.train.train()`` with
``device="cpu"`` and its CLI, the three behaviours of the reference's
``tests/test_system.py`` (descends and checkpoints; resumes from its
checkpoint; restarts deterministically), whose own ``train()`` fails on
jax 0.9.0 (ROADMAP queue 3).  The reduced qwen1.5-0.5b, the reference's
sizes and seeds.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.launch import train as port_train
from repro_torch.launch.train import TrainConfig, train

ARCH = "qwen1.5-0.5b"

BASE = dict(arch=ARCH, global_batch=4, mesh_shape=(1, 1),
            use_reduced_config=True, log_every=100, device="cpu")


def test_train_descends_and_checkpoints(tmp_path):
    out = train(TrainConfig(steps=30, seq_len=48, lr=1e-3, warmup=5,
                            ckpt_dir=str(tmp_path), ckpt_every=10, **BASE))
    h = out["history"]
    assert len(h) == 30
    assert all(np.isfinite(x) for x in h)
    assert min(h[-5:]) < h[0]                 # descends on structured data
    assert sorted(os.listdir(tmp_path)) == [
        "LATEST", "step_000000010", "step_000000020", "step_000000030"]
    assert out["plan"].strategy.name == "RC-1-1-d1-p1"
    assert out["plan"].predicted_step_s > 0
    assert int(out["state"].opt_state.step) == 30


def test_resume_continues_from_checkpoint(tmp_path):
    base = dict(BASE, seq_len=48, ckpt_dir=str(tmp_path), ckpt_every=5)
    out1 = train(TrainConfig(steps=10, **base))
    out2 = train(TrainConfig(steps=16, **base))     # resumes at 10
    assert len(out2["history"]) == 6
    assert np.isfinite(out2["history"][-1])
    assert int(out2["state"].opt_state.step) == 16
    assert len(out1["history"]) == 10


def test_deterministic_restart_same_losses():
    """Two fresh runs with the same seed give the same loss curve (data
    pipeline + init determinism)."""
    base = dict(BASE, steps=6, seq_len=32, seed=7)
    h1 = train(TrainConfig(**base))["history"]
    h2 = train(TrainConfig(**base))["history"]
    np.testing.assert_allclose(h1, h2, rtol=1e-5)


def test_cli_trains_on_the_host_and_refuses_a_mesh(tmp_path, capsys):
    port_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--compression", "int8",
                     "--remat", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out
    assert "[train] done: final loss" in out and "(3 steps" in out
    assert (tmp_path / "step_000000003" / "meta.json").is_file()
    # a mesh needs one process per device: in one process it names the
    # world size it needs (the mesh runs are tests/test_torch_parallel*.py)
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) has 4 devices but "
                                         r"the world size is 1"):
        train(TrainConfig(**dict(BASE, mesh_shape=(2, 2), steps=1)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train(TrainConfig(**dict(BASE, device=None, steps=1)))
