"""The port's runtime on a mesh, on the CPU: ``train()`` and ``serve()``
over gloo in one spawned group of 4 (`meshhelpers.group_runtime`, float32
reduced qwen1.5-0.5b), and the ``torchrun`` CLI (a second group).

* ``train()`` at 2x2 writes checkpoints in the reference's layout, which
  the reference's ``CheckpointManager.restore(like=...)`` reads leaf for
  leaf (the gathered full arrays);
* the same run cut at step 2 and continued on a 1x4 mesh (the elastic
  restore of tests/test_distributed.py) gives the uninterrupted 2x2 run's
  losses within 1e-5;
* int8 error-feedback compression at 2x2 gives the one-device compressed
  run's losses within float32 rounding (1e-5), through ``train()``, and
  through ``make_train_step`` on the reference's weights the reference's
  compressed steps (its ``make_train_step`` without a mesh);
* ``serve()`` at 2x2 gives the one-device greedy tokens, and its loop on
  the reference's weights the reference's decode loop's tokens; the
  ``collective`` microbenchmark measures in this group of 4 over gloo;
* ``torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu
  --reduced --mesh 2x2 --steps 3`` exits 0 and prints the train loop's
  lines, once (rank 0).
"""

import os
import subprocess
import sys
from pathlib import Path

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import meshhelpers
from repro import optim as ref_optim
from repro.checkpoint import CheckpointManager as RefManager
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data import pipeline as ref_pipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.runtime import init_error_state as ref_init_error_state
from repro_torch.launch.serve import serve
from repro_torch.launch.train import TrainConfig, train
from soehelpers import chip_smoke
from test_torch_serve import _ref_greedy

REPO = Path(__file__).resolve().parents[1]


def _ref_int8_losses(ref_model, ref_cfg, weights):
    """The reference's compressed steps without a mesh, on the batches
    `meshhelpers.step_batches` draws."""
    step = jax.jit(ref_make_train_step(
        ref_model, ref_cfg, ref_optim.AdamWConfig(
            lr=meshhelpers.LR, warmup_steps=1,
            total_steps=meshhelpers.STEPS), None, None, False, "int8"))
    p = jax.tree.map(jnp.asarray, weights)
    s, e = ref_optim.init(p), ref_init_error_state(p)
    losses = []
    for i in range(meshhelpers.STEPS):
        p, s, e, m = step(p, s, e, ref_pipeline.synth_batch(
            ref_pipeline.DataConfig(global_batch=meshhelpers.BATCH,
                                    seq_len=meshhelpers.SEQ), ref_cfg, i))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime")
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(
        meshhelpers.ARCH)), dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    weights = chip_smoke().golden_weights(ref_model.defs)
    prompts = np.random.default_rng(0).integers(
        0, ref_cfg.vocab_size, (2, 6)).astype(np.int32)
    meshhelpers.save(tmp, "int8_in", {"weights": weights})
    meshhelpers.save(tmp, "serve_in", {"weights": weights,
                                       "prompts": prompts, "gen": 4})
    group = meshhelpers.spawn(meshhelpers.group_runtime, 4, tmp, join=False)
    with meshhelpers.float32_runs():
        want = {"int8": train(TrainConfig(mesh_shape=(1, 1), steps=3,
                                          grad_compression="int8",
                                          **meshhelpers.RUN))["history"],
                "tokens": serve(meshhelpers.ARCH, batch=2, prompt_len=6,
                                gen=4, device="cpu")["tokens"]}
    want["int8_steps"] = _ref_int8_losses(ref_model, ref_cfg, weights)
    want["ref_tokens"] = _ref_greedy(
        ref_model, jax.tree.map(jnp.asarray, weights), prompts, 4)
    meshhelpers.wait(group)
    return tmp, meshhelpers.load(tmp, "runtime_out"), want


def test_mesh_checkpoint_is_read_by_the_reference(runs):
    tmp, got, _ = runs
    assert len(got["a"]) == 4 and all(np.isfinite(got["a"]))
    assert sorted(os.listdir(tmp / "a")) == [
        "LATEST", "step_000000002", "step_000000004"]
    params = ref_build_model(ref_reduced(ref_get_config(
        meshhelpers.ARCH))).init(jax.random.PRNGKey(0))
    like = {"params": params, "opt": ref_optim.init(params)._asdict()}
    restored = RefManager(str(tmp / "a")).restore(like=like)
    leaves = jax.tree.leaves(restored)
    assert len(leaves) == len(got["a_state"])
    for (path, want), leaf in zip(got["a_state"], leaves):
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=path)


def test_restore_onto_1x4_continues_the_2x2_run(runs):
    _, got, _ = runs
    np.testing.assert_allclose(got["b"], got["a"][:2], rtol=1e-5)
    assert len(got["c"]) == 2                     # resumed at step 2 of 4
    np.testing.assert_allclose(got["c"], got["a"][2:], rtol=1e-5)


def test_int8_compression_at_2x2_matches_one_device(runs):
    _, got, want = runs
    np.testing.assert_allclose(got["int8"], want["int8"], rtol=1e-5)
    np.testing.assert_allclose(got["int8_steps"], want["int8_steps"],
                               rtol=1e-5)


def test_serve_and_the_collective_microbenchmark_on_a_mesh(runs):
    _, got, want = runs
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["ref_tokens"], want["ref_tokens"])
    recs = got["collective"]
    assert [r["bytes"] for r in recs] == [1 << 10, 1 << 16]
    assert all(r["kind"] == "collective" and r["devices"] == 4
               and r["t_mean_s"] >= r["t_s"] > 0 for r in recs)


def test_torchrun_trains_on_a_2x2_mesh():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--reduced", "--mesh", "2x2", "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("[train] step     0 loss") for line in
               lines) == 1
    assert sum(line.startswith("[train] done: final loss") and "(3 steps"
               in line for line in lines) == 1
