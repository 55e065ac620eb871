"""The reference's own training numbers, committed, so that the card can be
held to them.

``tests/test_torch_golden_train.npz`` holds, for the reduced qwen1.5-0.5b,
recurrentgemma-2b and xlstm-125m in float32 (``chip_smoke.TRAIN_GOLDEN``):
the first step's per-leaf gradient norms (``jax.grad`` of ``loss_fn``, in
JAX's leaf order), the losses of five steps of the reference's
``make_train_step`` (AdamW, lr 1e-3, warmup 2), and the data pipeline's
five batches (2 x 32 tokens and labels) they ran on: numpy's generators
need not draw one stream in every version (a card machine's numpy may
differ), so the card trains on the file's batches.  The weights are numpy draws
(`chip_smoke.golden_weights`), so none are stored.  The card machine
has no JAX: ``chip_smoke.py`` phase 7 (d) and ``tests/test_torch_card.py::
test_card_training_matches_the_golden_training_file`` hold the card to
this file.

Here the file is held to the reference (rtol 1e-6), and the port on the
CPU to the file at ``chip_smoke.TRAIN_GOLDEN_TOLS`` (losses rtol 1e-4,
gradient norms rtol 1e-3; xlstm-125m's losses after the first update at
``chip_smoke.CHAOTIC_LOSS_TOL``, 1e-2, a premise this file holds: half an
ulp on every weight moves the reference's own curve by more than a tenth
of that).  Regenerate the file with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_golden_train.py
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import optim as ref_optim
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data import pipeline as ref_pipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from soehelpers import chip_smoke as load_chip_smoke

CS = load_chip_smoke()
golden_weights = CS.golden_weights
GOLDEN = CS.GOLDEN_TRAIN
CASE = CS.TRAIN_GOLDEN


def _reference_numbers(arch: str, weights=golden_weights) -> dict:
    """``weights``: the ParamDef tree -> numpy weights."""
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                              dtype="float32")
    model = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, weights(model.defs))

    def batch(i):
        return ref_pipeline.synth_batch(ref_pipeline.DataConfig(
            global_batch=CASE["batch"], seq_len=CASE["seq"]), cfg, i)

    batches = [batch(i) for i in range(CASE["steps"])]
    grads = jax.grad(lambda p: model.loss_fn(p, batches[0])[0])(params)
    norms = np.array([np.linalg.norm(np.asarray(g, np.float64).ravel())
                      for g in jax.tree.leaves(grads)], np.float32)
    step = jax.jit(ref_make_train_step(
        model, cfg, ref_optim.AdamWConfig(
            lr=CASE["lr"], warmup_steps=CASE["warmup"],
            total_steps=CASE["steps"]), None, None, False, "none"))
    state, losses = ref_optim.init(params), []
    for b in batches:
        params, state, _, m = step(params, state, None, b)
        losses.append(float(m["loss"]))
    return {"losses": np.array(losses, np.float32), "grad_norms": norms,
            **{key: np.stack([np.asarray(b[key]) for b in batches])
               for key in ("tokens", "labels")}}


@pytest.fixture(scope="module")
def golden():
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        np.savez_compressed(GOLDEN, **{
            f"{arch}/{key}": val for arch in CASE["archs"]
            for key, val in _reference_numbers(arch).items()})
    with np.load(GOLDEN) as f:
        return dict(f)


def test_golden_training_file_is_the_references(golden):
    assert GOLDEN.stat().st_size < 1 << 16
    for arch in CASE["archs"]:
        want = _reference_numbers(arch)
        assert sorted(k for k in golden if k.startswith(f"{arch}/")) == \
            sorted(f"{arch}/{key}" for key in want)
        for key, val in want.items():
            assert np.isfinite(val).all() and val.shape == \
                golden[f"{arch}/{key}"].shape
            np.testing.assert_allclose(golden[f"{arch}/{key}"], val,
                                       rtol=1e-6, err_msg=arch)


@pytest.mark.parametrize("arch", CASE["archs"])
def test_port_on_the_host_holds_to_the_golden_training_file(golden, arch):
    """The port's data pipeline gives the file's batches byte for byte
    here; the port trains on them to the file's numbers."""
    batches = tuple(golden[f"{arch}/{key}"] for key in ("tokens", "labels"))
    for got, want in zip(CS.golden_batches(arch), batches):
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    got = CS.train_golden_port(arch, "cpu", batches=batches)
    CS.hold_to_train_golden(got, golden, arch)


def test_xlstm_training_noise_is_the_references_own():
    """`chip_smoke.CHAOTIC_LOSS_TOL`'s premise, held so that the bound
    cannot outlive it: every weight of the reduced xlstm-125m moved by half
    an ulp (random signs, seed 0) moves the reference's own losses after
    the first update by more than a tenth of the bound (2.3e-3 at the
    fifth step), while its first loss stays within 1e-6."""
    arch = "xlstm-125m"
    assert CS.CHAOTIC_TRAIN == (arch,)
    want = _reference_numbers(arch)["losses"]
    rng = np.random.default_rng(0)

    def nudged(defs):
        return jax.tree.map(
            lambda a: (a + np.sign(rng.standard_normal(a.shape)).astype(
                np.float32) * np.spacing(np.abs(a)) * 0.5).astype(
                    np.float32), golden_weights(defs))

    got = _reference_numbers(arch, nudged)["losses"]
    rel = np.abs(got - want) / want
    assert rel[0] <= 1e-6
    assert rel[1:].max() > 0.1 * CS.CHAOTIC_LOSS_TOL
