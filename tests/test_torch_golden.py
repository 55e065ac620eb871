"""The reference's own outputs, committed, so that the card can be held to
them.

``tests/test_torch_golden.npz`` holds the reference's logits (``repro`` on
CPU JAX) for the reduced qwen1.5-0.5b and recurrentgemma-2b, in float32
and bfloat16: a forward over a 40-token prompt into fresh caches, then 8
decode steps (recurrentgemma's 32-entry local ring wraps).  The weights
are numpy draws from seed 0 over the models' ParamDef trees
(`test_torch_card.golden_weights`), so no weights are stored.  The card
machine has no JAX: ``test_torch_card.py::
test_card_matches_the_references_golden_outputs`` holds the port on the
card to this file.

Here the file is held to the reference's outputs (rtol 1e-6, atol 1e-6 of
max |logit|), and the port on the CPU to the file at
tests/test_torch_models.py's tolerances.  Regenerate the file with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_golden.py

xlstm-125m is not in the file: its bfloat16 stack is chaotic in the
reference itself and needs per-block checks (ROADMAP queue 3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_tf
from test_torch_card import (GOLDEN, GOLDEN_ARCHS, GOLDEN_BATCH,
                             GOLDEN_PROMPT, GOLDEN_STEPS, golden_tokens,
                             golden_weights, hold_to_golden,
                             port_golden_outputs)

DTYPES = ("float32", "bfloat16")


def _reference_outputs(arch: str, dtype: str) -> dict:
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype)
    params = jax.tree.map(jnp.asarray,
                          golden_weights(ref_build_model(cfg).defs))
    toks = golden_tokens(cfg.vocab_size)
    n = GOLDEN_PROMPT
    logits, caches, _ = ref_tf.forward(
        params, jnp.asarray(toks[:, :n]), cfg,
        caches=ref_tf.init_cache(cfg, GOLDEN_BATCH, n + GOLDEN_STEPS))
    steps = []
    for t in range(n, n + GOLDEN_STEPS):
        step, caches = ref_tf.decode_step(
            params, caches, jnp.asarray(toks[:, t:t + 1]),
            jnp.asarray(t, jnp.int32), cfg)
        steps.append(np.asarray(step, np.float32)[:, 0])
    v = cfg.vocab_size
    return {"prefill": np.asarray(logits, np.float32)[..., :v],
            "steps": np.stack(steps)[..., :v]}


@pytest.fixture(scope="module")
def golden():
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        np.savez_compressed(GOLDEN, **{
            f"{arch}/{dtype}/{key}": val
            for arch in GOLDEN_ARCHS for dtype in DTYPES
            for key, val in _reference_outputs(arch, dtype).items()})
    with np.load(GOLDEN) as f:
        return dict(f)


def test_golden_file_is_complete_and_small(golden):
    assert GOLDEN.stat().st_size < 1 << 20
    assert sorted(golden) == sorted(
        f"{arch}/{dtype}/{key}" for arch in GOLDEN_ARCHS for dtype in DTYPES
        for key in ("prefill", "steps"))
    for arch in GOLDEN_ARCHS:
        vocab = ref_reduced(ref_get_config(arch)).vocab_size
        for dtype in DTYPES:
            assert golden[f"{arch}/{dtype}/prefill"].shape == (
                GOLDEN_BATCH, GOLDEN_PROMPT, vocab)
            assert golden[f"{arch}/{dtype}/steps"].shape == (
                GOLDEN_STEPS, GOLDEN_BATCH, vocab)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_golden_file_is_the_references_output(golden, arch, dtype):
    for key, want in _reference_outputs(arch, dtype).items():
        got = golden[f"{arch}/{dtype}/{key}"]
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_port_on_the_host_matches_the_golden_file(golden, arch, dtype):
    hold_to_golden(port_golden_outputs(arch, dtype, "cpu"), golden, arch,
                   dtype)
