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

xlstm-125m's bfloat16 stack is chaotic in the reference itself, so it has
a file of its own, ``tests/test_torch_golden_xlstm.npz``, written by the
same command and held the same way, part by part: (a) the reduced model's
first mLSTM block and first sLSTM block (``mlstm_apply`` /
``slstm_apply``, weights as above) on a numpy input of 100 positions, in
float32 and bfloat16; (b) the stack's float32 logits over the prompt and
the decode steps, as above; (c) the TPU kernel itself
(``repro.kernels.mlstm.mlstm_parallel``, interpret mode) in bfloat16 at
the full head dim 192, shape (1, 2, 200, 192), inputs from a numpy seed.
The card is held to (c) at the TPU kernel's own roundings, which the
port's bf16 kernel shares, and through (a) at the reduced head dim 32.
Here the port on the CPU (the plain version, which rounds neither q * d^-1/2
nor the weights) is held to it as the card is: the blocks at 1e-4 in
float32, the stack at 2e-4 of max |logit| (``XLSTM_STACK_TOL``: the
reduced stack amplifies float32 summation order), and 3e-2 of max |value|
in bfloat16.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.kernels.mlstm import mlstm_parallel as ref_mlstm_kernel
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm
from test_torch_card import (GOLDEN, GOLDEN_ARCHS, GOLDEN_BATCH,
                             GOLDEN_PROMPT, GOLDEN_STEPS, GOLDEN_XLSTM,
                             XLSTM, XLSTM_BLOCK_SEQ, XLSTM_KERNEL_SHAPE,
                             XLSTM_PARTS, XLSTM_STACK_TOL, first_block,
                             golden_tokens,
                             golden_weights, hold_to_golden,
                             hold_to_xlstm_golden, port_golden_outputs,
                             port_xlstm_golden_outputs, xlstm_block_input,
                             xlstm_kernel_inputs)

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


def _xlstm_reference_outputs(part: str) -> dict:
    """The reference's outputs for one part of the xlstm golden file."""
    if part == "stack":
        return {f"stack/float32/{key}": val for key, val in
                _reference_outputs(XLSTM, "float32").items()}
    if part == "kernel":
        q, k, v, f_cum, log_i = xlstm_kernel_inputs()
        out = ref_mlstm_kernel(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)),
                               jnp.asarray(f_cum), jnp.asarray(log_i),
                               interpret=True)
        return {"kernel/bfloat16": np.asarray(out, np.float32)}
    apply = {"mlstm": ref_xlstm.mlstm_apply,
             "slstm": ref_xlstm.slstm_apply}[part]
    out = {}
    for dtype in DTYPES:
        cfg = dataclasses.replace(ref_reduced(ref_get_config(XLSTM)),
                                  dtype=dtype)
        groups = golden_weights(ref_build_model(cfg).defs)["groups"]
        p = first_block(jax.tree.map(lambda a: jnp.asarray(a[0]), groups),
                        part)
        x = jnp.asarray(xlstm_block_input(cfg.d_model), getattr(jnp, dtype))
        out[f"{part}/{dtype}"] = np.asarray(apply(p, x, cfg), np.float32)
    return out


@pytest.fixture(scope="module")
def golden_xlstm():
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        np.savez_compressed(GOLDEN_XLSTM, **{
            key: val for part in XLSTM_PARTS
            for key, val in _xlstm_reference_outputs(part).items()})
    with np.load(GOLDEN_XLSTM) as f:
        return dict(f)


def test_xlstm_golden_file_is_complete_and_small(golden_xlstm):
    assert GOLDEN_XLSTM.stat().st_size < 1 << 20
    cfg = ref_reduced(ref_get_config(XLSTM))
    block = (GOLDEN_BATCH, XLSTM_BLOCK_SEQ, cfg.d_model)
    assert {key: val.shape for key, val in golden_xlstm.items()} == {
        **{f"{kind}/{dtype}": block for kind in ("mlstm", "slstm")
           for dtype in DTYPES},
        "stack/float32/prefill": (GOLDEN_BATCH, GOLDEN_PROMPT,
                                  cfg.vocab_size),
        "stack/float32/steps": (GOLDEN_STEPS, GOLDEN_BATCH, cfg.vocab_size),
        "kernel/bfloat16": XLSTM_KERNEL_SHAPE}


@pytest.mark.parametrize("part", XLSTM_PARTS)
def test_xlstm_golden_file_is_the_references_output(golden_xlstm, part):
    for key, want in _xlstm_reference_outputs(part).items():
        assert np.isfinite(want).all()
        np.testing.assert_allclose(golden_xlstm[key], want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("part", XLSTM_PARTS)
def test_port_on_the_host_matches_the_xlstm_golden_file(golden_xlstm, part):
    hold_to_xlstm_golden(port_xlstm_golden_outputs(part, "cpu"),
                         golden_xlstm)


def test_xlstm_f32_stack_noise_is_the_references_own(golden_xlstm,
                                                     monkeypatch):
    """`XLSTM_STACK_TOL`'s premise, held so that the bound cannot outlive
    it: every weight moved by half an ulp (random signs, seed 0) moves the
    reference's own float32 logits of the reduced xlstm-125m by more than
    a tenth of the bound (3.6e-5 of max |logit| at this seed), so the
    bound is within an order of magnitude of the reference's own float32
    noise."""
    rng = np.random.default_rng(0)
    drawn = golden_weights

    def nudged(defs, seed=0):
        return jax.tree.map(
            lambda a: (a * (1 + rng.choice([-1.0, 1.0], a.shape)
                            * np.float32(2.0 ** -24))).astype(np.float32),
            drawn(defs, seed))

    monkeypatch.setattr(sys.modules[__name__], "golden_weights", nudged)
    moved = max(
        np.abs(val - golden_xlstm[f"stack/float32/{key}"]).max()
        / np.abs(golden_xlstm[f"stack/float32/{key}"]).max()
        for key, val in _reference_outputs(XLSTM, "float32").items())
    assert moved > XLSTM_STACK_TOL / 10, moved
