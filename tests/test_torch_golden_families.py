"""The reference's own outputs for the model families MoE, encoder-decoder
and LSTM, committed, so that the card can be held to them.

``tests/test_torch_golden_families.npz`` holds, for each case of
``chip_smoke.FAMILY_GOLDEN`` (the reduced qwen2-moe-a2.7b,
qwen3-moe-30b-a3b with each MoE dispatch, whisper-large-v3 and paper-lm)
in float32 and bfloat16: the logits of a forward over a 16-token prompt
(the decoder-only archs into fresh caches), 6 decode steps after it (the
encoder-decoder's from its prefill, whose cross caches are held too), the
loss of the prompt and its gradient's global norm, and every MoE router
call's experts (``jax.lax.top_k``'s, recorded in call order).  Weights
are numpy draws (`chip_smoke.golden_weights`); the inputs (tokens and
frame embeddings) are stored, as numpy's generators need not draw one
stream in every version.  The card machine has no JAX: ``chip_smoke.py``
phase 8 (a) holds the card to this file, with the routing rule described
at ``chip_smoke.FAMILY_GOLDEN``.

Here the file is held to the reference (rtol 1e-6, atol 1e-6 of max
|value|; experts equal), and the port on the CPU to the file as the card
is.  Regenerate the file with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_golden_families.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tf
from moehelpers import reference_routes
from soehelpers import chip_smoke as load_chip_smoke

CS = load_chip_smoke()
GOLDEN = CS.GOLDEN_FAMILIES
CASE = CS.FAMILY_GOLDEN
DTYPES = ("float32", "bfloat16")


def reference_outputs(case: str, dtype: str) -> dict:
    """The reference's numbers for one case, keyed as in the file."""
    cfg = CS.family_cfg(case, dtype, ref_get_config, ref_reduced)
    model = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, CS.golden_weights(model.defs))
    tokens, frames = CS.family_inputs()
    b, n, steps = CASE["batch"], CASE["prompt"], CASE["steps"]
    v = cfg.vocab_size
    toks = jnp.asarray(tokens)
    out = {}

    def np32(x):
        return np.asarray(x, np.float32)

    with reference_routes() as routes:
        if cfg.family == "lstm":
            out["logits"] = np32(model.forward(
                params, {"tokens": toks[:, :n]}))[..., :v]
        elif cfg.is_encoder_decoder:
            fr = jnp.asarray(frames)
            out["logits"] = np32(model.forward(
                params, {"frames": fr, "tokens": toks[:, :n]}))[..., :v]
            caches = ref_encdec.prefill(params, fr, cfg)
            out["cross"] = np.stack([np32(caches["cross"][key])
                                     for key in ("k", "v")])
            first = 0
        else:
            logits, caches, _ = ref_tf.forward(
                params, toks[:, :n], cfg,
                caches=ref_tf.init_cache(cfg, b, n + steps))
            out["logits"] = np32(logits)[..., :v]
            first = n
        if cfg.family != "lstm":
            step_logits = []
            for t in range(first, first + steps):
                logits, caches = model.decode_step(
                    params, caches, toks[:, t:t + 1],
                    jnp.asarray(t, jnp.int32))
                step_logits.append(np32(logits)[:, 0, :v])
            out["steps"] = np.stack(step_logits)
        batch = {"tokens": toks[:, :n], "labels": toks[:, 1:n + 1]}
        if cfg.is_encoder_decoder:
            batch["frames"] = jnp.asarray(frames)
        (loss, _), grads = jax.value_and_grad(
            lambda p: model.loss_fn(p, batch), has_aux=True)(params)
        out["loss"] = np.float32(loss)
        out["grad_norm"] = np.float32(np.sqrt(sum(
            float(np.sum(np.asarray(g, np.float64) ** 2))
            for g in jax.tree.leaves(grads))))
    if cfg.is_moe:
        out["n_routes"] = np.int32(len(routes))
        for i, r in enumerate(routes):
            out[f"routes/{i}"] = r.astype(np.int8)
    return out


@pytest.fixture(scope="module")
def golden():
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        tokens, frames = CS.family_inputs()
        np.savez_compressed(GOLDEN, tokens=tokens, frames=frames, **{
            f"{case}/{dtype}/{key}": val
            for case in CASE["cases"] for dtype in DTYPES
            for key, val in reference_outputs(case, dtype).items()})
    with np.load(GOLDEN) as f:
        return dict(f)


def test_golden_families_file_is_complete_and_small(golden):
    assert GOLDEN.stat().st_size < 1 << 20
    b, n, steps = CASE["batch"], CASE["prompt"], CASE["steps"]
    assert golden["tokens"].shape == (b, n + steps + 1)
    assert golden["frames"].shape == (b, CASE["frames"], 128)
    for case in CASE["cases"]:
        arch = case.partition("+")[0]
        cfg = ref_reduced(ref_get_config(arch))
        for dtype in DTYPES:
            key = f"{case}/{dtype}"
            assert golden[f"{key}/logits"].shape == (b, n, cfg.vocab_size)
            assert golden[f"{key}/loss"].shape == ()
            assert (f"{key}/steps" in golden) == (cfg.family != "lstm")
            assert (f"{key}/cross" in golden) == cfg.is_encoder_decoder
            if cfg.is_moe:
                # the prompt, each step and the loss: one call per layer
                assert int(golden[f"{key}/n_routes"]) == \
                    cfg.n_layers * (steps + 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_golden_families_file_is_the_references_output(golden, dtype):
    for case in CASE["cases"]:
        for key, want in reference_outputs(case, dtype).items():
            got = golden[f"{case}/{dtype}/{key}"]
            if key.startswith(("routes/", "n_routes")):
                np.testing.assert_array_equal(got, want)
                continue
            assert np.isfinite(want).all()
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_on_the_host_matches_the_golden_families_file(golden, dtype):
    for case in CASE["cases"]:
        CS.family_golden_port(case, dtype, "cpu", golden)
