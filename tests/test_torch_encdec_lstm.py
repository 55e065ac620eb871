"""The port's encoder-decoder (whisper-large-v3) and LSTM (paper-lm) against
the reference's, on the CPU.

The reference initialises the weights; they cross to the port through
``convert.params_from_numpy``.  Both run the same numpy-seeded frame
embeddings (2 x 24 x 128) and tokens.

* whisper, reduced (2 + 2 layers, ``decoder_len`` 16): the forward's
  logits over 16 tokens, the prefill's caches (the encoder, then each
  layer's cross K/V; the self caches empty), 20 decode steps from the
  prefill (past ``decoder_len``: the self cache's ring wraps and the
  position embedding stays at its last row) from each side's own caches
  and from the reference's handed over, the caches after them, and the
  loss.  Float32 logits within rtol / atol 1e-4, bfloat16 within 3e-2 of
  max |logit|; caches (bfloat16 in both dtypes) within 1e-2 / 3e-2 of
  max |value|.  In float32 the first 16 steps also equal the forward's
  logits (the decoder's causal attention) within 1e-2 of max (the caches
  hold K/V in bfloat16).
* paper-lm, reduced: the forward's logits and the loss, and in float32
  every gradient (within 1e-4 of its max); it runs in the parameters'
  float32 whatever its dtype, as the reference's.  It has no decode
  path: `Model.init_cache`, `prefill` and `decode_step` raise.
* `common.sinusoidal_positions` is the reference's table bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import encdec as ref_encdec
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import build_model, common
from repro_torch.models.convert import (cache_from_numpy, params_from_numpy,
                                        params_to_numpy)
from repro_torch.tree import tree_leaves

BATCH, FRAMES, PROMPT, STEPS = 2, 24, 16, 20
DTYPES = ("float32", "bfloat16")


def _models(arch, dtype):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref_cfg, ref_model, ref_params, build_model(cfg, "cpu"), params


def _inputs(vocab):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((BATCH, FRAMES, 128)).astype(np.float32)
    toks = rng.integers(0, vocab, (BATCH, STEPS + 1)).astype(np.int32)
    return frames, toks


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def _close_caches(got, want, dtype):
    got = jax.tree.leaves(params_to_numpy(got))
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        want))
    assert len(got) == len(want)
    tol = 1e-2 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_matches_the_reference(dtype):
    ref_cfg, ref_model, ref_params, model, params = _models(
        "whisper-large-v3", dtype)
    assert ref_cfg.decoder_len == PROMPT < STEPS
    frames, toks = _inputs(ref_cfg.vocab_size)
    fr, tk = jnp.asarray(frames), jnp.asarray(toks)
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks[:, :PROMPT]),
             "labels": torch.from_numpy(toks[:, 1:PROMPT + 1])}
    want = ref_model.forward(ref_params, {"frames": fr,
                                          "tokens": tk[:, :PROMPT]})
    logits, caches, aux = model.forward(params, batch)
    assert caches is None and float(aux) == 0.0
    _close(logits, want, dtype)

    ref_caches = ref_encdec.prefill(ref_params, fr, ref_cfg)
    caches = model.prefill(params, batch)
    _close_caches(caches, ref_caches, dtype)
    assert not any(bool(t.any()) for t in caches["self"].values())
    ported = cache_from_numpy(jax.tree.map(np.asarray, ref_caches), "cpu")
    steps = []
    for t in range(STEPS):
        want_t, ref_caches = ref_encdec.decode_step(
            ref_params, ref_caches, tk[:, t:t + 1], jnp.asarray(t, jnp.int32),
            ref_cfg)
        tok = torch.from_numpy(toks[:, t:t + 1])
        got_t, caches = model.decode_step(params, caches, tok, t)
        _close(got_t, want_t, dtype)
        got2, ported = model.decode_step(params, ported, tok, t)
        _close(got2, want_t, dtype)
        steps.append(got_t[:, 0])
    _close_caches(caches, ref_caches, dtype)
    _close_caches(ported, ref_caches, dtype)
    if dtype == "float32":
        # a step at position t < decoder_len is the forward's position t,
        # up to the caches' bfloat16 K/V
        first = torch.stack(steps[:PROMPT], dim=1)
        assert (first - logits).abs().max() <= 1e-2 * logits.abs().max()

    ref_loss, _ = ref_model.loss_fn(ref_params, {
        "frames": fr, "tokens": tk[:, :PROMPT],
        "labels": tk[:, 1:PROMPT + 1]})
    loss, metrics = model.loss_fn(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_paper_lm_matches_the_reference(dtype):
    ref_cfg, ref_model, ref_params, model, params = _models("paper-lm",
                                                            dtype)
    _, toks = _inputs(ref_cfg.vocab_size)
    tk = jnp.asarray(toks)
    want = ref_model.forward(ref_params, {"tokens": tk[:, :PROMPT]})
    logits, caches, aux = model.forward(
        params, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    assert caches is None and float(aux) == 0.0
    assert logits.dtype == torch.float32
    _close(logits, want, "float32")      # the parameters' dtype, as there

    ref_batch = {"tokens": tk[:, :PROMPT], "labels": tk[:, 1:PROMPT + 1]}
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, ref_batch), has_aux=True)(ref_params)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss_fn(params, {k: torch.from_numpy(np.array(v))
                                     for k, v in ref_batch.items()})
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(loss, leaves),
                    jax.tree.leaves(ref_grads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()

    assert not model.has_decode
    for call in (lambda: model.init_cache(BATCH, PROMPT),
                 lambda: model.prefill(params, {"tokens": torch.zeros(
                     (BATCH, 4), dtype=torch.int32)}),
                 lambda: model.decode_step(params, {}, None, 0)):
        with pytest.raises(ValueError, match="no decode path"):
            call()


def test_sinusoidal_positions_are_the_references_bit_for_bit():
    for seq, d in ((1, 2), (16, 128), (448, 1280), (1500, 1280), (7, 66)):
        want = np.asarray(ref_common.sinusoidal_positions(seq, d))
        got = common.sinusoidal_positions(seq, d)
        assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
        np.testing.assert_array_equal(got.numpy(), want)
    # cached per (seq, d, device): one table, never written
    assert common.sinusoidal_positions(16, 128) is \
        common.sinusoidal_positions(16, 128, "cpu")
