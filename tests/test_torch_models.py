"""The port's LM runtime against the reference's, on the CPU.

The reference initialises the weights (``build_model(cfg).init(
PRNGKey(0))``); they cross to the port through
``convert.params_from_numpy``.  Both run the same numpy-seeded tokens:
``forward`` logits, the caches a prefill writes, eight ``decode_step``
logits and the caches after them (gemma3 and recurrentgemma decode past
their 32-entry local ring: prompt 40 + 8 steps).  Float32 runs are held to
rtol/atol 1e-4 on the logits; bfloat16 runs (the configured dtype) to 3e-2
of max |logit|.  KV caches are bfloat16 in both dtypes, so caches (and the
fp32 recurrent states beside them) are held to one bfloat16 rounding step
(1e-2 of max |value|) in float32 and to 3e-2 in bfloat16.

MoE routing (the reduced qwen2-moe-a2.7b and qwen3-moe-30b-a3b, whose
`hold_parity` runs from tests/test_torch_moe_models.py): in
float32 every router call of the port takes the reference's experts.  In
bfloat16 the router product is rounded to bfloat16 before its softmax,
so a token whose k-th and (k+1)-th experts lie within a rounding of each
other can take either, and one such token moves its own later values by
far more than 3e-2.  There the port replays the reference's experts
(``chip_smoke.moe_routing``; weights from its own probabilities) and is
held as the other archs; its own routing is held on the forward, where
at the first layer that parts from the reference's every expert it takes
that the reference did not must lie within ``chip_smoke.NEAR_TIE`` of the
one it left (from there the token is another token).

The reduced xlstm-125m is chaotic in bfloat16: its mLSTM output divides by
a denominator that can come near zero, so a one-rounding difference in a
block's input can grow by orders of magnitude in an mLSTM block, and the
reference's own bfloat16 logits lie 47 % of max |logit| from its float32
ones (test_xlstm_bf16_noise_is_the_references_own holds that premise).  No port
can match the reference's bfloat16 roundings op for op (the two
frameworks sum matrix products in other orders), so there each bfloat16
value is held to the reference's own noise: no further from the
reference's float32 value than twice the reference's bfloat16 value is,
plus 3e-2 of max.  The blocks themselves are held to 3e-2 in bfloat16 on
identical inputs in tests/test_torch_recurrent.py.
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
from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import build_model, common
from repro_torch.models.convert import (cache_from_numpy, params_from_numpy,
                                        params_to_numpy)
from repro_torch.tree import tree_leaves
from moehelpers import reference_routes
from soehelpers import chip_smoke

CS = chip_smoke()

PROMPT, STEPS, BATCH = 40, 8, 2
ARCHS = ["qwen1.5-0.5b", "gemma3-27b", "recurrentgemma-2b", "xlstm-125m",
         "phi3-medium-14b", "mistral-large-123b", "internvl2-76b"]
# the MoE archs' parity runs `hold_parity` from tests/test_torch_moe_models.py
# (this file's item count sets its place in pytest-xdist's --dist loadfile
# queue, which the reference's order-dependent tests depend on: ROADMAP
# queue 3); every config's full-width tree is held by
# test_unported_families_raise
MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
NOISY_BF16 = {"xlstm-125m"}     # chaotic in bfloat16: see the docstring


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype))


def _close(got, want, dtype, rel_bf16=3e-2, truth=None):
    """``truth``: the reference's float32 value, where the reference's
    bfloat16 value is noise (NOISY_BF16)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    if truth is not None:
        truth = np.asarray(truth, np.float32)
        noise = np.abs(want - truth).max()
        assert np.abs(got - truth).max() <= \
            2 * noise + rel_bf16 * np.abs(truth).max()
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= rel_bf16 * np.abs(want).max()


def _close_caches(got_tree, want_tree, dtype, truth_tree=None):
    want = jax.tree.leaves(want_tree)
    got = list(jax.tree.leaves(params_to_numpy(got_tree)))
    truth = (jax.tree.leaves(truth_tree) if truth_tree is not None
             else [None] * len(want))
    assert len(got) == len(want) == len(truth)
    for g, w, tr in zip(got, want, truth):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        if tr is not None:
            _close(g, w, dtype, truth=tr)
            continue
        tol = (1e-2 if dtype == "float32" else 3e-2) * np.abs(w).max()
        assert np.abs(g - w).max() <= tol


def _embeds(cfg):
    """The vision stub's patch embeddings (numpy, seed 1) for the first
    ``n_patch_tokens`` positions, or None where the arch has no stub."""
    if cfg.frontend != "vision_stub" or not cfg.n_patch_tokens:
        return None
    n = min(cfg.n_patch_tokens, PROMPT)
    return np.random.default_rng(1).standard_normal(
        (BATCH, n, cfg.d_model)).astype(np.float32)


def _ref_run(ref_cfg, ref_params, toks):
    """The reference's forward logits, prefill caches, decode-step logits
    and final caches (float32 numpy), the prefill caches as they are, and
    its MoE routers' experts in call order (forward, prefill, each step)."""
    ref_model = ref_build_model(ref_cfg)
    emb = _embeds(ref_cfg)
    emb = None if emb is None else jnp.asarray(emb)
    batch = {"tokens": jnp.asarray(toks)}
    if emb is not None:
        batch["embeds"] = emb
    with reference_routes() as routes:
        out = {"logits": ref_model.forward(ref_params, batch)[0]}
        _, caches, _ = ref_tf.forward(
            ref_params, jnp.asarray(toks[:, :PROMPT]), ref_cfg, embeds=emb,
            caches=ref_tf.init_cache(ref_cfg, BATCH, PROMPT + STEPS))
        out["prefill"] = caches
        out["steps"] = []
        for t in range(PROMPT, PROMPT + STEPS):
            logits, caches = ref_tf.decode_step(
                ref_params, caches, jnp.asarray(toks[:, t:t + 1]),
                jnp.asarray(t, jnp.int32), ref_cfg)
            out["steps"].append(logits)
    out["decoded"] = caches
    raw = jax.tree.map(np.asarray, out["prefill"])     # bfloat16 kept
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out), raw, \
        routes


def _port_routes(routes, n_layers):
    """The reference's router calls in the port's order below: forward,
    prefill, then each step twice (from its own caches and from the
    reference's)."""
    n = n_layers
    steps = [routes[(2 + i) * n:(3 + i) * n] for i in range(STEPS)]
    return routes[:2 * n] + [r for step in steps for r in step * 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype):
    hold_parity(arch, dtype)


def hold_parity(arch, dtype):
    """The port's forward, prefill caches and decode steps of the reduced
    ``arch`` against the reference's (see the module docstring)."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
    want, ref_caches, routes = _ref_run(ref_cfg, ref_params, toks)
    truth = None
    if dtype == "bfloat16" and arch in NOISY_BF16:
        truth = _ref_run(_cfgs(arch, "float32")[0], ref_params, toks)[0]
    expected = _port_routes(routes, cfg.n_layers) if cfg.is_moe else []
    forced = expected if dtype == "bfloat16" else None

    def pick(key, i=None):
        if truth is None:
            return None
        return truth[key] if i is None else truth[key][i]

    emb = _embeds(cfg)
    extra = {} if emb is None else {"embeds": torch.from_numpy(emb)}
    if forced:
        with CS.moe_routing() as own:
            model.forward(params, {"tokens": torch.from_numpy(toks)})
        flips = CS.routing_flips(own.calls, routes[:cfg.n_layers])
        assert all(m <= CS.NEAR_TIE
                   for _, _, m in CS.first_divergence(flips)), flips
    with CS.moe_routing(forced) as rec:
        _hold_port_run(model, params, toks, extra, want, ref_caches, dtype,
                       pick)
    assert len(rec.calls) == len(expected)
    if forced is None:
        assert CS.routing_flips(rec.calls, expected) == []


def _hold_port_run(model, params, toks, extra, want, ref_caches, dtype,
                   pick):
    cfg = model.cfg
    got = model.forward(params, {"tokens": torch.from_numpy(toks),
                                 **extra})[0]
    assert got.dtype == torch.float32
    _close(got, want["logits"], dtype, truth=pick("logits"))

    _, caches, _ = model.forward(
        params, {"tokens": torch.from_numpy(toks[:, :PROMPT]), **extra},
        caches=model.init_cache(BATCH, PROMPT + STEPS))
    _close_caches(caches, want["prefill"], dtype, pick("prefill"))

    # each side decodes from its own prefill; then from the reference's
    # caches handed over, so a cache difference cannot hide a step's
    ported = cache_from_numpy(ref_caches, "cpu")
    for i, t in enumerate(range(PROMPT, PROMPT + STEPS)):
        tok = torch.from_numpy(toks[:, t:t + 1])
        got, caches = model.decode_step(params, caches, tok, t)
        assert tuple(got.shape) == (BATCH, 1, cfg.padded_vocab)
        _close(got, want["steps"][i], dtype, truth=pick("steps", i))
        got2, ported = model.decode_step(params, ported, tok, t)
        _close(got2, want["steps"][i], dtype, truth=pick("steps", i))
    _close_caches(caches, want["decoded"], dtype, pick("decoded"))
    _close_caches(ported, want["decoded"], dtype, pick("decoded"))


def test_xlstm_bf16_noise_is_the_references_own():
    """NOISY_BF16's premise, held so that the exemption cannot outlive it:
    the reference's own bfloat16 logits of the reduced xlstm-125m lie more
    than 10 % of max |logit| from its float32 ones (47 % at this seed),
    where qwen1.5-0.5b's lie within the 3e-2 the other archs are held to."""
    toks = np.random.default_rng(0).integers(
        0, 512, (BATCH, PROMPT + STEPS)).astype(np.int32)
    gap = {}
    for arch in ("xlstm-125m", "qwen1.5-0.5b"):
        logits = {}
        for dtype in ("float32", "bfloat16"):
            ref_cfg = _cfgs(arch, dtype)[0]
            model = ref_build_model(ref_cfg)
            params = model.init(jax.random.PRNGKey(0))
            logits[dtype] = np.asarray(model.forward(
                params, {"tokens": jnp.asarray(toks)})[0], np.float32)
        gap[arch] = (np.abs(logits["bfloat16"] - logits["float32"]).max()
                     / np.abs(logits["float32"]).max())
    assert gap["xlstm-125m"] > 0.1 and gap["qwen1.5-0.5b"] < 3e-2, gap


def _shapes(tree, is_leaf=None):
    return jax.tree.map(lambda d: tuple(d.shape), tree, is_leaf=is_leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_at_full_width(arch):
    _hold_tree(arch)


def _hold_tree(arch):
    ref_defs = ref_build_model(ref_get_config(arch)).defs
    defs = build_model(get_config(arch), device="cpu").defs
    want = _shapes(ref_defs, is_leaf=ref_common.is_def)
    got = common.tree_map(lambda d: tuple(d.shape), defs)
    assert got == want
    ref_leaves = jax.tree.leaves(ref_defs, is_leaf=ref_common.is_def)
    leaves = list(jax.tree.leaves(defs))
    assert [(d.shape, d.axes, d.init, d.scale) for d in leaves] == \
        [(d.shape, d.axes, d.init, d.scale) for d in ref_leaves]


def test_weights_round_trip_exactly():
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b", "bfloat16")
    tree = jax.tree.map(np.asarray,
                        ref_build_model(ref_cfg).init(jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    caches = jax.tree.map(
        np.asarray, ref_tf.init_cache(ref_cfg, 1, 4, jnp.bfloat16))
    caches = jax.tree.map(lambda a: (a + 1.5).astype(a.dtype), caches)
    port = cache_from_numpy(caches, "cpu")
    assert all(t.dtype == torch.bfloat16
               for t in jax.tree.leaves(port))
    for a, b in zip(jax.tree.leaves(params_to_numpy(port)),
                    jax.tree.leaves(caches)):
        assert np.array_equal(a, np.asarray(b, np.float32))


def test_tree_init_matches_reference_statistics():
    """Same shapes, scales and leaf order; the bits are torch's."""
    _, cfg = _cfgs("qwen1.5-0.5b", "float32")
    model = build_model(cfg, device="cpu")
    a, b = model.init(0), model.init(0)
    for x, y, d in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(model.defs)):
        assert tuple(x.shape) == d.shape and torch.equal(x, y)
        if d.init == "normal":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            want = d.scale if d.scale is not None else fan_in ** -0.5
            assert abs(float(x.std()) / want - 1) < 0.1
        else:
            assert float(x.abs().max()) == (1.0 if d.init == "ones" else 0.0)


def test_unported_families_raise():
    """Nothing is left unported: every config builds, at full width (its
    tree the reference's, shapes, axes, inits and scales leaf for leaf)
    and reduced, where its weights initialise; the LSTM baseline alone has
    no decode path, and its decode functions and ``serve`` refuse as the
    reference's do."""
    archs = set(ARCH_IDS) | {"paper_lm"}
    assert archs == set(REF_ARCH_IDS) | {"paper_lm"} and len(archs) == 11
    for arch in sorted(archs):
        cfg = get_config(arch)
        _hold_tree(arch)
        model = build_model(reduced(cfg), device="cpu")
        assert tree_leaves(model.init(0))
        assert model.has_decode == (cfg.family != "lstm")
    model = build_model(reduced(get_config("paper-lm")), device="cpu")
    for call in (lambda: model.init_cache(1, 4),
                 lambda: model.decode_step({}, {}, None, 0)):
        with pytest.raises(ValueError, match="no decode path"):
            call()
    for fn, kw in ((ref_serve.serve, {}), (serve.serve, {"device": "cpu"})):
        with pytest.raises(ValueError, match="paper-lm has no decode path"):
            fn("paper-lm", batch=1, prompt_len=2, gen=1, **kw)
