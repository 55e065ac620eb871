"""The port's recurrent blocks and families against the reference's, on the
CPU.

The reference initialises the reduced recurrentgemma-2b and xlstm-125m
(``build_model(cfg).init(PRNGKey(0))``); the weights cross to the port
through ``convert.params_from_numpy``.  Each block runs on the same
numpy-seeded input in both packages: RG-LRU train/prefill (with its
state) and decode; mLSTM parallel form, prefill state and decode; sLSTM
over a sequence (with its state) and decode, eight decode steps carrying
each side's own state.  Outputs are held to rtol/atol 1e-4 in float32 and
to 3e-2 of max |value| in bfloat16 (one bfloat16 rounding step of the
block's matmuls, and the kernels' own bfloat16 roundings); the fp32 states
to the same.  The reference's associative scan sums in log depth where
the port's scan is sequential; at these lengths that moves no value by
more than the float32 tolerance.  Then both archs greedy-decode the same
tokens as the reference's loop in float32, the planner agrees with the
reference for both at the serve cell (bucketing off: ROADMAP queue 3), and
``microbench.measure_point`` records a prefill and a decode step for each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as RefShapeCell
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core import compileahead
from repro.core import planner as ref_planner
from repro.core import scenarios as ref_scenarios
from repro.models import build_model as ref_build_model
from repro.models import rglru as ref_rglru
from repro.models import xlstm as ref_xlstm
from repro_torch.calibrate import microbench
from repro_torch.configs.base import ShapeCell, get_config, reduced
from repro_torch.core import planner, scenarios
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model, common
from repro_torch.models import rglru, xlstm
from repro_torch.models.convert import params_from_numpy

ARCHS = ("recurrentgemma-2b", "xlstm-125m")
SEQ, STEPS, BATCH = 24, 8, 2


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype))


def _params(arch, dtype):
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref_cfg, cfg, ref_params, params


def _block(ref_params, params, kind, key):
    """The first group's block of ``kind`` (reference, port)."""
    ref_g = jax.tree.map(lambda a: a[0], ref_params["groups"])
    g = common.tree_index(params["groups"], 0)
    j = {"rglru": 0, "mlstm": 0, "slstm": 1}[kind]
    return ref_g[f"b{j}"][key], g[f"b{j}"][key]


def _x(seed, s, d, dtype):
    x = np.random.default_rng(seed).standard_normal((BATCH, s, d))
    x = x.astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def _close_state(got, want, dtype):
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], dtype)


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_matches_reference(dtype):
    ref_cfg, cfg, ref_params, params = _params("recurrentgemma-2b", dtype)
    rp, p = _block(ref_params, params, "rglru", "rec")
    xj, xt = _x(1, SEQ + STEPS, cfg.d_model, dtype)
    _close(rglru.rglru_apply(p, xt, cfg),
           ref_rglru.rglru_apply(rp, xj, ref_cfg), dtype)
    want, ref_state = ref_rglru.rglru_apply(rp, xj[:, :SEQ], ref_cfg,
                                            return_state=True)
    got, state = rglru.rglru_apply(p, xt[:, :SEQ], cfg, return_state=True)
    _close(got, want, dtype)
    _close_state(state, ref_state, dtype)
    assert state["h"].dtype == state["conv"].dtype == torch.float32
    for t in range(SEQ, SEQ + STEPS):
        want, ref_state = ref_rglru.rglru_decode(rp, xj[:, t:t + 1],
                                                 ref_state, ref_cfg)
        got, state = rglru.rglru_decode(p, xt[:, t:t + 1], state, cfg)
        _close(got, want, dtype)
        _close_state(state, ref_state, dtype)
    init = rglru.rglru_init_state(cfg, BATCH)
    _close_state(init, ref_rglru.rglru_init_state(ref_cfg, BATCH), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_block_matches_reference(dtype):
    ref_cfg, cfg, ref_params, params = _params("xlstm-125m", dtype)
    rp, p = _block(ref_params, params, "mlstm", "mlstm")
    xj, xt = _x(2, SEQ + STEPS, cfg.d_model, dtype)
    _close(xlstm.mlstm_apply(p, xt, cfg),
           ref_xlstm.mlstm_apply(rp, xj, ref_cfg), dtype)
    ref_state = ref_xlstm.mlstm_prefill_state(rp, xj[:, :SEQ], ref_cfg)
    state = xlstm.mlstm_prefill_state(p, xt[:, :SEQ], cfg)
    _close_state(state, ref_state, dtype)
    for t in range(SEQ, SEQ + STEPS):
        want, ref_state = ref_xlstm.mlstm_decode(rp, xj[:, t:t + 1],
                                                 ref_state, ref_cfg)
        got, state = xlstm.mlstm_decode(p, xt[:, t:t + 1], state, cfg)
        _close(got, want, dtype)
        _close_state(state, ref_state, dtype)
    init = xlstm.mlstm_init_state(cfg, BATCH)
    _close_state(init, ref_xlstm.mlstm_init_state(ref_cfg, BATCH), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block_matches_reference(dtype):
    ref_cfg, cfg, ref_params, params = _params("xlstm-125m", dtype)
    rp, p = _block(ref_params, params, "slstm", "slstm")
    xj, xt = _x(3, SEQ + STEPS, cfg.d_model, dtype)
    _close(xlstm.slstm_apply(p, xt, cfg),
           ref_xlstm.slstm_apply(rp, xj, ref_cfg), dtype)
    want, ref_state = ref_xlstm.slstm_apply(rp, xj[:, :SEQ], ref_cfg,
                                            return_state=True)
    got, state = xlstm.slstm_apply(p, xt[:, :SEQ], cfg, return_state=True)
    _close(got, want, dtype)
    _close_state(state, ref_state, dtype)
    for t in range(SEQ, SEQ + STEPS):
        want, ref_state = ref_xlstm.slstm_decode(rp, xj[:, t:t + 1],
                                                 ref_state, ref_cfg)
        got, state = xlstm.slstm_decode(p, xt[:, t:t + 1], state, cfg)
        _close(got, want, dtype)
        _close_state(state, ref_state, dtype)
    init = xlstm.slstm_init_state(cfg, BATCH)
    _close_state(init, ref_xlstm.slstm_init_state(ref_cfg, BATCH), dtype)


@pytest.mark.parametrize("prompt", [1, 2, 5])
def test_prefill_then_decode_matches_a_forward(prompt):
    """A prompt shorter than the conv tail (kw - 1 = 3 rows) still leaves
    the state a forward over one more token continues from (float32 state
    and caches, so the two differ by summation order only)."""
    _, cfg, _, params = _params("recurrentgemma-2b", "float32")
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (BATCH, prompt + 1)).astype(np.int32))
    with torch.no_grad():
        caches = model.init_cache(BATCH, prompt + 1, torch.float32)
        model.forward(params, {"tokens": toks[:, :-1]}, caches=caches)
        step, _ = model.decode_step(params, caches, toks[:, -1:], prompt)
        full = model.forward(params, {"tokens": toks})[0][:, -1]
    torch.testing.assert_close(step[:, 0], full, rtol=1e-4, atol=1e-4)


def _ref_greedy(model, params, prompts, gen):
    """``launch/serve.py:50-67`` without the mesh (its Explicit axes fail on
    jax 0.9.0): prefill by stepping the prompt through decode_step, then
    greedy decode."""
    batch, prompt_len = prompts.shape
    caches = model.init_cache(batch, prompt_len + gen)
    decode = jax.jit(lambda p, c, t, pos: model.decode_step(
        p, c, t, pos, rules=None, mesh=None))
    prompts = jnp.asarray(prompts)
    for t in range(prompt_len):
        logits, caches = decode(params, caches, prompts[:, t:t + 1],
                                jnp.asarray(t, jnp.int32))
    out = []
    cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(gen):
        out.append(np.asarray(cur))
        logits, caches = decode(params, caches, cur,
                                jnp.asarray(prompt_len + t, jnp.int32))
        cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_decode_loop(arch):
    ref_cfg, cfg, ref_params, params = _params(arch, "float32")
    model = build_model(cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = _ref_greedy(ref_build_model(ref_cfg), ref_params, prompts, 8)
    got = port_serve.generate(model, params, prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_round_trip_on_the_host(arch):
    out = port_serve.serve(arch, batch=2, prompt_len=6, gen=3,
                           use_reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert out["tokens"].min() >= 0
    assert out["tokens"].max() < get_config(arch).vocab_size
    assert out["plan"] == "RC-1-1-d1-p1" and out["tok_per_s"] > 0


@pytest.fixture
def no_bucketing():
    prev = compileahead.set_bucketing_default(False)
    try:
        yield
    finally:
        compileahead.set_bucketing_default(prev)


@pytest.mark.parametrize("mesh", [(1, 1), (16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_planner_matches_reference_for_the_serve_cell(arch, mesh,
                                                      no_bucketing):
    cell = ShapeCell("serve", 160, 8, "decode")
    axes = ("data", "model")
    want = ref_planner.plan(ref_get_config(arch),
                            RefShapeCell("serve", 160, 8, "decode"), mesh,
                            axes)
    got = planner.plan(get_config(arch), cell, mesh, axes, device="cpu")
    assert got.strategy.name == want.strategy.name
    np.testing.assert_allclose(got.predicted_step_s, want.predicted_step_s,
                               rtol=1e-5)
    for key, val in want.predicted_breakdown.items():
        np.testing.assert_allclose(got.predicted_breakdown[key], val,
                                   rtol=1e-5, atol=1e-12, err_msg=key)
    assert got.rules == want.rules and got.notes == want.notes


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_state_bytes_match_reference(arch):
    for cfg, ref_cfg in ((get_config(arch), ref_get_config(arch)),
                         (reduced(get_config(arch)),
                          ref_reduced(ref_get_config(arch)))):
        for kv_len, batch in ((1, 1), (160, 8), (4096, 2), (524288, 1)):
            assert scenarios.kv_cache_bytes(cfg, kv_len, batch) == \
                ref_scenarios.kv_cache_bytes(ref_cfg, kv_len, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_step_records_on_the_host(arch):
    spec = microbench.MeasureSpec(
        suite="slice", model_archs=(arch,),
        model_phases=("prefill", "decode_step"), model_seq=16,
        model_batch=2, reps=1)
    recs = [microbench.measure_point(pt, spec, device="cpu")
            for pt in microbench.enumerate_points(spec)]
    assert [r["kind"] for r in recs] == ["prefill", "decode_step"]
    assert all(r["arch"] == arch and r["t_s"] > 0 for r in recs)
    assert recs[1]["bytes"] == ref_scenarios.kv_cache_bytes(
        ref_reduced(ref_get_config(arch)), 16, 2)
