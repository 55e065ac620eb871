"""The port's serving path against the reference's, on the CPU.

The reference's own ``serve()`` cannot run on jax 0.9.0 (its mesh has
Explicit axes, which ``common.logical``'s ``with_sharding_constraint``
refuses), so the reference side is its model functions called with
``rules=None, mesh=None`` and the greedy loop of ``launch/serve.py:50-67``
written out here.  The planner is compared with the reference's bucketing
off (its bucketed path fails on jax 0.9.0 at ``compileahead.py:206``).
Predictions are held to rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calibrate import fitting as ref_fitting
from repro.calibrate import microbench as ref_mb
from repro.configs.base import ARCH_IDS
from repro.configs.base import ShapeCell as RefShapeCell
from repro.configs.base import applicable_cells as ref_cells
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core import age as ref_age
from repro.core import compileahead
from repro.core import planner as ref_planner
from repro.core import scenarios as ref_scenarios
from repro.models import build_model as ref_build_model
from repro_torch.calibrate import fitting, microbench
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell, get_config, \
    reduced
from repro_torch.core import age, planner
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy


@pytest.fixture
def no_bucketing():
    prev = compileahead.set_bucketing_default(False)
    try:
        yield
    finally:
        compileahead.set_bucketing_default(prev)


def _ref_greedy(model, params, prompts, gen):
    """``launch/serve.py:50-67`` without the mesh: prefill by stepping the
    prompt through decode_step, then greedy decode."""
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


def test_greedy_tokens_match_reference_decode_loop():
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config("qwen1.5-0.5b")),
                                  dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = _ref_greedy(ref_model, ref_params, prompts, 8)
    got = port_serve.generate(model, params, prompts, 8)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["prefill_s"] > 0 and got["decode_s"] > 0


def test_serve_round_trip_on_the_host():
    out = port_serve.serve("qwen1.5-0.5b", batch=2, prompt_len=12, gen=4,
                           use_reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert out["tok_per_s"] > 0
    assert out["plan"] == "RC-1-1-d1-p1"
    again = port_serve.serve("qwen1.5-0.5b", batch=2, prompt_len=12, gen=4,
                             use_reduced=True, device="cpu")
    np.testing.assert_array_equal(out["tokens"], again["tokens"])


def test_serve_refuses_a_mesh_and_a_missing_card():
    # in one process a mesh names the world size it needs (serving on a
    # mesh: tests/test_torch_parallel_runtime.py)
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) has 4 devices but "
                                         r"the world size is 1"):
        port_serve.serve("qwen1.5-0.5b", mesh_shape=(2, 2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_serve.serve("qwen1.5-0.5b", batch=1, prompt_len=2, gen=1)


def _plan_pair(arch, cell, mesh):
    axes = ("data", "model")
    want = ref_planner.plan(ref_get_config(arch), _ref_cell(cell), mesh, axes)
    got = planner.plan(get_config(arch), cell, mesh, axes, device="cpu")
    return got, want


def _ref_cell(cell):
    return RefShapeCell(cell.name, cell.seq_len, cell.global_batch, cell.kind)


def _same_plan(got, want):
    assert got.strategy.name == want.strategy.name
    np.testing.assert_allclose(got.predicted_step_s, want.predicted_step_s,
                               rtol=1e-5)
    for key, val in want.predicted_breakdown.items():
        np.testing.assert_allclose(got.predicted_breakdown[key], val,
                                   rtol=1e-5, atol=1e-12, err_msg=key)
    assert got.rules == want.rules and got.notes == want.notes
    assert got.mesh_shape == want.mesh_shape


@pytest.mark.parametrize("mesh", [(1, 1), (16, 16)])
def test_planner_matches_reference_for_the_serve_cell(mesh, no_bucketing):
    cell = ShapeCell("serve", 48, 4, "decode")
    got, want = _plan_pair("qwen1.5-0.5b", cell, mesh)
    _same_plan(got, want)
    assert got.strategy.name == ("RC-1-1-d1-p1" if mesh == (1, 1)
                                 else "RC-1-16-d16-p1")


def test_planner_matches_reference_for_every_runnable_cell(no_bucketing):
    n = 0
    for arch in ARCH_IDS[:3]:
        for ref_cell in ref_cells(ref_get_config(arch)):
            cell = SHAPE_CELLS[ref_cell.name]
            got, want = _plan_pair(arch, cell, (16, 16))
            _same_plan(got, want)
            assert got.strategy.kp == 16
            n += 1
    assert n >= 10


MODEL_SPEC = dict(suite="slice", model_archs=("qwen1.5-0.5b",),
                  model_phases=("prefill", "decode_step"), model_seq=32,
                  model_batch=2, reps=1)


def test_model_step_records_on_the_host(tmp_path):
    spec = microbench.MeasureSpec(**MODEL_SPEC)
    stats = microbench.MicrobenchRunner(spec, out_dir=str(tmp_path),
                                        device="cpu").run()
    recs = stats.records
    assert [r["kind"] for r in recs] == ["prefill", "decode_step"]
    assert all(r["t_s"] > 0 and r["t_mean_s"] >= r["t_s"] for r in recs)
    ref_spec = ref_mb.MeasureSpec(**MODEL_SPEC)
    assert [p.key() for p in ref_mb.enumerate_points(ref_spec)] == \
        [r["key"] for r in recs]
    assert recs[1]["bytes"] == ref_scenarios.kv_cache_bytes(
        ref_reduced(ref_get_config("qwen1.5-0.5b")), 32, 2)
    for pt, ref_pt in zip(microbench.enumerate_points(spec),
                          ref_mb.enumerate_points(ref_spec)):
        assert dataclasses.astuple(microbench.model_cell(pt)) == \
            dataclasses.astuple(ref_mb.model_cell(ref_pt))
    params = dict(fitting.default_params(), compute_eff=0.4,
                  dram_bw_eff=0.7, kernel_overhead_s=5e-6)
    want = ref_fitting.predict_measurements(
        recs, ref_age.tpu_v5e_microarch(), params)
    got = fitting.predict_measurements(
        recs, age.tpu_v5e_microarch(device="cpu"), params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(got > 0)


def test_slice_suite_measures_the_model_steps():
    """The slice suite's model steps: three archs (attention, scan and
    mLSTM kernels) x prefill, decode and train steps; a train step
    measures on the host (the gradient, as the reference's jax.grad)."""
    spec = microbench.default_spec("slice")
    assert spec.model_archs == ("qwen1.5-0.5b", "recurrentgemma-2b",
                                "xlstm-125m")
    assert spec.model_phases == ("prefill", "decode_step", "train_step")
    assert (spec.model_seq, spec.model_batch) == (128, 2)
    kinds = [p.kind for p in microbench.enumerate_points(spec)]
    assert kinds[-9:] == ["prefill", "decode_step", "train_step"] * 3
    for arch in spec.model_archs:
        pt = microbench.MeasurePoint("train_step", (("arch", arch),
                                                    ("batch", 2),
                                                    ("seq", 8)))
        rec = microbench.measure_point(pt, spec, device="cpu")
        assert rec["kind"] == "train_step" and rec["t_s"] > 0
