"""The model families through the port's runtime entry points, on the CPU:
serving, the train step and loop, and the microbenchmarks' model points.

* Greedy serving (``launch.serve.generate``) of the reduced
  qwen2-moe-a2.7b and whisper-large-v3 in float32 gives the reference's
  tokens (its model functions in the loop of ``launch/serve.py:50-67``,
  tests/test_torch_serve.py's ``_ref_greedy``); whisper steps its prompt
  against the zero cross cache ``init_cache`` gives it, as the reference's
  loop does, and past its 16-slot self ring.  ``serve`` itself runs both
  at the configured bfloat16.
* ``make_train_step`` against the reference's (jitted, ``rules=None,
  mesh=None``) for three steps of the reduced qwen2-moe-a2.7b and
  whisper-large-v3 in float32 on the reference's batches (whisper's:
  frames, and tokens cut to ``decoder_len``): losses within rtol 1e-5,
  grad norms within 1e-4, and the metrics' ``aux`` (MoE's load-balancing
  loss, 0 for whisper) within 1e-5 of the reference's.  ``train()`` runs
  both from the data pipeline's batches.
* The microbenchmarks' model points of the reduced whisper (prefill,
  decode step, train step: zero frames of (batch, seq, d_model), tokens
  cut to ``decoder_len``) measure on the host, with the reference's keys
  and the reference's predictions of them; paper-lm's decode point raises
  as the reference's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.calibrate import fitting as ref_fitting
from repro.calibrate import microbench as ref_mb
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core import age as ref_age
from repro.data import pipeline as ref_pipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro_torch import optim
from repro_torch.calibrate import fitting, microbench
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import age
from repro_torch.launch import serve as port_serve
from repro_torch.launch.train import TrainConfig, make_train_step, train
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from soehelpers import chip_smoke
from test_torch_serve import _ref_greedy

CS = chip_smoke()
FAMILIES = ("qwen2-moe-a2.7b", "whisper-large-v3")


def _pair(arch, dtype="float32"):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    return ref_cfg, cfg


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_match_the_reference_loop(arch):
    ref_cfg, cfg = _pair(arch)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = _ref_greedy(ref_model, ref_params, prompts, 8)
    got = port_serve.generate(model, params, prompts, 8)
    np.testing.assert_array_equal(got["tokens"], want)
    out = port_serve.serve(arch, batch=2, prompt_len=6, gen=3,
                           use_reduced=True, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert out["plan"] == "RC-1-1-d1-p1"


def test_train_steps_match_the_reference_for_moe_and_whisper():
    for arch in FAMILIES:
        ref_cfg, cfg = _pair(arch)
        ref_model = ref_build_model(ref_cfg)
        weights = CS.golden_weights(ref_model.defs)
        kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
        ref_step = jax.jit(ref_make_train_step(
            ref_model, ref_cfg, ref_optim.AdamWConfig(**kw), None, None,
            False, "none"))
        step = make_train_step(build_model(cfg, "cpu"), cfg,
                               optim.AdamWConfig(**kw), False, "none")
        ref_p = jax.tree.map(jnp.asarray, weights)
        ref_s = ref_optim.init(ref_p)
        p = params_from_numpy(weights, "cpu")
        s = optim.init(p)
        for i in range(3):
            batch = ref_pipeline.synth_batch(
                ref_pipeline.DataConfig(global_batch=2, seq_len=24),
                ref_cfg, i)
            if cfg.is_encoder_decoder:
                assert batch["tokens"].shape == (2, cfg.decoder_len)
                assert batch["frames"].shape == (2, 24, cfg.d_model)
            ref_p, ref_s, _, ref_m = ref_step(ref_p, ref_s, None, batch)
            p, s, _, m = step(p, s, None, {k: torch.from_numpy(np.array(v))
                                           for k, v in batch.items()})
            np.testing.assert_allclose(float(m["loss"]),
                                       float(ref_m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(ref_m["grad_norm"]), rtol=1e-4)
            np.testing.assert_allclose(float(m["aux"]), float(ref_m["aux"]),
                                       rtol=1e-5, atol=1e-7)
            assert (float(m["aux"]) > 0) == cfg.is_moe
        out = train(TrainConfig(arch=arch, steps=3, global_batch=2,
                                seq_len=24, lr=1e-3, warmup=1, log_every=1,
                                use_reduced_config=True, device="cpu"))
        assert len(out["history"]) == 3
        assert all(np.isfinite(out["history"]))


def test_microbench_model_points_of_the_encoder_decoder(tmp_path):
    spec_kw = dict(suite="slice", model_archs=("whisper-large-v3",),
                   model_phases=("prefill", "decode_step", "train_step"),
                   model_seq=32, model_batch=2, reps=1)
    spec = microbench.MeasureSpec(**spec_kw)
    recs = microbench.MicrobenchRunner(spec, out_dir=str(tmp_path),
                                       device="cpu").run().records
    assert [r["kind"] for r in recs] == ["prefill", "decode_step",
                                         "train_step"]
    assert all(r["t_s"] > 0 for r in recs)
    ref_spec = ref_mb.MeasureSpec(**spec_kw)
    assert [p.key() for p in ref_mb.enumerate_points(ref_spec)] == \
        [r["key"] for r in recs]
    params = dict(fitting.default_params(), compute_eff=0.4,
                  dram_bw_eff=0.7, kernel_overhead_s=5e-6)
    want = ref_fitting.predict_measurements(
        recs, ref_age.tpu_v5e_microarch(), params)
    got = fitting.predict_measurements(
        recs, age.tpu_v5e_microarch(device="cpu"), params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    pt = microbench.MeasurePoint("decode_step", (("arch", "paper-lm"),
                                                 ("batch", 1), ("seq", 4)))
    with pytest.raises(RuntimeError, match="no decode path"):
        microbench.measure_point(pt, spec, device="cpu")
    ref_pt = ref_mb.MeasurePoint("decode_step", pt.params)
    with pytest.raises(RuntimeError, match="no decode path"):
        ref_mb.measure_point(ref_pt, ref_spec)
