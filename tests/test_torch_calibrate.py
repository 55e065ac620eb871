"""The port's calibration loop against the reference, on the CPU.

Spec fingerprints and point keys must be identical (they are the resume
identity of a measurement directory); on numpy-seeded synthetic
measurements the predictions, the loss gradient, the multi-start fit and
the validation report must agree within the tolerances stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calibrate import fitting as ref_fitting
from repro.calibrate import microbench as ref_mb
from repro.calibrate import report as ref_report
from repro.core import age as ref_age
from repro.core import roofline as ref_roofline
from repro_torch.calibrate import fitting, microbench, report
from repro_torch.core import age, roofline

CPU = "cpu"
REF_PPE = ref_roofline.PPEConfig(n_tilings=8)
PPE = roofline.PPEConfig(n_tilings=8)
SUITES = ("quick", "full", "slice")


def _ref_spec(suite):
    """The reference's MeasureSpec for a suite (slice is the port's own)."""
    if suite == "slice":
        return ref_mb.MeasureSpec.from_dict(
            microbench.default_spec("slice").to_dict())
    return ref_mb.default_spec(suite)


@pytest.mark.parametrize("suite", SUITES)
def test_spec_fingerprint_and_keys_match(suite):
    spec, ref_spec = microbench.default_spec(suite), _ref_spec(suite)
    assert spec.fingerprint() == ref_spec.fingerprint()
    assert [p.key() for p in microbench.enumerate_points(spec)] == \
        [p.key() for p in ref_mb.enumerate_points(ref_spec)]
    assert microbench.MeasureSpec.from_dict(spec.to_dict()) == spec


def test_slice_spec_covers_the_full_width_kernel_shapes():
    spec = microbench.default_spec("slice")
    assert set(microbench.QWEN_LAYER_SHAPES) <= set(spec.pallas_shapes)
    assert set(spec.gemm_shapes) <= set(spec.pallas_shapes)
    kinds = {p.kind for p in microbench.enumerate_points(spec)}
    assert kinds == {"gemm", "gemm_pallas", "elementwise", "prefill",
                     "decode_step", "train_step"}


def _records(seed=0):
    """Synthetic measurement records of the three slice kinds."""
    rng = np.random.default_rng(seed)
    spec = microbench.MeasureSpec(
        suite="slice",
        gemm_shapes=((128, 128, 128), (256, 512, 256), (1024, 256, 2048),
                     (512, 1024, 512)),
        pallas_shapes=((128, 128, 128), (4096, 1024, 2816)),
        elementwise_sizes=(1 << 16, 1 << 22), reps=1)
    recs = []
    for p in microbench.enumerate_points(spec):
        r = {"key": p.key(), "kind": p.kind, **dict(p.params)}
        if p.kind == "elementwise":
            n = r["n_elems"]
            r.update(flops=2.0 * n, bytes=12.0 * n)
            base = 12.0 * n / 2e12
        else:
            m, n, k = r["m"], r["n"], r["k"]
            r.update(flops=2.0 * m * n * k,
                     bytes=4.0 * (m * k + k * n + m * n))
            base = 2.0 * m * n * k / 3e13
        r["t_s"] = float(base * np.exp(rng.uniform(-0.7, 0.7)) + 5e-6)
        r["t_mean_s"] = r["t_s"]
        recs.append(r)
    return recs


def _templates(which):
    if which == "tpu_v5e":
        return ref_age.tpu_v5e_microarch(), age.tpu_v5e_microarch(device=CPU)
    return ref_age.cpu_host_microarch(), age.cpu_host_microarch(device=CPU)


PARAMS = {"compute_eff": 0.4, "dram_bw_eff": 2.5, "l1_bw_eff": 0.7,
          "vector_eff": 1.8, "kernel_overhead_s": 8e-6}


@pytest.mark.parametrize("which", ["tpu_v5e", "cpu_host"])
def test_predict_measurements_match(which):
    ref_t, t = _templates(which)
    recs = _records()
    for params in (None, PARAMS):
        want = ref_fitting.predict_measurements(recs, ref_t, params=params,
                                                ppe=REF_PPE)
        got = fitting.predict_measurements(recs, t, params=params, ppe=PPE)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loss_gradient_matches_jax_grad():
    ref_t, t = _templates("tpu_v5e")
    recs = _records(1)
    meas = np.asarray([r["t_s"] for r in recs], dtype=np.float32)
    w = ref_fitting._kind_weights(recs)
    theta = ref_fitting.params_to_theta(PARAMS).astype(np.float32)

    ref_loss = ref_fitting._loss_fn(
        ref_fitting.build_predictor(recs, ref_t, REF_PPE),
        jnp.asarray(meas), jnp.asarray(w))
    want_v, want_g = jax.value_and_grad(ref_loss)(jnp.asarray(theta))

    loss = fitting._loss_fn(fitting.build_predictor(recs, t, PPE),
                            torch.from_numpy(meas), torch.from_numpy(w))
    vals, grads = fitting.value_and_grad_rows(loss,
                                              torch.from_numpy(theta)[None])
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(float(vals[0]), float(want_v), rtol=1e-5)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(grads[0].numpy(), want_g, rtol=1e-4,
                               atol=1e-6 * np.abs(want_g).max())


def test_fit_matches_reference():
    ref_t, t = _templates("tpu_v5e")
    recs = _records(2)
    want = ref_fitting.fit(recs, ref_t, ppe=REF_PPE,
                           cfg=ref_fitting.FitConfig(steps=10, starts=3))
    got = fitting.fit(recs, t, ppe=PPE,
                      cfg=fitting.FitConfig(steps=10, starts=3))
    assert got.selected == want.selected
    assert got.n_evals == want.n_evals
    for name in fitting.PARAM_NAMES:
        np.testing.assert_allclose(got.params[name], want.params[name],
                                   rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.mre, want.mre, rtol=1e-3)
    np.testing.assert_allclose(got.mre_identity, want.mre_identity,
                               rtol=1e-5)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)


def _assert_reports_match(got, want, rtol=1e-5):
    assert set(got["groups"]) == set(want["groups"])
    for g, s in want["groups"].items():
        for key, v in s.items():
            np.testing.assert_allclose(got["groups"][g][key], v, rtol=rtol,
                                       err_msg=f"{g}.{key}")
    for key, v in want["overall"].items():
        np.testing.assert_allclose(got["overall"][key], v, rtol=rtol,
                                   err_msg=f"overall.{key}")


@pytest.mark.parametrize("params", [None, PARAMS])
def test_validation_report_matches(params):
    ref_t, t = _templates("tpu_v5e")
    recs = _records(3)
    want = ref_report.validation_report(recs, ref_t, params=params,
                                        ppe=REF_PPE)
    got = report.validation_report(recs, t, params=params, ppe=PPE)
    assert "gemm_pallas" in got["groups"]
    _assert_reports_match(got, want)
    assert report.format_report(got) == ref_report.format_report(want)


def test_unported_kinds_raise():
    spec = microbench.MeasureSpec(suite="full", collective_bytes=(1 << 10,),
                                  model_archs=("qwen1.5-0.5b",),
                                  model_phases=("train_step",), reps=1)
    points = microbench.enumerate_points(spec)
    assert [p.kind for p in points] == ["collective", "train_step"]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        microbench.measure_point(points[0], spec, device=CPU)
    rec = microbench.measure_point(points[1], spec, device=CPU)
    assert rec["key"] == points[1].key() and rec["kind"] == "train_step"
    assert rec["t_s"] > 0 and rec["t_mean_s"] >= rec["t_s"]
