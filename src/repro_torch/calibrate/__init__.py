"""Measurement-driven calibration & validation (DeepFlow paper §8), on the
card.

The paper's credibility claim is validation against *measured* hardware;
this package closes the techlib <- kernels loop for the port:

  microbench.py  times the port's executables on the card — cuBLAS GEMMs
                 through torch.matmul, the hand-written Hopper GEMM, an
                 elementwise bandwidth probe — streaming measurements to
                 JSONL with the sweep runner's fingerprint/resume
                 discipline (files interchangeable with the reference's);
  fitting.py     treats techlib/PPE efficiency + overhead parameters as a
                 batched vector and fits them to the measurements by
                 multi-start gradient descent, with torch autograd through
                 `roofline.gemm_time` / `simulate.predict`;
  profiles.py    serialized calibration profiles (JSON) that the sweep /
                 pathfind / cooptimize engines consume via ``--profile``;
  report.py      paper-style correlation / mean-relative-error validation
                 tables per kernel & model, plus drift detection against a
                 stored baseline report.

CLI: ``python -m repro_torch.pathfind calibrate --out DIR`` and
``python -m repro_torch.pathfind validate --out DIR``.  The profile format is
the reference's, so a profile fitted on the card feeds the reference's
``python -m repro.pathfind sweep --profile DIR/profile.json``.
"""

from repro_torch.calibrate.fitting import (
    FitConfig, FitResult, PARAM_NAMES, default_params, fit,
    predict_measurements, scale_microarch)
from repro_torch.calibrate.microbench import (
    MeasureSpec, MicrobenchRunner, default_spec, enumerate_points,
    load_measurements)
from repro_torch.calibrate.profiles import (
    CalibrationProfile, apply_profile, load_profile, ppe_with_profile,
    save_profile)
from repro_torch.calibrate.report import (
    check_drift, format_report, validation_report)

__all__ = [
    "CalibrationProfile", "FitConfig", "FitResult", "MeasureSpec",
    "MicrobenchRunner", "PARAM_NAMES", "apply_profile", "check_drift",
    "default_params", "default_spec", "enumerate_points", "fit",
    "format_report", "load_measurements", "load_profile",
    "ppe_with_profile", "predict_measurements", "save_profile",
    "scale_microarch", "validation_report",
]
