"""Validation reporter — paper-style measured-vs-predicted tables + drift.

Produces, per measurement group (kernel kind / model family), the metrics
the paper reports for CrossFlow's validation (Figs. 6-8): correlation of
log times, mean relative error, and bias (signed mean log ratio); plus an
overall row.  `compare_reports` sets an uncalibrated baseline against a
calibrated profile (the acceptance metric: calibrated MRE strictly lower
on the GEMM sweep), and `check_drift` diffs a fresh report against the
stored baseline (``report.json`` next to the profile) so CI can catch a
model or container regression that silently degrades calibration.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.calibrate import fitting
from repro_torch.core.age import MicroArch
from repro_torch.core.roofline import PPEConfig

REPORT_VERSION = 1


def _group_key(rec: Dict) -> str:
    if rec["kind"] in ("train_step", "prefill", "decode_step"):
        return f"{rec['kind']}:{rec.get('arch', '?')}"
    return str(rec["kind"])


def _stats(measured: np.ndarray, predicted: np.ndarray) -> Dict:
    meas = np.maximum(measured, 1e-12)
    pred = np.maximum(predicted, 1e-12)
    logr = np.log(pred / meas)
    corr = float(np.corrcoef(np.log(meas), np.log(pred))[0, 1]) \
        if len(meas) >= 2 and np.std(np.log(meas)) > 0 else float("nan")
    return {"n": int(len(meas)),
            "corr_log": corr,
            "mre": float(np.mean(np.abs(pred - meas) / meas)),
            "bias_log": float(np.mean(logr)),
            "worst_rel": float(np.max(np.abs(pred - meas) / meas))}


def validation_report(measurements: Sequence[Dict], template: MicroArch,
                      params: Optional[Dict[str, float]] = None,
                      ppe: PPEConfig = PPEConfig()) -> Dict:
    """Measured-vs-predicted report for one parameter set.

    ``params=None`` scores the uncalibrated techlib entry (identity
    parameters).  Predictions come from `fitting.predict_measurements` —
    the same path the fit optimized.
    """
    measurements = [r for r in measurements if "t_s" in r]
    if not measurements:
        return {"version": REPORT_VERSION, "groups": {}, "overall": {}}
    pred = fitting.predict_measurements(measurements, template,
                                        params=params, ppe=ppe)
    meas = np.asarray([float(r["t_s"]) for r in measurements])
    groups: Dict[str, List[int]] = {}
    for i, rec in enumerate(measurements):
        groups.setdefault(_group_key(rec), []).append(i)
    out = {g: _stats(meas[idx], pred[idx])
           for g, idx in sorted(groups.items())}
    # overall excludes unfitted kinds so it matches the fit objective
    fitted = [i for i, r in enumerate(measurements)
              if r["kind"] in fitting.KINDS_FITTED]
    overall = _stats(meas[fitted], pred[fitted]) if fitted else {}
    return {"version": REPORT_VERSION, "groups": out, "overall": overall,
            "params": dict(params or fitting.default_params())}


def compare_reports(baseline: Dict, calibrated: Dict) -> Dict:
    """Per-group and overall MRE improvement (baseline -> calibrated)."""
    out = {}
    for g, cal in calibrated.get("groups", {}).items():
        base = baseline.get("groups", {}).get(g)
        if base:
            out[g] = {"mre_baseline": base["mre"], "mre": cal["mre"],
                      "improved": cal["mre"] < base["mre"]}
    b, c = baseline.get("overall") or {}, calibrated.get("overall") or {}
    if b and c:
        out["overall"] = {"mre_baseline": b["mre"], "mre": c["mre"],
                          "improved": c["mre"] < b["mre"]}
    return out


def format_report(report: Dict, baseline: Optional[Dict] = None) -> str:
    """Text table (stderr-friendly); optional baseline column."""
    rows = [f"{'group':24s} {'n':>4s} {'corr(log)':>10s} {'MRE':>8s} "
            f"{'bias':>7s}" + ("  {:>10s}".format("base MRE")
                               if baseline else "")]
    items = list(report.get("groups", {}).items())
    if report.get("overall"):
        items.append(("OVERALL(fitted)", report["overall"]))
    for g, s in items:
        if not s:
            continue
        line = (f"{g:24s} {s['n']:4d} {s['corr_log']:10.3f} "
                f"{s['mre'] * 100:7.1f}% {s['bias_log']:+7.2f}")
        if baseline:
            base = (baseline.get("groups", {}).get(g)
                    or (baseline.get("overall")
                        if g == "OVERALL(fitted)" else None))
            line += (f"  {base['mre'] * 100:9.1f}%" if base
                     else f"  {'-':>10s}")
        rows.append(line)
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# Drift detection
# ---------------------------------------------------------------------------


def save_baseline(report: Dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_baseline(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def check_drift(report: Dict, baseline: Dict,
                tol: float = 0.25) -> List[str]:
    """Regressions of the fresh report vs the stored baseline.

    A group drifts when its MRE worsens by more than ``tol`` (absolute,
    e.g. 0.25 = 25 points of relative error) or when it disappears from
    the fresh report.  Returns human-readable messages (empty = healthy);
    the CLI exits non-zero on drift so a CI lane can gate on it.
    """
    msgs = []
    base_groups = baseline.get("groups", {})
    new_groups = report.get("groups", {})
    for g, b in sorted(base_groups.items()):
        cur = new_groups.get(g)
        if cur is None:
            msgs.append(f"group {g!r} missing from the fresh report "
                        f"(baseline MRE {b['mre'] * 100:.1f}%)")
            continue
        if cur["mre"] > b["mre"] + tol:
            msgs.append(
                f"group {g!r} drifted: MRE {b['mre'] * 100:.1f}% -> "
                f"{cur['mre'] * 100:.1f}% (tol {tol * 100:.0f} points)")
    b, c = baseline.get("overall") or {}, report.get("overall") or {}
    if b and c and c["mre"] > b["mre"] + tol:
        msgs.append(f"overall MRE drifted: {b['mre'] * 100:.1f}% -> "
                    f"{c['mre'] * 100:.1f}%")
    return msgs
