"""Serialized calibration profiles — the measurement-anchored contract.

A profile is the JSON artifact `pathfind calibrate` produces and every
downstream engine consumes (``pathfind sweep --profile DIR/profile.json``;
`sweeprunner.SweepSpec` embeds the profile dict so the sweep fingerprint —
and therefore resume identity — changes with the calibration; `cooptimize`
inherits it through the sweep spec).  It records:

  * the fitted parameter vector (`fitting.PARAM_NAMES`),
  * which tech entry it anchors (``tech`` name) and the measurement-spec
    fingerprint it was fitted against,
  * fit metadata (loss/MRE before and after, candidate selected), and
  * the validation report at fit time (the drift baseline).

Applying a profile = scaling a MicroArch's efficiency leaves
(`fitting.scale_microarch`) + overriding the PPE kernel overhead — plain
arithmetic on the leaves, so tensors and autograd pass through.

The JSON format is the reference's, byte for byte: a profile written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from repro_torch.calibrate.fitting import default_params, scale_microarch
from repro_torch.core.age import MicroArch
from repro_torch.core.roofline import PPEConfig

PROFILE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """One calibration result, JSON round-trippable."""

    tech: str                               # techlib entry it anchors
    params: Dict[str, float]                # fitting.PARAM_NAMES -> value
    measure_fingerprint: str = ""           # MeasureSpec.fingerprint()
    fit: Dict[str, float] = dataclasses.field(default_factory=dict)
    validation: Dict = dataclasses.field(default_factory=dict)
    version: int = PROFILE_VERSION

    def to_dict(self) -> Dict:
        return {"version": self.version, "tech": self.tech,
                "params": {k: float(v) for k, v in self.params.items()},
                "measure_fingerprint": self.measure_fingerprint,
                "fit": self.fit, "validation": self.validation}

    @staticmethod
    def from_dict(d: Dict) -> "CalibrationProfile":
        return CalibrationProfile(
            tech=str(d.get("tech", "")),
            params={k: float(v) for k, v in (d.get("params") or {}).items()},
            measure_fingerprint=str(d.get("measure_fingerprint", "")),
            fit=dict(d.get("fit") or {}),
            validation=dict(d.get("validation") or {}),
            version=int(d.get("version", PROFILE_VERSION)))

    def kernel_overhead_s(self) -> Optional[float]:
        v = self.params.get("kernel_overhead_s")
        return float(v) if v is not None else None


def identity_profile(tech: str = "") -> CalibrationProfile:
    """The do-nothing profile (uncalibrated techlib entry)."""
    return CalibrationProfile(tech=tech, params=default_params())


def save_profile(profile: CalibrationProfile, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(profile.to_dict(), fh, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_profile(path: str) -> CalibrationProfile:
    with open(path) as fh:
        return CalibrationProfile.from_dict(json.load(fh))


def coerce(profile) -> Optional[CalibrationProfile]:
    """CalibrationProfile | dict | path | None -> CalibrationProfile."""
    if profile is None:
        return None
    if isinstance(profile, CalibrationProfile):
        return profile
    if isinstance(profile, dict):
        return CalibrationProfile.from_dict(profile)
    if isinstance(profile, str):
        return load_profile(profile)
    raise TypeError(f"cannot interpret profile {type(profile).__name__}")


def apply_profile(arch: MicroArch, profile) -> MicroArch:
    """Measurement-anchored MicroArch: efficiency scales applied.

    Accepts a CalibrationProfile, its dict form, a profile.json path, or
    None (identity).  Autograd-safe: tensor leaves stay tensors.
    """
    prof = coerce(profile)
    if prof is None:
        return arch
    return scale_microarch(arch, prof.params)


def ppe_with_profile(ppe: PPEConfig, profile) -> PPEConfig:
    """PPEConfig carrying the profile's PPE-level parameters.

    ``kernel_overhead_s`` replaces the default launch latency, and
    ``vector_frac`` is scaled by vector_eff / compute_eff: the MicroArch's
    compute throughput is already scaled by compute_eff
    (`fitting.scale_microarch`), so the elementwise rate
    (throughput * vector_frac) lands on the *fitted* vector efficiency —
    the same model the fit validated.
    """
    prof = coerce(profile)
    if prof is None:
        return ppe
    out = ppe
    ov = prof.kernel_overhead_s()
    if ov is not None:
        out = dataclasses.replace(out, kernel_overhead_s=float(ov))
    vec = prof.params.get("vector_eff")
    comp = prof.params.get("compute_eff")
    if vec is not None and comp:
        out = dataclasses.replace(
            out, vector_frac=out.vector_frac * float(vec) / float(comp))
    return out
