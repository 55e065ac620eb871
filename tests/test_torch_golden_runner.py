"""The reference's own sweep-runner records of phase 4 (d)'s axes, kept in a
file so that the card (which has no JAX) can be held to them.

``tests/test_torch_golden_runner.jsonl`` holds, one JSON object a line, the
records the reference's serial runner (bucketing off, a private prediction
cache: ROADMAP queue 3) writes for ``chip_smoke.RUNNER``'s axes narrowed
to ``RUNNER["golden_arches"]``, for each of its scenarios (train, serving,
serving-traffic), each tagged with ``"scenario"`` and without its chunk
index.  Here the file is held to the reference (rtol 1e-6) and the port's
host records to the file (rtol 1e-5); ``chip_smoke.py`` phase 4 (d) holds
the card's records to it (1e-4).  Regenerate it with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_golden_runner.py
"""

import importlib.util
import json
import os
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind
from repro_torch.core import pathfinder, sweeprunner
from repro_torch.core.sweepexec import json_safe

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).with_name("test_torch_golden_runner.jsonl")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def specs():
    """Each scenario's port `SweepSpec`, parsed from chip_smoke's own
    ``pathfind sweep`` arguments with the golden archs."""
    cs = _chip_smoke()
    parser = pathfind._parser()
    out = {}
    for scenario in cs.RUNNER["scenarios"]:
        argv = cs.runner_argv(scenario, dict(
            cs.RUNNER, arches=cs.RUNNER["golden_arches"]))
        out[scenario] = pathfind._spec_from_args(parser.parse_args(argv))
    return out


@pytest.fixture(scope="module")
def golden(specs):
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        lines = []
        for scenario, spec in specs.items():
            stats = ref_sr.SweepRunner(
                ref_sr.SweepSpec.from_dict(spec.to_dict()),
                backend="serial", bucketing=False,
                cache=ref_pf.PredictionCache()).run()
            lines += [json.dumps({"scenario": scenario, **json_safe(r)})
                      for r in stats.records]
        GOLDEN.write_text("\n".join(lines) + "\n")
    out = {}
    for line in GOLDEN.read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec.pop("scenario"), []).append(rec)
    return out


def _same_records(got, want, rtol):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float):
                assert isinstance(g[k], float), (k, g[k])
                assert abs(g[k] - v) <= rtol * abs(v), (w["key"], k, g[k], v)
            else:
                assert g[k] == v, (w["key"], k, g[k], v)


def test_golden_runner_file_is_the_references(specs, golden):
    assert list(golden) == list(specs)
    for scenario, spec in specs.items():
        stats = ref_sr.SweepRunner(
            ref_sr.SweepSpec.from_dict(spec.to_dict()), backend="serial",
            bucketing=False, cache=ref_pf.PredictionCache()).run()
        _same_records(json_safe(stats.records), golden[scenario], 1e-6)
    assert 40 <= sum(len(v) for v in golden.values()) <= 100
    flags = {(r["feasible"], r["slo_ok"]) for r in golden["serving-traffic"]}
    assert {(True, True), (True, False), (False, False)} <= flags


def test_port_host_records_match_the_golden_file(specs, golden):
    for scenario, spec in specs.items():
        stats = sweeprunner.SweepRunner(
            spec, cache=pathfinder.PredictionCache(), device="cpu").run()
        _same_records(json_safe(stats.records), golden[scenario], 1e-5)
