"""The reference's SOE and refinement objectives at fixed points, kept in a
file so that the card (which has no JAX) can be held to them.

``tests/test_torch_golden_soe.json`` holds, for each of
``chip_smoke.SOE_CASES``: the reference's `soe.make_objective` value and
gradient at the template and seeded starts; each scenario's refine
objective (`cooptimize.make_refine_objective`, built in and with composed
objectives) value and gradient at the seed operating point and a seeded
start, normalized by the design's own record; a three-step batched eq.-6
descent (iterates, values, queries); and what ``pathfind soe`` prints at
phase 4 (e)'s flags and at a short run's.  The reference runs on the CPU
with its bucketing off and a private prediction cache (ROADMAP queue 3).
Here the port on the host is held to the file (values rtol 1e-5,
gradients 1e-4 of their norm, iterates 1e-6); the port is held to the
reference at the same cases by tests/test_torch_soe.py and
test_torch_cooptimize.py, and ``chip_smoke.py`` phase 4 (e) and
tests/test_torch_card.py hold the card to the file.  Regenerate it with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_golden_soe.py
"""

import json
import os
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from soehelpers import (chip_smoke, ref_descent, ref_objective,
                        ref_objective_points, ref_refine_case, ref_soe_cli,
                        values_and_grads)

GOLDEN = Path(__file__).with_name("test_torch_golden_soe.json")
HOST_TOLS = dict(value=1e-5, grad=1e-4, w=1e-6)


def write_golden(cases) -> dict:
    golden = {"objective": [], "refine": []}
    for case in cases["objective"]:
        points = ref_objective_points(case)
        golden["objective"].append({"case": case, "points": points,
                                    **values_and_grads(ref_objective(case),
                                                       points)})
    for case in cases["refine"]:
        gcase, points, f = ref_refine_case(case)
        golden["refine"].append({"case": gcase, "points": points,
                                 **values_and_grads(f, points)})
    golden["descent"] = ref_descent(cases)
    golden["soe_cli"] = [ref_soe_cli(argv) for argv in cases["soe_cli"]]
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    return golden


@pytest.fixture(scope="module")
def cs():
    return chip_smoke()


@pytest.fixture(scope="module")
def golden(cs):
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        return write_golden(cs.SOE_CASES)
    return json.loads(GOLDEN.read_text())


def test_golden_soe_file_holds_chip_smokes_cases(cs, golden):
    """The file describes exactly ``chip_smoke.SOE_CASES``: every case, its
    points, and ``pathfind soe``'s lines for phase 4 (e)'s flags."""
    cases = cs.SOE_CASES
    assert [e["case"] for e in golden["objective"]] == cases["objective"]
    assert len(golden["refine"]) == len(cases["refine"])
    for entry, case in zip(golden["refine"], cases["refine"]):
        spec = entry["case"]["spec"]
        assert spec["scenario"] == case["scenario"]
        assert spec.get("objectives") == case["objectives"]
        assert spec.get("scenario_params") == case["scenario_params"]
        assert len(entry["points"]) == case["starts"]
        assert all(len(p) == 20 for p in entry["points"])
        assert entry["case"]["norms"] and all(
            np.isfinite(n) and n != 0 for n in entry["case"]["norms"])
    descent = golden["descent"]
    assert {k: descent[k] for k in cases["descent"]} == cases["descent"]
    assert descent["n_queries"] == descent["starts"] * descent["steps"]
    assert [e["argv"] for e in golden["soe_cli"]] == cases["soe_cli"]
    for entry in golden["soe_cli"]:
        assert entry["stdout"].startswith("strategy  RC-4-1-d16-p1\n")


def test_port_host_matches_the_golden_file(cs, golden):
    """The port on the host at every golden point: values within rtol 1e-5,
    gradients within 1e-4 of their norm, the descent's iterates within
    1e-6 and its query count exact."""
    got = cs.soe_golden_port(golden, "cpu")
    assert cs.hold_to_soe_golden(got, golden, HOST_TOLS) == 504
