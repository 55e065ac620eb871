"""The port's in-memory ``sweep`` against the reference's, on the CPU, and
the golden file that holds the card to the reference.

The grid is ``tests/test_torch_pathfinder_rows.py``'s: qwen1.5-0.5b and
recurrentgemma-2b x train_4k x 8x8, 16x16 x N7/N5/N3 x HBM2E/HBM3 x
IB-NDR-X8, 24 points.  Both sweeps run with ``cache=None`` and the
reference's bucketing off inside a fixture that restores it (ROADMAP
queue 3).

``tests/test_torch_golden_sweep.npz`` holds the reference's rows of this
grid, so that the card (which has no JAX) can be held to them
(``chip_smoke.py`` phase 4).  Here the file is held to the reference
(rtol 1e-6) and the port's host rows to the file (rtol 1e-5).  A sweep
with a calibration ``profile`` (every hardware point and the PPE anchored
to it) is held to the reference's on part of the grid.
Regenerate it with

    REPRO_WRITE_GOLDEN=1 PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_pathfinder_sweep.py -k golden
"""

import os
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from repro.core import compileahead
from repro.core import pathfinder as ref_pf
from repro_torch.core import pathfinder

GRID = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
            cells=("train_4k",), mesh_shapes=((8, 8), (16, 16)),
            logic_nodes=("N7", "N5", "N3"), hbms=("HBM2E", "HBM3"),
            nets=("IB-NDR-X8",))
GOLDEN = Path(__file__).with_name("test_torch_golden_sweep.npz")
SWEEP_METRICS = ("time_s", "compute_s", "comm_s", "exposed_comm_s")
RTOL = 1e-5


@pytest.fixture(scope="module")
def ref_sweep():
    prev = compileahead.set_bucketing_default(False)
    try:
        return ref_pf.sweep(**GRID, cache=None)
    finally:
        compileahead.set_bucketing_default(prev)


@pytest.fixture(scope="module")
def port_sweep():
    return pathfinder.sweep(**GRID, cache=None, device="cpu")


@pytest.fixture(scope="module")
def golden(ref_sweep):
    if os.environ.get("REPRO_WRITE_GOLDEN"):
        np.savez_compressed(
            GOLDEN, labels=np.asarray([_label(p) for p in ref_sweep.points]),
            metrics=np.asarray(SWEEP_METRICS), rows=_rows(ref_sweep.points))
    with np.load(GOLDEN) as f:
        return dict(f)


def _label(p) -> str:
    return "|".join((p.arch, p.cell, "x".join(map(str, p.mesh)), p.logic,
                     p.hbm, p.net, p.strategy.name))


def _rows(points) -> np.ndarray:
    return np.asarray([[getattr(p, m) for m in SWEEP_METRICS]
                       for p in points], dtype=np.float64)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)


def test_sweep_has_the_references_points_in_its_order(ref_sweep, port_sweep):
    assert [_label(p) for p in port_sweep.points] == \
        [_label(p) for p in ref_sweep.points]
    assert port_sweep.n_evaluations == ref_sweep.n_evaluations == 24
    _close(_rows(port_sweep.points), _rows(ref_sweep.points))
    for p, q in zip(port_sweep.points, ref_sweep.points):
        assert (p.devices, p.power_w, p.chip_area_mm2) == \
            (q.devices, q.power_w, q.chip_area_mm2)
    assert port_sweep.to_csv().splitlines()[0] == pathfinder.CSV_HEADER \
        == ref_pf.CSV_HEADER


def test_sweep_has_the_references_best_point_and_pareto_sets(ref_sweep,
                                                              port_sweep):
    assert _label(port_sweep.best()) == _label(ref_sweep.best())
    for objs in (("time_s", "devices"), ("time_s", "comm_s")):
        assert [_label(p) for p in port_sweep.pareto(objs)] == \
            [_label(p) for p in ref_sweep.pareto(objs)]


def test_golden_file_is_the_references_rows(ref_sweep, golden):
    assert GOLDEN.stat().st_size < 1 << 16
    assert list(golden["metrics"]) == list(SWEEP_METRICS)
    assert list(golden["labels"]) == [_label(p) for p in ref_sweep.points]
    want = _rows(ref_sweep.points)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(golden["rows"], want, rtol=1e-6, atol=1e-12)


def test_port_host_rows_are_the_golden_files(port_sweep, golden):
    assert list(golden["labels"]) == [_label(p) for p in port_sweep.points]
    _close(_rows(port_sweep.points), golden["rows"])


# a calibration profile (the JSON form `pathfind calibrate` writes) with
# every efficiency and the kernel overhead away from its identity value
PROFILE = {"version": 1, "tech": "tpu_v5e", "params": {
    "compute_eff": 0.62, "dram_bw_eff": 0.71, "l2_bw_eff": 0.8,
    "l1_bw_eff": 0.9, "l0_bw_eff": 0.95, "vector_eff": 0.43,
    "kernel_overhead_s": 7e-6, "net_alpha_eff": 1.5, "net_beta_eff": 0.8}}


def test_sweep_with_a_profile_matches_the_references():
    grid = dict(GRID, arches=GRID["arches"][:1], logic_nodes=("N7", "N5"))
    prev = compileahead.set_bucketing_default(False)
    try:
        want = ref_pf.sweep(**grid, cache=None, profile=PROFILE)
    finally:
        compileahead.set_bucketing_default(prev)
    got = pathfinder.sweep(**grid, cache=None, profile=PROFILE,
                           device="cpu")
    plain = pathfinder.sweep(**grid, cache=None, device="cpu")
    assert [_label(p) for p in got.points] == [_label(p) for p in want.points]
    _close(_rows(got.points), _rows(want.points))
    # the profile moved every point
    assert (np.abs(_rows(got.points)[:, 0] / _rows(plain.points)[:, 0] - 1)
            > 1e-3).all()
