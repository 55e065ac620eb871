"""The port's batched evaluator against the reference's, on the CPU.

The grid is qwen1.5-0.5b and recurrentgemma-2b x train_4k x meshes 8x8
and 16x16 x N7/N5/N3 x HBM2E/HBM3 x IB-NDR-X8: four skeletons of six
hardware points.  Rows are held to the reference's at rtol 1e-5 (its rows
from the batched float32 path, from the eager path below
``min_batch_jit``, and from matrix mode), and the port's vmapped rows to
its own per-row predictions bit for bit.

The reference's bucketing is off only inside a fixture that restores it
(its bucketed path fails on jax 0.9.0 at ``compileahead.py:206``), and
every reference evaluator gets ``cache=None`` or a private
``PredictionCache()``: its process-wide caches are neither filled nor
cleared (ROADMAP queue 3).
"""

import itertools

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPE_CELLS as REF_CELLS
from repro.configs.base import get_config as ref_get_config
from repro.core import age as ref_age
from repro.core import compileahead
from repro.core import lmgraph as ref_lmgraph
from repro.core import pathfinder as ref_pf
from repro.core import planner as ref_planner
from repro.core import techlib as ref_techlib
from repro.core.placement import mesh_system as ref_mesh_system
from repro.core.roofline import PPEConfig as RefPPEConfig
from repro_torch.configs.base import SHAPE_CELLS, get_config
from repro_torch.core import age, lmgraph, pathfinder, planner, simulate, \
    techlib
from repro_torch.core.placement import mesh_system
from repro_torch.core.roofline import PPEConfig

ARCHS = ("qwen1.5-0.5b", "recurrentgemma-2b")
MESHES = ((8, 8), (16, 16))
TECH = tuple(itertools.product(("N7", "N5", "N3"), ("HBM2E", "HBM3")))
SKELETONS = tuple(itertools.product(ARCHS, MESHES))
PPE, REF_PPE = PPEConfig(n_tilings=8), RefPPEConfig(n_tilings=8)
RTOL = 1e-5


@pytest.fixture(scope="module")
def no_bucketing():
    prev = compileahead.set_bucketing_default(False)
    try:
        yield
    finally:
        compileahead.set_bucketing_default(prev)


def _ref_skeleton(arch, mesh):
    cfg, cell = ref_get_config(arch), REF_CELLS["train_4k"]
    return (ref_lmgraph.build_graph(cfg, cell),
            ref_planner.candidate_strategies(cfg, cell, mesh)[0],
            ref_mesh_system(mesh),
            [ref_age.generate(ref_techlib.make_tech_config(lg, hbm),
                              ref_age.Budgets.default())
             for lg, hbm in TECH])


def _port_skeleton(arch, mesh):
    cfg, cell = get_config(arch), SHAPE_CELLS["train_4k"]
    return (lmgraph.build_graph(cfg, cell),
            planner.candidate_strategies(cfg, cell, mesh)[0],
            mesh_system(mesh),
            [age.generate(techlib.make_tech_config(lg, hbm),
                          age.Budgets.default(), device="cpu")
             for lg, hbm in TECH])


@pytest.fixture(scope="module")
def skeletons():
    """{(arch, mesh): (reference skeleton, port skeleton)}."""
    out = {}
    for key in SKELETONS:
        (rg, rst, rsys, rarchs), (g, st, system, archs) = \
            _ref_skeleton(*key), _port_skeleton(*key)
        assert st.name == rst.name
        out[key] = ((rg, rst, rsys, rarchs), (g, st, system, archs))
    return out


def _evaluators(skeleton, ref_cache):
    (rg, rst, rsys, _), (g, st, system, _) = skeleton
    return (pathfinder.BatchedEvaluator(g, st, system=system, ppe=PPE,
                                        cache=None, device="cpu"),
            ref_pf.BatchedEvaluator(rg, rst, system=rsys, ppe=REF_PPE,
                                    cache=ref_cache))


def _close(got, want, key):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12,
                               err_msg=str(key))


def _scaled(packed: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n rows cycling through ``packed``, the 13 performance columns
    scaled by seeded factors in [0.8, 1.2]."""
    m = packed[np.arange(n) % len(packed)].copy()
    m[:, :13] *= np.random.default_rng(seed).uniform(
        0.8, 1.2, (n, 13)).astype(np.float32)
    return m


def test_batched_rows_match_the_reference(skeletons, no_bucketing):
    """Six points per skeleton, at or above ``min_batch_jit``: the packed
    float32 batch on both sides."""
    for key in SKELETONS:
        (_, _, _, rarchs), (_, _, _, archs) = skeletons[key]
        ev, ref_ev = _evaluators(skeletons[key], ref_pf.PredictionCache())
        got = ev.evaluate(archs)
        assert got.shape == (len(TECH), len(pathfinder.METRICS))
        _close(got, ref_ev.evaluate(rarchs), key)
        # at or above min_batch_jit, evaluate() takes matrix mode's rows
        np.testing.assert_array_equal(got, ev.evaluate_matrix(
            archs[0], pathfinder.pack_hw_many(archs)), err_msg=str(key))


def test_eager_rows_below_min_batch_jit_match_the_reference(skeletons,
                                                             no_bucketing):
    """Below ``min_batch_jit`` both score the point on its own leaves."""
    for key in SKELETONS:
        (_, _, _, rarchs), (_, _, _, archs) = skeletons[key]
        ev, ref_ev = _evaluators(skeletons[key], None)
        eager = ev.evaluate(archs[:1], min_batch_jit=2)
        _close(eager, ref_ev.evaluate(rarchs[:1], min_batch_jit=2), key)
        np.testing.assert_array_equal(eager[0], ev._eager_row(archs[0]))


def test_matrix_mode_matches_the_reference(skeletons, no_bucketing):
    """`evaluate`'s matrix mode on six seeded scaled rows per skeleton (the
    shape the reference compiled for it)."""
    for key in SKELETONS:
        (rg, rst, rsys, rarchs), (g, st, system, archs) = skeletons[key]
        matrix = _scaled(pathfinder.pack_hw_many(archs), len(TECH), seed=1)
        _close(pathfinder.evaluate(
            template=archs[0], matrix=matrix, graph=g, strategy=st,
            system=system, ppe=PPE, cache=None),
            ref_pf.evaluate(template=rarchs[0], matrix=matrix, graph=rg,
                            strategy=rst, system=rsys, ppe=REF_PPE,
                            cache=ref_pf.PredictionCache(), devices=1), key)


def _per_row(arch, graph, st, system, v) -> bytes:
    """One row of ``simulate.predict`` on an unpacked row, outside vmap."""
    bd = simulate.predict(pathfinder.unpack_hw(arch, torch.as_tensor(v)),
                          graph, st, system=system, cfg=PPE)
    return torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in (
        bd.total_s, bd.compute_s, bd.comm_s, bd.exposed_comm_s,
        bd.pipeline_bubble_s)]).double().numpy().tobytes()


def test_vmapped_rows_are_the_per_row_predictions_bit_for_bit(skeletons):
    """The roofline repair: under ``torch.func.vmap`` the GEMM cache is
    skipped, and 64 seeded scaled rows per arch are what
    ``simulate.predict`` gives each row alone."""
    for arch in ARCHS:
        _, (g, st, system, archs) = skeletons[(arch, MESHES[0])]
        ev = pathfinder.BatchedEvaluator(g, st, system=system, ppe=PPE,
                                         cache=None, device="cpu")
        matrix = _scaled(pathfinder.pack_hw_many(archs), 64, seed=2)
        rows = ev.evaluate_matrix(archs[0], matrix)
        for v, row in zip(matrix, rows):
            assert row.tobytes() == _per_row(archs[0], g, st, system, v)


def test_deprecated_evaluate_points_warns_and_agrees(skeletons):
    _, (g, st, system, archs) = skeletons[SKELETONS[0]]
    points = [pathfinder.EvalPoint(a, g, st, system=system) for a in archs]
    with pytest.warns(DeprecationWarning, match="evaluate_points"):
        old = pathfinder.evaluate_points(points, ppe=PPE, cache=None)
    np.testing.assert_array_equal(
        old, pathfinder.evaluate(points=points, ppe=PPE, cache=None))
