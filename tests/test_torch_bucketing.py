"""Cross-design bucketing in the port (``repro_torch.core.compileahead``),
on the CPU.

Sibling designs (one structure, other constants) share one bucket and
replay correctly; a design is traced once per key; the matrix path never
buckets; the port's bucketed serial records are the reference's records
(run with its bucketing off: its bucketed path raises on jax 0.9.0, ROADMAP
queue 3) within rtol 1e-5 on the reference's three grids, infeasible and
SLO-wall rows included; and the port's serial, pipeline and thread
backends write bit for bit the same bucketed records.

The reference runs with a private prediction cache and its bucketing off
by argument, never process-wide.
"""

import itertools
import math

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch.configs.base import SHAPE_CELLS, get_config
from repro_torch.core import age, compileahead, lmgraph, pathfinder
from repro_torch.core import sweeprunner, techlib
from repro_torch.core.parallelism import Strategy
from repro_torch.core.roofline import PPEConfig

ARCH = "qwen1.5-0.5b"
RTOL = 1e-5
# tests/test_compileahead.py's grids: serving's 2x2 does not fit its KV
# cache (infeasible rows), serving-traffic's p99 TTFT axis spans a wall
# that fails and one that holds
GRIDS = {
    "train": dict(arches=(ARCH,), mesh_shapes=((2, 2), (4, 4)),
                  scenario="train", logic_nodes=("N7", "N5"),
                  budget_scales=(0.9, 1.0, 1.1), n_tilings=4, chunk_size=4),
    "serving": dict(arches=(ARCH,), mesh_shapes=((2, 2), (4, 4)),
                    scenario="serving", logic_nodes=("N7",),
                    budget_scales=(0.8, 1.0), n_tilings=4, chunk_size=3),
    "serving-traffic": dict(arches=(ARCH,), mesh_shapes=((2, 2), (4, 4)),
                            scenario="serving-traffic", n_tilings=2,
                            chunk_size=3,
                            scenario_params={"qps": 0.1,
                                             "slo_ttft_p99": [1.0, 1e6]}),
}
_UNIQ = itertools.count()


def _ukey(tag: str) -> tuple:
    return ("test-torch-bucketing", tag, next(_UNIQ))


def _port(grid: str, backend: str = "serial", **kw):
    return sweeprunner.SweepRunner(
        sweeprunner.SweepSpec(**GRIDS[grid]), backend=backend, cache=None,
        device="cpu", **kw).run()


def _by_key(records):
    return {r["key"]: r for r in records}


def test_sibling_designs_share_one_bucket_and_designs_are_memoized():
    """Two designs that differ only in their constants (a float literal
    and a tensor made inside the function) land in one bucket, each with
    its own packs, and replay ``x * c + 2c``; a key is traced once."""
    def make_scalar(c):
        def scalar(x):
            return x * c + torch.tensor(2.0 * c)
        return lambda: scalar

    spec = (pathfinder.TensorSpec((3,)),)
    s0 = compileahead.bucket_stats()
    k1, k2 = _ukey("dv"), _ukey("dv")
    dv1 = compileahead.design_vector(k1, make_scalar(3.0), spec, "cpu")
    dv2 = compileahead.design_vector(k2, make_scalar(5.0), spec, "cpu")
    s1 = compileahead.bucket_stats()
    assert dv1.bucket is dv2.bucket, "sibling designs split"
    assert s1["designs_traced"] == s0["designs_traced"] + 2
    assert s1["buckets"] == s0["buckets"] + 1
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for key, c in ((k1, 3.0), (k2, 5.0)):
        fn = compileahead.design_batch_fn(key, make_scalar(c), spec, "cpu")
        np.testing.assert_allclose(fn(x).numpy(), x.numpy() * c + 2 * c,
                                   rtol=1e-6)
    assert compileahead.bucket_stats() == s1       # no retrace
    key = _ukey("memo")
    fn = lambda: (lambda x: x + 1.0)                 # noqa: E731
    assert compileahead.design_vector(key, fn, spec, "cpu") is \
        compileahead.design_vector(key, fn, spec, "cpu")
    # a row read on the host while tracing is refused, as vmap refuses it
    with pytest.raises(RuntimeError, match="data-dependent"):
        compileahead.design_vector(
            _ukey("bad"), lambda: (lambda x: x * float(x[0])), spec, "cpu")

    # a constant the graph has read, then written in place by an op the
    # trace folds, is refused: the graph would replay the stale value
    def mutating():
        c = torch.ones(3)

        def scalar(x):
            y = x * c
            c.add_(1.0)
            return y
        return scalar
    with pytest.raises(NotImplementedError, match="writes in place"):
        compileahead.design_vector(_ukey("mut"), mutating, spec, "cpu")


def test_evaluate_matrix_stays_on_legacy_functions():
    """Template+matrix mode is one design over a big hardware batch: it
    never registers a design vector, and its rows are the bucketed points
    path's within rtol 1e-5."""
    g = lmgraph.build_graph(get_config(ARCH), SHAPE_CELLS["train_4k"])
    st = Strategy("RC", kp1=1, kp2=2, dp=8)
    template = age.generate(techlib.make_tech_config("N7", "HBM2E"),
                            age.Budgets.default(), device="cpu")
    base = pathfinder.pack_hw(template)
    rng = np.random.default_rng(0)
    hw = (base[None, :] * rng.uniform(0.85, 1.15, (32, base.shape[0]))
          ).astype(np.float32)
    ev = pathfinder.BatchedEvaluator(g, st, ppe=PPEConfig(n_tilings=4),
                                     cache=None, bucketed=True,
                                     device="cpu")
    s0 = compileahead.bucket_stats()
    rows = ev.evaluate_matrix(template, hw, devices=1)
    assert compileahead.bucket_stats()["designs_traced"] == \
        s0["designs_traced"], "evaluate_matrix registered a design vector"
    archs = [pathfinder.unpack_hw(template, torch.as_tensor(row))
             for row in hw]
    np.testing.assert_allclose(ev.evaluate(archs), rows, rtol=1e-5)
    assert compileahead.bucket_stats()["designs_traced"] == \
        s0["designs_traced"] + 1


def test_bucketed_records_are_the_references_unbucketed_records():
    """The port's bucketed serial runner against the reference's serial
    runner with ``bucketing=False``: the same keys and labels, floats
    within rtol 1e-5, the non-finite pattern exactly, on every grid."""
    for grid, spec in GRIDS.items():
        got = _port(grid, bucketing=True)
        want = ref_sr.SweepRunner(
            ref_sr.SweepSpec(**spec), backend="serial", bucketing=False,
            cache=ref_pf.PredictionCache()).run()
        assert got.complete and want.complete
        got, want = _by_key(got.records), _by_key(want.records)
        assert got.keys() == want.keys() and want, grid
        for key, w in want.items():
            g = got[key]
            assert list(g) == list(w), (grid, key)
            for f, v in w.items():
                if isinstance(v, float) and math.isfinite(v):
                    assert abs(g[f] - v) <= RTOL * abs(v), (grid, key, f)
                else:
                    assert g[f] == v or (v != v and g[f] != g[f]), \
                        (grid, key, f, g[f], v)
        feasible = {r.get("feasible", True) for r in got.values()}
        if grid != "train":     # infeasible and SLO-wall rows are covered
            assert feasible == {True, False}, (grid, feasible)


def _assert_bitwise(got, want):
    got, want = _by_key(got), _by_key(want)
    assert got.keys() == want.keys() and want
    for key, w in want.items():
        g = got[key]
        assert list(g) == list(w), key
        for f, v in w.items():
            if isinstance(v, float) and math.isnan(v):
                assert isinstance(g[f], float) and math.isnan(g[f])
            else:
                assert g[f] == v, (key, f, g[f], v)


@pytest.mark.parametrize("grid", ["train", "serving-traffic"])
def test_backends_write_bit_identical_bucketed_records(grid):
    """With bucketing asked for, every backend replays the same canonical
    graphs: serial, the pipeline (its defaults, and superbatches of one chunk with a
    lookahead of one) and the thread pool write the same bits."""
    serial = _port(grid, bucketing=True).records
    for backend, kw in (("pipeline", {}),
                        ("pipeline", dict(superbatch=1, compile_ahead=1)),
                        ("thread", dict(workers=2))):
        _assert_bitwise(_port(grid, backend, bucketing=True, **kw).records,
                        serial)
