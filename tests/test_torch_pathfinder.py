"""The port's hardware layout, prediction cache and Pareto tools against the
reference's, on the CPU; the search layer's devices and its misuses.

The evaluator's rows are in ``test_torch_pathfinder_rows.py``, the sweep
in ``test_torch_pathfinder_sweep.py`` and the CLI in
``test_torch_pathfind_cli.py``.  None of them fills or clears the
reference's process-wide caches (ROADMAP queue 3).
"""

import itertools

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import age as ref_age
from repro.core import pathfinder as ref_pf
from repro.core import techlib as ref_techlib
from repro_torch.core import age, lmgraph, pathfinder, sweeprunner, techlib
from repro_torch.core.parallelism import Strategy
from repro_torch.core.roofline import PPEConfig

TECH = tuple(itertools.product(("N7", "N5", "N3"), ("HBM2E", "HBM3")))
PPE = PPEConfig(n_tilings=8)


def _arch_pairs():
    """(reference, port) hardware: AGE'd points (tensor leaves) and known
    silicon (Python-float leaves)."""
    budgets, ref_budgets = age.Budgets.default(), ref_age.Budgets.default()
    return [(ref_age.generate(ref_techlib.make_tech_config(lg, hbm),
                              ref_budgets),
             age.generate(techlib.make_tech_config(lg, hbm), budgets,
                          device="cpu")) for lg, hbm in TECH] + [
        (ref_age.tpu_v5e_microarch(), age.tpu_v5e_microarch("cpu")),
        (ref_age.cpu_host_microarch(), age.cpu_host_microarch(device="cpu"))]


def test_pack_hw_is_the_references_bit_for_bit():
    assert pathfinder.HW_FIELDS == ref_pf.HW_FIELDS
    assert pathfinder.HW_COEFF_FIELDS == ref_pf.HW_COEFF_FIELDS
    assert pathfinder.METRICS == ref_pf.METRICS
    pairs = _arch_pairs()
    for ref_arch, arch in pairs:
        want = ref_pf.pack_hw(ref_arch)
        got = pathfinder.pack_hw(arch)
        assert got.dtype == np.float32 and got.shape == (pathfinder.HW_DIM,)
        assert got.tobytes() == want.tobytes(), (arch.tech.name, got, want)
        assert pathfinder._hw_key(arch) == want.tobytes()
    # the batch packs each arch as `pack_hw` does
    archs = [arch for _, arch in pairs]
    for arch, v in zip(archs, pathfinder.pack_hw_many(archs)):
        assert pathfinder.pack_hw(arch).tobytes() == v.tobytes()


def test_unpack_hw_gives_the_packed_row_back():
    archs = [arch for _, arch in _arch_pairs()[:len(TECH)]]
    for arch, v in zip(archs, pathfinder.pack_hw_many(archs)):
        back = pathfinder.unpack_hw(arch, torch.as_tensor(v))
        assert back.tech == arch.tech and back.device == arch.device
        assert pathfinder.pack_hw(back)[:13].tobytes() == v[:13].tobytes()
        assert float(back.dram_bw) == float(np.float32(float(arch.dram_bw)))


def _toy():
    g = lmgraph.gemm_graph(2048, 1024, 4096, train=True)
    st = Strategy("RC", kp1=2, kp2=2, dp=4)
    archs = [age.generate(techlib.make_tech_config(lg, hbm),
                          age.Budgets.default(), device="cpu")
             for lg in ("N7", "N5") for hbm in ("HBM2E", "HBM3")]
    return g, st, archs


def test_prediction_cache_keeps_the_references_lru_semantics():
    """``tests/test_pathfinder.py``'s cache semantics, on the port."""
    g, st, archs = _toy()
    cache = pathfinder.PredictionCache(maxsize=64)
    ev = pathfinder.BatchedEvaluator(g, st, ppe=PPE, cache=cache,
                                     device="cpu")
    rows = ev.evaluate(archs)
    assert cache.stats == {"hits": 0, "misses": len(archs),
                           "size": len(archs)}
    np.testing.assert_array_equal(rows, ev.evaluate(archs))
    assert cache.stats["hits"] == cache.stats["misses"] == len(archs)
    extra = age.generate(techlib.make_tech_config("N3", "HBM2E"),
                         age.Budgets.default(), device="cpu")
    rows3 = ev.evaluate(archs + [extra])
    assert cache.stats["hits"] == 2 * len(archs)
    assert cache.stats["misses"] == len(archs) + 1
    np.testing.assert_array_equal(rows3[:len(archs)], rows)

    small = pathfinder.PredictionCache(maxsize=2)
    ev = pathfinder.BatchedEvaluator(g, st, ppe=PPE, cache=small,
                                     device="cpu")
    ev.evaluate(archs)                       # 4 points through a 2-slot LRU
    assert len(small) == 2
    ev.evaluate([archs[-1]])                 # most recent point still cached
    assert small.stats["hits"] == 1
    small.put_many([("a", np.zeros(5)), ("b", np.ones(5))])
    assert small.get_many(["a", "b", "x"])[2] is None and len(small) == 2
    small.clear()
    assert small.stats == {"hits": 0, "misses": 0, "size": 0}

    shared = pathfinder.PredictionCache()    # no false sharing across keys
    r1, r2 = (pathfinder.evaluate(points=[pathfinder.EvalPoint(
        archs[0], g, other)], ppe=PPE, cache=shared) for other in (
        Strategy("RC", kp1=2, kp2=2, dp=4), Strategy("CR", kp1=4, dp=4)))
    assert shared.stats["misses"] == 2 and r1[0, 0] != r2[0, 0]

    prev = pathfinder.prediction_cache()     # late binding of the default
    mine = pathfinder.set_prediction_cache(pathfinder.PredictionCache())
    try:
        pathfinder.BatchedEvaluator(g, st, ppe=PPE,
                                    device="cpu").evaluate(archs[:1])
        assert pathfinder.cache_stats() == mine.stats == {
            "hits": 0, "misses": 1, "size": 1}
        pathfinder.clear_prediction_cache()
        assert len(mine) == 0 and pathfinder.resolve_cache(None) is None
    finally:
        pathfinder.set_prediction_cache(prev)


def test_pareto_front_and_hypervolume_match_the_reference():
    """Seeded points on a coarse grid, so that there are exact ties on one
    objective and on all of them, with repeats, NaN and inf."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        pts = [tuple(v) for v in rng.integers(0, 6, (40, 2 + seed % 2))
               .astype(float)]
        pts += pts[:5] + [(np.nan,) * len(pts[0]), (np.inf,) * len(pts[0])]
        objs = [(lambda p, k=k: p[k]) for k in range(len(pts[0]))]
        want = ref_pf.pareto_front(pts, objs)
        got = pathfinder.pareto_front(pts, objs)
        assert [id(p) for p in got] == [id(p) for p in want] and got
        ref = np.full(len(pts[0]), 6.0)
        assert pathfinder.hypervolume(pts, ref) == ref_pf.hypervolume(pts,
                                                                      ref)
        assert pathfinder.hypervolume(got, ref) == \
            pathfinder.hypervolume(pts, ref)


def test_what_is_not_ported_raises_naming_its_item():
    """The search layer's devices work (host shards give the rows of one
    device) and its misuses raise: mixed modes, a matrix of the wrong
    width, mixed systolic dims, more cards than the host has."""
    g, st, archs = _toy()
    ev = pathfinder.BatchedEvaluator(g, st, ppe=PPE, cache=None,
                                     device="cpu")
    hw = pathfinder.pack_hw_many(archs)
    one = ev.evaluate_matrix(archs[0], hw, devices=1)
    np.testing.assert_allclose(ev.evaluate_matrix(archs[0], hw, devices=2),
                               one, rtol=1e-6)
    prev = pathfinder.set_host_devices(2)
    try:
        np.testing.assert_allclose(ev.evaluate(archs, shard_devices=True),
                                   one, rtol=1e-6)
    finally:
        pathfinder.set_host_devices(prev)
    assert sweeprunner.pick_backend("device") == "device"
    with pytest.raises(ValueError, match="this host has"):
        pathfinder.shard_devices("cuda", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="label mode needs both"):
        pathfinder.evaluate(spec=object())
    with pytest.raises(ValueError, match="label mode's"):
        pathfinder.evaluate(points=[], device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        pathfinder.evaluate()
    with pytest.raises(ValueError, match="matrix mode"):
        pathfinder.evaluate(template=archs[0], matrix=np.zeros((1, 18)))
    with pytest.raises(ValueError, match=r"\(N, 18\)"):
        ev.evaluate_matrix(archs[0], np.zeros((2, 13)))
    with pytest.raises(ValueError, match="mixed systolic"):
        ev.evaluate([archs[0], age.tpu_v5e_microarch("cpu")])
