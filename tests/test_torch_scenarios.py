"""The port's scenario layer against the reference's, on the CPU.

Both packages fold metric rows into records with float64 numpy, line for
line, so on identical inputs they agree bit for bit: the reference's
`record` and `metrics_fold` are fed seeded rows (finite, infinite, and
rows that cross the utilization and SLO walls) for labels whose
hardware the two packages build each their own way (every other serving
design given a main memory that puts it on the capacity derate's ramp or
past its wall), and every record value must be the reference's to the
last bit (``repr``), type included.
`simulate.serving_breakdown`, the scenario specs and the registry are
held to the reference the same way.  Nothing is evaluated, so the
reference's process-wide caches are not touched.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp  # (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPE_CELLS as REF_CELLS
from repro.configs.base import get_config as ref_get_config
from repro.core import pathfinder as ref_pf
from repro.core import scenarios as ref_scenarios
from repro.core import simulate as ref_simulate
from repro.core import sweeprunner as ref_sr
from repro.core.parallelism import Strategy as RefStrategy
from repro_torch.configs.base import get_config
from repro_torch.core import pathfinder, scenarios, simulate, sweeprunner
from repro_torch.core.parallelism import Strategy

# archs and meshes that put some designs past the HBM capacity wall
GRID = dict(arches=("qwen1.5-0.5b", "mistral-large-123b",
                    "recurrentgemma-2b"),
            mesh_shapes=((2, 2), (8, 8)), logic_nodes=("N7", "N5"),
            hbms=("HBM2E",), n_tilings=4)
OBJECTIVES = ("energy", "cost", "goodput")
SCENARIOS = {
    "train": dict(scenario="train"),
    "serving": dict(scenario="serving", slo_s=0.5),
    "serving-traffic": dict(scenario="serving-traffic", slo_s=20.0,
                            scenario_params={"qps": [0.25, 1.0],
                                             "slo_tpot_p50": 0.05}),
}


def _bits(v):
    """A record value as its type and exact ``repr`` (NaN == NaN)."""
    return type(v).__name__, repr(v)


def _same_record(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), (k, got[k], want[k])


def _rows(rng, n: int, ppd: int) -> np.ndarray:
    """Seeded (n, ppd, 5) float32 metric rows over five decades, with
    infinite and NaN rows and rows slow enough to cross the walls."""
    rows = np.exp(rng.uniform(np.log(1e-4), np.log(20.0), (n, ppd, 5)))
    rows[::5, -1, 0] = np.inf            # a phase without a prediction
    rows[1::7, 0, 0] = np.nan
    rows[2::6, -1, 0] *= 1e3             # past the utilization wall
    return rows.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_folds_on_identical_rows_are_the_references_bit_for_bit(name):
    """`record`, `metrics_fold` and `objective_values` of every variant, with
    the composed objectives energy, cost and goodput."""
    kw = dict(GRID, objectives=OBJECTIVES, **SCENARIOS[name])
    ref_spec, spec = ref_sr.SweepSpec(**kw), sweeprunner.SweepSpec(**kw)
    labels = ref_sr.enumerate_labels(ref_spec)
    assert [lb.key() for lb in labels] == \
        [lb.key() for lb in sweeprunner.enumerate_labels(spec)]
    rng = np.random.default_rng(len(name))
    ppd = 1 if name == "train" else 2
    rows = _rows(rng, len(labels), ppd)
    n_infeasible = n_wall = n_ramp = 0
    groups = {}
    for i, lb in enumerate(labels):
        ref_dp = ref_sr.resolve_label(ref_spec, lb)
        dp = sweeprunner.resolve_label(spec, sweeprunner.PointLabel(
            **vars(lb)), device="cpu")
        if ppd == 2 and i % 2:    # occupancy 0.8-1.05 of the capacity
            scn = ref_sr.scenario_for(ref_spec, lb.cell)
            w, kv = ref_scenarios.serving_bytes_per_device(
                ref_dp.cfg, ref_dp.strategy, REF_CELLS[scn.decode_cell])
            cap = float(np.float32((w + kv) / rng.uniform(0.8, 1.05)))
            ref_dp = dataclasses.replace(ref_dp, hw=dataclasses.replace(
                ref_dp.hw, dram_capacity=jnp.float32(cap)))
            dp = dataclasses.replace(dp, hw=dataclasses.replace(
                dp.hw, dram_capacity=torch.tensor(cap)))
        hw = ref_pf.pack_hw(ref_dp.hw)
        assert pathfinder.pack_hw(dp.hw).tobytes() == hw.tobytes()
        ref_scn = ref_sr.scenario_for(ref_spec, lb.cell)
        scn = sweeprunner.scenario_for(spec, lb.cell)
        assert scn.fields == ref_scn.fields
        assert scn.objectives == ref_scn.objectives
        want = ref_scn.record(ref_dp, rows[i].astype(np.float64))
        got = scn.record(dp, rows[i].astype(np.float64))
        _same_record(got, want)
        assert scn.objective_values(got) == ref_scn.objective_values(want)
        n_ramp += 1.0 < want.get("kv_derate", 1.0) < math.inf
        n_infeasible += want.get("feasible") is False
        n_wall += want.get("feasible") is True and \
            want.get("slo_ok") is False
        groups.setdefault((lb.arch, lb.strategy, lb.cell), []).append(
            (i, ref_dp, hw))
    if name != "train":
        assert n_infeasible and n_wall and n_ramp, \
            (n_infeasible, n_wall, n_ramp)
    for (arch, strategy, cell), members in groups.items():
        idx = [i for i, _, _ in members]
        hw = np.stack([h for _, _, h in members])
        ref_dp = members[0][1]
        want = ref_sr.scenario_for(ref_spec, cell).metrics_fold(
            ref_dp.cfg, ref_dp.strategy, cell)(rows[idx], hw)
        got = sweeprunner.scenario_for(spec, cell).metrics_fold(
            get_config(arch), Strategy.parse(strategy), cell)(rows[idx], hw)
        assert len(got) == len(want) == len(idx)
        for g, w in zip(got, want):
            _same_record(g, w)


def test_serving_breakdown_matches_the_reference():
    """Seeded phase times and memory footprints on both sides of the
    capacity knee and wall, with and without an SLO: every field to the
    last bit."""
    rng = np.random.default_rng(0)
    for i in range(400):
        phases = [tuple(float(x) for x in rng.exponential(1.0, 4))
                  for _ in range(2)]
        if i % 9 == 0:
            phases[1] = (math.inf,) + phases[1][1:]
        cap = float(rng.uniform(1e9, 1e11))
        kw = dict(batch=int(rng.integers(0, 512)),
                  devices=int(rng.integers(1, 1024)),
                  weight_bytes_per_device=float(rng.uniform(0, 0.7)) * cap,
                  kv_bytes_per_device=float(rng.uniform(0, 0.6)) * cap,
                  dram_capacity=cap,
                  slo_s=None if i % 3 else float(rng.uniform(0.1, 3.0)))
        want = ref_simulate.serving_breakdown(
            *(ref_simulate.TimeBreakdown(*p) for p in phases), **kw)
        got = simulate.serving_breakdown(
            *(simulate.TimeBreakdown(*p) for p in phases), **kw)
        _same_record(vars(got), vars(want))


def test_scenario_specs_and_registry_match_the_reference():
    """ScenarioSpec construction, serialization, variant expansion and
    resolution, and the registry's names, fields and objectives; the
    frontier folds against the reference's traced ones."""
    assert scenarios.scenario_names() == ref_scenarios.scenario_names()
    specs = [dict(name=n) for n in scenarios.scenario_names()] + [
        dict(name="train", cells=("train_4k",)),
        dict(name="serving", slo_s=0.3, objectives=("energy", "ttft_s")),
        dict(name="serving-traffic", cells=("prefill_32k", "decode_32k"),
             params={"qps": [1, 4.0], "prefill_chunk": 256.0,
                     "energy_price_usd_per_kwh": 0.2}),
        dict(name="serving-traffic", slo_s=2.0,
             objectives=("cost", "goodput"))]
    for kw in specs:
        ref, port = ref_scenarios.ScenarioSpec(**kw), \
            scenarios.ScenarioSpec(**kw)
        assert port.to_dict() == ref.to_dict()
        assert scenarios.ScenarioSpec.from_dict(ref.to_dict()) == port
        assert [v.to_dict() for v in port.variants()] == \
            [v.to_dict() for v in ref.variants()]
        for rv, pv in zip(ref.variants(), port.variants()):
            rs, ps = rv.resolve(), pv.resolve()
            assert type(ps).__name__ == type(rs).__name__
            for attr in ("name", "fields", "objectives", "cell_id",
                         "refine_objective_fields", "objective_kind",
                         "_obj_signs", "_custom", "obj_params"):
                a, b = getattr(ps, attr), getattr(rs, attr)
                assert (a() if callable(a) else a) == \
                    (b() if callable(b) else b), attr
            assert [o.name for o in ps.extra_objectives] == \
                [o.name for o in rs.extra_objectives]
            assert pv.for_cell_id(ps.cell_id()).to_dict() == \
                rv.for_cell_id(rs.cell_id()).to_dict()
    with pytest.raises(ValueError, match="takes no params"):
        scenarios.ScenarioSpec(name="train", params={"qps": 1}).resolve()
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get_scenario("no-such-scenario")

    # the device-resident frontier fold (item 11 (a)) over seeded rows is
    # the reference's traced one within float32 rounding, infinities where
    # it has them; cooptimize's differentiable fold (item 8) is a fold of
    # the scenario's refine objectives (held to the reference's in
    # tests/test_torch_cooptimize.py); the registry is the port's own
    kw = dict(GRID, scenario="serving", objectives=OBJECTIVES)
    spec = sweeprunner.SweepSpec(**kw)
    lb = next(lb for lb in sweeprunner.enumerate_labels(spec)
              if lb.mesh == (8, 8))        # a design whose KV cache fits
    dp = sweeprunner.resolve_label(spec, lb, device="cpu")
    hw = pathfinder.pack_hw(dp.hw)
    ref_cfg = ref_get_config(lb.arch)
    ref_st = RefStrategy.parse(lb.strategy)
    rng = np.random.default_rng(3)
    for name in scenarios.scenario_names():
        for objectives in (None, OBJECTIVES):
            scn = scenarios.get_scenario(name).with_objectives(objectives)
            ref = ref_scenarios.get_scenario(name).with_objectives(
                objectives)
            # milliseconds to seconds: some designs within the traffic's
            # utilization wall
            rows = _rows(rng, 16, scn.points_per_design()) \
                * np.float32(1e-3)
            hws = np.repeat(hw[None], 16, axis=0)
            hws[::3, pathfinder.HW_FIELDS.index("dram_capacity")] *= 1e-3
            got = torch.func.vmap(scn.frontier_fold(dp.cfg, dp.strategy))(
                torch.from_numpy(rows), torch.from_numpy(hws)).numpy()
            want = np.asarray(jax.vmap(ref.frontier_fold(
                ref_cfg, ref_st))(jnp.asarray(rows), jnp.asarray(hws)))
            assert got.dtype == np.float32 and got.shape == want.shape
            fin = np.isfinite(want)
            assert (np.isfinite(got) == fin).all() and fin.any(), name
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
        assert callable(scn.refine_objectives(dp))
    mine = scenarios.TrainScenario(cell="train_4k", name="train-port-only")
    scenarios.register_scenario(mine)
    try:
        assert "train-port-only" in scenarios.scenario_names()
        assert "train-port-only" not in ref_scenarios.scenario_names()
        with pytest.raises(ValueError, match="already registered"):
            scenarios.register_scenario(mine)
    finally:
        scenarios._REGISTRY.pop("train-port-only")
