"""The reference's side of the SOE / cooptimize parity tests.

Shared by tests/test_torch_soe*.py, test_torch_cooptimize*.py and
test_torch_golden_soe.py: the reference's objectives of
``chip_smoke.SOE_CASES``, evaluated on the CPU with its bucketing off and
a private prediction cache (ROADMAP queue 3: neither the process-wide
cache nor the bucketing default is left changed), and the tolerances the
port is held to.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import torch

from repro import pathfind as ref_pathfind
from repro.core import compileahead
from repro.core import cooptimize as ref_co
from repro.core import pathfinder as ref_pf
from repro.core import soe as ref_soe
from repro.core import sweeprunner as ref_sr
from repro.core import techlib as ref_techlib
from repro.core.age import Budgets as RefBudgets

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5             # f32 values
GRAD_TOL = 1e-4         # of the gradient's norm


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def private_reference():
    """The reference with its bucketing off and a private prediction cache
    swapped in; both restored after, the process-wide cache untouched."""
    prev_bucketing = compileahead.set_bucketing_default(False)
    prev = ref_pf.prediction_cache()
    ref_pf.set_prediction_cache(ref_pf.PredictionCache())
    try:
        yield
    finally:
        ref_pf.set_prediction_cache(prev)
        compileahead.set_bucketing_default(prev_bucketing)


def ref_objective(case):
    """The reference's `soe.make_objective` of one `SOE_CASES` case."""
    from repro.configs.base import SHAPE_CELLS, get_config
    from repro.core import lmgraph
    from repro.core.parallelism import Strategy
    from repro.core.roofline import PPEConfig
    kind, *args = case["graph"]
    graph = lmgraph.gemm_graph(*args) if kind == "gemm" else \
        lmgraph.build_graph(get_config(args[0]), SHAPE_CELLS[args[1]])
    return ref_soe.make_objective(
        ref_techlib.make_tech_config(*case["tech"]), graph,
        Strategy.parse(case["strategy"]), template=RefBudgets.default(),
        ppe=PPEConfig(n_tilings=case["n_tilings"]))


def ref_objective_points(case):
    return [np.asarray(w).tolist() for w in ref_soe._initial_starts(
        ref_soe.SOEConfig(starts=case["starts"], seed=case["seed"]),
        RefBudgets.default())]


def ref_refine_parts(case):
    """The reference's pieces of one refine case of `SOE_CASES`: the first
    design of its sweep spec (`refine_sweep`'s arguments for it), its
    starts, and its norms (the design's own record, as `refine_sweep`
    normalizes by a candidate's)."""
    spec = ref_sr.SweepSpec(
        arches=tuple(case["arches"]),
        mesh_shapes=tuple(tuple(m) for m in case["mesh_shapes"]),
        scenario=case["scenario"], logic_nodes=tuple(case["logic_nodes"]),
        n_tilings=case["n_tilings"],
        scenario_params=case["scenario_params"],
        objectives=tuple(case["objectives"]) if case["objectives"] else None)
    lb = ref_sr.enumerate_labels(spec)[0]
    with private_reference():
        rec = ref_pf.evaluate(spec=spec, labels=[lb],
                              cache=ref_pf.PredictionCache())[0]
    scn = ref_sr.scenario_for(spec, lb.cell)
    tech = ref_techlib.make_tech_config(lb.logic, lb.hbm, lb.net)
    like = spec.budgets(lb.scale)
    cfg = ref_co.RefineConfig(starts=case["starts"], seed=case["seed"])
    return dict(spec=spec, scn=scn, dp=ref_sr.resolve_label(spec, lb),
                tech=tech, like=like, ppe=ref_sr.spec_ppe(spec),
                norms=[float(rec[f]) for f in scn.refine_objective_fields],
                thetas=ref_co.initial_thetas(tech, like, cfg).tolist())


def ref_refine_case(case):
    """(golden case, thetas, reference refine objective) of one case."""
    p = ref_refine_parts(case)
    f = ref_co.make_refine_objective(
        p["tech"], p["like"], p["scn"], p["dp"], p["ppe"], p["norms"],
        ref_co.RefineConfig(), profile=p["spec"].profile)
    return ({"spec": p["spec"].to_dict(), "norms": p["norms"]},
            p["thetas"], f)


def values_and_grads(f, points):
    """The reference's value and gradient at each point, one eager call
    each (a jitted vmap compiles for longer than this takes)."""
    vals, grads = [], []
    for p in points:
        v, g = jax.value_and_grad(f)(np.asarray(p, dtype=np.float32))
        vals.append(float(v))
        grads.append(np.asarray(g, dtype=np.float64).tolist())
    return {"values": vals, "grads": grads}


def port_values_and_grads(f, points):
    """The port's, in one vmapped ``grad_and_value`` on the CPU."""
    x = torch.tensor(points, dtype=torch.float32)
    g, v = torch.func.vmap(torch.func.grad_and_value(f))(x)
    return {"values": v.double().tolist(), "grads": g.double().tolist()}


def assert_values_and_grads(got, want, rtol=RTOL, grad_tol=GRAD_TOL):
    np.testing.assert_allclose(got["values"], want["values"], rtol=rtol,
                               atol=0)
    for g, w in zip(np.asarray(got["grads"]), np.asarray(want["grads"])):
        assert np.isfinite(g).all() and np.linalg.norm(w) > 0
        assert np.linalg.norm(g - w) <= grad_tol * np.linalg.norm(w), (g, w)


def ref_descent(cases):
    """The reference's batched descent of ``cases["descent"]``."""
    d = dict(cases["descent"])
    steps = []
    res = ref_soe.optimize(
        ref_objective(cases["objective"][d["objective"]]),
        ref_soe.SOEConfig(steps=d["steps"], starts=d["starts"],
                          seed=d["seed"]),
        on_step=lambda t, W: steps.append(np.asarray(W).tolist()))
    return {**d, "W": steps, "history": [float(v) for v in res.history],
            "n_queries": res.n_queries}


def ref_soe_cli(argv):
    """What ``python -m repro.pathfind soe ...`` prints."""
    out = io.StringIO()
    with private_reference(), contextlib.redirect_stdout(out):
        assert ref_pathfind.main(list(argv)) == 0
    return {"argv": list(argv), "stdout": out.getvalue()}
