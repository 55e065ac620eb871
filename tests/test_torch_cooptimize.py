"""The port's cross-stack refinement engine (``repro_torch.core.
cooptimize``) against the reference's, on the CPU: the technology knobs,
`apply_tech_knobs`, `power_excess`, `feasible_knobs` and `realize_theta`;
every scenario's refine fold (built in and with composed objectives), each
of its scalars and its gradient, at a seeded start; the soft capacity
derate; and `refine_theta`'s batched descent.  Values at rtol 1e-5,
gradients at 1e-4 of their norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import age as ref_age
from repro.core import cooptimize as ref_co
from repro.core import lmgraph as ref_lmgraph
from repro.core import pathfinder as ref_pf
from repro.core import roofline as ref_roofline
from repro.core import simulate as ref_simulate
from repro.core import techlib as ref_techlib
from repro.core.age import Budgets as RefBudgets
from repro.core.parallelism import Strategy as RefStrategy
from repro_torch.calibrate import fitting
from repro_torch.core import age, cooptimize, lmgraph, pathfinder, \
    roofline, simulate, sweeprunner, techlib
from repro_torch.core.age import Budgets
from repro_torch.core.parallelism import Strategy
from soehelpers import GRAD_TOL, RTOL, chip_smoke, ref_refine_parts

CS = chip_smoke()
TECH = ("N7", "HBM2E", "IB-NDR-X8")


def _budgets(rng):
    """Seeded budget vectors: the template, an over-subscribed power
    simplex, and a starved one."""
    w0 = np.asarray(Budgets.default().as_vector("cpu"))
    out = [w0]
    for scale in (1.3, 0.6):
        w = w0 * rng.uniform(0.7, 1.3, w0.shape)
        w[7:14] *= scale
        out.append(w.astype(np.float32))
    return out


def test_knobs_and_realize_theta_match_reference():
    """Knob maps, the DVFS / HBM transform on an AGE'd point, the power
    penalty, the joint power clamp and the realized hardware (with and
    without a calibration profile), on seeded budgets and knobs."""
    rng = np.random.default_rng(3)
    tech, ref_tech = (techlib.make_tech_config(*TECH),
                      ref_techlib.make_tech_config(*TECH))
    cfg, ref_cfg = cooptimize.RefineConfig(), ref_co.RefineConfig()
    assert cooptimize.knob_bounds(tech, cfg) == \
        ref_co.knob_bounds(ref_tech, ref_cfg)
    assert cooptimize.nominal_knobs(tech) == ref_co.nominal_knobs(ref_tech)
    profile = {"tech": "cpu_host",
               "params": dict(fitting.default_params(), compute_eff=0.7,
                              dram_bw_eff=0.8)}
    for w in _budgets(rng):
        u = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        np.testing.assert_allclose(
            cooptimize.unit_from_knobs(
                cooptimize.knobs_from_unit(u, tech, cfg), tech, cfg),
            ref_co.unit_from_knobs(ref_co.knobs_from_unit(u, ref_tech,
                                                          ref_cfg),
                                   ref_tech, ref_cfg), rtol=1e-6)
        knobs = [float(k) for k in cooptimize.knobs_from_unit(u, tech, cfg)]
        arch = cooptimize.apply_tech_knobs(
            age.generate(tech, Budgets.from_vector(torch.as_tensor(w),
                                                   Budgets.default())),
            tech, *knobs)
        ref_arch = ref_co.apply_tech_knobs(
            ref_age.generate(ref_tech, RefBudgets.from_vector(
                jnp.asarray(w), RefBudgets.default())), ref_tech, *knobs)
        np.testing.assert_allclose(pathfinder.pack_hw(arch),
                                   ref_pf.pack_hw(ref_arch), rtol=1e-6)
        np.testing.assert_allclose(
            float(cooptimize.power_excess(torch.as_tensor(w), tech, *knobs)),
            float(ref_co.power_excess(jnp.asarray(w), ref_tech, *knobs)),
            rtol=1e-5, atol=1e-7)
        budgets = Budgets.from_vector(w.astype(np.float64),
                                      Budgets.default())
        ref_budgets = RefBudgets.from_vector(w.astype(np.float64),
                                             RefBudgets.default())
        for req in ((0.5, 2.0, 2.0), (knobs[0], 1.5, 0.7), (2.0, 0.6, 1.9)):
            assert cooptimize.feasible_knobs(tech, budgets, *req, cfg) == \
                ref_co.feasible_knobs(ref_tech, ref_budgets, *req, ref_cfg)
        assert cooptimize.feasible_voltage(tech, budgets, 1.2) == \
            ref_co.feasible_voltage(ref_tech, ref_budgets, 1.2)
        theta = np.concatenate([w, u])
        for prof in (None, profile):
            arch, b, k = cooptimize.realize_theta(
                tech, Budgets.default(), theta, cfg, profile=prof,
                device="cpu")
            ref_arch, ref_b, ref_k = ref_co.realize_theta(
                ref_tech, RefBudgets.default(), theta, ref_cfg, profile=prof)
            assert k == ref_k
            assert cooptimize._budget_fields(b) == \
                ref_co._budget_fields(ref_b)
            np.testing.assert_allclose(pathfinder.pack_hw(arch),
                                       ref_pf.pack_hw(ref_arch), rtol=1e-6)


def _port_fold_fn(spec_dict):
    """theta -> the port's refine fold scalars, stacked, of the first
    design of a sweep spec (make_refine_objective's path without the
    normalization and the penalty)."""
    spec = sweeprunner.SweepSpec.from_dict(spec_dict)
    lb = sweeprunner.enumerate_labels(spec)[0]
    scn = sweeprunner.scenario_for(spec, lb.cell)
    dp = sweeprunner.resolve_label(spec, lb, "cpu")
    tech = techlib.make_tech_config(lb.logic, lb.hbm, lb.net)
    like, ppe, cfg = (spec.budgets(lb.scale), sweeprunner.spec_ppe(spec),
                      cooptimize.RefineConfig())
    eps, fold = scn.eval_points(dp), scn.refine_objectives(dp)

    def f(theta):
        v, s_bw, s_cap = cooptimize.knobs_from_unit(theta[17:], tech, cfg)
        arch = cooptimize.apply_tech_knobs(
            age.generate(tech, Budgets.from_vector(theta[:17], like),
                         discrete=False), tech, v, s_bw, s_cap)
        bds = [simulate.predict(arch, ep.graph, ep.strategy,
                                system=ep.system, cfg=ppe, pod_bw=ep.pod_bw)
               for ep in eps]
        return torch.stack(list(fold(bds, pathfinder.hw_ctx(arch))))
    return f


def _ref_fold_fn(parts):
    tech, like, ppe, dp = parts["tech"], parts["like"], parts["ppe"], \
        parts["dp"]
    cfg = ref_co.RefineConfig()
    eps, fold = parts["scn"].eval_points(dp), parts["scn"].refine_objectives(
        dp)

    def f(theta):
        v, s_bw, s_cap = ref_co.knobs_from_unit(theta[17:], tech, cfg)
        arch = ref_co.apply_tech_knobs(
            ref_age.generate(tech, RefBudgets.from_vector(theta[:17], like),
                             discrete=False), tech, v, s_bw, s_cap)
        bds = [ref_simulate.predict(arch, ep.graph, ep.strategy,
                                    system=ep.system, cfg=ppe,
                                    pod_bw=ep.pod_bw) for ep in eps]
        return jnp.stack(list(fold(bds, ref_pf.hw_ctx(arch))))
    return f


@pytest.mark.parametrize("composed", [False, True],
                         ids=["built-in", "energy,cost,goodput"])
def test_refine_folds_match_reference(composed):
    """Each scenario's `refine_objectives` (train, serving,
    serving-traffic), built in or composed: every canonical scalar and its
    gradient in theta (jacobians: the port's jacrev under vmap, the
    reference's jacrev) at the case's seeded start.  serving-traffic's
    goodput is flat in theta (qps x output tokens x availability), so its
    gradient must be zero in both."""
    for case in CS.SOE_CASES["refine"]:
        if bool(case["objectives"]) != composed:
            continue
        parts = ref_refine_parts(case)
        theta = np.asarray(parts["thetas"][1], np.float32)
        want_v = np.asarray(_ref_fold_fn(parts)(theta), np.float64)
        want_j = np.asarray(jax.jacrev(_ref_fold_fn(parts))(theta),
                            np.float64)
        f = _port_fold_fn(parts["spec"].to_dict())
        x = torch.as_tensor(theta)[None]
        got_v = torch.func.vmap(f)(x)[0].double().numpy()
        got_j = torch.func.vmap(torch.func.jacrev(f))(x)[0].double().numpy()
        n = len(parts["scn"].refine_objective_fields)
        assert got_v.shape == want_v.shape == (n,), case
        np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=0)
        for name, g, w in zip(parts["scn"].refine_objective_fields, got_j,
                              want_j):
            # an objective flat in theta (zero gradient) must be flat here
            assert np.linalg.norm(g - w) <= GRAD_TOL * np.linalg.norm(w), \
                (case["scenario"], name, g, w)


def test_capacity_pressure_derate_soft_matches_reference():
    """Below the knee, on the ramp, at and past the wall: values and
    gradients."""
    occ = np.asarray([0.0, 0.5, 0.85, 0.9, 0.99, 1.0, 1.02, 1.5, 3.0],
                     np.float32)
    want = np.asarray(jax.vmap(ref_roofline.capacity_pressure_derate_soft)(
        occ))
    want_g = np.asarray(jax.vmap(jax.grad(
        ref_roofline.capacity_pressure_derate_soft))(occ))
    x = torch.as_tensor(occ).requires_grad_(True)
    got = roofline.capacity_pressure_derate_soft(x)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=RTOL, atol=1e-6)
    assert float(roofline.capacity_pressure_derate_soft(0.95)) == \
        pytest.approx(float(ref_roofline.capacity_pressure_derate_soft(0.95)),
                      rel=RTOL)


def _gemm_refine_objective(pkg_age, pkg_co, pkg_lmgraph, pkg_simulate,
                           budgets_cls, strategy_cls, tech, cfg):
    """A refine objective over a GEMM (the shape of
    `make_refine_objective`'s: knobs, AGE, prediction, power penalty),
    written once for either package."""
    graph = pkg_lmgraph.gemm_graph(4096, 4096, 4096)
    st = strategy_cls("RC", kp1=2, kp2=2, dp=2)
    like = budgets_cls.default()

    def f(theta):
        w = theta[:17]
        v, s_bw, s_cap = pkg_co.knobs_from_unit(theta[17:], tech, cfg)
        arch = pkg_co.apply_tech_knobs(
            pkg_age.generate(tech, budgets_cls.from_vector(w, like),
                             discrete=False), tech, v, s_bw, s_cap)
        bd = pkg_simulate.predict(arch, graph, st)
        return bd.total_s * (1.0 + cfg.power_penalty * pkg_co.power_excess(
            w, tech, v, s_bw, s_cap))
    return f


def test_refine_theta_matches_reference():
    """`refine_theta`'s batched descent (eq. 6 on the budget block, the
    clipped EMA on the knob block) from the same starts, after one and
    after three steps: the best theta, its value and the evaluations."""
    tech, ref_tech = (techlib.make_tech_config(*TECH),
                      ref_techlib.make_tech_config(*TECH))
    f = _gemm_refine_objective(age, cooptimize, lmgraph, simulate, Budgets,
                               Strategy, tech, cooptimize.RefineConfig())
    ref_f = _gemm_refine_objective(ref_age, ref_co, ref_lmgraph,
                                   ref_simulate, RefBudgets, RefStrategy,
                                   ref_tech, ref_co.RefineConfig())
    for steps in (1, 3):
        cfg = cooptimize.RefineConfig(steps=steps, starts=3, seed=1)
        ref_cfg = ref_co.RefineConfig(**dataclasses.asdict(cfg))
        theta0s = cooptimize.initial_thetas(tech, Budgets.default(), cfg)
        np.testing.assert_allclose(
            theta0s, ref_co.initial_thetas(ref_tech, RefBudgets.default(),
                                           ref_cfg), rtol=1e-6, atol=1e-7)
        got = cooptimize.refine_theta(f, theta0s, cfg, device="cpu")
        want = ref_co.refine_theta(ref_f, theta0s, ref_cfg)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
        assert got[2] == want[2] == 3 * steps
