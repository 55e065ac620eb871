"""The port's SOE (``repro_torch.core.soe``) against the reference's, on
the CPU: the projection, the eq.-6 update and the starts on the same
arrays; the objective's value and gradient at ``chip_smoke.SOE_CASES``'
points; the batched and the FD descents step for step; and `co_optimize`
with and without the budget search.  Values at rtol 1e-5, gradients at
1e-4 of their norm, iterates at 1e-6 (float32 W of order 0.1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lmgraph as ref_lmgraph
from repro.core import soe as ref_soe
from repro.core import techlib as ref_techlib
from repro.core.age import Budgets as RefBudgets
from repro_torch.core import lmgraph, soe, techlib
from repro_torch.core.age import Budgets
from soehelpers import (RTOL, assert_values_and_grads, chip_smoke,
                        port_values_and_grads, private_reference,
                        ref_objective, ref_objective_points, values_and_grads)

CS = chip_smoke()
TECH = ("N7", "HBM2E", "IB-NDR-X8")


def test_projection_eq6_update_and_starts_match_reference():
    """`_project_simplexes`, `eq6_update` (a poisoned NaN gradient row
    included) and `_initial_starts` on the same arrays and seeds."""
    rng = np.random.default_rng(7)
    S = 5
    W, M = (rng.uniform(0.0, 1.0, (S, soe._DIM)).astype(np.float32)
            for _ in range(2))
    G = rng.normal(0.0, 3.0, (S, soe._DIM)).astype(np.float32)
    G[1] = np.nan
    ref_proj = jax.vmap(functools.partial(ref_soe._project_simplexes,
                                          min_frac=1e-3))
    want = ref_soe.eq6_update(jnp.asarray(W), jnp.asarray(M), jnp.asarray(G),
                              lr=0.05, beta=0.7, project=ref_proj)
    got = soe.eq6_update(torch.as_tensor(W), torch.as_tensor(M),
                         torch.as_tensor(G), lr=0.05, beta=0.7,
                         project=functools.partial(soe._project_simplexes,
                                                   min_frac=1e-3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    for w in (W, 0.9 * np.ones(soe._DIM, np.float32)):
        np.testing.assert_allclose(
            soe._project_simplexes(torch.as_tensor(w), 1e-3).numpy(),
            np.asarray(ref_proj(jnp.atleast_2d(w))).reshape(w.shape),
            rtol=1e-6, atol=1e-7)
    for starts, seed in ((1, 0), (4, 0), (16, 123)):
        got = soe._initial_starts(soe.SOEConfig(starts=starts, seed=seed),
                                  Budgets.default(), "cpu")
        want = ref_soe._initial_starts(
            ref_soe.SOEConfig(starts=starts, seed=seed), RefBudgets.default())
        assert len(got) == len(want) == starts
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_objective_value_and_gradient_match_reference():
    """`make_objective` at the template and seeded starts of each case:
    tests/test_core_soe.py's GEMM fixture and qwen1.5-0.5b x train_4k at
    phase 4 (e)'s strategy; the port through one vmap of
    grad_and_value."""
    for case in CS.SOE_CASES["objective"]:
        points = ref_objective_points(case)
        want = values_and_grads(ref_objective(case), points)
        got = port_values_and_grads(CS.soe_objective(case), points)
        assert_values_and_grads(got, want)


@pytest.mark.parametrize("grad_mode", ["auto", "fd"])
def test_descent_matches_reference_step_for_step(grad_mode):
    """Three eq.-6 steps on the GEMM objective: every iterate (``on_step``)
    and every value; the batched path from three starts, the paper's FD
    loop from one (17 perturbed queries per step)."""
    case = CS.SOE_CASES["objective"][0]
    starts = 3 if grad_mode == "auto" else 1
    kw = dict(steps=3, starts=starts, seed=0, grad_mode=grad_mode)
    ref_w, got_w = [], []
    want = ref_soe.optimize(ref_objective(case), ref_soe.SOEConfig(**kw),
                            on_step=lambda t, W: ref_w.append(np.asarray(W)))
    got = soe.optimize(CS.soe_objective(case), soe.SOEConfig(**kw),
                       on_step=lambda t, W: got_w.append(W), device="cpu")
    assert got.n_queries == want.n_queries == \
        3 * starts * (1 if grad_mode == "auto" else soe._DIM)
    np.testing.assert_allclose(got.history, want.history, rtol=RTOL)
    assert len(got_w) == len(ref_w) == 3
    for g, w in zip(got_w, ref_w):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.time_s, want.time_s, rtol=RTOL)
    for part in ("area_frac", "power_frac", "perim_frac"):
        g, w = getattr(got.budgets, part), getattr(want.budgets, part)
        assert list(g) == list(w)
        np.testing.assert_allclose([float(v) for v in g.values()],
                                   [float(v) for v in w.values()],
                                   rtol=0, atol=1e-6)


def test_co_optimize_picks_the_references_strategy():
    """`co_optimize` over every 8-device strategy of a KP-friendly GEMM
    (tests/test_core_soe.py's), strategy only and strategy + budgets
    (the two best-ranked strategies descending): the same strategy, time,
    queries and history."""
    cfg = dict(steps=3, starts=2)
    for search_arch in (False, True):
        # the two best-ranked strategies descend (max_strategies // 8)
        kw = dict(n_devices=8, search_arch=search_arch, max_strategies=16)
        with private_reference():
            want = ref_soe.co_optimize(
                ref_techlib.make_tech_config(*TECH),
                ref_lmgraph.gemm_graph(8192, 8192, 8192, train=True),
                cfg=ref_soe.SOEConfig(**cfg), **kw)
        got = soe.co_optimize(
            techlib.make_tech_config(*TECH),
            lmgraph.gemm_graph(8192, 8192, 8192, train=True),
            cfg=soe.SOEConfig(**cfg), device="cpu", **kw)
        assert got.strategy.name == want.strategy.name
        assert got.strategy.devices == 8
        assert got.n_queries == want.n_queries
        np.testing.assert_allclose(got.time_s, want.time_s, rtol=RTOL)
        np.testing.assert_allclose(got.history, want.history, rtol=RTOL)
