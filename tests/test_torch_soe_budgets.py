"""The SOE's batched paths in the port, on the CPU: `pathfinder.
evaluate_budgets` against `soe.make_objective` and the reference; the
CrossFlow objectives taking the batched ``torch.func`` path (their query
counts); a Python objective that ``torch.func`` cannot transform falling
back to the FD loop, and nothing else falling back; and the gradient
through a GEMM node under vmap(grad), which a roofline-cache hit would cut.
"""

import json

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro_torch.core import cooptimize, pathfinder, roofline, soe
from repro_torch.core.age import Budgets
from soehelpers import RTOL, chip_smoke, ref_objective

CS = chip_smoke()
GEMM = CS.SOE_CASES["objective"][0]


def _starts(n, seed):
    return torch.stack(soe._initial_starts(soe.SOEConfig(starts=n, seed=seed),
                                           Budgets.default(), "cpu"))


def test_evaluate_budgets_matches_objective_and_reference():
    """One vmapped call over a (5, 17) stack: each row the port's
    objective and the reference's, differentiable in the stack, and the
    memoized function reused by a second call."""
    from repro_torch.core import lmgraph, techlib
    from repro_torch.core.parallelism import Strategy
    from repro_torch.core.roofline import PPEConfig
    W = _starts(5, 2)
    args = (techlib.make_tech_config(*GEMM["tech"]),
            lmgraph.gemm_graph(*GEMM["graph"][1:]),
            Strategy.parse(GEMM["strategy"]))
    ppe = PPEConfig(n_tilings=GEMM["n_tilings"])
    Wg = W.clone().requires_grad_(True)
    times = pathfinder.evaluate_budgets(*args, Wg, ppe=ppe)
    n_fns = len(pathfinder._BUDGET_FNS)
    f = CS.soe_objective(GEMM)
    rows = torch.stack([f(w) for w in W])
    np.testing.assert_allclose(times.detach().numpy(), rows.numpy(),
                               rtol=1e-6)
    ref_f = ref_objective(GEMM)
    want = [float(ref_f(np.asarray(w))) for w in W.numpy()]
    np.testing.assert_allclose(times.detach().numpy(), want, rtol=RTOL)
    (grad,) = torch.autograd.grad(times.sum(), Wg)
    g_rows, _ = torch.func.vmap(torch.func.grad_and_value(f))(W)
    np.testing.assert_allclose(grad.numpy(), g_rows.numpy(), rtol=1e-5,
                               atol=1e-9)
    assert float(grad.norm()) > 0
    again = pathfinder.evaluate_budgets(*args, W.numpy(), ppe=ppe,
                                        device="cpu")
    assert len(pathfinder._BUDGET_FNS) == n_fns
    np.testing.assert_array_equal(again.numpy(), times.detach().numpy())


def test_crossflow_objectives_take_the_batched_path(monkeypatch):
    """The SOE's and the refinement's CrossFlow objectives advance every
    start in one vmapped call per step: one query per start and step, one
    history entry each (the FD loop costs 17 per entry), and the
    sequential loop is never entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CrossFlow objective fell back to FD")

    monkeypatch.setattr(soe, "_optimize_sequential", refuse)
    res = soe.optimize(CS.soe_objective(GEMM),
                       soe.SOEConfig(steps=4, starts=3), device="cpu")
    assert res.n_queries == len(res.history) == 3 * 4
    case = json.loads(CS.GOLDEN_SOE.read_text())["refine"][0]
    theta, val, evals = cooptimize.refine_theta(
        CS.refine_objective(case["case"], "cpu"),
        np.asarray(case["points"], np.float32),
        cooptimize.RefineConfig(steps=3, starts=2), device="cpu")
    assert evals == 2 * 3 and np.isfinite(val) and theta.shape == (20,)


def test_nontraceable_objective_falls_back_to_fd():
    """A Python objective that reads its input on the host (the
    reference's tests/test_pathfinder.py black box) takes the FD loop;
    a RuntimeError that is not ``torch.func`` refusing a transform (a CUDA
    fault, an out-of-memory) propagates instead."""
    calls = {"n": 0}

    def black_box(w):
        calls["n"] += 1
        return float(np.sum(np.square(np.asarray(w))))

    res = soe.optimize(black_box, soe.SOEConfig(steps=3, starts=2),
                       device="cpu")
    assert calls["n"] > 0 and np.isfinite(res.time_s)
    assert res.n_queries == soe._DIM * len(res.history) > 0

    for err in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                torch.OutOfMemoryError("CUDA out of memory")):
        def broken(w, err=err):
            raise err
        with pytest.raises(type(err)):
            soe.optimize(broken, soe.SOEConfig(steps=2, starts=2),
                         device="cpu")
        assert not soe.untraceable(err)


def test_gemm_node_gradient_is_nonzero_under_vmap_grad():
    """A concrete prediction fills the roofline's GEMM cache at W; the
    same W under vmap(grad) must miss it (a hit would return a constant
    and cut the gradient to zero) and give plain autograd's gradient."""
    f = CS.soe_objective(GEMM)
    w = Budgets.default().as_vector("cpu")
    f(w)                                        # fills the cache at w
    n_cached = len(roofline._GEMM_CACHE)
    g, v = torch.func.vmap(torch.func.grad_and_value(f))(w[None])
    assert len(roofline._GEMM_CACHE) == n_cached
    wg = w.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(f(wg), wg)
    assert float(g.norm()) > 0
    np.testing.assert_allclose(g[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(float(v[0]), float(f(w)), rtol=1e-6)
