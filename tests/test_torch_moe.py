"""The port's MoE layer (`repro_torch.models.moe`) against the reference's,
on the CPU.

* ``moe_apply`` of the reduced qwen2-moe-a2.7b (shared expert) and
  qwen3-moe-30b-a3b for both dispatches (``scatter_ep``; ``grouped_tp`` at
  1, 2 and 4 groups) on the same numpy input and weights: float32 outputs
  within 1e-5 of max |value|, the aux loss within rtol 1e-6, every input's
  and weight's gradient (of a fixed projection of the output) within 1e-4
  of its max, and the routing identical to the reference's; bfloat16
  outputs within 3e-2 of max, every router row whose experts differ from
  the reference's within ``chip_smoke.NEAR_TIE`` of a tie (it has none
  here).  The capacity drops some assignments at these shapes
  (1.25 x 96 x 2 / 8 -> 32 slots), which the reference drops too.
* At capacity 8.0 (no drops), both dispatches equal a dense computation
  (every expert on every token, weighted by the top-k routing), as
  tests/test_model_families.py holds the reference to.
* Planted top-k ties: ``top_k`` takes the lower expert first, as
  ``jax.lax.top_k`` does, and the router of a layer whose two experts have
  the same router column routes as the reference's.
* At capacity 1.0, `moe.dropped` counts the assignments the reference's
  dispatch drops, and the outputs still match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import moe as ref_moe
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_leaves
from moehelpers import reference_routes
from soehelpers import chip_smoke

CS = chip_smoke()
ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
DISPATCHES = (("scatter_ep", 0), ("grouped_tp", 1), ("grouped_tp", 2),
              ("grouped_tp", 4))
SHAPE = (2, 48, 128)


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                dtype=dtype, **over),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                                **over))


def _case(arch, dtype="float32", seed=3, **over):
    """(reference config, port config, numpy weights, numpy input)."""
    ref_cfg, cfg = _cfgs(arch, dtype, **over)
    weights = CS.golden_weights(ref_moe.moe_defs(ref_cfg), seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(SHAPE).astype(
        np.float32)
    return ref_cfg, cfg, weights, x


def _run_ref(ref_cfg, weights, x, dtype):
    with reference_routes() as routes:
        out, aux = ref_moe.moe_apply(jax.tree.map(jnp.asarray, weights),
                                     jnp.asarray(x).astype(dtype), ref_cfg)
    return np.asarray(out, np.float32), float(aux), routes


def _run_port(cfg, weights, x, dtype, routing=None):
    with CS.moe_routing(routing) as rec:
        out, aux = moe.moe_apply(params_from_numpy(weights, "cpu"),
                                 torch.from_numpy(x).to(dtype), cfg)
    return out.float().numpy(), float(aux), rec.calls


def _ref_grads(ref_cfg, weights, x, proj):
    def f(p, xx):
        out, aux = ref_moe.moe_apply(p, xx, ref_cfg)
        return jnp.sum(out * proj) + aux
    gp, gx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, weights),
                                         jnp.asarray(x))
    return [np.asarray(g) for g in jax.tree.leaves(gp)] + [np.asarray(gx)]


def _port_grads(cfg, weights, x, proj):
    params = params_from_numpy(weights, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    xx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(params, xx, cfg)
    f = torch.sum(out * torch.from_numpy(proj)) + aux
    return [g.numpy() for g in torch.autograd.grad(f, leaves + [xx])]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_the_reference(arch):
    for impl, groups in DISPATCHES:
        over = dict(moe_impl=impl, moe_groups=groups)
        ref_cfg, cfg, weights, x = _case(arch, **over)
        want, want_aux, want_routes = _run_ref(ref_cfg, weights, x,
                                               jnp.float32)
        got, aux, calls = _run_port(cfg, weights, x, torch.float32)
        assert CS.routing_flips(calls, want_routes) == []
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
        proj = np.random.default_rng(9).standard_normal(SHAPE).astype(
            np.float32)
        for g, w in zip(_port_grads(cfg, weights, x, proj),
                        _ref_grads(ref_cfg, weights, x, proj)):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-12
        # bfloat16, the configured dtype
        ref_cfg, cfg, _, _ = _case(arch, "bfloat16", **over)
        want, _, want_routes = _run_ref(ref_cfg, weights, x, jnp.bfloat16)
        got, _, calls = _run_port(cfg, weights, x, torch.bfloat16)
        flips = CS.routing_flips(calls, want_routes)
        assert all(m <= CS.NEAR_TIE for _, _, m in flips), flips
        rows = np.ones(SHAPE[:2], bool).reshape(-1)
        rows[[r for _, r, _ in flips]] = False
        diff = np.abs(got - want).reshape(-1, SHAPE[-1])[rows]
        assert diff.max() <= 3e-2 * np.abs(want).max(), (impl, groups)


def _dense(params, x, cfg):
    """Every expert on every token, weighted by the top-k routing: no
    capacity."""
    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    xt = x.reshape(t, d)
    _, topw, topi = moe.route(params, xt, cfg)
    out = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        h = xt @ params["experts"]["wi"][e]
        u, g = torch.chunk(h, 2, dim=-1)
        y = (torch.nn.functional.silu(g) * u) @ params["experts"]["wo"][e]
        w = ((topi == e).to(x.dtype) * topw).sum(-1)
        out = out + w[:, None] * y
    if cfg.n_shared_experts:
        sh = params["shared"]
        u, g = torch.chunk(xt @ sh["wi"], 2, dim=-1)
        out = out + (torch.nn.functional.silu(g) * u) @ sh["wo"]
    return out.reshape(x.shape)


def test_moe_matches_a_dense_computation_without_drops():
    for arch in ARCHS:
        for impl, groups in DISPATCHES:
            _, cfg, weights, x = _case(arch, capacity_factor=8.0,
                                       moe_impl=impl, moe_groups=groups)
            params = params_from_numpy(weights, "cpu")
            xt = torch.from_numpy(x)
            got, _ = moe.moe_apply(params, xt, cfg)
            want = _dense(params, xt, cfg)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            _, _, topi = moe.route(params, xt.reshape(-1, SHAPE[-1]), cfg)
            assert moe.dropped(topi, cfg) == 0


def test_top_k_takes_the_lower_expert_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.0],
                      [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
                      [0.0, 0.25, 0.0, 0.25, 0.25, 0.25]], np.float32)
    for k in (1, 2, 3, 4):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want_v, want_i = jax.lax.top_k(jnp.asarray(probs, jdt), k)
            got_v, got_i = moe.top_k(torch.from_numpy(probs).to(tdt), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_v.float().numpy(),
                                          np.asarray(want_v, np.float32))
    # a router whose experts 1 and 5 (and 2 and 6) have the same column:
    # every token ties between them, in both dtypes
    for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        ref_cfg, cfg, weights, x = _case("qwen3-moe-30b-a3b", dtype)
        w = weights["router"]["w"]
        w[:, 5], w[:, 6] = w[:, 1], w[:, 2]
        want, _, want_routes = _run_ref(ref_cfg, weights, x, jdt)
        got, _, calls = _run_port(cfg, weights, x, tdt)
        assert CS.routing_flips(calls, want_routes) == []
        tied = np.isin(want_routes[0], (1, 2, 5, 6)).any(-1).sum()
        assert tied > SHAPE[0] * SHAPE[1] // 4
        tol = 1e-5 if dtype == "float32" else 3e-2
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_drop_count_at_capacity_one_is_the_references():
    for impl, groups in DISPATCHES:
        ref_cfg, cfg, weights, x = _case("qwen2-moe-a2.7b",
                                         capacity_factor=1.0, moe_impl=impl,
                                         moe_groups=groups)
        want, _, routes = _run_ref(ref_cfg, weights, x, jnp.float32)
        got, _, calls = _run_port(cfg, weights, x, torch.float32)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        # the reference's dispatch: assignments past their expert's slots
        t = SHAPE[0] * SHAPE[1]
        g = max(groups, 1) if impl == "grouped_tp" else 1
        tl = t // g
        lane = 4 if impl == "grouped_tp" else 8
        cap = int(max(1.0 * tl * 2 / 8, lane))
        cap = -(-cap // lane) * lane
        ref_routes = routes[0].reshape(g, tl * 2)
        want_drops = sum(int(np.maximum(np.bincount(r, minlength=8) - cap,
                                        0).sum()) for r in ref_routes)
        topi = torch.from_numpy(calls[0][1])
        if impl == "grouped_tp":
            topi = topi.reshape(g, tl, 2)
        got_drops = moe.dropped(topi, cfg)
        assert got_drops == want_drops > 0, (impl, groups, got_drops)
