"""The port's CrossFlow core against the reference, on the CPU.

Same inputs to both packages: the copied graph IR must agree exactly; the
float32 performance model (AGE, roofline, simulate) within rtol 1e-5 on
values and 1e-4 on gradients.  Hardware crosses from the reference with
`MicroArch.from_numpy`.  The full-size case is qwen1.5-0.5b x train_4k.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPE_CELLS as REF_CELLS
from repro.configs.base import get_config as ref_get_config
from repro.core import age as ref_age
from repro.core import lmgraph as ref_lmgraph
from repro.core import roofline as ref_roofline
from repro.core import simulate as ref_simulate
from repro.core import transform as ref_transform
from repro.core.parallelism import Strategy as RefStrategy
from repro_torch.configs.base import ARCH_IDS, SHAPE_CELLS, get_config
from repro_torch.core import age, lmgraph, roofline, simulate, transform
from repro_torch.core.parallelism import Strategy

CPU = "cpu"
ARCH = "qwen1.5-0.5b"
STRATEGIES = ("RC-1-1-d64-p1", "RC-2-2-d4-p4", "CR-4-d2-p2", "RC-4-2-d8-p1")
T = 4096                            # one train_4k sequence


def _node_rows(g):
    return [(name, n.kind, n.b, n.m, n.n, n.k, n.n_elems, n.flops_per_elem,
             n.rows, n.width, n.comm, n.comm_bytes, n.comm_axis,
             n.comm_participants, n.dtype_bytes, sorted(n.meta.items()))
            for name, n in g.nodes.items()]


# every arch x every cell; qwen1.5-0.5b's cases keep their ids (the cell)
GRAPH_CASES = [pytest.param(a, c, id=c if a == "qwen1_5_0_5b" else f"{a}-{c}")
               for a in ARCH_IDS for c in REF_CELLS]


@pytest.mark.parametrize("arch,cell", GRAPH_CASES)
def test_graph_and_sharded_shapes_match(arch, cell):
    ref_g = ref_lmgraph.build_graph(ref_get_config(arch), REF_CELLS[cell])
    g = lmgraph.build_graph(get_config(arch), SHAPE_CELLS[cell])
    assert g.fingerprint() == ref_g.fingerprint()
    for s in STRATEGIES:
        ref_sh = ref_transform.shard_graph(ref_g, RefStrategy.parse(s))
        sh = transform.shard_graph(g, Strategy.parse(s))
        assert _node_rows(sh) == _node_rows(ref_sh), s
        assert sh.fingerprint() == ref_sh.fingerprint(), s


def _leaves(a):
    out = {}
    for f in age.LEAF_FIELDS:
        v = getattr(a, f)
        vals = v if isinstance(v, tuple) else (v,)
        out[f] = np.asarray([float(x) for x in vals], dtype=np.float64)
    return out


def _to_port(ref_arch):
    """The reference MicroArch's leaves -> the port's, on the CPU."""
    d = {f: (tuple(np.asarray(x) if hasattr(x, "dtype") else x
                   for x in getattr(ref_arch, f))
             if isinstance(getattr(ref_arch, f), tuple)
             else (np.asarray(getattr(ref_arch, f))
                   if hasattr(getattr(ref_arch, f), "dtype")
                   else getattr(ref_arch, f)))
         for f in age.LEAF_FIELDS}
    d["tech"] = dataclasses.asdict(ref_arch.tech)
    return age.MicroArch.from_numpy(d, device=CPU)


def _age_pair(which):
    if which == "tpu_v5e":
        return ref_age.tpu_v5e_microarch(), age.tpu_v5e_microarch(device=CPU)
    if which == "cpu_host":
        return ref_age.cpu_host_microarch(), age.cpu_host_microarch(
            device=CPU)
    discrete = which == "generate"
    tech = ref_age.tpu_v5e_microarch().tech
    return (ref_age.generate(tech, ref_age.Budgets.default(),
                             discrete=discrete),
            age.generate(age.tpu_v5e_microarch(device=CPU).tech,
                         age.Budgets.default(), discrete=discrete,
                         device=CPU))


@pytest.mark.parametrize("which", ["tpu_v5e", "cpu_host", "generate",
                                   "generate_smooth"])
def test_microarch_matches(which):
    ref_a, a = _age_pair(which)
    ref_l, l = _leaves(ref_a), _leaves(a)
    for f in age.LEAF_FIELDS:
        np.testing.assert_allclose(l[f], ref_l[f], rtol=1e-5, err_msg=f)
    assert dataclasses.asdict(a.tech) == dataclasses.asdict(ref_a.tech)
    # the reference's leaves crossed over give the same hardware back
    np.testing.assert_allclose(
        np.concatenate(list(_leaves(_to_port(ref_a)).values())),
        np.concatenate(list(ref_l.values())), rtol=1e-7)


LEAVES_FOR_GRAD = [("compute_throughput", None), ("dram_bw", None),
                   ("mem_bw", 1), ("mem_capacity", 2), ("n_mcu", None)]


@pytest.mark.parametrize("field,idx", LEAVES_FOR_GRAD)
def test_generate_gradient_matches_jax_grad(field, idx):
    like_ref = ref_age.Budgets.default()
    like = age.Budgets.default()
    tech_ref = ref_age.tpu_v5e_microarch().tech
    tech = age.tpu_v5e_microarch(device=CPU).tech

    def ref_leaf(w):
        a = ref_age.generate(tech_ref, ref_age.Budgets.from_vector(
            w, like_ref), discrete=False)
        v = getattr(a, field)
        return v[idx] if idx is not None else v

    g_ref = np.asarray(jax.grad(ref_leaf)(like_ref.as_vector()))
    w = like.as_vector(device=CPU).requires_grad_(True)
    a = age.generate(tech, age.Budgets.from_vector(w, like), discrete=False)
    v = getattr(a, field)
    (v[idx] if idx is not None else v).backward()
    g = w.grad.numpy()
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g, g_ref, rtol=1e-4,
                               atol=1e-6 * np.abs(g_ref).max())


def _gemm_shapes():
    cfg = get_config(ARCH)
    d, f = cfg.d_model, cfg.d_ff
    kv = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    layer = [(d, d), (kv, d), (d, d), (2 * f, d), (d, f)]   # q kv o up down
    shapes = [(T, n, k, 1) for n, k in layer]
    shapes += [(T * 64, n, k, 1) for n, k in layer[3:]]
    shapes += [(40, 120, 72, 1), (8, 128, 128, 1), (1024, 256, 2048, 1),
               (4096, 64, 2048, 16 * 256)]               # batched qk-like
    return shapes


@pytest.mark.parametrize("which", ["tpu_v5e", "cpu_host", "generate"])
def test_gemm_time_and_tiling_match(which):
    ref_a, _ = _age_pair(which)
    a = _to_port(ref_a)
    for tilings in (8, 24):
        ref_cfg = ref_roofline.PPEConfig(n_tilings=tilings)
        cfg = roofline.PPEConfig(n_tilings=tilings)
        for m, n, k, b in _gemm_shapes():
            for db in (2, 4):
                want = float(ref_roofline.gemm_time(ref_a, m, n, k, b=b,
                                                    dtype_bytes=db,
                                                    cfg=ref_cfg))
                got = float(roofline.gemm_time(a, m, n, k, b=b,
                                               dtype_bytes=db, cfg=cfg))
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=str((m, n, k, b, db)))
                # tilings only where the winner is clear of a float32 tie
                _, per = roofline.candidate_times(a, m, n, k, 1, db, cfg)
                top = np.sort(per.numpy().astype(np.float64))
                if (top[1] - top[0]) > 4 * np.finfo(np.float32).eps * top[0]:
                    assert roofline.best_gemm_tiling(
                        a, m, n, k, dtype_bytes=db, cfg=cfg) == \
                        ref_roofline.best_gemm_tiling(
                            ref_a, m, n, k, dtype_bytes=db, cfg=ref_cfg)


@pytest.mark.parametrize("strategy", ["RC-1-1-d64-p1", "RC-2-2-d4-p4"])
def test_full_size_train_4k_prediction_matches(strategy):
    ref_g = ref_lmgraph.build_graph(ref_get_config(ARCH),
                                    REF_CELLS["train_4k"])
    g = lmgraph.build_graph(get_config(ARCH), SHAPE_CELLS["train_4k"])
    want = ref_simulate.predict(ref_age.tpu_v5e_microarch(), ref_g,
                                RefStrategy.parse(strategy))
    got = simulate.predict(age.tpu_v5e_microarch(device=CPU), g,
                           Strategy.parse(strategy))
    for f in ("total_s", "compute_s", "comm_s", "exposed_comm_s"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    assert torch.is_tensor(got.total_s) and got.total_s.device.type == CPU
    if Strategy.parse(strategy).lp > 1:
        np.testing.assert_allclose(float(got.pipeline_bubble_s),
                                   float(want.pipeline_bubble_s), rtol=1e-5)


def test_prediction_on_generated_hardware_matches():
    """An AGE point (not a fixed template) crossed over with from_numpy."""
    ref_a, _ = _age_pair("generate")
    cell = REF_CELLS["prefill_32k"]
    ref_g = ref_lmgraph.build_graph(ref_get_config(ARCH), cell)
    g = lmgraph.build_graph(get_config(ARCH), SHAPE_CELLS["prefill_32k"])
    want = ref_simulate.predict(ref_a, ref_g, RefStrategy.parse("RC-2-2-d8-p1"),
                                cfg=ref_roofline.PPEConfig(n_tilings=8))
    got = simulate.predict(_to_port(ref_a), g, Strategy.parse("RC-2-2-d8-p1"),
                           cfg=roofline.PPEConfig(n_tilings=8))
    np.testing.assert_allclose(float(got.total_s), float(want.total_s),
                               rtol=1e-5)


def test_gradient_flows_through_predict():
    """Autograd from a predicted step time back to the budget vector."""
    like = age.Budgets.default()
    w = like.as_vector(device=CPU).requires_grad_(True)
    tech = age.tpu_v5e_microarch(device=CPU).tech
    arch = age.generate(tech, age.Budgets.from_vector(w, like),
                        discrete=False)
    g = lmgraph.build_graph(get_config(ARCH), SHAPE_CELLS["train_4k"])
    bd = simulate.predict(arch, g, Strategy.parse("RC-1-1-d64-p1"),
                          cfg=roofline.PPEConfig(n_tilings=8))
    bd.total_s.backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0
