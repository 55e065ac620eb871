"""Two mesh-path layouts of the port held to the reference: the MoE expert
products run where the expert weights lie, and the LM head's logits come
out vocabulary-sharded.

(a) qwen2-moe-a2.7b decode_32k on 16x16, cut to 2 layers at full width:
    the bytes rank 0 receives in one step of the port's dry-run
    (`dryrun.port_collectives`, the card's path on a fake
    256-rank group), all kinds summed, at most the reference's
    (`dryrunhelpers.reference`, its probe-corrected ``collective_bytes``,
    in a process of its own); its all-gather and all-reduce at most
    ``chip_smoke.DRYRUN["moe_most"]``, the figures phase 11 holds the
    card's torch to, which are at most the reference's.
(b) recurrentgemma-2b prefill_32k on 16x16 at full depth: peak a rank at
    most ``chip_smoke.DRYRUN["peak"]``'s 7.1 GiB, dot FLOPs within 1 %
    of the 1.9544e14 that torch 2.11 counts for the cell on the card's
    path, collectives at most its 319 plus 10 %, and the head's logits
    ``Shard(-1)`` over ``model``.
(c) reduced qwen2-moe-a2.7b with 5 experts, which the 2-way ``model``
    axis does not divide, in float32 on gloo meshes of 2x2 and 4x2: the
    loss and every parameter gradient of the mesh path against the
    reference's single-device ``loss_fn`` and against the port's
    one-device run with the reference's experts replayed (rtol 1e-5;
    each gradient within 1e-5 of its leaf's largest); the cases cover
    the expert products on the weights' shards, the weights gathered
    (``moe.gathers_weights``: many slots an expert) and ``grouped_tp``,
    each mesh run recording the layout its layers took
    (`meshhelpers.expert_layouts`).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import meshhelpers
from dryrunhelpers import reference
from moehelpers import reference_routes
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_leaves
from soehelpers import chip_smoke

CS = chip_smoke()
MOE = "qwen2-moe-a2.7b"
# (name, config overrides): 5 experts over a 2-way model axis; the
# default capacity keeps the weights in place, capacity 4 gathers them
CASES = (("ep", dict(n_experts=5)),
         ("ep_gathered", dict(n_experts=5, capacity_factor=4.0)),
         ("grouped", dict(n_experts=5, moe_impl="grouped_tp", moe_groups=2,
                          capacity_factor=8.0)))
MESHES = ((2, 2), (4, 2))


def test_moe_decode_receives_at_most_the_reference():
    arch, cell, mesh, layers = CS.DRYRUN["moe"]
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, arch, cell, mesh, "--collectives",
                          "--layers", str(layers))
        port = dryrun.port_collectives(
            arch, cell, [int(x) for x in mesh.split("x")], layers)
        ref = ref.result()["collectives"]
    kinds = [k for k in port if k != "count"]
    assert sum(port[k] for k in kinds) <= sum(ref[k] for k in kinds), \
        (port, ref)
    for kind, most in CS.DRYRUN["moe_most"].items():
        assert port[kind] <= most <= ref[kind], (kind, port, ref)


def test_recurrentgemma_prefill_logits_vocab_sharded():
    seen = []
    head = transformer._head

    def recorded(params, cfg, x):
        out = head(params, cfg, x)
        seen.append(tuple(out.placements))
        return out

    transformer._head = recorded
    try:
        with dryrun.fake_group(256):
            mesh = mesh_lib.make_mesh((16, 16), device="cuda")
            m = dryrun._step_metrics("recurrentgemma-2b", "prefill_32k",
                                     mesh, (16, 16), True, None)
    finally:
        transformer._head = head
    cell, most = CS.DRYRUN["peak"]
    assert cell == ("recurrentgemma-2b", "prefill_32k", "single")
    assert m["memory"]["peak_bytes"] <= most, m["memory"]
    assert m["flops"] == pytest.approx(1.9544e14, rel=1e-2)
    assert m["coll"]["count"] <= 319 * 1.1, m["coll"]
    model = mesh.mesh_dim_names.index("model")
    assert seen and all(pl[model] == Shard(2) for pl in seen), seen


def _ref_case(kw):
    """(numpy weights, numpy batch, the reference's f32 loss, its
    gradients, its experts) of the reduced MoE with ``kw``."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(MOE)),
                                  dtype="float32", **kw)
    model = ref_build_model(ref_cfg)
    weights = CS.golden_weights(model.defs)
    cfg = dataclasses.replace(meshhelpers.f32(MOE), **kw)
    batch = {k: v.numpy() for k, v in synth_batch(DataConfig(
        global_batch=meshhelpers.BATCH, seq_len=meshhelpers.SEQ), cfg,
        0).items()}
    p = jax.tree.map(jnp.asarray, weights)
    with reference_routes() as routes:
        loss, g = jax.value_and_grad(lambda p: model.loss_fn(p, batch)[0])(p)
    return (cfg, weights, batch, float(loss),
            [np.asarray(x) for x in jax.tree.leaves(g)], routes)


def _port_replayed(cfg, weights, batch, routes):
    """The port's one-device f32 loss and gradients with the reference's
    experts replayed, and the experts its own router took."""
    params = params_from_numpy(weights, "cpu")
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with CS.moe_routing() as own:
        build_model(cfg, "cpu").loss_fn(params, tb)
    with CS.moe_routing(routes):
        loss = build_model(cfg, "cpu").loss_fn(params, tb)[0]
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), [g.numpy() for g in grads], own.calls


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_faults")
    cases = {name: _ref_case(kw) for name, kw in CASES}
    for name, (cfg, weights, batch, *_) in cases.items():
        for shape in MESHES:
            meshhelpers.save(tmp, "%s%dx%d_in" % ((name,) + shape),
                             {"weights": weights, "batch": batch})
    # both groups run while the oracles are computed
    groups = [meshhelpers.spawn(meshhelpers.moe_cases, shape[0] * shape[1],
                                tmp, MOE, shape, CASES, join=False)
              for shape in MESHES]
    want = {}
    for name, (cfg, weights, batch, loss, grads, routes) in cases.items():
        port = _port_replayed(cfg, weights, batch, routes)
        want[name] = (loss, grads, port, routes)
    for group in groups:
        meshhelpers.wait(group)
    return tmp, want


def test_case_paths_cover_both_expert_layouts(moe_runs):
    tmp, _ = moe_runs
    assert all(kw["n_experts"] % 2 for _, kw in CASES)
    layers = meshhelpers.f32(MOE).n_layers
    for shape in MESHES:
        took = [meshhelpers.load(tmp, "%s%dx%d_out" % ((name,) + shape))
                ["layouts"] for name, _ in CASES[:2]]
        assert took == [[False] * layers, [True] * layers], (shape, took)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x2"])
def test_uneven_experts_match_one_device_and_the_reference(moe_runs,
                                                           shape):
    tmp, want = moe_runs
    for name, _ in CASES:
        loss, ref_grads, (port_loss, port_grads, own), routes = want[name]
        # float32: the port's router takes the reference's experts
        assert [c[1].tolist() for c in own] == \
            [np.asarray(r).tolist() for r in routes], name
        got = meshhelpers.load(tmp, "%s%dx%d_out" % ((name,) + shape))
        for oracle, grads in ((loss, ref_grads), (port_loss, port_grads)):
            np.testing.assert_allclose(got["loss"], oracle, rtol=1e-5,
                                       err_msg=name)
            assert len(got["grads"]) == len(grads)
            for i, (g, w) in enumerate(zip(got["grads"], grads)):
                assert g.shape == w.shape, (name, i)
                assert np.abs(g - w).max() <= \
                    1e-5 * np.abs(w).max() + 1e-9, (name, i)
