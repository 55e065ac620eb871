"""The port's sharding rules against the reference's, with no processes:
the reference's side gets ``jax.sharding.AbstractMesh`` (no devices), the
port's `repro_torch.launch.mesh.AbstractMesh`.

* every parameter of the 11 configs at meshes 1x1, 2x2, 4x2, 16x16 and
  2x16x16: the port's spec equals the reference's ``guard_spec(mesh,
  model.param_pspecs(resolve_rules(plan, mesh)), shape)``, and its
  placements are that spec's;
* the batch and cache specs likewise for every applicable cell, the SP
  plan of ``long_500k`` (the cache's sequence dim on ``model``, kv heads
  on ``data``) and whisper's 20 heads on a 16-way ``model`` axis
  (replicated);
* ``flatten_to_buckets`` against the reference's on a mixed bf16 / f32
  tree and an empty one: the same buckets, and every leaf back exactly;
* a mesh larger than the world raises and names the world size it needs,
  placements of a multi-axis entry, and ``logical`` off the mesh.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPE_CELLS as REF_CELLS
from repro.configs.base import get_config as ref_get_config
from repro.core import planner as ref_planner
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro.parallel import collectives as ref_collectives
from repro.parallel import sharding as ref_sharding
from repro_torch.configs.base import SHAPE_CELLS, _ALIASES, get_config
from repro_torch.core import planner
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import build_model, common, encdec, transformer
from repro_torch.parallel import collectives, sharding
from repro_torch.tree import tree_leaves

ARCHS = tuple(_ALIASES)
MESHES = ((1, 1), (2, 2), (4, 2), (16, 16), (2, 16, 16))


def _meshes(shape):
    axes = mesh_lib.default_axes(shape)
    return RefMesh(shape, axes), mesh_lib.AbstractMesh(shape, axes)


def _plans(sp=False):
    """The planner's rules (SP: kv_seq on model) in both packages."""
    def rules(default):
        return tuple((a, ("model",)) if sp and a == "kv_seq" else (a, v)
                     for a, v in default)
    ref = ref_planner.ShardingPlan("a", "c", (1,), ("model",), None,
                                   rules(ref_planner.DEFAULT_RULES), 0.0, {})
    port = planner.ShardingPlan("a", "c", (1,), ("model",), None,
                                rules(planner.DEFAULT_RULES), 0.0, {})
    return ref, port


def _norm(spec, ndim):
    """A PartitionSpec (or the port's spec tuple) as a tuple of ndim
    entries, each None or a tuple of axis names."""
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(None if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def test_param_specs_match_the_reference():
    assert planner.DEFAULT_RULES == ref_planner.DEFAULT_RULES
    ref_plan, plan = _plans()
    n = 0
    for arch in ARCHS:
        ref_model = ref_build_model(ref_get_config(arch))
        model = build_model(get_config(arch), "cpu")
        for shape in MESHES:
            ref_mesh, mesh = _meshes(shape)
            rules = ref_sharding.resolve_rules(ref_plan, ref_mesh)
            assert sharding.resolve_rules(plan, mesh) == rules
            want = [ref_sharding.guard_spec(ref_mesh, s, d.shape) for s, d in
                    zip(jax.tree.leaves(ref_model.param_pspecs(rules),
                                        is_leaf=lambda x: isinstance(
                                            x, jax.sharding.PartitionSpec)),
                        jax.tree.leaves(ref_model.defs,
                                        is_leaf=ref_sharding.common.is_def))]
            shapes = [d.shape for d in jax.tree.leaves(
                ref_model.defs, is_leaf=ref_sharding.common.is_def)]
            got = tree_leaves(sharding.param_specs(model, plan, mesh))
            placed = tree_leaves(sharding.param_shardings(model, plan, mesh))
            assert len(got) == len(want) == len(placed), (arch, shape)
            for g, w, p, s in zip(got, want, placed, shapes):
                assert g == _norm(w, len(s)), (arch, shape, s)
                assert p == sharding.placements(mesh, g)
                n += any(e is not None for e in g)
    assert n > 1000          # the big meshes really shard


def _ref_caches(cfg, batch, length):
    if cfg.is_encoder_decoder:
        return jax.eval_shape(lambda: ref_encdec.init_cache(
            cfg, batch, length))
    return jax.eval_shape(lambda: ref_transformer.init_cache(
        cfg, batch, length))


def _caches(cfg, batch, length):
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, batch, length, device="meta")
    return transformer.init_cache(cfg, batch, length, device="meta")


def test_batch_and_cache_specs_match_the_reference():
    seen_sp = seen_guard = 0
    for arch in ARCHS:
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        if cfg.family == "lstm":             # no caches, batch specs only
            cells = ["train_4k"]
        else:
            cells = [c for c in SHAPE_CELLS if c != "long_500k"
                     or cfg.supports_long_context]
        for cell_name in cells:
            sp = cell_name == "long_500k"
            ref_plan, plan = _plans(sp)
            for shape in ((2, 2), (16, 16), (2, 16, 16)):
                ref_mesh, mesh = _meshes(shape)
                want = ref_sharding.batch_shardings(
                    ref_cfg, REF_CELLS[cell_name], ref_plan, ref_mesh)
                got = sharding.batch_specs(cfg, SHAPE_CELLS[cell_name], plan,
                                           mesh)
                assert sorted(got) == sorted(want), (arch, cell_name)
                for k in got:
                    assert got[k] == _norm(want[k].spec, len(got[k]))
                if cfg.family == "lstm":
                    continue
                batch = 1 if sp else 16
                want = jax.tree.leaves(ref_sharding.cache_shardings(
                    ref_cfg, ref_plan, ref_mesh,
                    _ref_caches(ref_cfg, batch, 64)))
                caches = _caches(cfg, batch, 64)
                got = tree_leaves(sharding.cache_specs(cfg, plan, mesh,
                                                       caches))
                placed = tree_leaves(sharding.cache_shardings(
                    cfg, plan, mesh, caches))
                assert len(got) == len(want) > 0, (arch, cell_name)
                for g, w, p, leaf in zip(got, want, placed,
                                         tree_leaves(caches)):
                    assert g == _norm(w.spec, leaf.dim()), (arch, cell_name)
                    assert p == sharding.placements(mesh, g)
                    if sp and leaf.dim() >= 4:
                        seen_sp += g[-2] == ("model",)
                    if arch == "whisper-large-v3" and shape == (16, 16):
                        seen_guard += g[-3] is None     # 20 kv heads
    assert seen_sp and seen_guard


def test_buckets_match_the_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "c": {"d": rng.standard_normal((5, 2)).astype(ml_dtypes.bfloat16),
                  "e": rng.standard_normal((9,)).astype(np.float32)}}
    port_tree = {"w": torch.from_numpy(tree["w"].astype(np.float32)).to(
                     torch.bfloat16),
                 "b": torch.from_numpy(tree["b"]),
                 "c": {"d": torch.from_numpy(tree["c"]["d"].astype(
                           np.float32)).to(torch.bfloat16),
                       "e": torch.from_numpy(tree["c"]["e"])}}
    for bucket_bytes in (16, 4 << 20):
        want, _ = ref_collectives.flatten_to_buckets(
            jax.tree.map(jnp.asarray, tree), bucket_bytes)
        got, spec = collectives.flatten_to_buckets(port_tree, bucket_bytes)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        back = collectives.unflatten_buckets(got, spec)
        for g, w in zip(tree_leaves(back), tree_leaves(port_tree)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert ref_collectives.flatten_to_buckets({})[0] == []
    got, spec = collectives.flatten_to_buckets({})
    assert got == [] and collectives.unflatten_buckets(got, spec) == {}


def test_meshes_and_logical_off_the_mesh():
    with pytest.raises(ValueError, match="world size is 1"):
        mesh_lib.make_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="nproc-per-node 8"):
        train(TrainConfig(mesh_shape=(4, 2), device="cpu",
                          use_reduced_config=True, steps=1))
    assert mesh_lib.runtime_mesh((1, 1), "cpu") is None
    mesh = mesh_lib.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh_lib.mesh_devices(mesh) == 512
    assert sharding.placements(mesh, (("pod", "data"), None, ("model",))) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.scalar_sharding(mesh) == (Replicate(),) * 3
    x = torch.ones(2, 3)
    assert common.logical(x, ("batch", None)) is x
    assert common.logical(x, ("batch", None), {"batch": ("data",)},
                          mesh) is x
