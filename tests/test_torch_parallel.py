"""The port's mesh path against the reference, on the CPU: gloo over
spawned host processes (`meshhelpers`), two process groups in all (one
of 4 ranks for every 2x2 check, one of 8 for 4x2).

* reduced qwen1.5-0.5b in float32 at 2x2 and 4x2: the loss and every
  gradient against the reference's single-device ``loss_fn`` (``rules=
  None, mesh=None``) on the same numpy weights and batch (rtol 1e-5; each
  gradient within 1e-5 of its leaf's largest); the attention wrapper
  reached with ``heads / model`` local heads; each rank's parameter and
  AdamW moment bytes the full bytes over the spec's shard factor; three
  steps of ``make_train_step`` against the port's one-device steps
  (losses rtol 1e-5; parameters within 5e-5 but for elements whose
  gradient is float32 noise, see the test).
* reduced qwen3-moe-30b-a3b at 2x2, ``grouped_tp`` with ``moe_groups=2``
  (capacity 8) and the default ``scatter_ep`` (experts over ``model``):
  the loss against the reference's single-device loss (the same
  ``moe_groups``) and the port's one-device loss within 1e-3, the
  reference's own check (tests/test_distributed.py), and here within
  1e-5.
* reduced recurrentgemma-2b's and xlstm-125m's f32 losses at 2x2 against
  the reference's, the scan's and the mLSTM's wrappers reached on a
  quarter of the (batch, channel) or (batch, head) rows on each rank.
* a 4-stage ``gpipe`` against the sequential tanh stack on the
  reference's weights (1e-5), and ``bucketed_all_reduce`` / the mean
  against the sum of the ranks' mixed bf16 / f32 trees (exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import meshhelpers
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from soehelpers import chip_smoke

MESHES = ((2, 2), (4, 2))
golden_weights = chip_smoke().golden_weights


def _case(arch, **kw):
    """(numpy weights, numpy batch) of a reduced f32 arch."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  dtype="float32", **kw)
    weights = golden_weights(ref_build_model(ref_cfg).defs)
    cfg = dataclasses.replace(meshhelpers.f32(arch), **kw)
    batch = synth_batch(DataConfig(global_batch=meshhelpers.BATCH,
                                   seq_len=meshhelpers.SEQ), cfg, 0)
    return ref_cfg, cfg, weights, {k: v.numpy() for k, v in batch.items()}


def _ref_loss(ref_cfg, weights, batch, grads=False):
    model = ref_build_model(ref_cfg)
    fn = lambda p: model.loss_fn(p, batch)[0]
    p = jax.tree.map(jnp.asarray, weights)
    if not grads:
        return float(fn(p)), None
    loss, g = jax.value_and_grad(fn)(p)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    # the inputs first, then the 2x2 group runs while the references do
    dense = _case(meshhelpers.ARCH)
    for shape in MESHES:
        meshhelpers.save(tmp, "dense%dx%d_in" % shape,
                         {"weights": dense[2], "batch": dense[3]})
    moe = {}
    for name, kw in (("moe_grouped", dict(moe_impl="grouped_tp",
                                          moe_groups=2,
                                          capacity_factor=8.0)),
                     ("moe_ep", {})):
        moe[name] = _case("qwen3-moe-30b-a3b", **kw)
        meshhelpers.save(tmp, f"{name}_in", {"weights": moe[name][2],
                                             "batch": moe[name][3]})
    rec = {name: _case(arch) for name, arch in (("rg", "recurrentgemma-2b"),
                                                 ("xl", "xlstm-125m"))}
    for name, case in rec.items():
        meshhelpers.save(tmp, f"{name}_in", {"weights": case[2],
                                             "batch": case[3]})
    ws = jax.random.normal(jax.random.PRNGKey(0), (8, 4, 4)) * 0.5
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 5, 4))
    meshhelpers.save(tmp, "gpipe_in", {"ws": np.asarray(ws),
                                       "x": np.asarray(x)})
    group = meshhelpers.spawn(meshhelpers.group_2x2, 4, tmp, join=False)

    ref_cfg, cfg, weights, batch = dense
    want = {"dense": _ref_loss(ref_cfg, weights, batch, grads=True),
            "steps": meshhelpers.one_device_steps(cfg, weights)}
    for name, case in rec.items():
        want[name] = _ref_loss(case[0], case[2], case[3])[0]
    for name, (ref_cfg, cfg, w, b) in moe.items():
        want[name] = _ref_loss(ref_cfg, w, b)[0]
        tb = {k: meshhelpers.torch.from_numpy(v) for k, v in b.items()}
        want[f"{name}_port"] = float(build_model(cfg, "cpu").loss_fn(
            params_from_numpy(w, "cpu"), tb)[0])

    def fn_stage(params, x):
        x, _ = jax.lax.scan(lambda x, p: (jnp.tanh(x @ p), None), x, params)
        return x

    want["gpipe"] = np.stack([np.asarray(fn_stage(ws, x[i]))
                              for i in range(3)])
    meshhelpers.wait(group)
    meshhelpers.spawn(meshhelpers.group_4x2, 8, tmp)
    return tmp, want


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x2"])
def test_dense_mesh_matches_the_reference_and_one_device(runs, shape):
    tmp, want = runs
    got = meshhelpers.load(tmp, "dense%dx%d_out" % shape)
    ref_loss, ref_grads = want["dense"]
    np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
    assert len(got["grads"]) == len(ref_grads)
    for i, (g, w) in enumerate(zip(got["grads"], ref_grads)):
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-9, i
    # every attention call on its rank's heads: 4 q heads over model
    assert got["local"] and {s[1] for s in got["local"]} == \
        {4 // shape[1]}
    sharded = 0
    for local, full, mu, nu, factor in got["held"]:
        assert local * factor == full and mu == nu == local
        sharded += factor > 1
    assert sharded > len(got["held"]) // 2
    losses, params = want["steps"]
    np.testing.assert_allclose(got["step_losses"], losses, rtol=1e-5)
    # AdamW normalises each element's step, so an element whose gradient
    # is within float32 noise of zero moves by up to lr per step either
    # way: all elements within STEPS x lr, all but 1e-4 of them within 5e-5
    off = total = 0
    for g, w in zip(got["final"], meshhelpers.params_leaves(params)):
        err = np.abs(g - w)
        assert err.max() <= meshhelpers.STEPS * meshhelpers.LR
        off += int((err > 5e-5).sum())
        total += err.size
    assert off <= 1e-4 * total, (off, total)


def test_moe_grouped_tp_and_ep_match_the_single_device_loss(runs):
    tmp, want = runs
    for name in ("moe_grouped", "moe_ep"):
        got = meshhelpers.load(tmp, f"{name}_out")["loss"]
        for key in (name, f"{name}_port"):
            assert abs(got - want[key]) / want[key] < 1e-3, key
            np.testing.assert_allclose(got, want[key], rtol=1e-5,
                                       err_msg=key)


def test_recurrent_losses_at_2x2_match_the_reference(runs):
    tmp, want = runs
    for name in ("rg", "xl"):
        got = meshhelpers.load(tmp, f"{name}_out")
        np.testing.assert_allclose(got["loss"], want[name], rtol=1e-5,
                                   err_msg=name)
    # each rank scans a quarter of the (batch, channel) rows, and runs the
    # mLSTM on a quarter of the (batch, head) rows: no two ranks launch on
    # the same rows
    rows = meshhelpers.BATCH * 128 // 4
    assert {s[0] * s[2] for s in meshhelpers.load(tmp, "rg_out")["local"]} \
        == {rows}
    rows = meshhelpers.BATCH * 4 // 4
    assert {s[0] * s[1] for s in meshhelpers.load(tmp, "xl_out")["local"]} \
        == {rows}


def test_gpipe_and_bucketed_all_reduce(runs):
    tmp, want = runs
    got = meshhelpers.load(tmp, "gpipe_out")
    assert got.shape == want["gpipe"].shape
    assert np.abs(got - want["gpipe"]).max() < 1e-5
    assert meshhelpers.load(tmp, "buckets_out") == {"sum": True,
                                                    "mean": True}
