"""swiglu on its ``model`` shards and whisper's residual stream reduced
before each add, held to the reference.

(a) phi3-medium-14b prefill_32k and whisper-large-v3 train_4k on 16x16,
    each cut to 2 (decoder) layers at full width: the bytes rank 0
    receives in one step of the port's dry-run
    (`dryrun.port_collectives`, the card's path on a fake 256-rank
    group), all kinds summed, at most the reference's
    (`dryrunhelpers.reference`, its probe-corrected
    ``collective_bytes``, in a process of its own).  Before, the port
    gathered swiglu's product whole (phi3) and left whisper's residual
    stream a partial sum, so that its next products ran whole.
(b) qwen1.5-0.5b train_4k on 16x16 cut to 2 layers, through the port's
    op counter (`dryrunhelpers.port_ops`): no dot product pairs a
    65,536-token operand with the FFN's whole 2,816 or 5,632 columns, and
    the dot FLOPs a rank are at most 1.10 times the reference's jaxpr
    walk over the 256 devices.
(c) reduced qwen1.5-0.5b (swiglu) in float32 on gloo meshes of 2x2 and
    4x2, swiglu's halves paired through each layout in turn (the
    weight's columns moved, then the product's: `meshhelpers.
    swiglu_layouts`), each layer's choice recorded, and with an mlp
    width of 255, which the 2-way ``model`` axis does not divide (the
    product replicated, no choice made): the loss and every parameter
    gradient against the reference's single-device ``loss_fn`` of the
    same config (rtol 1e-5; each gradient within 1e-5 of its leaf's
    largest).
(d) reduced whisper-large-v3 the same way: its mesh path (the residual
    adds of `encdec`) against the reference.
"""

from __future__ import annotations

import ast
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import meshhelpers
from dryrunhelpers import port_ops, reference
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import dryrun
from soehelpers import chip_smoke

MESHES = ((2, 2), (4, 2))
WHISPER = "whisper-large-v3"


@pytest.mark.parametrize("arch, cell", [("phi3-medium-14b", "prefill_32k"),
                                        (WHISPER, "train_4k")])
def test_receives_at_most_the_reference(arch, cell):
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, arch, cell, "16x16", "--collectives",
                          "--layers", "2")
        port = dryrun.port_collectives(arch, cell, (16, 16), 2)
        ref = ref.result()["collectives"]
    kinds = [k for k in port if k != "count"]
    assert sum(port[k] for k in kinds) <= sum(ref[k] for k in kinds), \
        (port, ref)


def test_qwen_train_runs_the_ffn_on_its_shards():
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, "qwen1.5-0.5b", "train_4k", "16x16",
                          "--walk", "--layers", "2")
        ops = port_ops("qwen1.5-0.5b", "train_4k", "16x16", ["--layers", "2"])
        walk = ref.result()["dot_flops"] / 256
    total = ops.pop("total")
    for key in ops:
        shapes = ast.literal_eval(key)[1:]
        tokens = [s for s in shapes if 65536 in s]
        assert not (tokens and any(2816 in s or 5632 in s for s in shapes)), \
            key
    assert total <= 1.10 * walk, (total, walk)


def _case(arch, **kw):
    """(numpy weights, numpy batch, the reference's f32 loss, its
    gradients) of the reduced ``arch`` with config overrides ``kw``."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  dtype="float32", **kw)
    model = ref_build_model(ref_cfg)
    weights = chip_smoke().golden_weights(model.defs)
    batch = {k: v.numpy() for k, v in synth_batch(DataConfig(
        global_batch=meshhelpers.BATCH, seq_len=meshhelpers.SEQ),
        dataclasses.replace(meshhelpers.f32(arch), **kw), 0).items()}
    p = jax.tree.map(jnp.asarray, weights)
    loss, g = jax.value_and_grad(lambda p: model.loss_fn(p, batch)[0])(p)
    return weights, batch, float(loss), [np.asarray(x) for x in
                                         jax.tree.leaves(g)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ffn_layout")
    cases = {layout: _case(meshhelpers.ARCH, **kw)
             for layout, _, kw in meshhelpers.LAYOUTS}
    cases[WHISPER] = _case(WHISPER)
    for shape in MESHES:
        for name, (weights, batch, *_) in cases.items():
            tag = ("whisper%dx%d" if name == WHISPER else
                   f"dense_{name}%dx%d") % shape
            meshhelpers.save(tmp, f"{tag}_in",
                             {"weights": weights, "batch": batch})
    groups = [meshhelpers.spawn(meshhelpers.ffn_layout_cases,
                                shape[0] * shape[1], tmp, shape, join=False)
              for shape in MESHES]
    for group in groups:
        meshhelpers.wait(group)
    return tmp, cases


def _held(got, loss, grads, what):
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, err_msg=what)
    assert len(got["grads"]) == len(grads), what
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        assert g.shape == w.shape, (what, i)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-9, \
            (what, i)


def test_swiglu_layouts_match_the_reference(runs):
    tmp, cases = runs
    layers = meshhelpers.f32(meshhelpers.ARCH).n_layers
    for shape in MESHES:
        for layout, force, _ in meshhelpers.LAYOUTS:
            _, _, loss, grads = cases[layout]
            tag = "dense_%s%dx%d" % ((layout,) + shape)
            got = meshhelpers.load(tmp, f"{tag}_out")
            want = [] if force is None else [force] * layers
            assert got["layouts"] == want, (tag, got["layouts"])
            _held(got, loss, grads, tag)


def test_whisper_mesh_matches_the_reference(runs):
    tmp, cases = runs
    _, _, loss, grads = cases[WHISPER]
    for shape in MESHES:
        tag = "whisper%dx%d" % shape
        _held(meshhelpers.load(tmp, f"{tag}_out"), loss, grads, tag)
