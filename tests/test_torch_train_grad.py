"""The port's training gradients against the reference's, on the CPU.

Weights are numpy draws (``chip_smoke.golden_weights``) handed to
both packages; batches are the reference's ``synth_batch``.  For the
reduced qwen1.5-0.5b, recurrentgemma-2b and xlstm-125m:

* float32: the loss within rtol 1e-6 of ``jax.value_and_grad(loss_fn)``'s,
  every leaf's gradient within 1e-4 of that leaf's max |gradient| (1e-3
  for xlstm-125m: its mLSTM output divides by a denominator that can come
  near zero, which amplifies float32 summation order);
* bfloat16: the loss within rtol 1e-3 of the reference's (each side's
  bfloat16 roundings; the reference's own bfloat16 loss lies up to 1.4e-3
  from its float32 one);

On the CPU the kernel wrappers take their plain versions, so this holds
the model's differentiable path; the card holds the kernels' autograd
Functions to the same plain versions (``tests/test_torch_card.py``,
``chip_smoke.py`` phase 7).  The one Function whose backward is not the
plain version's gradient, the scan's reversed recurrence, runs here with
the plain loop standing in for the kernel, against ``jax.grad`` through
the reference's ``associative_scan``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data import pipeline as ref_pipeline
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import rglru
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_leaves, tree_map
from soehelpers import chip_smoke

golden_weights = chip_smoke().golden_weights

ARCHS = ("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m")
GRAD_TOL = {"qwen1.5-0.5b": 1e-4, "recurrentgemma-2b": 1e-4,
            "xlstm-125m": 1e-3}
BATCH, SEQ = 2, 32


def grad_case(arch, dtype):
    """(reference model, port model, numpy weights, the reference's batch
    of step 0) of one reduced arch in ``dtype``."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    ref_model = ref_build_model(ref_cfg)
    weights = golden_weights(ref_model.defs)
    batch = ref_pipeline.synth_batch(
        ref_pipeline.DataConfig(global_batch=BATCH, seq_len=SEQ), ref_cfg, 0)
    return ref_model, build_model(cfg, "cpu"), weights, batch


def port_value_and_grad(model, weights, batch, remat=False):
    """The port's loss and every leaf's gradient (JAX's leaf order), on
    the CPU."""
    live = tree_map(lambda t: t.requires_grad_(True),
                    params_from_numpy(weights, "cpu"))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = model.loss_fn(live, tb, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_and_every_gradient_match_the_reference(arch):
    ref_model, model, weights, batch = grad_case(arch, "float32")
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, batch), has_aux=True)(
            jax.tree.map(jnp.asarray, weights))
    loss, grads = port_value_and_grad(model, weights, batch)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    want = [np.asarray(g) for g in jax.tree.leaves(ref_grads)]
    assert len(grads) == len(want) == len(tree_leaves(weights))
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and np.isfinite(g).all(), i
        assert np.abs(g - w).max() <= GRAD_TOL[arch] * np.abs(w).max(), i


def test_bf16_loss_matches_the_reference():
    for arch in ARCHS:
        ref_model, model, weights, batch = grad_case(arch, "bfloat16")
        want = float(ref_model.loss_fn(jax.tree.map(jnp.asarray, weights),
                                       batch)[0])
        loss, grads = port_value_and_grad(model, weights, batch)
        np.testing.assert_allclose(loss, want, rtol=1e-3, err_msg=arch)
        assert all(np.isfinite(g).all() for g in grads), arch


def _ref_scan_grads(a, b, h0, g):
    """jax.grad of sum(h * g) through the reference's associative_scan
    (``repro/models/rglru.py:78-83``), h0 folded into the first b."""
    def combine(left, right):
        al, bl = left
        ar, br = right
        return al * ar, bl * ar + br

    def f(a, b, h0):
        b = b.at[:, 0].add(a[:, 0] * h0)
        _, h = jax.lax.associative_scan(combine, (a, b), axis=1)
        return jnp.sum(h * g)

    return jax.grad(f, argnums=(0, 1, 2))(a, b, h0)


def test_scan_function_backward_is_the_reversed_scan():
    """`rglru.RGLRUScan` on CPU tensors (the plain loop in the kernel's
    place, forward and reversed): h bit for bit the wrapper's, gradients
    of a, b and h0 within 1e-5 of max (float32; one bfloat16 rounding,
    1e-2, where a and b are bfloat16) of jax.grad's; the wrapper's own
    CPU path (autograd through the plain loop) agrees."""
    for dtype in ("float32", "bfloat16"):
        _hold_scan_function(dtype)


def _hold_scan_function(dtype):
    rng = np.random.default_rng(0)
    shape = (3, 41, 24)
    a = (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((3, 24)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    ta, tb = (torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (a, b))
    th0 = torch.from_numpy(h0).requires_grad_(True)
    h = rglru.RGLRUScan.apply(ta, tb, th0)
    assert torch.equal(h, rglru.rglru_scan(ta.detach(), tb.detach(), th0
                                           .detach()))
    got = torch.autograd.grad((h * torch.from_numpy(g)).sum(),
                              (ta, tb, th0))
    assert [x.dtype for x in got] == [tdt, tdt, torch.float32]
    ref_in = [np.asarray(x.detach().float()) for x in (ta, tb)]
    want = _ref_scan_grads(*map(jnp.asarray, (*ref_in, h0, g)))
    plain = torch.autograd.grad(
        (rglru.rglru_scan(ta, tb, th0) * torch.from_numpy(g)).sum(),
        (ta, tb, th0))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for x, w, p in zip(got, want, plain):
        x, w, p = x.float().numpy(), np.asarray(w), p.float().numpy()
        assert np.abs(x - w).max() <= tol * np.abs(w).max()
        assert np.abs(x - p).max() <= tol * np.abs(p).max()
