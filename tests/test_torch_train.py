"""The port's train step against the reference's, on the CPU.

* ``make_train_step`` against the reference's (jitted, ``rules=None,
  mesh=None``: the reference's ``train()`` itself fails on jax 0.9.0, see
  ROADMAP queue 3) for five steps of the reduced qwen1.5-0.5b in float32,
  numpy weights and the reference's batches, for compression ``none`` and
  ``int8``, each with and without remat: the loss curves within rtol
  1e-5, the grad norms within rtol 1e-4, the learning rates within rtol
  1e-6.  Parameters: within 5e-5 absolute for ``none`` (AdamW normalises
  each element's step, so float32 noise in a gradient that should be
  zero, the key biases', moves an element by a fraction of lr = 1e-3);
  within 5 lr for ``int8`` (a gradient element on a quantisation boundary
  can round to either neighbour, flipping that element's normalised
  step: 5 steps of at most lr each).
* remat True and ``"dots"`` on the three reduced archs: the loss and
  every gradient equal to no remat's (rtol 1e-6).

The train loop (``train()``) is tests/test_torch_train_loop.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data import pipeline as ref_pipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.runtime import init_error_state as ref_init_error_state
from repro_torch import optim
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import init_error_state
from repro_torch.tree import tree_leaves
from test_torch_train_grad import (ARCHS, golden_weights, grad_case,
                                   port_value_and_grad)

ARCH, STEPS, LR = "qwen1.5-0.5b", 5, 1e-3


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_steps_match_the_reference(compression):
    for remat in (False, True):
        _hold_train_steps(compression, remat)


def _hold_train_steps(compression, remat):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                                  dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    weights = golden_weights(ref_model.defs)
    kw = dict(lr=LR, warmup_steps=2, total_steps=STEPS + 1)
    ref_step = jax.jit(ref_make_train_step(
        ref_model, ref_cfg, ref_optim.AdamWConfig(**kw), None, None, remat,
        compression))
    step = make_train_step(build_model(cfg, "cpu"), cfg,
                           optim.AdamWConfig(**kw), remat, compression)
    ref_p = jax.tree.map(jnp.asarray, weights)
    ref_s = ref_optim.init(ref_p)
    p = params_from_numpy(weights, "cpu")
    s = optim.init(p)
    ref_e = ref_init_error_state(ref_p) if compression == "int8" else None
    e = init_error_state(p) if compression == "int8" else None
    for i in range(STEPS):
        batch = ref_pipeline.synth_batch(
            ref_pipeline.DataConfig(global_batch=2, seq_len=32), ref_cfg, i)
        ref_p, ref_s, ref_e, ref_m = ref_step(ref_p, ref_s, ref_e, batch)
        p, s, e, m = step(p, s, e, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
    assert int(s.step) == int(ref_s.step) == STEPS
    atol = 5e-5 if compression == "none" else STEPS * LR
    for got, want in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    if compression == "int8":
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(e))


def test_remat_gradients_equal_no_remat():
    for arch in ARCHS:
        _, model, weights, batch = grad_case(arch, "float32")
        base_loss, base = port_value_and_grad(model, weights, batch)
        for remat in (True, "dots"):
            loss, grads = port_value_and_grad(model, weights, batch,
                                               remat=remat)
            assert loss == base_loss, (arch, remat)
            for g, b in zip(grads, base):
                np.testing.assert_allclose(g, b, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="remat"):
        port_value_and_grad(model, weights, batch, remat="everything")
