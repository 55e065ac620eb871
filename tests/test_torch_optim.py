"""The port's AdamW and gradient compression against the reference's, on
the CPU.

The same numpy-seeded parameters and gradients go through
``repro.optim`` / ``repro.runtime`` (JAX on the CPU) and
``repro_torch.optim`` / ``repro_torch.runtime``.  Float32 values are held
to rtol 1e-6 (atol 1e-7 for values near zero), learning rates too (the
cosine is one float32 ulp apart at some steps); the int8 payloads
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.runtime import compression as ref_comp
from repro_torch import optim
from repro_torch.runtime import compression
from repro_torch.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    """A nested tree of float32 numpy arrays, one leaf over two blocks of
    the int8 quantiser (2048 elements each)."""
    return {"embed": (rng.standard_normal((64, 40)) * scale
                      ).astype(np.float32),
            "groups": {"wq": (rng.standard_normal((2, 16, 8)) * scale
                              ).astype(np.float32),
                       "bias": (rng.standard_normal((5,)) * scale
                                ).astype(np.float32)},
            "final_norm": {"scale": np.zeros((8,), np.float32)}}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _close(got_tree, want_tree, rtol=RTOL, atol=ATOL):
    got = [np.asarray(t) for t in tree_leaves(got_tree)]
    want = [np.asarray(w) for w in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("grad_scale,clip", [(0.01, 1.0), (3.0, 1.0),
                                             (1.0, 1e9)])
def test_apply_matches_the_reference_over_steps(grad_scale, clip):
    """Eight AdamW steps through warmup into the cosine, with clipping
    active (large gradients), idle (small ones) and off: parameters,
    moments, step, grad norm and lr after every step."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=clip)
    ref_cfg, cfg = ref_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    p0 = _tree(rng)
    ref_p = jax.tree.map(jnp.asarray, p0)
    ref_s = ref_optim.init(ref_p)
    p = _torch(p0)
    s = optim.init(p)
    for _ in range(8):
        g = _tree(rng, grad_scale)
        ref_p, ref_s, ref_m = ref_optim.apply(
            ref_cfg, ref_s, ref_p, jax.tree.map(jnp.asarray, g))
        p, s, m = optim.apply(cfg, s, p, _torch(g))
        _close(p, ref_p)
        _close(s.mu, ref_s.mu)
        _close(s.nu, ref_s.nu)
        assert int(s.step) == int(ref_s.step)
        assert s.step.dtype == torch.int32
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=RTOL)


def test_schedule_and_global_norm_match_the_reference():
    """No warmup, warmup inside the run, warmup past its end."""
    for warmup, total in ((0, 10), (5, 100), (100, 50)):
        kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
                  min_lr_frac=0.1)
        ref_cfg, cfg = ref_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
        steps = np.arange(0, 130, 7, dtype=np.int32)
        got = optim.schedule(cfg, torch.from_numpy(steps)).numpy()
        want = np.asarray(ref_optim.schedule(ref_cfg, jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        tree = _tree(np.random.default_rng(warmup + total), 2.0)
        np.testing.assert_allclose(
            float(optim.global_norm(_torch(tree))),
            float(ref_optim.global_norm(jax.tree.map(jnp.asarray, tree))),
            rtol=RTOL)


def test_int8_compression_matches_the_reference():
    """Three rounds of error feedback: the int8 payloads and scales, the
    residual state, the decompressed gradients and the ratio."""
    rng = np.random.default_rng(3)
    ref_err, err = None, None
    for _ in range(3):
        g = _tree(rng, 0.1)
        ref_c, ref_err = ref_comp.compress(jax.tree.map(jnp.asarray, g),
                                           ref_err)
        c, err = compression.compress(_torch(g), err)
        for got, want in ((c.q, ref_c.q), (c.scales, ref_c.scales)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == {np.int8: torch.int8,
                                   np.float32: torch.float32}[
                                       np.asarray(b).dtype.type]
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(err, ref_err)
        _close(compression.decompress(c, _torch(g)),
               ref_comp.decompress(ref_c, jax.tree.map(jnp.asarray, g)))
    assert compression.compression_ratio(_torch(g)) == \
        ref_comp.compression_ratio(jax.tree.map(jnp.asarray, g))
    zeros = compression.init_error_state(_torch(g))
    assert all(bool((z == 0).all()) and z.dtype == torch.float32
               for z in tree_leaves(zeros))
