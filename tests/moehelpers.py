"""The reference's MoE routing, recorded for the port's parity tests.

Shared by tests/test_torch_models.py, test_torch_moe.py and
test_torch_golden_families.py.  `reference_routes` records the experts of
every ``jax.lax.top_k`` the reference calls (only its MoE routers do) in
call order; the port replays or compares them through
``chip_smoke.moe_routing`` and ``chip_smoke.routing_flips``.
"""

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def reference_routes():
    """Every ``jax.lax.top_k`` of the reference inside the block, recorded
    in call order as numpy expert arrays (t, k); ``jax.lax.top_k`` is
    restored on exit."""
    calls = []
    orig = jax.lax.top_k

    def top_k(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(
            lambda i: calls.append(np.asarray(i).reshape(-1, k)), idx,
            ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        yield calls
        jax.effects_barrier()
    finally:
        jax.lax.top_k = orig
