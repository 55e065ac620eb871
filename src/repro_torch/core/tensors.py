"""float32 scalar arithmetic that mirrors ``jax.numpy``'s weak typing.

The reference computes the performance model with Python floats until a
``jnp`` op meets them, then in float32.  These helpers keep that split:
two Python floats stay a Python float (float64) where the reference's
expression stays in Python, and a Python float meeting a tensor becomes a
float32 tensor first.  Division always divides two tensors: torch turns
``float / tensor`` into ``reciprocal(tensor) * float`` and, on CUDA,
``tensor / float`` into a multiply by the reciprocal — one ulp off the
reference, which is enough to flip a ``ceil`` at an exact multiple.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def as_f32(x, device) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.tensor(float(x), dtype=F32,
                                                     device=device)


def _dev(a, b, device):
    for x in (a, b):
        if torch.is_tensor(x):
            return x.device
    return device


def div(a, b):
    """``a / b`` with the reference's rounding (see module docstring)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.div(a, b)
    if torch.is_tensor(b):
        return torch.div(as_f32(a, b.device), b)
    if torch.is_tensor(a):
        return torch.div(a, as_f32(b, a.device))
    return a / b


def maximum(a, b, device=None) -> torch.Tensor:
    """``jnp.maximum``: always a float32 tensor; ties split the gradient."""
    d = _dev(a, b, device)
    return torch.maximum(as_f32(a, d), as_f32(b, d))


def minimum(a, b, device=None) -> torch.Tensor:
    d = _dev(a, b, device)
    return torch.minimum(as_f32(a, d), as_f32(b, d))


def clip(x, lo, hi, device=None) -> torch.Tensor:
    """``jnp.clip`` is ``minimum(hi, maximum(lo, x))``; so is this, so the
    gradient at a bound is split as the reference splits it."""
    return minimum(hi, maximum(lo, x, device), device)
