"""float32 scalar arithmetic that mirrors ``jax.numpy``'s weak typing.

The reference computes the performance model with Python floats until a
``jnp`` op meets them, then in float32.  These helpers keep that split:
two Python floats stay a Python float (float64) where the reference's
expression stays in Python, and a Python float meeting a tensor becomes a
float32 tensor first.  Division always divides two tensors: torch turns
``float / tensor`` into ``reciprocal(tensor) * float`` and, on CUDA,
``tensor / float`` into a multiply by the reciprocal — one ulp off the
reference, which is enough to flip a ``ceil`` at an exact multiple.

`XP` is the array module ``xp`` the traced folds receive: the
``jax.numpy`` names they call, over float32 tensors.
"""

from __future__ import annotations

import math
import types

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


def _device_of(*xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def _where(cond, a, b) -> torch.Tensor:
    d = _device_of(cond, a, b)
    return torch.where(cond, as_f32(a, d), as_f32(b, d))


def _stack(xs) -> torch.Tensor:
    d = _device_of(*xs)
    return torch.stack([as_f32(x, d) for x in xs])


def _amax(x, axis=None) -> torch.Tensor:
    """``jnp.max``: the values only, and a tie splits the gradient evenly
    (``torch.max(x, dim)`` returns indices too and sends it all to one)."""
    return torch.amax(x) if axis is None else torch.amax(x, dim=axis)


def _sum(x, axis=None) -> torch.Tensor:
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis)


def _unary(fn):
    return lambda x: fn(as_f32(x, _device_of(x)))


# The array module ``xp`` of the traced folds (``core/traffic.py``,
# ``core/objectives.py``, the scenarios' refine folds) over tensors: each
# name takes what the ``jax.numpy`` function of that name takes, Python
# floats included, and returns a float32 tensor.
XP = types.SimpleNamespace(
    inf=math.inf, maximum=maximum, minimum=minimum, clip=clip,
    where=_where, stack=_stack, max=_amax, sum=_sum,
    log=_unary(torch.log), exp=_unary(torch.exp),
    isfinite=_unary(torch.isfinite), ones_like=torch.ones_like)
