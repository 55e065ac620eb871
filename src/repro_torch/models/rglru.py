"""RG-LRU recurrent block (recurrentgemma, arXiv:2402.19427), as
``repro.models.rglru``.

Block = input/gate projections -> short causal depthwise conv1d -> RG-LRU
diagonal linear recurrence -> output projection.  The recurrence

    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))          (gated decay)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs on the train/prefill path as `ops.rglru_scan(..., use_kernel=True)`,
the hand-written scan kernel, where the reference runs
``jax.lax.associative_scan``: the same recurrence from h0 = 0, summed
sequentially instead of in log depth.  Decode keeps (h, conv tail) as O(1)
state and steps it with plain tensor ops, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef

_C = 8.0                            # recurrentgemma's fixed scaling constant


def rglru_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "in_x": ParamDef((d, w), ("fsdp", "lru")),
        "in_gate": ParamDef((d, w), ("fsdp", "lru")),
        "conv_w": ParamDef((cfg.conv1d_width, w), (None, "lru"),
                           scale=cfg.conv1d_width ** -0.5),
        "conv_b": ParamDef((w,), ("lru",), init="zeros"),
        "gate_a": ParamDef((w, w), ("lru", None), scale=w ** -0.5),
        "gate_x": ParamDef((w, w), ("lru", None), scale=w ** -0.5),
        "log_lambda": ParamDef((w,), ("lru",), init="zeros"),
        "out": ParamDef((w, d), ("lru", "fsdp")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def _gates(p: Dict, xw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and b_t (input) of the linear recurrence, fp32."""
    x32 = xw.float()
    r = torch.sigmoid(x32 @ p["gate_a"].float())
    i = torch.sigmoid(x32 @ p["gate_x"].float())
    log_a = -_C * F.softplus(p["log_lambda"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * x32)
    return a, b


def _conv(p: Dict, x: torch.Tensor,
          tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over seq; ``tail`` = last (width-1) steps of
    the previous segment (decode state)."""
    kw = p["conv_w"].shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * p["conv_w"][i].to(x.dtype) for i in range(kw))
    return out + p["conv_b"].to(x.dtype)


def rglru_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Train/prefill path. x: (b, s, d) -> (b, s, d) [, final decode state].

    The scan goes to the hand-written kernel (its plain version on the
    CPU); the state's ``h`` is the scan's last row and ``conv`` the last
    ``kw - 1`` pre-conv rows in fp32."""
    xw_pre = x @ p["in_x"].to(x.dtype)                       # (b, s, w)
    gate = _gelu(x @ p["in_gate"].to(x.dtype))
    xw = _conv(p, xw_pre)
    a, b = _gates(p, xw)
    h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device)
    h = ops.rglru_scan(a, b, h0, use_kernel=True)
    out = (h.to(x.dtype) * gate) @ p["out"].to(x.dtype)
    if not return_state:
        return out
    kw = p["conv_w"].shape[0]
    state = {"h": h[:, -1],
             "conv": xw_pre[:, -(kw - 1):].float()}
    return out, state


def rglru_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=torch.float32, device=device)}


def rglru_decode(p: Dict, x: torch.Tensor, state: Dict,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (b, 1, d); state: {h: (b, w), conv: (b, kw-1, w)}.
    Returns the output and a new state (``state`` is left as it was)."""
    xw = x @ p["in_x"].to(x.dtype)                           # (b, 1, w)
    gate = _gelu(x @ p["in_gate"].to(x.dtype))
    new_conv = torch.cat([state["conv"][:, 1:], xw.float()], dim=1)
    xw = _conv(p, xw, tail=state["conv"])
    a, b = _gates(p, xw)
    h = a[:, 0] * state["h"] + b[:, 0]                       # (b, w)
    out = (h[:, None].to(x.dtype) * gate) @ p["out"].to(x.dtype)
    return out, {"h": h, "conv": new_conv}
