"""xLSTM blocks (arXiv:2405.04517), as ``repro.models.xlstm``: mLSTM (matrix
memory, parallelizable) and sLSTM (scalar memory, sequential recurrence
with block-diagonal recurrent weights).

mLSTM over a prompt uses the paper's *parallel form*, decay-weighted causal
linear attention

    D_tj = exp(F_t - F_j + i_j - m_t),  F = cumsum(log f)
    h_t  = (sum_j D_tj (q_t.k_j) v_j) / max(|sum_j D_tj (q_t.k_j)|, e^{-m_t})

which runs as `ops.mlstm(..., use_kernel=True)`, the hand-written kernel,
where the reference runs its jnp twin ``_mlstm_parallel``: in bfloat16 (the
model's dtype) on the tensor cores (``mma.sync``; q, k and v split off the
(b, s, h*d) projections meet its 16-byte alignment), in float32 on FFMA.
As the TPU kernel does, the kernel scales q in its own dtype (as the jnp
twin and both decodes do: the scale rounded to q's dtype) and rounds the
weights to v's dtype before they meet V (the jnp twin keeps them in fp32):
in bfloat16 the two differ by a rounding, in float32 not at all.  Decode
carries the (h, d, d') matrix state C and normalizer n, O(1) per token.

sLSTM is inherently sequential (h_{t-1} feeds the gates through recurrent
weights R): the reference's ``lax.scan`` over time is a Python loop here.
The JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import common
from repro_torch.models.common import ParamDef


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a mesh its composite min(x, 0) - log1p(
    exp(-|x|)), equal within float32 rounding (DTensor has no rule for
    log-sigmoid's backward)."""
    if common.is_dtensor(x):
        return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-torch.abs(x)))
    return F.logsigmoid(x)


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    return cfg.n_heads, cfg.resolved_head_dim


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def mlstm_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    nh, hd = _heads(cfg)
    return {
        "wq": ParamDef((d, nh * hd), ("fsdp", "heads")),
        "wk": ParamDef((d, nh * hd), ("fsdp", "heads")),
        "wv": ParamDef((d, nh * hd), ("fsdp", "heads")),
        "wi": ParamDef((d, nh), ("fsdp", None), scale=0.1),
        "wf": ParamDef((d, nh), ("fsdp", None), scale=0.1),
        "bf": ParamDef((nh,), (None,), init="ones"),
        "wo": ParamDef((nh * hd, d), ("heads", "fsdp")),
        "up": ParamDef((d, 2 * d), ("fsdp", "mlp")),
        "down": ParamDef((2 * d, d), ("mlp", "fsdp")),
    }


def slstm_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    nh, hd = _heads(cfg)
    return {
        "wz": ParamDef((d, nh * hd), ("fsdp", "heads")),
        "wi": ParamDef((d, nh * hd), ("fsdp", "heads"), scale=0.1),
        "wf": ParamDef((d, nh * hd), ("fsdp", "heads"), scale=0.1),
        "wo_gate": ParamDef((d, nh * hd), ("fsdp", "heads"), scale=0.1),
        # block-diagonal recurrent weights, one (hd, hd) block per head
        "rz": ParamDef((nh, hd, hd), (None, None, None), scale=hd ** -0.5),
        "ri": ParamDef((nh, hd, hd), (None, None, None), scale=0.05),
        "rf": ParamDef((nh, hd, hd), (None, None, None), scale=0.05),
        "bf": ParamDef((nh * hd,), ("heads",), init="ones"),
        "wo": ParamDef((nh * hd, d), ("heads", "fsdp")),
        "up": ParamDef((d, 2 * d), ("fsdp", "mlp")),
        "down": ParamDef((2 * d, d), ("mlp", "fsdp")),
    }


def _split_heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, s, _ = x.shape
    return common.split_last(x, nh, x.shape[-1] // nh).transpose(1, 2)


def _up_down(p: Dict, h: torch.Tensor) -> torch.Tensor:
    """Output projection, then the up/down projection that replaces the
    FFN (d_ff = 0 in the config)."""
    out = h @ p["wo"].to(h.dtype)
    return _gelu(out @ p["up"].to(h.dtype)) @ p["down"].to(h.dtype)


# --------------------------------------------------------------------- mLSTM


def _mlstm_gates(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """log i and log f, fp32 (b, nh, s)."""
    x32 = x.float()
    log_i = (x32 @ p["wi"].float()).transpose(1, 2)
    log_f = _logsigmoid((x32 @ p["wf"].float()).transpose(1, 2)
                         + p["bf"].float()[None, :, None])
    return log_i, log_f


def mlstm_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b, s, d = x.shape
    nh, hd = _heads(cfg)
    q = _split_heads(x @ p["wq"].to(x.dtype), nh)
    k = _split_heads(x @ p["wk"].to(x.dtype), nh)
    v = _split_heads(x @ p["wv"].to(x.dtype), nh)
    log_i, log_f = _mlstm_gates(p, x)
    f_cum = torch.cumsum(log_f, dim=-1)                    # F_t
    h = ops.mlstm(q, k, v, f_cum, log_i, use_kernel=True)
    h = h.transpose(1, 2).reshape(b, s, nh * hd)
    return _up_down(p, h)


def mlstm_prefill_state(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> Dict:
    """Final recurrent (C, n, m) state after consuming x, so decode can
    continue after a parallel-form prefill."""
    nh, hd = _heads(cfg)
    k = _split_heads(x @ p["wk"].to(x.dtype), nh).float()
    v = _split_heads(x @ p["wv"].to(x.dtype), nh).float()
    log_i, log_f = _mlstm_gates(p, x)
    f_cum = torch.cumsum(log_f, dim=-1)
    # weight of step j in the final state: F_T - F_j + i_j
    a = f_cum[..., -1:] - f_cum + log_i                    # (b, h, s)
    m = torch.amax(a, dim=-1)
    w = torch.exp(a - m[..., None])
    c = torch.einsum("bhs,bhsd,bhse->bhde", w, k, v)
    n = torch.einsum("bhs,bhsd->bhd", w, k)
    return {"c": c, "n": n, "m": m}


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    nh, hd = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh), NEG_INF, **f32)}


def mlstm_decode(p: Dict, x: torch.Tensor, state: Dict,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (b, 1, d).  Recurrent matrix-memory update (xLSTM eqs. 19-27).
    Returns the output and a new state (``state`` is left as it was)."""
    b = x.shape[0]
    nh, hd = _heads(cfg)
    # the reference's jnp multiplies by the scale rounded to x's dtype (a
    # weakly typed float), as the kernel does over a prompt; on the host
    q = common.split_last(x @ p["wq"].to(x.dtype), nh, hd)[:, 0] \
        * torch.tensor(hd ** -0.5, dtype=x.dtype).item()
    k = common.split_last(x @ p["wk"].to(x.dtype), nh, hd)[:, 0].float()
    v = common.split_last(x @ p["wv"].to(x.dtype), nh, hd)[:, 0].float()
    q = q.float()
    x32 = x[:, 0].float()
    log_i = x32 @ p["wi"].float()                          # (b, nh)
    log_f = _logsigmoid(x32 @ p["wf"].float() + p["bf"].float())
    m_new = torch.maximum(state["m"] + log_f, log_i)
    fg = torch.exp(state["m"] + log_f - m_new)[..., None]
    ig = torch.exp(log_i - m_new)[..., None]
    c = state["c"] * fg[..., None] + ig[..., None] \
        * torch.einsum("bhd,bhe->bhde", k, v)
    n = state["n"] * fg + ig * k
    num = torch.einsum("bhde,bhd->bhe", c, q)
    # stabilized denominator: max(|n.q|, e^{-m}) (xLSTM eq. 27 with the
    # running stabilizer factored out; matches the parallel form)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, nh * hd).to(x.dtype)
    return _up_down(p, h), {"c": c, "n": n, "m": m_new}


# --------------------------------------------------------------------- sLSTM


def _slstm_gates(p: Dict, x32: torch.Tensor):
    z = x32 @ p["wz"].float()
    i = x32 @ p["wi"].float()
    f = x32 @ p["wf"].float() + p["bf"].float()
    o = x32 @ p["wo_gate"].float()
    return z, i, f, o


def _slstm_step(r: torch.Tensor, carry, zifo):
    """One sLSTM step.  ``r``: the recurrent blocks (rz | ri | rf) side by
    side, (nh, hd, 3 hd) fp32, so one batched product per step feeds all
    three gates."""
    c, n, h, m = carry                                     # (b, nh, hd) each
    z_x, i_x, f_x, o_x = zifo
    hd = c.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", h, r)
    z = torch.tanh(z_x + rec[..., :hd])
    i_t = i_x + rec[..., hd:2 * hd]
    f_t = f_x + rec[..., 2 * hd:]
    log_f = _logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)                  # stabilizer
    i_g = torch.exp(i_t - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = torch.sigmoid(o_x) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _recurrent(p: Dict) -> torch.Tensor:
    return torch.cat([p["rz"].float(), p["ri"].float(), p["rf"].float()],
                     dim=-1)


def slstm_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    b, s, d = x.shape
    nh, hd = _heads(cfg)
    gates = [common.split_last(g, nh, hd)
             for g in _slstm_gates(p, x.float())]
    r = _recurrent(p)
    carry = tuple(torch.zeros((b, nh, hd), dtype=torch.float32,
                              device=x.device) for _ in range(3)) \
        + (torch.full((b, nh, hd), NEG_INF, dtype=torch.float32,
                      device=x.device),)
    hs = []
    for t in range(s):
        carry, h = _slstm_step(r, carry, [g[:, t] for g in gates])
        hs.append(h)
    hs = torch.stack(hs, dim=1)                            # (b, s, nh, hd)
    y = _up_down(p, hs.reshape(b, s, nh * hd).to(x.dtype))
    if not return_state:
        return y
    c, n, hh, m = carry
    return y, {"c": c, "n": n, "h": hh, "m": m}


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict:
    nh, hd = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, nh, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "h": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh, hd), NEG_INF, **f32)}


def slstm_decode(p: Dict, x: torch.Tensor, state: Dict,
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """Returns the output and a new state (``state`` is left as it was)."""
    b = x.shape[0]
    nh, hd = _heads(cfg)
    zifo = [common.split_last(g, nh, hd)
            for g in _slstm_gates(p, x[:, 0].float())]
    carry = (state["c"], state["n"], state["h"], state["m"])
    (c, n, h, m), hh = _slstm_step(_recurrent(p), carry, zifo)
    y = _up_down(p, hh.reshape(b, 1, nh * hd).to(x.dtype))
    return y, {"c": c, "n": n, "h": h, "m": m}
