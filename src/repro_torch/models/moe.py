"""Mixture-of-Experts layer, as ``repro.models.moe``: top-k routing, a
capacity-bounded sort-based dispatch, batched expert products and the
Switch load-balancing loss.

Dispatch is the argsort / segment trick (no (T, E) one-hot): flatten the
(token, k) assignments, sort them stably by expert, take each one's
position within its expert from the segment starts, drop those past the
capacity, scatter the kept tokens into an (E, C, d) buffer, run the expert
products batched over E, gather back and weight by the routing weights.
Within an overflowing expert the latest tokens are the ones dropped.

Two dispatches, as the reference's ``moe_impl``: ``scatter_ep`` (one
buffer for all tokens) and ``grouped_tp`` (`_grouped_dispatch`: the same
index math per group of tokens, ``cfg.moe_groups`` groups, 1 when unset,
as the reference's is without a mesh).

Top-k ties: ``jax.lax.top_k`` puts the lower expert first among equal
probabilities, which happen in bfloat16 (the router product is rounded to
bfloat16 before the softmax).  `top_k` takes the first k of a stable
descending sort, which orders ties the same way on any device.

The expert products are plain products (``torch.bmm`` / ``einsum``), as
the reference leaves them to XLA outside any Pallas kernel.  Each layer
casts its own expert weights to the activation dtype.

Auxiliary load-balancing loss (Switch / GShard): E * sum_e f_e * p_e.

On a mesh (DTensor ``x``, `_mesh_apply`): the routing and the index math
stay on each rank's tokens, and the expert weights stay in their stored
shards (`common.gather_dp` leaves the `IN_PLACE` subtree; each rank
casts its own shard): the expert products run where the weights lie
(`_expert_product`), as the reference's GSPMD partitions them.
``grouped_tp`` takes G = ``cfg.moe_groups`` or the DP degree (``data`` x
``pod``, the reference's rule), so each DP shard dispatches its own
groups: the weights, in the activation dtype, are gathered over the DP
axes, swiglu's halves are paired on the ``model`` shards of the experts'
hidden dim (`common.swiglu_paired`: the weights' columns or the
product's, whichever are fewer), and the only collective left on the
products is the down-projection's reduction over ``model``.
``scatter_ep`` keeps one buffer for all tokens: every rank routes the
whole batch; the experts are computed where the ``experts`` axis puts
them (EP over ``model``), and each rank contracts its ``fsdp`` slice of
d, so the up-projection's partial sums are reduced over ``data`` and the
down-projection's d shards gathered (a decode step's few tokens move,
not the weights).  Where an expert's slots outnumber what its weights
would cost to gather (`gathers_weights`: a training or prefill step's
many tokens), the weights are gathered over the DP axes instead.  The
aux loss sums each rank's expert counts and probabilities across shards.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef

# the subtree of an MoE layer's parameters that `common.gather_dp` leaves
# in its stored shards: `_mesh_apply` decides how the expert weights move
IN_PLACE = ("experts",)


def moe_defs(cfg: ArchConfig) -> Dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    mult = 2 if cfg.ffn_kind == "swiglu" else 1
    if cfg.moe_impl == "grouped_tp":
        # TP expert weights: per-expert hidden f over the model axis
        expert_defs = {
            "wi": ParamDef((e, d, mult * f), (None, "fsdp", "mlp")),
            "wo": ParamDef((e, f, d), (None, "mlp", "fsdp")),
        }
    else:
        # EP owns the model axis; d rides the fsdp axis
        expert_defs = {
            "wi": ParamDef((e, d, mult * f), ("experts", "fsdp", None)),
            "wo": ParamDef((e, f, d), ("experts", None, "fsdp")),
        }
    defs = {
        "router": {"w": ParamDef((d, e), ("fsdp", None), scale=d ** -0.5)},
        "experts": expert_defs,
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared"] = {
            "wi": ParamDef((d, mult * fs), ("fsdp", "mlp")),
            "wo": ParamDef((fs, d), ("mlp", "fsdp")),
        }
    return defs


def _act(h: torch.Tensor, ffn_kind: str) -> torch.Tensor:
    """The FFN's activation; swiglu's gate is the second half."""
    if ffn_kind == "swiglu":
        u, g = torch.chunk(h, 2, dim=-1)
        return common.activation("swiglu", g) * u
    return common.activation(ffn_kind, h)


def _expert_ffn(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor,
                ffn_kind: str) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), batched over experts."""
    return torch.bmm(_act(torch.bmm(x, wi), ffn_kind), wo)


def _shared(params: Dict, xt: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The shared experts, an FFN (`common.ffn`)."""
    sh = params["shared"]
    return common.ffn(xt, sh["wi"], sh["wo"], cfg.ffn_kind)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    the lower index first among equal values (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Dict, x: torch.Tensor, cfg: ArchConfig):
    """The router over tokens x (..., d): (probs, normalised top-k weights,
    top-k experts), the probabilities in float32 from the router product
    in x's dtype."""
    logits = (x @ params["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, cfg.experts_per_token)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def capacity(cfg: ArchConfig, tokens: int, grouped: bool = False) -> int:
    """Slots per expert: capacity_factor x tokens x k / E, at least and
    rounded up to 8 (4 per group in the grouped dispatch)."""
    lane = 4 if grouped else 8
    cap = int(max(cfg.capacity_factor * tokens * cfg.experts_per_token
                  / cfg.n_experts, lane))
    return -(-cap // lane) * lane


def _slots(flat_e: torch.Tensor, e: int, cap: int):
    """Per row of expert ids (..., n): (the stable order by expert, each
    sorted assignment's slot ``expert * cap + position`` or the spare slot
    ``e * cap`` where it is dropped, and whether it is kept)."""
    n = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    experts = torch.arange(e, device=flat_e.device).expand(
        *flat_e.shape[:-1], e).contiguous()
    seg = torch.searchsorted(se, experts, right=False)
    pos = torch.arange(n, device=flat_e.device) - torch.gather(seg, -1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    return order, slot, keep


def dropped(topi: torch.Tensor, cfg: ArchConfig) -> int:
    """Assignments the dispatch drops for these top-k experts: (t, k) for
    ``scatter_ep``, (g, tl, k) for ``grouped_tp``'s groups; those past
    their expert's capacity."""
    if topi.dim() == 3:
        cap = capacity(cfg, topi.shape[1], grouped=True)
        flat = topi.reshape(topi.shape[0], -1)
    else:
        cap = capacity(cfg, topi.shape[0])
        flat = topi.reshape(1, -1)
    counts = torch.stack([torch.bincount(r, minlength=cfg.n_experts)
                          for r in flat])
    return int(torch.clamp(counts - cap, min=0).sum())


def _counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert, float32 (``bincount`` with ``minlength``
    ``e``, but of a size known before the data: the dry-run's fake
    tensors take it)."""
    flat = flat_e.reshape(-1).long()
    return torch.zeros(e, dtype=torch.float32, device=flat.device) \
        .index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                        device=flat.device))


def _aux(probs: torch.Tensor, flat_e: torch.Tensor, e: int) -> torch.Tensor:
    density = _counts(flat_e, e) / flat_e.numel()
    mean_prob = probs.reshape(-1, e).mean(0)
    return e * torch.sum(density * mean_prob)


def _grouped_dispatch(params: Dict, x: torch.Tensor, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """grouped_tp: top-k, capacity, scatter and gather are all local to
    each of G groups of tokens (G = ``cfg.moe_groups``, 1 when unset, cut
    to a divisor of the token count)."""
    b, s, d = x.shape
    t = b * s
    kk, e = cfg.experts_per_token, cfg.n_experts
    g = max(min(cfg.moe_groups or 1, t), 1)
    while t % g:
        g -= 1
    tl = t // g                                     # tokens per group
    xt = x.reshape(g, tl, d)
    probs, topw, topi = route(params, xt, cfg)      # (g, tl, k)
    cap = capacity(cfg, tl, grouped=True)
    flat_e = topi.reshape(g, tl * kk)
    flat_t = torch.arange(tl * kk, device=x.device) // kk
    order, slot, keep = _slots(flat_e, e, cap)

    src = torch.gather(xt, 1, flat_t[order][..., None].expand(-1, -1, d))
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(-1, -1, d), src)
    buf = buf[:, :-1].reshape(g, e, cap, d)

    wi = params["experts"]["wi"].to(x.dtype)        # (e, d, mult*f)
    wo = params["experts"]["wo"].to(x.dtype)
    h = _act(torch.einsum("gecd,edf->gecf", buf, wi), cfg.ffn_kind)
    out_buf = torch.einsum("gecf,efd->gecd", h, wo)

    flat_out = out_buf.reshape(g, e * cap, d)
    safe = torch.clamp(slot, 0, e * cap - 1)
    gathered = torch.gather(flat_out, 1, safe[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    unsort = torch.zeros((g, tl * kk, d), dtype=x.dtype, device=x.device)
    unsort = unsort.scatter(1, order[..., None].expand(-1, -1, d), gathered)
    out = torch.einsum("gtkd,gtk->gtd", unsort.reshape(g, tl, kk, d),
                       topw.to(x.dtype))
    if cfg.n_shared_experts:
        out = out + _shared(params, xt, cfg)
    return out.reshape(b, s, d), _aux(probs, flat_e, e)


def _groups(cfg: ArchConfig, t: int, mesh) -> int:
    """grouped_tp's G: ``cfg.moe_groups``, else the DP degree on a mesh
    and 1 without; cut to a divisor of the token count."""
    g = cfg.moe_groups
    if not g:
        from repro_torch.parallel.sharding import mesh_shape
        sizes = mesh_shape(mesh) if mesh is not None else {}
        g = sizes.get("data", 1) * sizes.get("pod", 1)
    g = max(min(g, t), 1)
    while t % g:
        g -= 1
    return g


def gathers_weights(slots: int, d: int, fi: int, fo: int) -> bool:
    """Whether `_mesh_apply` gathers the expert weights over the DP axes
    rather than move the products' activations: where an expert's
    ``slots`` (all groups' capacity) times what each moves (its partial
    sums of the up-projection's ``fi`` columns and its ``d`` outputs)
    outnumber the elements of its weights (d x fi + fo x d)."""
    return slots * (fi + d) > d * (fi + fo)


def _expert_product(a, w, bpl, pair=None):
    """``einsum("geck,ekn->gecn", a, w)`` of DTensors, computed where the
    weight ``w`` lies: on each mesh dim that splits w's experts, its k or
    its n, ``a`` takes the matching split (a local slice where it is whole
    there) and the product comes out split over the experts, as a partial
    sum over k, or split over n; on the mesh dims that keep ``w`` whole,
    ``a`` and the product keep the tokens' placements ``bpl``.  No weight
    moves, but for ``pair``, a mesh dim that splits swiglu's n = [u | g]:
    the rank's columns are made [u_m | g_m] first (`common.pair_halves`).
    In the backward, ``a``'s gradient is a partial sum over n's shards and
    ``w``'s over the tokens' shards, so each reaches its stored layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    split = {0: (Shard(1), Shard(1)), 1: (Shard(3), Partial()),
             2: (Replicate(), Shard(3))}    # w's dim -> (a, product)
    a_pl, o_pl, a_grad, w_grad = [], [], [], []
    for p, b in zip(w.placements, bpl):
        ap, op = split[p.dim] if p.is_shard() else (b, b)
        a_pl.append(ap)
        o_pl.append(op)
        a_grad.append(Partial() if p == Shard(2) else ap)
        w_grad.append(Partial() if b.is_shard() else p)
    al = a.redistribute(a.device_mesh, tuple(a_pl)).to_local(
        grad_placements=tuple(a_grad))
    wl = w.to_local(grad_placements=tuple(w_grad))
    if pair is not None:
        wl = common.pair_halves(wl, a.device_mesh, pair)
    return DTensor.from_local(torch.einsum("geck,ekn->gecn", al, wl),
                              a.device_mesh, tuple(o_pl), run_check=False)


def _mesh_apply(params: Dict, x, cfg: ArchConfig, mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_apply` on DTensors: the dispatch on each rank's tokens, the
    expert products where the weights lie (see the module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    grouped = cfg.moe_impl == "grouped_tp"
    b, s, d = x.shape
    t = b * s
    kk, e = cfg.experts_per_token, cfg.n_experts
    xmesh = x.device_mesh
    g = _groups(cfg, t, mesh) if grouped else 1
    # tokens: each rank keeps its batch shard where its groups are whole
    # there (grouped_tp), else every rank takes all of them
    bpl = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    ndp = 1
    for i, p in enumerate(bpl):
        ndp *= xmesh.size(i) if p == Shard(0) else 1
    if not grouped or g % ndp or b % ndp:
        bpl, ndp = (Replicate(),) * xmesh.ndim, 1
    xl = x.redistribute(xmesh, bpl).to_local()
    gl, tl = max(g // ndp, 1), t // g
    xt = xl.reshape(gl, tl, d)
    # the router on each rank's tokens: its gradient is Partial over them
    part = tuple(Partial() if p == Shard(0) else Replicate() for p in bpl)
    router = {"router": {"w": params["router"]["w"].redistribute(
        xmesh, (Replicate(),) * xmesh.ndim).to_local(grad_placements=part)}}
    probs, topw, topi = route(router, xt, cfg)              # (gl, tl, k)
    cap = capacity(cfg, tl, grouped=grouped) if grouped else \
        capacity(cfg, t)
    flat_e = topi.reshape(gl, tl * kk)
    flat_t = torch.arange(tl * kk, device=xl.device) // kk
    order, slot, keep = _slots(flat_e, e, cap)
    src = torch.gather(xt, 1, flat_t[order][..., None].expand(-1, -1, d))
    buf = torch.zeros((gl, e * cap + 1, d), dtype=xl.dtype, device=xl.device)
    buf = buf.scatter(1, slot[..., None].expand(-1, -1, d), src)
    buf = buf[:, :-1].reshape(gl, e, cap, d)

    # each rank's weight shards cast, then gathered only over the mesh
    # dims that split the tokens and, past `gathers_weights`, the DP dims
    buf = DTensor.from_local(buf, xmesh, bpl, run_check=False)
    wi = params["experts"]["wi"].to(xl.dtype)       # (e, d, F)
    wo = params["experts"]["wo"].to(xl.dtype)       # (e, f, d)
    heavy = gathers_weights(buf.shape[0] * buf.shape[2], d, wi.shape[2],
                            wo.shape[1])
    whole = tuple(b.is_shard() or (heavy and name in common.DP_AXES)
                  for name, b in zip(xmesh.mesh_dim_names, bpl))
    wi, wo = (w.redistribute(xmesh, tuple(
        Replicate() if gather else p
        for gather, p in zip(whole, w.placements))) for w in (wi, wo))
    # swiglu's halves paired on the model shards: the weights' columns or
    # the product's, the fewer (`common.pairs_weights`); where the shards
    # do not divide f, the product is made whole there
    i, even = common.swiglu_split(wi) if cfg.ffn_kind == "swiglu" else \
        (None, False)
    paired = even and common.pairs_weights(
        buf.to_local().shape[0] * cap, wi.to_local().shape[1])
    h = _expert_product(buf, wi, bpl, i if paired else None)
    # the hidden dim summed
    h = h.redistribute(xmesh, tuple(
        Replicate() if p.is_partial() or (i is not None and not even
                                          and p == Shard(3))
        else p for p in h.placements))
    h = common.swiglu_paired(h, i, paired) if even else \
        _act(h, cfg.ffn_kind)
    out_buf = _expert_product(h, wo, bpl)
    out_buf = out_buf.redistribute(xmesh, bpl).to_local()

    flat_out = out_buf.reshape(gl, e * cap, d)
    safe = torch.clamp(slot, 0, e * cap - 1)
    gathered = torch.gather(flat_out, 1, safe[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=xl.dtype, device=xl.device))
    unsort = torch.zeros((gl, tl * kk, d), dtype=xl.dtype, device=xl.device)
    unsort = unsort.scatter(1, order[..., None].expand(-1, -1, d), gathered)
    out = torch.einsum("gtkd,gtk->gtd", unsort.reshape(gl, tl, kk, d),
                       topw.to(xl.dtype))
    out = DTensor.from_local(out.reshape(xl.shape), xmesh, bpl,
                             run_check=False)
    if cfg.n_shared_experts:
        out = out + _shared(params, x, cfg)     # on the tokens' own shards
    # aux: this rank's expert counts and probability sums, summed over
    # the ranks that hold other tokens
    counts = DTensor.from_local(_counts(flat_e, e), xmesh, part,
                                run_check=False)
    psum = DTensor.from_local(probs.reshape(-1, e).sum(0), xmesh, part,
                              run_check=False)
    aux = e * torch.sum((counts / (t * kk)) * (psum / t))
    return out, aux


def moe_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, rules=None,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (batch, seq, d) -> (out, aux_loss)."""
    if common.is_dtensor(x):
        return _mesh_apply(params, x, cfg, mesh)
    if cfg.moe_impl == "grouped_tp":
        return _grouped_dispatch(params, x, cfg)
    b, s, d = x.shape
    t = b * s
    kk, e = cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(t, d)
    probs, topw, topi = route(params, xt, cfg)      # (t, k)

    # ---- capacity-bounded sort dispatch ---------------------------------
    cap = capacity(cfg, t)
    flat_e = topi.reshape(-1)                       # (t*k,)
    flat_t = torch.arange(t * kk, device=x.device) // kk
    order, slot, keep = _slots(flat_e, e, cap)
    # dropped assignments all land on the spare last row
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt[flat_t[order]])
    buf = buf[:-1].reshape(e, cap, d)

    out_buf = _expert_ffn(params["experts"]["wi"].to(x.dtype),
                          params["experts"]["wo"].to(x.dtype), buf,
                          cfg.ffn_kind)

    # ---- combine ---------------------------------------------------------
    flat_out = out_buf.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp(slot, 0, e * cap - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    unsort = torch.zeros((t * kk, d), dtype=x.dtype, device=x.device)
    unsort = unsort.index_put((order,), gathered)   # a permutation
    out = torch.einsum("tkd,tk->td", unsort.reshape(t, kk, d),
                       topw.to(x.dtype))
    if cfg.n_shared_experts:
        out = out + _shared(params, xt, cfg)
    return out.reshape(b, s, d), _aux(probs, flat_e, e)
