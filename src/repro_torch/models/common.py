"""Shared model machinery: parameter definitions with logical sharding axes,
norms, positions, and the attention call every attention block makes.

Parameters are described once as a tree (nested dicts) of `ParamDef`s
(shape + logical axes + init), as in ``repro.models.common``; `tree_init`
materialises it into a tree of tensors with the reference's layout, so
weights cross between the packages leaf for leaf
(`repro_torch.models.convert`).

Logical axes used by params (the reference's sharding vocabulary; the
planner's rules map them onto mesh axes, `repro_torch.parallel.sharding`):
    layers   stacked layer axis (never sharded)
    vocab    embedding/logits vocabulary dim        -> model
    fsdp     the weight dim sharded ZeRO-3-style    -> data (big archs)
    heads    attention projection out dim           -> model
    mlp      ffn hidden                             -> model
    experts  MoE expert axis                        -> model (EP)
and by activations:
    batch -> (pod, data);  act_seq, act_embed -> replicated;
    act_heads -> model;  kv_seq -> model only under SP (long_500k).

On a mesh the parameters are DTensors and `logical` is a real constraint:
it redistributes an activation to the placements its logical axes
resolve to, where the reference constrains the compiler's layout.  On one
device without a mesh it is the identity, and nothing here touches
DTensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import is_dtensor, tree_map
from repro_torch.kernels.ref import NEG_INF

# ---------------------------------------------------------------------------
# ParamDef machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # default: 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_init(defs, seed: int = 0, dtype: torch.dtype = torch.float32,
              device=None, place=None):
    """Materialise a ParamDef tree into tensors on ``device`` (default: the
    card).

    The same shapes, scales and leaf order as ``repro.models.common.
    tree_init``; the random bits come from one ``torch.Generator`` seeded
    with ``seed`` and drawn leaf by leaf in that order, so they differ from
    JAX's (tests hand the reference's weights over with
    `repro_torch.models.convert.params_from_numpy`).

    ``place(path, tensor)``, where given, takes each leaf as it is drawn
    (``path`` the tuple of its keys) and returns what the tree holds: on a
    mesh, the rank's shard of it (`repro_torch.parallel.sharding.
    distribute`), so no more than one full leaf is held at a time and the
    values are the one-device init's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        # drawn and scaled in place: a leaf of tens of GB (qwen2-moe's
        # stacked experts) never needs twice its size
        return torch.randn(d.shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(scale).to(dtype)

    def walk(tree, path):           # sorted keys: the reference's order
        if isinstance(tree, dict):
            return {key: walk(tree[key], path + (key,))
                    for key in sorted(tree)}
        return mk(tree) if place is None else place(path, mk(tree))

    return walk(defs, ())


def tree_abstract(defs, dtype: torch.dtype = torch.float32):
    """The parameters' shapes and dtype as meta tensors (no storage)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def tree_pspecs(defs, rules: Dict[str, Optional[Tuple[str, ...]]]):
    """ParamDef tree -> spec tree (the reference's ``PartitionSpec`` as a
    tuple of per-dim entries, each None or a tuple of mesh axes) via the
    logical-axis rules."""
    def spec(d: ParamDef):
        parts = []
        for ax in d.axes:
            r = rules.get(ax) if ax is not None else None
            parts.append(None if r is None else
                         (r,) if isinstance(r, str) else tuple(r))
        return tuple(parts)
    return tree_map(spec, defs)


def rules_from_plan(plan_rules) -> Dict[str, Optional[Tuple[str, ...]]]:
    base = {k: v for k, v in plan_rules}
    # param-axis defaults derived from the activation rules
    base.setdefault("layers", None)
    base.setdefault("fsdp", base.get("batch") and ("data",) or None)
    base.setdefault("act_heads", base.get("heads"))
    base.setdefault("act_embed", None)
    base.setdefault("act_seq", None)
    return base


def tree_index(tree, i: int):
    """Slice ``i`` of a tree stacked along a leading axis (views; a
    DTensor's slice keeps the placements of its other dims)."""
    return tree_map(lambda t: t[i], tree)


DP_AXES = ("pod", "data")


def gather_dp(tree):
    """Parameters ready for use: each DTensor leaf's shards over the DP
    axes (``fsdp`` -> ``data``: ZeRO-style storage) gathered, its shards
    over ``model`` (tensor parallelism) kept; GSPMD's gather of an
    FSDP-sharded weight before its product.  The gradient goes back to
    the stored layout as a reduce-scatter.  Plain tensors as they are."""
    def one(t):
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        pl = tuple(Replicate() if name in DP_AXES else p for name, p in
                   zip(t.device_mesh.mesh_dim_names, t.placements))
        if pl == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, pl)
    return tree_map(one, tree)


def layer_params(tree, i: int):
    """Layer ``i``'s parameters from a stacked tree, ready for use
    (`gather_dp`: one layer gathered at a time)."""
    return gather_dp(tree_index(tree, i))


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]``; on a mesh (a DTensor table, the vocabulary
    possibly sharded) the embedding lookup, which gives the same rows."""
    if is_dtensor(table):
        from repro_torch.parallel import shards
        return shards.embedding(table, tokens)
    return table[tokens.long()]


def write_(dst: torch.Tensor, index: Tuple, src: torch.Tensor) -> None:
    """``dst[index] = src`` in place (a cache write).  On a mesh each rank
    writes its own shard: ``src`` takes ``dst``'s placements, and
    ``index`` may cut only dims ``dst`` does not shard."""
    if not is_dtensor(dst):
        dst[index] = src
        return
    from repro_torch.parallel import shards
    for p in dst.placements:
        d = getattr(p, "dim", None)
        if d is not None and d < len(index) and index[d] != slice(None):
            raise ValueError(f"write_: index {index} cuts dim {d}, which "
                             f"{tuple(dst.placements)} shards")
    dst.to_local()[index] = shards.to_placements(
        src, dst.device_mesh, dst.placements).to_local()


def logical(x: torch.Tensor, axes: Tuple[Optional[str], ...],
            rules: Optional[Dict] = None, mesh=None) -> torch.Tensor:
    """Activation sharding constraint by logical axes: a DTensor is
    redistributed to the placements ``axes`` resolve to under ``rules`` on
    ``mesh``.  Mesh axes the mesh lacks, or that an earlier dim already
    claimed, are dropped, as the reference drops them; so is an entry
    whose devices do not divide its dim (replicated instead).  Without
    rules or mesh, and for a plain tensor, the identity."""
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    from repro_torch.parallel import sharding
    names = sharding.mesh_axes(mesh)
    parts = []
    used = set()
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        if isinstance(r, str):
            r = (r,)
        if r is not None:
            r = tuple(a for a in r if a in names and a not in used) or None
            if r:
                used.update(r)
        parts.append(r)
    spec = sharding.guard_spec(mesh, tuple(parts), tuple(x.shape))
    pl = sharding.placements(mesh, spec)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# Norms / positions / activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + gamma.float())
            ).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def norm(kind: str, x, p) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_defs(kind: str, d: int) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), (None,), init="zeros")}
    return {"scale": ParamDef((d,), (None,), init="ones"),
            "bias": ParamDef((d,), (None,), init="zeros")}


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs     # (..., s, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device="cpu") -> torch.Tensor:
    """(seq, d) float32: sin then cos of pos / 10000^(2i/d), computed in
    float64 numpy as the reference's and rounded once, so the table is the
    reference's bit for bit.  Cached per (seq, d, device): callers read
    it and never write it."""
    return _sinusoidal(seq, d, str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _sinusoidal(seq: int, d: int, device: str) -> torch.Tensor:
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Set the padded vocab slots (vocab..padded) to -1e30 so CE/argmax
    never see them; keeps the padded shape."""
    if logits.shape[-1] <= vocab:
        return logits
    if is_dtensor(logits):          # the same values, on any vocab shard
        keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
        return torch.where(keep, logits, torch.full(
            (), NEG_INF, dtype=logits.dtype, device=logits.device))
    out = logits.clone()
    out[..., vocab:] = NEG_INF
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, kv_len: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention without materialising (sq, skv): the
    hand-written flash-attention kernel (its plain version on the CPU).

    q: (b, h, sq, d); k/v: (b, h_kv, skv, d). ``q_offset`` is the absolute
    position of q[0] (decode: cache length); ``kv_len`` (a host int) masks
    cache positions >= kv_len.  ``q_chunk`` / ``kv_chunk`` size the
    reference's jnp loop; the kernel tiles itself, so they are unused.
    """
    return ops.attention(q, k, v, causal=causal, window=window,
                         use_kernel=True, q_offset=q_offset, kv_len=kv_len)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE; logits (..., vocab), labels int (...,).  On a
    mesh the logits keep their batch shards and gather the rest (the
    vocabulary) before the lookup of each label; the mean reduces across
    the batch shards."""
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate, Shard
        mesh = logits.device_mesh
        pl = tuple(p if p == Shard(0) else Replicate()
                   for p in logits.placements)
        logits = logits.redistribute(mesh, pl)
        if is_dtensor(labels):
            labels = labels.redistribute(mesh, pl)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    loss = torch.mean(lse - picked)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
