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


def _gather_one(t):
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if name in DP_AXES else p for name, p in
               zip(t.device_mesh.mesh_dim_names, t.placements))
    if pl == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def gather_dp(tree, keep=()):
    """Parameters ready for use: each DTensor leaf's shards over the DP
    axes (``fsdp`` -> ``data``: ZeRO-style storage) gathered, its shards
    over ``model`` (tensor parallelism) kept; GSPMD's gather of an
    FSDP-sharded weight before its product.  The gradient goes back to
    the stored layout as a reduce-scatter.  Plain tensors as they are, and
    the subtrees under a key in ``keep`` as they are stored (their
    module moves them itself)."""
    if keep and isinstance(tree, dict):
        return {k: v if k in keep else gather_dp(v, keep)
                for k, v in tree.items()}
    return tree_map(_gather_one, tree)


def tied_table(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A tied embedding table ready for its lookup and the head alike
    where no gradient reaches it (serving): on a mesh each rank's shard
    cast to ``dtype`` (as `lookup` and `head_logits` cast it) and the DP
    shards gathered once (`gather_dp`), so that the head takes the
    lookup's gather.  A plain tensor, or one a gradient reaches, as it
    is."""
    if not is_dtensor(table) or (torch.is_grad_enabled()
                                 and table.requires_grad):
        return table
    return _gather_one(table.to(dtype))


def layer_params(tree, i: int, keep=()):
    """Layer ``i``'s parameters from a stacked tree, ready for use
    (`gather_dp`: one layer gathered at a time, ``keep`` as stored)."""
    return gather_dp(tree_index(tree, i), keep)


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An LM head's ``x @ w`` in x's dtype, ``w`` (d, vocab).  On a mesh
    ``w`` is cast on each rank's shard, then put in its rule's layout with
    d whole (the vocabulary split where the rule splits it, over
    ``model``), and ``x`` is made whole on d and on each mesh dim that
    splits the vocabulary (a partial sum there reduced first); the
    product runs on the local shards, so the logits come out split as the
    vocabulary is, whatever DTensor's strategies, and no rank holds a
    whole vocabulary row.  In the backward, ``x``'s gradient is a partial
    sum over the vocabulary's shards and ``w``'s over the rows'."""
    w = w.to(x.dtype)
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    vocab = tuple(p == Shard(1) for p in w.placements)
    xpl = tuple(Replicate() if v or not p.is_shard() or p.dim == last else p
                for v, p in zip(vocab, x.placements))
    xl = x.redistribute(mesh, xpl).to_local(grad_placements=tuple(
        Partial() if v else p for v, p in zip(vocab, xpl)))
    wl = w.redistribute(mesh, tuple(
        Shard(1) if v else Replicate() for v in vocab)).to_local(
        grad_placements=tuple(Shard(1) if v else Partial() if p.is_shard()
                              else Replicate() for v, p in zip(vocab, xpl)))
    return DTensor.from_local(xl @ wl, mesh, tuple(
        Shard(last) if v else p for v, p in zip(vocab, xpl)),
        run_check=False)


def residual(x: torch.Tensor, r: torch.Tensor, rules, mesh) -> torch.Tensor:
    """``x + r``, ``r`` first put in the residual stream's layout (on a
    mesh: a row-parallel product's partial sums reduced), so that the
    stream stays whole on d, as the reference's compiler keeps it,
    whatever DTensor's strategies for the sum."""
    return x + logical(r, ("batch", "act_seq", "act_embed"), rules, mesh)


def pairs_weights(rows: int, k: int) -> bool:
    """How `swiglu` brings each rank's halves together on a mesh: True
    moves the weight's columns (``k`` x 2f/M elements a rank, and their
    gradient back), False the product's (``rows`` x 2f/M); the fewer."""
    return rows > k


def swiglu_split(w: torch.Tensor) -> Tuple[Optional[int], bool]:
    """(the one mesh dim that splits the last dim of ``w``, a swiglu
    weight stored [u | g], over more than one rank, or None where none
    or several do; whether its ranks divide f, so that each can hold the
    same slice of u and g)."""
    if not is_dtensor(w):
        return None, False
    from torch.distributed.tensor import Shard
    mesh, last = w.device_mesh, w.ndim - 1
    dims = [i for i, p in enumerate(w.placements)
            if p == Shard(last) and mesh.size(i) > 1]
    if len(dims) != 1:
        return None, False
    return dims[0], (w.shape[-1] // 2) % mesh.size(dims[0]) == 0


def pair_halves(t: torch.Tensor, mesh, i: int) -> torch.Tensor:
    """Each rank's shard of a last dim [u | g] that mesh dim ``i`` splits
    evenly (M ranks, rank m holding blocks 2m and 2m + 1 of the 2M
    blocks of f / M) made [u_m | g_m], the m-th blocks of u and g: one
    all-to-all over that dim, each rank sending block j to rank j mod M
    and receiving its two from ranks m // 2 and (M + m) // 2, in that
    order.  The gradient goes back the same way."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    n, m = mesh.size(i), mesh.get_local_rank(i)
    c = t.shape[-1] // 2
    blocks = t.movedim(-1, 0)
    dst = [(2 * m) % n, (2 * m + 1) % n]
    if dst[0] > dst[1]:                 # sent in the order of their ranks
        blocks = torch.cat([blocks[c:], blocks[:c]])
    send, recv = [0] * n, [0] * n
    for r in dst:
        send[r] += c
    recv[m // 2] += c
    recv[(n + m) // 2] += c
    out = all_to_all_single_autograd(blocks.contiguous(), recv, send,
                                     mesh.get_group(i))
    return out.movedim(0, -1)


def swiglu_paired(h, i: int, paired: bool):
    """swiglu's ``silu(g) * u`` of a product DTensor ``h`` whose last dim,
    [u | g], mesh dim ``i`` splits evenly (`swiglu_split`), on each
    rank's shard: made [u_m | g_m] first (`pair_halves`) unless
    ``paired`` (the weight's columns were, so the shard already is); the
    result is split over f on ``i`` as wo's rows are, h's other
    placements kept (none a partial sum)."""
    hl = h.to_local()
    if not paired:
        hl = pair_halves(hl, h.device_mesh, i)
    return _swiglu_local(hl, h.device_mesh, h.placements, h.shape)


def _swiglu_local(hl, mesh, placements, shape):
    """The DTensor of global ``shape`` less half its last dim whose
    shards are swiglu of each rank's [u_m | g_m] ``hl``."""
    from torch.distributed.tensor import DTensor
    u, g = torch.chunk(hl, 2, dim=-1)
    out = (*shape[:-1], shape[-1] // 2)
    return DTensor.from_local(activation("swiglu", g) * u, mesh, placements,
                              run_check=False, shape=torch.Size(out),
                              stride=_contiguous(out))


def swiglu(x: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """swiglu's ``silu(g) * u`` of ``x @ wi``, ``wi`` (d, 2f) stored
    [u | g] (in x's dtype).  On a mesh where one mesh dim of M ranks
    splits wi's columns and M divides f, each rank computes u and g for
    the same m-th slice of f and nothing is gathered: x is made whole on
    d and on that dim (its token shards kept), and `pairs_weights`
    chooses whether the rank's columns of wi are paired before the
    product (`pair_halves`) or the product's after (`swiglu_paired`);
    the result comes out split over f there, as wo's rows are.  x's
    gradient is then a partial sum over that dim and wi's over x's token
    shards, each reduced to its stored layout.  Where M does not divide
    f, the product is made whole there (replicated, as `logical` does
    with a dim its devices do not divide)."""
    if not (is_dtensor(x) and is_dtensor(wi)):
        return _swiglu_whole(x @ wi)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    i, even = swiglu_split(wi)
    if not even:
        return _swiglu_whole(x @ wi)
    xpl = tuple(Replicate() if j == i or not p.is_shard() or p.dim == last
                else p for j, p in enumerate(x.placements))
    x = x.redistribute(mesh, xpl)
    hpl = tuple(Shard(last) if j == i else p for j, p in enumerate(xpl))
    if not pairs_weights(x.to_local().numel() // x.shape[-1], wi.shape[0]):
        return swiglu_paired((x @ wi).redistribute(mesh, hpl), i, False)
    wpl = tuple(p if j == i else Replicate()
                for j, p in enumerate(wi.placements))
    wl = wi.redistribute(mesh, wpl).to_local(grad_placements=tuple(
        p if j == i else Partial() if xp.is_shard() else Replicate()
        for j, (p, xp) in enumerate(zip(wpl, xpl))))
    xl = x.to_local(grad_placements=tuple(
        Partial() if j == i else p for j, p in enumerate(xpl)))
    return _swiglu_local(xl @ pair_halves(wl, mesh, i), mesh, hpl,
                         (*x.shape[:-1], wi.shape[-1]))


def ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, kind: str,
        rules=None, mesh=None) -> torch.Tensor:
    """An FFN, ``act(x @ wi) @ wo`` (swiglu: `swiglu`), the weights cast
    to x's dtype; on a mesh the hidden activations in the ``mlp`` layout
    and both products on the ``model`` shards (`swiglu`,
    `row_parallel`)."""
    wi = wi.to(x.dtype)
    h = swiglu(x, wi) if kind == "swiglu" else activation(kind, x @ wi)
    h = logical(h, ("batch", "act_seq", "mlp"), rules, mesh)
    return row_parallel(h, wo.to(x.dtype))


def row_parallel(h: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """A block's output projection ``h @ wo`` (the FFN's down-projection,
    attention's out), ``wo`` (f, d) in h's dtype.  On a mesh where one
    mesh dim splits wo's rows evenly and h's last dim alike or not at all
    (heads that the dim does not divide: h whole there), h takes that
    split (a local slice: its gradient is gathered back) and the product
    runs on the local shards, a partial sum over that dim for the
    residual add to reduce (`residual`): its backward stays on the shards
    too, whatever DTensor's strategies.  wo's gradient is a partial sum
    over h's token shards.  Otherwise DTensor's product."""
    if not (is_dtensor(h) and is_dtensor(wo)):
        return h @ wo
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = h.device_mesh, h.ndim - 1
    rows = [j for j, p in enumerate(wo.placements)
            if p == Shard(0) and mesh.size(j) > 1]
    if len(rows) != 1 or wo.shape[0] % mesh.size(rows[0]) or \
            h.placements[rows[0]] not in (Replicate(), Shard(last)) or \
            any(p.is_partial() or (p == Shard(last) and j != rows[0])
                for j, p in enumerate(h.placements)):
        return h @ wo
    i = rows[0]
    h = h.redistribute(mesh, tuple(Shard(last) if j == i else p
                                   for j, p in enumerate(h.placements)))
    wl = wo.redistribute(mesh, tuple(
        Shard(0) if j == i else Replicate() for j in range(mesh.ndim))
    ).to_local(grad_placements=tuple(
        Shard(0) if j == i else Partial() if p.is_shard() else Replicate()
        for j, p in enumerate(h.placements)))
    shape = (*h.shape[:-1], wo.shape[-1])
    return DTensor.from_local(
        h.to_local() @ wl, mesh,
        tuple(Partial() if j == i else p for j, p in enumerate(h.placements)),
        run_check=False, shape=torch.Size(shape), stride=_contiguous(shape))


def _contiguous(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return tuple(stride)


def _swiglu_whole(h: torch.Tensor) -> torch.Tensor:
    """swiglu of a product's halves (on a mesh DTensor's chunk, which
    gathers a split last dim)."""
    u, g = torch.chunk(h, 2, dim=-1)
    return activation("swiglu", g) * u


def lookup(table: torch.Tensor, tokens: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows ``table[tokens]``, in ``dtype`` where given; on a mesh (a
    DTensor table, the vocabulary possibly sharded) the embedding lookup,
    which gives the same rows.  There, where no gradient reaches the
    table (serving), each rank casts its shard first, so the table's
    gather moves ``dtype``: a cast commutes with a lookup, so the rows
    are the same (a gradient would accumulate in ``dtype``, so training
    gathers the stored dtype)."""
    if not is_dtensor(table):
        rows = table[tokens.long()]
    else:
        from repro_torch.parallel import shards
        if dtype is not None and not (torch.is_grad_enabled()
                                      and table.requires_grad):
            table = table.to(dtype)
        rows = shards.embedding(table, tokens)
    return rows if dtype is None else rows.to(dtype)


def split_last(y: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``y.reshape(*y.shape[:-1], n, size)``: the last dim split into
    ``n`` heads of ``size``.  On a mesh, where the last dim's shards do not
    divide ``n`` (8 kv heads on a 16-way ``model`` axis), it is gathered
    first: DTensor splits a sharded dim only into whole heads per rank."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        last = y.ndim - 1
        k = 1
        for i, p in enumerate(y.placements):
            if p == Shard(last):
                k *= y.device_mesh.size(i)
        if n % k:
            y = y.redistribute(y.device_mesh, tuple(
                Replicate() if p == Shard(last) else p
                for p in y.placements))
    return y.reshape(*y.shape[:-1], n, size)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)``; on a mesh as its two slices joined
    (not every torch's DTensor has a rule for ``roll``), ``dim`` being one
    the placements do not shard."""
    if not is_dtensor(x):
        return torch.roll(x, shift, dims=dim)
    n = x.shape[dim]
    shift %= n
    if not shift:
        return x
    return torch.cat([x.narrow(dim, n - shift, shift),
                      x.narrow(dim, 0, n - shift)], dim=dim)


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
    it and never write it.  A table for fake tensors (the dry-run's) is
    made anew and never cached."""
    dev = torch.device(device)
    from torch._guards import detect_fake_mode
    if dev.type == "meta" or detect_fake_mode() is not None:
        return _sinusoidal(seq, d, "cpu").to(dev)
    return _sinusoidal(seq, d, str(dev))


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
    mesh, `_sharded_cross_entropy`."""
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    loss = torch.mean(lse - picked)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _sharded_cross_entropy(logits, labels, z_loss: float):
    """`cross_entropy` of DTensor logits, vocabulary-parallel: each rank
    keeps its shard of the logits (rows and vocabulary), and where the
    vocabulary is split over more than one rank the rows' max (no
    gradient), sum of exponentials and label logit are summed across its
    shards, so no rank holds a whole row of the vocabulary or its
    gradient: lse = max + log(sum exp(x - max)), the one-device value up
    to the order of the sums.  Where each rank holds whole rows, the
    one-device formula runs on them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.parallel import shards
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    pl = tuple(p if isinstance(p, Shard) else Replicate()
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    rows = tuple(Replicate() if p == Shard(vdim) else p for p in pl)

    def across_vocab(local, op):
        parts = tuple(Partial(op) if p == Shard(vdim) else r
                      for p, r in zip(pl, rows))
        return DTensor.from_local(local, mesh, parts, run_check=False
                                  ).redistribute(mesh, rows).to_local()

    local = logits.to_local(grad_placements=pl).float()
    lab = shards.to_placements(labels, mesh, rows).to_local().long()
    if not any(p == Shard(vdim) and mesh.size(i) > 1
               for i, p in enumerate(pl)):
        # each rank holds whole rows: the one-device formula on them
        lse = torch.logsumexp(local, dim=-1)
        picked = torch.gather(local, -1, lab[..., None]).squeeze(-1)
    else:
        start, n = shards._offset(mesh, pl, vdim, logits.shape[vdim])
        lab = lab - start
        valid = (lab >= 0) & (lab < n)
        m = across_vocab(local.detach().amax(-1), "max")
        lse = m + torch.log(across_vocab(
            torch.exp(local - m[..., None]).sum(-1), "sum"))
        picked = torch.gather(local, -1, lab.clamp(0, n - 1)[..., None]
                              ).squeeze(-1) * valid.to(local.dtype)
        picked = across_vocab(picked, "sum")
    loss = torch.mean(DTensor.from_local(lse - picked, mesh, rows,
                                         run_check=False))
    if z_loss:
        loss = loss + z_loss * torch.mean(DTensor.from_local(
            torch.square(lse), mesh, rows, run_check=False))
    return loss
