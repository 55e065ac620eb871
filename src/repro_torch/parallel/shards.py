"""The hand-written kernels on a mesh: each rank launches the kernel on its
own shards.

The kernels' wrappers pass ``data_ptr()`` to ctypes, which a DTensor has
no sharding rule for.  So on the mesh path `repro_torch.kernels.ops`
hands DTensor inputs here: each input is redistributed so that only the
dims the kernel treats independently are sharded (batch and heads for
attention and the mLSTM, batch and channels for the scan), each mesh dim
that shards neither splitting the heads or channels where they divide
(so no two ranks launch on the same rows), the rank's local tensors go
to the wrapper (the kernel on the card, its plain version on the host),
and the local result comes back as a DTensor of the same placements
(``to_local`` / ``from_local``, both differentiable).  No input is
gathered to its full size: a dim the kernel needs whole (the sequence,
the head dim) is replicated only where it was sharded.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor


def _keep(placements, dims) -> Tuple:
    """``placements`` with every shard of a dim outside ``dims``
    replicated (a ``Partial`` is reduced)."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else
                 Replicate() for p in placements)


def _spread(x, dims, split: int) -> Tuple:
    """The placements a kernel input ``x`` is taken in: its shards of
    ``dims`` (the dims the kernel treats independently) kept, and each
    other mesh dim of more than one rank split over dim ``split`` (heads,
    channels) where that divides, so that no two ranks launch on the same
    rows.  A ``Partial`` (a row-parallel product's output, as the
    residual stream after a block is) is so reduce-scattered, a replica
    cut locally; where ``split`` does not divide, both are replicated."""
    out = list(_keep(x.placements, dims))
    mesh, size = x.device_mesh, x.shape[split]
    for i, p in enumerate(out):
        n = math.prod(mesh.size(j) for j, o in enumerate(out)
                      if o == Shard(split))
        if p == Replicate() and mesh.size(i) > 1 and \
                size % (n * mesh.size(i)) == 0:
            out[i] = Shard(split)
    return tuple(out)


def to_placements(x, mesh, placements) -> DTensor:
    """``x`` on ``placements``: a DTensor redistributed, a plain tensor
    (the same on every rank) cut to the rank's shard."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _offset(mesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """(the rank's first index along ``dim``, the shard's length) for a
    dim of ``size`` sharded evenly as ``placements`` say."""
    n, start = 1, 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            k = mesh.size(i)
            start = start * k + mesh.get_local_rank(i)
            n *= k
    return start * (size // n), size // n


def attention(q, k, v, **kw) -> DTensor:
    """``ops.attention(..., use_kernel=True)`` on each rank's batch rows and
    q heads.  k/v follow q's head shards where the kv heads divide them;
    otherwise they are replicated over those mesh dims and each rank takes
    the kv head of each of its q heads (GQA's ``head // group``), so the
    local call has one kv head per q head."""
    from repro_torch.kernels import ops
    mesh = q.device_mesh
    pl = _spread(q, (0, 1), 1)
    q = q.redistribute(mesh, pl)
    h, h_kv = q.shape[1], k.shape[1]
    n_heads = math.prod(mesh.size(i) for i, p in enumerate(pl)
                        if p == Shard(1))
    if h_kv % n_heads == 0:
        k, v = to_placements(k, mesh, pl), to_placements(v, mesh, pl)
        kl, vl = k.to_local(), v.to_local()
    else:
        kvp = tuple(Replicate() if p == Shard(1) else p for p in pl)
        # each rank reads the kv heads of its q heads: Partial gradients
        gpl = tuple(Partial() if p == Shard(1) else p for p in pl)
        kl = to_placements(k, mesh, kvp).to_local(grad_placements=gpl)
        vl = to_placements(v, mesh, kvp).to_local(grad_placements=gpl)
        start, hl = _offset(mesh, pl, 1, h)
        idx = (start + torch.arange(hl, device=kl.device)) // (h // h_kv)
        kl, vl = kl.index_select(1, idx), vl.index_select(1, idx)
    out = ops.attention(q.to_local(), kl, vl, use_kernel=True, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def rglru_scan(a, b, h0) -> DTensor:
    """``ops.rglru_scan(..., use_kernel=True)`` on each rank's batch rows
    and channels: a/b (batch, seq, width), h0 (batch, width)."""
    from repro_torch.kernels import ops
    mesh = a.device_mesh
    pl = _spread(a, (0, 2), 2)
    a, b = a.redistribute(mesh, pl), to_placements(b, mesh, pl)
    hpl = tuple(Shard(1) if p == Shard(2) else p for p in pl)
    h0 = to_placements(h0, mesh, hpl)
    out = ops.rglru_scan(a.to_local(), b.to_local(), h0.to_local(),
                         use_kernel=True)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def mlstm(q, k, v, f_cum, log_i, **kw) -> DTensor:
    """``ops.mlstm(..., use_kernel=True)`` on each rank's batch rows and
    heads: q/k/v (b, h, s, d), f_cum/log_i (b, h, s)."""
    from repro_torch.kernels import ops
    mesh = q.device_mesh
    pl = _spread(q, (0, 1), 1)
    local = [to_placements(t, mesh, pl).to_local()
             for t in (q, k, v, f_cum, log_i)]
    out = ops.mlstm(*local, use_kernel=True, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def embedding(table, tokens) -> DTensor:
    """Rows ``table[tokens]`` with the vocabulary sharded: each rank looks
    up the tokens of its batch shard that fall in its rows of the table
    (zeros elsewhere), and the rows are summed over the vocabulary's
    shards (a ``Partial``, reduced where the next op needs it).  The sum
    adds exact zeros, so the rows are the one-device lookup's."""
    mesh = table.device_mesh
    tpl = _keep(table.placements, (0,))
    table = table.redistribute(mesh, tpl)
    tok = tokens if isinstance(tokens, DTensor) else \
        to_placements(tokens, mesh, (Replicate(),) * mesh.ndim)
    kpl = tuple(Replicate() if t == Shard(0) else
                (p if p == Shard(0) else Replicate())
                for t, p in zip(tpl, tok.placements))
    tl = tok.redistribute(mesh, kpl).to_local().long()
    start, n = _offset(mesh, tpl, 0, table.shape[0])
    idx = tl - start
    valid = (idx >= 0) & (idx < n)
    # the table's gradient differs on ranks of other batch rows: Partial
    gpl = tuple(Partial() if k == Shard(0) else t for t, k in zip(tpl, kpl))
    rows = torch.nn.functional.embedding(
        idx.clamp(0, n - 1), table.to_local(grad_placements=gpl))
    rows = rows * valid[..., None].to(rows.dtype)
    opl = tuple(Shard(0) if k == Shard(0) else
                Partial() if t == Shard(0) else Replicate()
                for t, k in zip(tpl, kpl))
    return DTensor.from_local(rows, mesh, opl, run_check=False)
