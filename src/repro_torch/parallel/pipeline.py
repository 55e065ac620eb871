"""Pipeline parallelism (the paper's LP axis): GPipe over a mesh's
``stage`` axis, as ``repro.parallel.pipeline``.

The layer stack is cut into S stages, one per index of the ``stage``
axis; microbatches stream through the stages over S + M - 1 ticks (the
reference's rotate-and-compute schedule).  At each tick every stage
applies its own parameters to what it holds, then passes the result to
the next stage with one ``batch_isend_irecv`` (send to stage i + 1,
receive from stage i - 1).  Stage 0 injects microbatch t at tick t; the
last stage finishes microbatch t - (S - 1).  At the end the last stage's
outputs go to every rank as the reference's mask + psum does (an
all-reduce of the outputs masked to the last stage).

The schedule runs forward only (serving, and the activations' check
against the sequential stack): the point-to-point sends carry no
gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def stage_params_split(params_stacked: Any, n_stages: int) -> Any:
    """Stacked layer params (L, ...) -> (S, L/S, ...)."""
    def r(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree_map(r, params_stacked)


def _stage_slice(p, stage_id: int):
    """This stage's parameters from a leaf of leading dim S: a DTensor
    sharded over the stage axis holds only its own (1, ...) slice."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        local = p.to_local()
        return local[0] if local.shape[0] == 1 else local[stage_id]
    return p[stage_id]


def gpipe(fn_stage: Callable, mesh, stage_axis: str = "stage",
          n_microbatches: int = 4) -> Callable:
    """Wrap ``fn_stage(stage_params, x) -> y`` (y shaped as x) into a GPipe
    pipeline over ``mesh``'s ``stage_axis``.

    Returns ``pipelined(params_staged, x_microbatched)``: leaves of
    ``params_staged`` have leading dim S (each rank reads its stage's
    slice), ``x_microbatched`` is (M, mb, ...) with M = ``n_microbatches``,
    the same on every rank; the result (M, mb, ...) too."""
    s = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    group = mesh.get_group(stage_axis)

    def pipelined(params_staged: Any, x_all: torch.Tensor) -> torch.Tensor:
        m = x_all.shape[0]
        if m != n_microbatches:
            raise ValueError(f"gpipe: {m} microbatches, built for "
                             f"{n_microbatches}")
        stage_id = mesh.get_local_rank(stage_axis)
        params = tree_map(lambda p: _stage_slice(p, stage_id), params_staged)
        nxt = dist.get_global_rank(group, (stage_id + 1) % s)
        prv = dist.get_global_rank(group, (stage_id - 1) % s)
        buf = torch.zeros_like(x_all[0])
        outs = torch.zeros_like(x_all)
        with torch.no_grad():
            for t in range(m + s - 1):
                x_in = x_all[min(t, m - 1)].to(buf.dtype) if stage_id == 0 \
                    else buf
                y = fn_stage(params, x_in)
                emit = t - (s - 1)
                if stage_id == s - 1 and emit >= 0:
                    outs[emit] = y.to(outs.dtype)
                if s > 1:               # rotate to the next stage
                    buf = torch.empty_like(y)
                    reqs = dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                        dist.P2POp(dist.irecv, buf, prv, group)])
                    for r in reqs:
                        r.wait()
                else:
                    buf = y
            if s > 1:                   # the last stage's outputs to all
                outs = outs * float(stage_id == s - 1)
                dist.all_reduce(outs, group=group)
        return outs

    return pipelined
