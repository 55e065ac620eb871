"""Compute-graph structure transformation (DeepFlow paper §5.1).

Each parallelism strategy is a graph transformation:

  * data parallelism (d{DP}): every weight-gradient node gains a ring
    all-reduce across DP replicas (ring edges are cross-edges);
  * kernel parallelism RC-{KP1}-{KP2}: every GEMM node is replaced by a
    KP1 x KP2 torus of shard nodes — each shard computes an
    (m/KP1, n/KP2, k) block and activations are all-gathered along torus
    dims between consecutive GEMMs;
  * kernel parallelism CR-{KP1}: each shard computes an (m, n, k/KP1)
    outer-product partial and the outputs are all-reduced across KP1;
  * pipeline parallelism p{LP}: the graph is cut into LP stages; stage
    boundary edges become cross-edges (p2p activation sends).

Two materializations are provided:

  `shard_graph`       the scalable form used for large degrees: one
                      representative replica with per-shard kernel dims and
                      explicit `comm` nodes (the paper's §6.5 observation
                      that DP/KP replicas are homogeneous and deterministic
                      makes this sufficient for timing);
  `build_supergraph`  the explicit super-graph (every replica materialized,
                      rings/tori wired with cross-edges) — used for small
                      degrees and unit tests, faithful to paper Fig. 5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import ComputeGraph, Node
from repro_torch.core.parallelism import Strategy


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def shard_graph(g: ComputeGraph, strategy: Strategy,
                grad_bytes: Optional[float] = None) -> ComputeGraph:
    """Produce the one-replica sharded graph with comm nodes inserted.

    Node meta flags consumed here (set by repro_torch.core.lmgraph builders):
      shard_m / shard_n / shard_k : bool — which GEMM dims the KP strategy
          may shard for this node (e.g. recurrence GEMMs forbid k-sharding);
      weight : bool — node produces weight gradients (DP all-reduce target);
      moe    : bool — routed-expert GEMM (EP all-to-all dispatch inserted);
      no_kp  : bool — node not shardable by kernel parallelism at all.
    """
    s = strategy
    out = ComputeGraph(f"{g.name}|{s.name}")
    name_map: Dict[str, str] = {}
    total_grad_bytes = 0.0

    for name in g.topo_order():
        node = g.nodes[name]
        deps = [name_map[p] for p in dict.fromkeys(g.preds(name))]
        if node.kind == "gemm":
            meta = dict(node.meta)
            repeat = meta.get("repeat", 1)
            no_kp = meta.get("no_kp", False)
            kp1 = 1 if no_kp else s.kp1
            kp2 = 1 if no_kp else s.kp2
            b, m, n, k = node.b, node.m, node.n, node.k
            # data parallelism shards the batch-like dim (m for act GEMMs)
            bd = meta.get("batch_dim", "m")
            if not meta.get("no_dp"):
                if bd == "m":
                    m = _ceil_div(m, s.dp)
                elif bd == "b":
                    b = _ceil_div(b, s.dp)
                elif bd == "k":
                    k = _ceil_div(k, s.dp)
            if s.kind == "RC" and not no_kp:
                sm = _ceil_div(m, kp1) if meta.get("shard_m", True) else m
                sn = _ceil_div(n, kp2) if meta.get("shard_n", True) else n
                if meta.get("kp_b"):            # head-parallel batched GEMMs
                    b = _ceil_div(b, s.kp)
                sk = k
                # inner-product: gather the kp2-sharded activation first
                if meta.get("gather_act", True) and kp2 > 1:
                    ag = out.comm_op(f"{name}.ag", "allgather",
                                     size_bytes=float(sm) * sk / kp2
                                     * node.dtype_bytes * b,
                                     axis="kp2", participants=kp2, deps=deps)
                    ag.meta["repeat"] = repeat
                    deps = [ag.name]
                new = out.gemm(name, m=sm, n=sn, k=sk, b=b, deps=deps,
                               dtype_bytes=node.dtype_bytes, **meta)
            elif s.kind == "CR" and not no_kp:
                sk = _ceil_div(k, s.kp1) if meta.get("shard_k", True) else k
                new = out.gemm(name, m=m, n=n, k=sk, b=b, deps=deps,
                               dtype_bytes=node.dtype_bytes, **meta)
                if meta.get("shard_k", True) and s.kp1 > 1:
                    ar = out.comm_op(f"{name}.ar", "allreduce",
                                     size_bytes=float(m) * n * b
                                     * node.dtype_bytes,
                                     axis="kp1", participants=s.kp1,
                                     deps=[name])
                    ar.meta["repeat"] = repeat
                    name_map[name] = ar.name
                    if meta.get("weight"):
                        total_grad_bytes += (float(m) * n * b
                                             * node.dtype_bytes * repeat)
                    continue
            else:
                new = out.gemm(name, m=m, n=n, k=k, b=b, deps=deps,
                               dtype_bytes=node.dtype_bytes, **meta)
            if meta.get("weight"):
                # a weight GEMM's parameter bytes ~ n*k (m is the token dim)
                total_grad_bytes += float(new.n) * new.k \
                    * node.dtype_bytes * repeat
            # MoE dispatch: tokens cross the EP group before/after the GEMM
            if meta.get("moe") and s.ep > 1:
                a2a = out.comm_op(f"{name}.a2a", "alltoall",
                                  size_bytes=float(new.m) * new.k
                                  * node.dtype_bytes,
                                  axis="ep", participants=s.ep, deps=[name])
                a2a.meta["repeat"] = repeat
                name_map[name] = a2a.name
                continue
        elif node.kind == "elementwise":
            n_elems = _ceil_div(node.n_elems, s.dp * max(s.kp, 1))
            out.elementwise(name, n_elems=n_elems,
                            flops_per_elem=node.flops_per_elem, deps=deps,
                            dtype_bytes=node.dtype_bytes, **node.meta)
        elif node.kind == "gather":
            out.gather(name, rows=_ceil_div(node.rows, s.dp),
                       width=_ceil_div(node.width, max(s.kp, 1)), deps=deps,
                       dtype_bytes=node.dtype_bytes)
        elif node.kind == "comm":
            out.comm_op(name, node.comm, node.comm_bytes, node.comm_axis,
                        node.comm_participants, deps=deps)
        else:
            raise ValueError(node.kind)
        name_map[name] = name

    # data-parallel gradient exchange (ring all-reduce across DP replicas)
    if s.dp > 1:
        gb = grad_bytes if grad_bytes is not None else total_grad_bytes
        if gb > 0:
            sinks = [n for n in out.nodes
                     if not out.succs(n)] or list(out.nodes)[-1:]
            out.comm_op("grad.allreduce", "allreduce", size_bytes=float(gb),
                        axis="dp", participants=s.dp, deps=sinks[-1:])
    out.validate()
    return out


# ---------------------------------------------------------------------------
# Explicit super-graph (paper Fig. 5) — small degrees / unit tests
# ---------------------------------------------------------------------------


def build_supergraph(g: ComputeGraph, strategy: Strategy) -> ComputeGraph:
    """Materialize every replica: pipeline cut -> DP rings -> KP tori.

    Replica naming: ``<node>@p<stage>d<rep>r<row>c<col>``. Ring/torus edges
    are cross-edges. Feasible for small degree products (tests use <= 48).
    """
    s = strategy
    if s.devices > 4096:
        raise ValueError("explicit super-graph is for small degrees; "
                         "use shard_graph for large systems")
    out = ComputeGraph(f"{g.name}|super|{s.name}")
    order = g.topo_order()
    stages = _cut_stages(g, order, s.lp)

    def rep_name(base: str, p: int, d: int, r: int, c: int) -> str:
        return f"{base}@p{p}d{d}r{r}c{c}"

    for d in range(s.dp):
        for p, stage_nodes in enumerate(stages):
            for name in stage_nodes:
                node = g.nodes[name]
                for r in range(s.kp1):
                    for c in range(s.kp2):
                        nn = dataclasses.replace(
                            node, name=rep_name(name, p, d, r, c))
                        if node.kind == "gemm":
                            nn.m = _ceil_div(_ceil_div(node.m, s.dp), s.kp1)
                            nn.n = _ceil_div(node.n, s.kp2)
                        dev = (((p * s.dp) + d) * s.kp1 + r) * s.kp2 + c
                        nn.device = dev
                        out.add(nn)
                        # intra-replica deps
                        for pred in dict.fromkeys(g.preds(name)):
                            pred_stage = _stage_of(stages, pred)
                            pn = rep_name(pred, pred_stage, d, r, c)
                            if pn in out.nodes:
                                out.connect(pn, nn.name,
                                            cross=pred_stage != p)
                        # KP torus cross-edges (activation redistribution)
                        if node.kind == "gemm" and (s.kp1 > 1 or s.kp2 > 1):
                            for rr, cc in (((r + 1) % s.kp1, c),
                                           (r, (c + 1) % s.kp2)):
                                if (rr, cc) != (r, c):
                                    peer = rep_name(name, p, d, rr, cc)
                                    if peer in out.nodes:
                                        out.connect(nn.name, peer, cross=True)
        # DP ring cross-edges on gradient-bearing nodes
    if s.dp > 1:
        for p, stage_nodes in enumerate(stages):
            for name in stage_nodes:
                if not g.nodes[name].meta.get("weight"):
                    continue
                for d in range(s.dp):
                    for r in range(s.kp1):
                        for c in range(s.kp2):
                            a = rep_name(name, p, d, r, c)
                            bnode = rep_name(name, p, (d + 1) % s.dp, r, c)
                            if a in out.nodes and bnode in out.nodes:
                                out.connect(a, bnode, cross=True)
    return out


def _cut_stages(g: ComputeGraph, order: List[str], lp: int) -> List[List[str]]:
    """Cut the topo order into LP balanced stages by flop mass (paper §5.1:
    pipeline slices the original graph into sub-graphs)."""
    if lp <= 1:
        return [order]
    flops = [max(g.nodes[n].flops, 1.0) for n in order]
    total = sum(flops)
    target = total / lp
    stages, cur, acc = [], [], 0.0
    for name, f in zip(order, flops):
        cur.append(name)
        acc += f
        if acc >= target and len(stages) < lp - 1:
            stages.append(cur)
            cur, acc = [], 0.0
    stages.append(cur)
    while len(stages) < lp:
        stages.append([])
    return stages


def _stage_of(stages: List[List[str]], name: str) -> int:
    for i, st in enumerate(stages):
        if name in st:
            return i
    raise KeyError(name)


def stage_subgraphs(g: ComputeGraph, lp: int) -> List[ComputeGraph]:
    """Split into per-stage graphs (used by the pipeline-aware simulator)."""
    order = g.topo_order()
    stages = _cut_stages(g, order, lp)
    outs = []
    for i, names in enumerate(stages):
        sg = ComputeGraph(f"{g.name}|stage{i}")
        nameset = set(names)
        for n in names:
            node = g.nodes[n]
            deps = [p for p in dict.fromkeys(g.preds(n)) if p in nameset]
            sg.add(dataclasses.replace(node), deps)
        outs.append(sg)
    return outs
