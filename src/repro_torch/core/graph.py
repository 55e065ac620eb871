"""Compute-graph IR (DeepFlow paper §3, §5).

The ML model is described as a DAG of kernel nodes. CrossFlow transforms this
graph into a *super-graph* under a parallelism strategy (repro_torch.core.transform),
maps it onto the system graph (repro_torch.core.placement), times each node with the
hierarchical roofline (repro_torch.core.roofline) and each edge with the network
model, then runs event-driven simulation (repro_torch.core.simulate).

Node kinds and their cost semantics:

  gemm         batched GEMM  (b, m, n, k): flops = 2*b*m*n*k
  elementwise  n_elems elements, `flops_per_elem` each, rw bytes = in+out
  gather       embedding lookup: rows * width * dtype bytes moved, ~0 flops
  comm         a communication op (collective or p2p) — timed by the network
               model, not the roofline

Edges carry activation bytes; `cross=True` marks device-boundary edges
created by the graph transformation (paper Fig. 5, red edges).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

COMM_KINDS = ("allreduce", "allgather", "reducescatter", "alltoall", "p2p")


@dataclasses.dataclass
class Node:
    name: str
    kind: str                       # "gemm" | "elementwise" | "gather" | "comm"
    # gemm
    b: int = 1
    m: int = 0
    n: int = 0
    k: int = 0
    # elementwise / gather
    n_elems: int = 0
    flops_per_elem: float = 1.0
    rows: int = 0
    width: int = 0
    # comm
    comm: str = ""                  # one of COMM_KINDS
    comm_bytes: float = 0.0         # payload per participant
    comm_axis: str = ""             # logical parallel axis ("dp","kp1","kp2","lp","ep")
    comm_participants: int = 1
    dtype_bytes: int = 2
    # scheduling
    device: int = 0                 # assigned hardware node (after placement)
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        if self.kind == "gemm":
            return 2.0 * self.b * self.m * self.n * self.k
        if self.kind == "elementwise":
            return float(self.n_elems) * self.flops_per_elem
        return 0.0

    @property
    def io_bytes(self) -> float:
        """Minimum main-memory traffic (compulsory): inputs + outputs once."""
        s = self.dtype_bytes
        if self.kind == "gemm":
            return s * self.b * (self.m * self.k + self.k * self.n
                                 + self.m * self.n)
        if self.kind == "elementwise":
            return 2.0 * s * self.n_elems
        if self.kind == "gather":
            return s * self.rows * self.width * 2.0
        return 0.0


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    bytes: float = 0.0
    cross: bool = False             # crosses a device boundary
    meta: Dict = dataclasses.field(default_factory=dict)


class ComputeGraph:
    """A DAG of Nodes. Insertion order is required to be a valid topo order
    for the builders in repro_torch.core.lmgraph (asserted in `validate`)."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Edge] = []
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}
        self._fingerprint: Optional[str] = None

    # -- construction -----------------------------------------------------
    def add(self, node: Node, deps: Iterable[str] = (),
            dep_bytes: float = 0.0) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self._fingerprint = None
        self.nodes[node.name] = node
        self._succ.setdefault(node.name, [])
        self._pred.setdefault(node.name, [])
        for d in deps:
            self.connect(d, node.name, bytes=dep_bytes)
        return node

    def gemm(self, name: str, m: int, n: int, k: int, b: int = 1,
             deps: Iterable[str] = (), dtype_bytes: int = 2, **meta) -> Node:
        return self.add(Node(name, "gemm", b=b, m=m, n=n, k=k,
                             dtype_bytes=dtype_bytes, meta=meta), deps)

    def elementwise(self, name: str, n_elems: int, flops_per_elem: float = 1.0,
                    deps: Iterable[str] = (), dtype_bytes: int = 2,
                    **meta) -> Node:
        return self.add(Node(name, "elementwise", n_elems=int(n_elems),
                             flops_per_elem=flops_per_elem,
                             dtype_bytes=dtype_bytes, meta=meta), deps)

    def gather(self, name: str, rows: int, width: int,
               deps: Iterable[str] = (), dtype_bytes: int = 2) -> Node:
        return self.add(Node(name, "gather", rows=rows, width=width,
                             dtype_bytes=dtype_bytes), deps)

    def comm_op(self, name: str, comm: str, size_bytes: float, axis: str,
                participants: int, deps: Iterable[str] = ()) -> Node:
        assert comm in COMM_KINDS, comm
        return self.add(Node(name, "comm", comm=comm, comm_bytes=size_bytes,
                             comm_axis=axis, comm_participants=participants),
                        deps)

    def connect(self, src: str, dst: str, bytes: float = 0.0,
                cross: bool = False) -> Edge:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"unknown edge endpoint {src}->{dst}")
        e = Edge(src, dst, bytes=bytes, cross=cross)
        self._fingerprint = None
        self.edges.append(e)
        self._succ[src].append(dst)
        self._pred[dst].append(src)
        return e

    # -- queries ----------------------------------------------------------
    def preds(self, name: str) -> List[str]:
        return self._pred[name]

    def succs(self, name: str) -> List[str]:
        return self._succ[name]

    def topo_order(self) -> List[str]:
        """Kahn topological order (stable w.r.t. insertion order)."""
        indeg = {n: len(set(self._pred[n])) for n in self.nodes}
        order, ready = [], [n for n in self.nodes if indeg[n] == 0]
        seen_edges = set()
        indeg = {n: 0 for n in self.nodes}
        for e in self.edges:
            if (e.src, e.dst) not in seen_edges:
                seen_edges.add((e.src, e.dst))
                indeg[e.dst] += 1
        ready = [n for n in self.nodes if indeg[n] == 0]
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for s in dict.fromkeys(self._succ[cur]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()

    def fingerprint(self) -> str:
        """Stable structural hash: node kinds/dims/meta + dependency wiring.

        Two graphs with the same fingerprint produce identical prediction
        traces, so this is the graph component of batched-evaluator and
        prediction-cache keys (repro_torch.core.pathfinder).  Memoized until the
        next structural mutation (add/connect) — sweep drivers call this
        once per point."""
        if self._fingerprint is not None:
            return self._fingerprint
        import hashlib
        h = hashlib.sha1()
        index = {n: i for i, n in enumerate(self.nodes)}
        for name, node in self.nodes.items():
            h.update(repr((
                node.kind, node.b, node.m, node.n, node.k, node.n_elems,
                node.flops_per_elem, node.rows, node.width, node.comm,
                node.comm_bytes, node.comm_axis, node.comm_participants,
                node.dtype_bytes, sorted(node.meta.items()),
                sorted(index[p] for p in set(self._pred[name])),
            )).encode())
        self._fingerprint = h.hexdigest()
        return self._fingerprint

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_io_bytes(self) -> float:
        return sum(n.io_bytes for n in self.nodes.values())

    def comm_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.kind == "comm"]

    def compute_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.kind != "comm"]

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        return (f"ComputeGraph({self.name!r}, nodes={len(self.nodes)}, "
                f"edges={len(self.edges)}, "
                f"flops={self.total_flops():.3e})")
