"""Device mapping and routing engine (DeepFlow paper §5.2).

Maps the transformed (super-)graph onto the *system graph* — a (possibly
hierarchical) torus of hardware nodes — and derives the effective bandwidth
of every communication operation:

  * greedy dimension-ordered mapping: walk the parallel dims in a chosen
    order, laying shards onto adjacent hardware nodes, wrapping around to the
    next torus dim when one fills; all permutations of the parallel dims are
    tried and the best (lowest estimated comm cost) is kept (paper: 4! = 24);
  * X-Y (dimension-ordered) routing to map logical edges to physical paths;
  * link sharing: a physical link shared by E logical edges has its
    bandwidth derated by E (paper §6.4).

Collectives are modelled as ring algorithms along their parallel axis (the
paper's DP/KP transformation wires rings/tori), with per-hop distance taken
from the mapping: time(allreduce, S, p) = 2 (p-1)/p * S / bw_eff + lat terms.

`place()` and the mapping search run host-side NumPy once per skeleton;
`comm_time` / `Placement.effective_bw` are pure arithmetic in the
MicroArch's numeric leaves (Python floats or float32 tensors on the
MicroArch's device), so one placement serves many hardware points and
autograd flows through them for the SOE's exact gradients.  `SystemGraph`
is frozen / hashable because it is part of prediction-cache keys.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.age import MicroArch
from repro_torch.core.parallelism import Strategy
from repro_torch.core.tensors import div


@dataclasses.dataclass(frozen=True)
class SystemGraph:
    """A hierarchical torus: `dims` per-level node counts (innermost last).

    `level_of_dim` tags each torus dim with the network level that its links
    belong to: "intra" (in-package / ICI) or "inter" (between packages / DCN).
    """

    dims: Tuple[int, ...] = (16, 16)
    levels: Tuple[str, ...] = ("inter", "inter")

    @property
    def n_nodes(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def coords(self, rank: int) -> Tuple[int, ...]:
        cs = []
        for d in reversed(self.dims):
            cs.append(rank % d)
            rank //= d
        return tuple(reversed(cs))

    def torus_distance(self, a: int, b: int) -> int:
        ca, cb = self.coords(a), self.coords(b)
        hops = 0
        for x, y, d in zip(ca, cb, self.dims):
            delta = abs(x - y)
            hops += min(delta, d - delta)
        return hops


def single_pod_system(side: int = 16) -> SystemGraph:
    return SystemGraph(dims=(side, side), levels=("inter", "inter"))


def multi_pod_system(pods: int = 2, side: int = 16) -> SystemGraph:
    return SystemGraph(dims=(pods, side, side),
                       levels=("pod", "inter", "inter"))


def mesh_system(mesh_shape: Tuple[int, ...]) -> SystemGraph:
    """SystemGraph for a runtime mesh shape: 3-d meshes are multi-pod
    (pod dim on the slower fabric); 1-/2-d meshes are tori of the same
    dims, so the system node count always equals the mesh device count."""
    if len(mesh_shape) == 3:
        return SystemGraph(dims=tuple(mesh_shape),
                           levels=("pod", "inter", "inter"))
    return SystemGraph(dims=tuple(mesh_shape),
                       levels=("inter",) * len(mesh_shape))


@dataclasses.dataclass
class AxisMapping:
    """Where one parallel axis landed in physical space."""

    axis: str
    degree: int
    ring_hop_distance: float        # mean physical hops between ring neighbours
    link_sharing: float             # logical edges per physical link
    level: str                      # "intra" | "inter" | "pod"


@dataclasses.dataclass
class Placement:
    system: SystemGraph
    strategy: Strategy
    order: Tuple[str, ...]
    axis_maps: Dict[str, AxisMapping]

    def effective_bw(self, arch: MicroArch, axis: str,
                     pod_bw: Optional[float] = None) -> Tuple[float, float]:
        """(effective bytes/s per ring direction, per-hop latency) for an axis."""
        am = self.axis_maps[axis]
        if am.level == "pod":
            bw = pod_bw if pod_bw is not None else arch.net_inter_bw * 0.5
            lat = arch.net_inter_latency * 4.0
        elif am.level == "intra":
            bw, lat = arch.net_intra_bw, arch.net_intra_latency
        else:
            bw, lat = arch.net_inter_bw, arch.net_inter_latency
        # wormhole-routed ring: an edge's bandwidth is limited by its most
        # contended link; with stride-s embedding, hop distance == #rings
        # sharing each link, so the derate is max(hop, sharing), not the
        # product (each of `hop` links carries `sharing` edges in parallel).
        derate = max(am.ring_hop_distance, am.link_sharing, 1.0)
        return div(bw, derate), lat * max(am.ring_hop_distance, 1.0)


_PARALLEL_AXES = ("kp2", "kp1", "dp", "lp")


def _axis_degrees(s: Strategy) -> Dict[str, int]:
    return {"kp2": s.kp2, "kp1": s.kp1, "dp": s.dp, "lp": s.lp}


def _map_order(system: SystemGraph, s: Strategy,
               order: Sequence[str]) -> Dict[str, AxisMapping]:
    """Lay out axes along the linearized torus in `order`; derive per-axis
    ring-neighbour distance and sharing from strides (X-Y routed)."""
    degrees = _axis_degrees(s)
    maps: Dict[str, AxisMapping] = {}
    stride = 1
    for axis in order:
        deg = degrees[axis]
        if deg == 1:
            maps[axis] = AxisMapping(axis, 1, 0.0, 1.0, "inter")
            continue
        # ring neighbours are `stride` ranks apart in the linearization;
        # distance = torus hops between rank 0 and rank `stride`.
        samples = []
        for i in range(min(deg, 8)):
            a = (i * stride) % system.n_nodes
            b = ((i + 1) * stride) % system.n_nodes
            samples.append(system.torus_distance(a, b))
        hop = float(np.mean(samples)) if samples else 1.0
        # multi-hop neighbours force `hop` rings through shared links
        sharing = max(hop, 1.0)
        # which network level carries this axis: the OUTERMOST torus dim
        # the axis occupies decides (links of outer dims are the slower
        # fabric: pod > inter > intra in the hierarchy).
        span = stride * deg
        cums = [1]
        for d in reversed(system.dims):
            cums.append(cums[-1] * d)
        level = "inter"
        for i in range(len(system.dims)):          # i = 0 -> innermost dim
            lo, hi = cums[i], cums[i + 1]
            if stride < hi and span > lo:          # axis overlaps dim i
                level = system.levels[len(system.dims) - 1 - i]
        if level not in ("pod", "inter", "intra"):
            level = "inter"
        maps[axis] = AxisMapping(axis, deg, hop, sharing, level)
        stride *= deg
    # ep/sp reuse the kernel-parallel placement
    kp_map = maps.get("kp1") if s.kp1 >= s.kp2 else maps.get("kp2")
    base = kp_map or AxisMapping("kp", 1, 1.0, 1.0, "inter")
    maps["ep"] = dataclasses.replace(base, axis="ep", degree=max(s.ep, 1))
    maps["sp"] = dataclasses.replace(base, axis="sp", degree=max(s.sp, 1))
    return maps


def _mapping_cost(maps: Dict[str, AxisMapping],
                  traffic_weight: Dict[str, float]) -> float:
    """Estimated comm cost: sum over axes of traffic * derate (for ranking
    the 24 orderings)."""
    cost = 0.0
    for axis, w in traffic_weight.items():
        am = maps.get(axis)
        if am is None or am.degree <= 1:
            continue
        cost += w * max(am.ring_hop_distance, 1.0) * max(am.link_sharing, 1.0)
    return cost


def place(system: SystemGraph, strategy: Strategy,
          traffic_weight: Optional[Dict[str, float]] = None) -> Placement:
    """Greedy mapping, all (<=24) axis orderings tried (paper §5.2)."""
    tw = traffic_weight or {"kp2": 4.0, "kp1": 4.0, "dp": 2.0, "lp": 1.0}
    best: Optional[Tuple[float, Tuple[str, ...], Dict[str, AxisMapping]]] = None
    for order in itertools.permutations(_PARALLEL_AXES):
        maps = _map_order(system, strategy, order)
        cost = _mapping_cost(maps, tw)
        if best is None or cost < best[0]:
            best = (cost, order, maps)
    assert best is not None
    return Placement(system=system, strategy=strategy, order=best[1],
                     axis_maps=best[2])


# ---------------------------------------------------------------------------
# Collective timing (ring algorithms on the mapped axes)
# ---------------------------------------------------------------------------


def comm_time(arch: MicroArch, placement: Placement, comm: str,
              size_bytes: float, axis: str, participants: int,
              pod_bw: Optional[float] = None, parallel_rings: int = 2):
    """Time one communication op. `size_bytes` is the per-participant payload
    (all-reduce: full gradient buffer; all-gather: the local shard).
    `parallel_rings`: bidirectional torus rings split the payload (NCCL /
    ICI both run >= 2 concurrent rings per axis)."""
    p = max(int(participants), 1)
    if p == 1 or size_bytes <= 0:
        return 0.0
    bw, lat = placement.effective_bw(arch, axis, pod_bw=pod_bw)
    bw = bw * max(parallel_rings, 1)
    steps = p - 1
    if comm == "allreduce":
        vol = 2.0 * steps / p * size_bytes
        return div(vol, bw) + 2.0 * steps * lat
    if comm in ("allgather", "reducescatter"):
        # allgather input is the local shard; total received = (p-1)*shard
        vol = steps * size_bytes if comm == "allgather" else \
            steps / p * size_bytes
        return div(vol, bw) + steps * lat
    if comm == "alltoall":
        vol = steps / p * size_bytes
        return div(vol, bw) + steps * lat
    if comm == "p2p":
        return div(size_bytes, bw) + lat
    raise ValueError(comm)
