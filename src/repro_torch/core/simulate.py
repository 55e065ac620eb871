"""Event-driven end-to-end time estimation (DeepFlow paper §6.5) and the
top-level CrossFlow `predict` API.

Event-driven simulation = resource-constrained critical-path analysis.
Per the paper, simulation runs on the *original* (one-replica, sharded)
graph: DP/KP replicas are homogeneous and deterministic so their timing is
identical; only pipeline parallelism needs explicit (stage x microbatch)
event scheduling.

Resources per hardware node: one compute engine (<= k kernels at a time,
k=1) and one network engine; compute/comm overlap is a switch (default on —
matches both modern NCCL-style async collectives and XLA's latency-hiding
scheduler; CrossFlow's validation in the paper included overlapped NCCL).

Accumulation is float32 torch on the MicroArch's device: with a fixed
schedule order the accumulated times are differentiable w.r.t. MicroArch
parameters (used by the SOE and the calibration fit).

Serving (inference) mode: `serving_breakdown` combines a prefill-graph and
a decode-graph prediction into TTFT / TPOT / tokens-per-sec-per-device with
KV-cache memory-pressure derating; the scenario registry in
`repro_torch.core.scenarios` builds the phase graphs and drives it through the
batched pathfinding engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import placement as placement_lib
from repro_torch.core import roofline, transform
from repro_torch.core.age import MicroArch
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy
from repro_torch.core.placement import Placement, SystemGraph
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.tensors import div, maximum


@dataclasses.dataclass
class TimeBreakdown:
    total_s: object
    compute_s: object
    comm_s: object
    exposed_comm_s: object
    pipeline_bubble_s: object = 0.0
    per_node: Optional[Dict[str, object]] = None

    def as_floats(self) -> "TimeBreakdown":
        f = lambda x: float(x)
        return TimeBreakdown(f(self.total_s), f(self.compute_s),
                             f(self.comm_s), f(self.exposed_comm_s),
                             f(self.pipeline_bubble_s), None)


def _node_times(arch: MicroArch, g: ComputeGraph, placement: Placement,
                cfg: PPEConfig, pod_bw: Optional[float]) -> Dict[str, object]:
    times = {}
    for name, node in g.nodes.items():
        if node.kind == "comm":
            t = placement_lib.comm_time(
                arch, placement, node.comm, node.comm_bytes, node.comm_axis,
                node.comm_participants, pod_bw=pod_bw)
        else:
            t = roofline.node_time(arch, node, cfg)
        # a tagged node stands for `repeat` identical layers (lmgraph)
        times[name] = t * node.meta.get("repeat", 1)
    return times


def simulate_graph(arch: MicroArch, g: ComputeGraph, placement: Placement,
                   cfg: PPEConfig = PPEConfig(), overlap: bool = True,
                   pod_bw: Optional[float] = None,
                   keep_per_node: bool = False) -> TimeBreakdown:
    """List-schedule the sharded graph on one replica's resources.

    Two engines (compute, network); deps respected; fixed topo order so the
    schedule itself is not time-dependent (keeps the result differentiable).
    """
    times = _node_times(arch, g, placement, cfg, pod_bw)
    finish: Dict[str, object] = {}
    dev = arch.device
    zero = torch.zeros((), device=dev)
    compute_free, net_free = zero, zero
    compute_busy, comm_busy = zero, zero
    for name in g.topo_order():
        node = g.nodes[name]
        ready = zero
        for p in dict.fromkeys(g.preds(name)):
            ready = torch.maximum(ready, finish[p])
        dur = times[name]
        if node.kind == "comm":
            start = torch.maximum(ready, net_free) if not overlap else ready
            # network engine serializes comms even when overlapped w/ compute
            start = torch.maximum(start, net_free)
            net_free = start + dur
            comm_busy = comm_busy + dur
        else:
            start = torch.maximum(ready, compute_free)
            compute_free = start + dur
            compute_busy = compute_busy + dur
        if not overlap:
            # no overlap: both engines serialize behind each other
            merged = torch.maximum(compute_free, net_free)
            compute_free = net_free = merged
        finish[name] = start + dur
    total = zero
    for v in finish.values():
        total = torch.maximum(total, v)
    exposed = maximum(total - compute_busy, 0.0)
    return TimeBreakdown(total_s=total, compute_s=compute_busy,
                         comm_s=comm_busy, exposed_comm_s=exposed,
                         per_node=times if keep_per_node else None)


def simulate_pipeline(stage_times, p2p_times, n_microbatches: int,
                      device=None):
    """(stage x microbatch) grid event-sim, GPipe schedule (paper Fig. 5
    bottom shows the analogous backward-pass grid).

    start(s, m) = max(finish(s-1, m) + p2p(s-1), finish(s, m-1)).
    Returns makespan and bubble time, on the stage times' device (or
    ``device`` when every stage time is a Python float).
    """
    S = len(stage_times)
    M = int(n_microbatches)
    dev = next((t.device for t in stage_times if torch.is_tensor(t)), None)
    zero = torch.zeros((), device=dev or resolve_device(device))
    finish = [[None] * M for _ in range(S)]
    for m in range(M):
        for s in range(S):
            ready = zero
            if s > 0:
                ready = maximum(ready, finish[s - 1][m] + p2p_times[s - 1])
            if m > 0:
                ready = maximum(ready, finish[s][m - 1])
            finish[s][m] = ready + stage_times[s]
    makespan = finish[S - 1][M - 1]
    total_work = zero
    for s in range(S):
        total_work = total_work + stage_times[s] * M
    bubble = div(maximum(makespan * S - total_work, 0.0), S)
    return makespan, bubble


# ---------------------------------------------------------------------------
# Top-level CrossFlow predict
# ---------------------------------------------------------------------------


def default_system(strategy: Strategy) -> SystemGraph:
    """Balanced 2-D torus factorization (a, b), a*b = devices, a <= b."""
    n = strategy.devices
    a = max(int(n ** 0.5), 1)
    while n % a:
        a -= 1
    return SystemGraph(dims=(a, n // a), levels=("inter", "inter")) \
        if a > 1 else SystemGraph(dims=(n,), levels=("inter",))


def predict(arch: MicroArch, g: ComputeGraph, strategy: Strategy,
            system: Optional[SystemGraph] = None,
            cfg: PPEConfig = PPEConfig(), overlap: bool = True,
            n_microbatches: Optional[int] = None,
            pod_bw: Optional[float] = None,
            grad_bytes: Optional[float] = None) -> TimeBreakdown:
    """End-to-end per-iteration time for (model graph, strategy, hardware).

    This is the CrossFlow standalone entry point (paper §3.1): transform ->
    place -> roofline per node -> event-driven end-to-end estimate.
    """
    if system is None:
        system = default_system(strategy)
    pl = placement_lib.place(system, strategy)
    sharded = transform.shard_graph(g, strategy, grad_bytes=grad_bytes)

    if strategy.lp <= 1:
        return simulate_graph(arch, sharded, pl, cfg, overlap, pod_bw)

    # pipeline: per-stage time from list-scheduling each stage subgraph,
    # then the (stage x microbatch) grid sim.
    stages = transform.stage_subgraphs(sharded, strategy.lp)
    stage_bd = [simulate_graph(arch, sg, pl, cfg, overlap, pod_bw)
                for sg in stages if len(sg)]
    mb = n_microbatches or max(4 * strategy.lp, 8)
    # per-microbatch stage time: stage work divided across microbatches
    st = [div(bd.total_s, mb) for bd in stage_bd]
    act_bytes = _stage_boundary_bytes(sharded, strategy)
    p2p = []
    for i in range(len(st) - 1):
        p2p.append(placement_lib.comm_time(arch, pl, "p2p",
                                           act_bytes / mb, "lp", 2,
                                           pod_bw=pod_bw))
    makespan, bubble = simulate_pipeline(st, p2p, mb, device=arch.device)
    compute = sum(bd.compute_s for bd in stage_bd)
    comm = sum(bd.comm_s for bd in stage_bd)
    return TimeBreakdown(total_s=makespan, compute_s=compute, comm_s=comm,
                         exposed_comm_s=maximum(makespan - compute, 0.0),
                         pipeline_bubble_s=bubble)


def _stage_boundary_bytes(g: ComputeGraph, s: Strategy) -> float:
    """Activation bytes crossing a stage boundary ~ largest gemm output."""
    best = 0.0
    for node in g.nodes.values():
        if node.kind == "gemm":
            best = max(best, float(node.b) * node.m * node.n
                       * node.dtype_bytes)
    return best


# ---------------------------------------------------------------------------
# Serving (inference) phase model — prefill + decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingBreakdown:
    """Inference-mode prediction: one prefill pass + steady-state decode.

    TTFT (time to first token) is the prefill makespan; TPOT (time per
    output token) is one decode step over the whole concurrent batch,
    derated for KV-cache memory pressure
    (`roofline.capacity_pressure_derate`).  ``cost_device_s_per_token`` =
    devices * TPOT / batch is the Pareto cost axis paired with TTFT in the
    serving scenario (repro_torch.core.scenarios).
    """

    ttft_s: float
    tpot_s: float
    tokens_per_s: float
    tokens_per_s_per_device: float
    cost_device_s_per_token: float
    weight_bytes_per_device: float
    kv_bytes_per_device: float
    hbm_occupancy: float
    kv_derate: float
    feasible: bool
    slo_ok: Optional[bool] = None


def serving_breakdown(prefill: TimeBreakdown, decode: TimeBreakdown, *,
                      batch: int, devices: int,
                      weight_bytes_per_device: float,
                      kv_bytes_per_device: float,
                      dram_capacity: float,
                      slo_s: Optional[float] = None) -> ServingBreakdown:
    """Combine per-phase CrossFlow predictions into serving metrics.

    The decode graph's attention GEMMs already charge the per-step KV-cache
    *bandwidth* (reading the whole context each token); this combinator
    adds the *capacity* dimension: per-device resident bytes (weights +
    KV) against main-memory capacity, with decode bandwidth derated near
    the wall and the point marked infeasible beyond it.
    """
    from repro_torch.core import roofline as roofline_lib
    import math
    occ = ((weight_bytes_per_device + kv_bytes_per_device)
           / max(float(dram_capacity), 1.0))
    derate = roofline_lib.capacity_pressure_derate(occ)
    ttft = float(prefill.total_s)
    tpot = float(decode.total_s) * derate
    # both phases must produce a finite prediction (guards NaN too)
    feasible = math.isfinite(tpot) and math.isfinite(ttft)
    tokens_per_s = batch / tpot if feasible and tpot > 0 else 0.0
    per_dev = tokens_per_s / max(devices, 1)
    cost = (devices * tpot / batch) if feasible and batch else float("inf")
    return ServingBreakdown(
        ttft_s=ttft, tpot_s=tpot, tokens_per_s=tokens_per_s,
        tokens_per_s_per_device=per_dev, cost_device_s_per_token=cost,
        weight_bytes_per_device=float(weight_bytes_per_device),
        kv_bytes_per_device=float(kv_bytes_per_device),
        hbm_occupancy=float(occ), kv_derate=float(derate),
        feasible=feasible,
        slo_ok=None if slo_s is None else bool(ttft <= slo_s))
