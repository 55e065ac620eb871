"""Hierarchical roofline performance model (DeepFlow paper §6.1-§6.3).

Per compute node we estimate operational intensity at *every* level of the
memory hierarchy by searching over tiling strategies (paper: N^L random
tilings that satisfy the capacity constraint at each level, N≈20, L=3), plus
a dataflow/reuse model for the register level (paper eq. 5). Node time is
the hierarchical roofline:

    t = max( flops / compute_throughput,
             traffic_L / bw_L   for every memory level L )

Candidate evaluation is vectorized float32 torch on the MicroArch's device,
so node timing is differentiable w.r.t. the MicroArch parameters (autograd
gives the SOE and the calibration fit exact gradients).  The candidate
tilings are sampled on the host with numpy, exactly as the reference
samples them, so both packages search the same candidates.

Level labels: HBM -> L2 -> L1 -> L0 (registers); the L1 tile triple is the
GEMM kernel's block-shape recommendation surfaced through
`best_gemm_tiling`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.age import MicroArch
from repro_torch.core.graph import Node
from repro_torch.core.tensors import F32, as_f32, div, maximum

DATAFLOWS = ("weight_stationary", "output_stationary", "activation_stationary")


@dataclasses.dataclass(frozen=True)
class PPEConfig:
    n_tilings: int = 24             # N per level (paper: ~20)
    kernel_overhead_s: float = 3e-6  # sw-stack launch latency (paper §8 notes)
    vector_frac: float = 1.0 / 16.0  # VPU : MXU throughput ratio (elementwise)
    seed: int = 0


def _pow2_candidates(dim: int, lo: int = 8) -> np.ndarray:
    cands = []
    d = 1
    while d <= dim:
        if d >= min(lo, dim):
            cands.append(d)
        d *= 2
    if dim not in cands:
        cands.append(dim)
    return np.asarray(sorted(set(cands)), dtype=np.int64)


@functools.lru_cache(maxsize=8192)
def _sample_nested_tilings(m: int, n: int, k: int, n_samples: int,
                           seed: int) -> np.ndarray:
    """Sample nested tiling triples for (L2, L1, L0): shape (S, 3 levels, 3).

    Hierarchy constraint: tile at level l-1 divides (<=) tile at level l.
    Mix of random power-of-two samples and square-ish heuristics.
    """
    rng = np.random.default_rng(seed)
    cm, cn, ck = _pow2_candidates(m), _pow2_candidates(n), _pow2_candidates(k)
    out = []
    for _ in range(n_samples):
        t2 = (rng.choice(cm), rng.choice(cn), rng.choice(ck))
        t1 = tuple(int(rng.choice(c[c <= t]))
                   for c, t in zip((cm, cn, ck), t2))
        t0 = tuple(int(rng.choice(c[c <= t]))
                   for c, t in zip((cm, cn, ck), t1))
        out.append((t2, t1, t0))
    # deterministic heuristics: full problem, 512/128-square MXU-aligned tiles
    for side2, side1 in ((512, 128), (1024, 256), (256, 128), (128, 128)):
        t2 = (min(m, side2), min(n, side2), min(k, side2))
        t1 = (min(m, side1), min(n, side1), min(k, side1))
        t0 = (min(m, 128), min(n, 128), min(k, 128))
        out.append((t2, t1, t0))
    arr = np.asarray(out, dtype=np.float64)    # (S, 3, 3)
    arr.setflags(write=False)                  # memoized: callers must not
    return arr                                 # mutate (lru_cache above)


def _blocked_traffic(M, N, K, tm, tn, tk, dtype_bytes):
    """Bytes moved from the level holding (M,N,K) to the level tiled (tm,tn,tk).

    Classic blocked-GEMM streaming: A re-streamed once per N-tile column,
    B once per M-tile row, C read+written once per K-tile pass.
    """
    n_restream_a = torch.ceil(div(N, tn))
    n_restream_b = torch.ceil(div(M, tm))
    n_c_passes = maximum(torch.ceil(div(K, tk)), 1.0)
    return dtype_bytes * (M * K * n_restream_a
                          + K * N * n_restream_b
                          + 2.0 * M * N * n_c_passes * 0.5 + M * N)


def _reg_traffic(flops, nx, ny, reuse):
    """Paper eq. 5: #RegAccess = #Flops * (Nx*Ny + K*Nx + K*Ny)/(2*K*Nx*Ny)."""
    k = maximum(reuse, 1.0)
    accesses = div(flops * (nx * ny + k * nx + k * ny), (2.0 * k * nx * ny))
    return accesses          # in elements; caller multiplies dtype bytes


# LRU-bounded cache of scalar gemm_time results.  Long sweeps stream many
# distinct (arch, shape) keys through this module; OrderedDict move-to-end
# keeps the working set and the cap evicts one-shot keys oldest-first.  All
# bookkeeping happens under a lock, since an LRU mutates on every read.
_GEMM_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_GEMM_CACHE_MAXSIZE = 65536
_GEMM_CACHE_LOCK = threading.Lock()


def _carries_graph(v) -> bool:
    """True for a value that must not be cached: a tensor that requires
    grad (its result would carry an autograd graph), a batched one, or one
    wrapped by a ``torch.func`` transform.  Under ``torch.func.vmap`` a
    leaf looks 0-d and has no value to key on (``float`` of it raises), as
    a JAX tracer has none: the reference skips its cache for those
    (``is_tracer``), and so does this."""
    return torch.is_tensor(v) and (
        v.requires_grad or v.dim() > 0
        or torch._C._functorch.is_functorch_wrapped_tensor(v))


def _cache_key(arch: MicroArch, m, n, k, b, dtype_bytes, cfg: PPEConfig):
    vals = (arch.compute_throughput, arch.dram_bw, *arch.mem_bw,
            *arch.mem_capacity)
    if any(_carries_graph(v) for v in vals):
        return None
    return (tuple(float(v) for v in vals), str(arch.device), m, n, k, b,
            dtype_bytes, cfg.n_tilings, cfg.seed, cfg.kernel_overhead_s)


def clear_cache() -> None:
    with _GEMM_CACHE_LOCK:
        _GEMM_CACHE.clear()


def gemm_time(arch: MicroArch, m: int, n: int, k: int, b: int = 1,
              dtype_bytes: int = 2, cfg: PPEConfig = PPEConfig(),
              return_tiling: bool = False):
    """Hierarchical-roofline GEMM time on one node; vectorized tiling search."""
    m, n, k = int(max(m, 1)), int(max(n, 1)), int(max(k, 1))
    key = None
    if not return_tiling:
        key = _cache_key(arch, m, n, k, b, dtype_bytes, cfg)
        if key is not None:
            with _GEMM_CACHE_LOCK:
                hit = _GEMM_CACHE.get(key)
                if hit is not None:
                    _GEMM_CACHE.move_to_end(key)
            if hit is not None:
                return hit
    tilings, per_candidate = candidate_times(arch, m, n, k, b, dtype_bytes,
                                             cfg)
    best = torch.argmin(per_candidate)
    # index_select, not ``per_candidate[best]``: under torch.func.grad a
    # tensor index is read on the host, which vmap refuses; the gradient
    # still goes to the first minimum alone, as the reference's does
    t_best = (torch.index_select(per_candidate, 0, best.reshape(1))
              .reshape(()) + cfg.kernel_overhead_s)
    if return_tiling:
        return t_best, np.asarray(tilings[int(best)], dtype=np.int64)
    if key is not None:
        with _GEMM_CACHE_LOCK:
            _GEMM_CACHE[key] = t_best
            _GEMM_CACHE.move_to_end(key)
            while len(_GEMM_CACHE) > _GEMM_CACHE_MAXSIZE:
                _GEMM_CACHE.popitem(last=False)
    return t_best


def candidate_times(arch: MicroArch, m: int, n: int, k: int, b: int = 1,
                    dtype_bytes: int = 2, cfg: PPEConfig = PPEConfig()):
    """-> (tilings (S, 3, 3) numpy, (S,) predicted time per candidate,
    without kernel overhead): the tiling search `gemm_time` minimizes."""
    m, n, k = int(max(m, 1)), int(max(n, 1)), int(max(k, 1))
    tilings = _sample_nested_tilings(m, n, k, cfg.n_tilings,
                                     seed=cfg.seed + m * 7 + n * 31 + k * 101)
    b, m, n, k = float(b), float(m), float(n), float(k)  # host float64
    flops = 2.0 * b * m * n * k
    tl = torch.tensor(tilings, dtype=F32, device=arch.device)
    t2, t1, t0 = tl[:, 0, :], tl[:, 1, :], tl[:, 2, :]      # (S,3) each

    caps, bws, lats = arch.memory_hierarchy()    # L0,L1,L2,DRAM
    cap0, cap1, cap2 = caps[0], caps[1], caps[2]
    bw0, bw1, bw2, bw_dram = bws[0], bws[1], bws[2], arch.dram_bw

    def footprint(t):
        return dtype_bytes * (t[:, 0] * t[:, 2] + t[:, 2] * t[:, 1]
                              + t[:, 0] * t[:, 1])

    # capacity feasibility (soft penalty keeps the search differentiable)
    pen = (maximum(div(footprint(t2), maximum(cap2, 1.0, tl.device)) - 1.0,
                   0.0)
           + maximum(div(footprint(t1), maximum(cap1, 1.0, tl.device)) - 1.0,
                     0.0)
           + maximum(div(footprint(t0), maximum(cap0, 1.0, tl.device)) - 1.0,
                     0.0))

    # traffic per level (paper §6.2: walk upward from main memory)
    traffic_dram = b * _blocked_traffic(m, n, k, t2[:, 0], t2[:, 1], t2[:, 2],
                                        dtype_bytes)
    n_t2 = (torch.ceil(div(m, t2[:, 0])) * torch.ceil(div(n, t2[:, 1]))
            * torch.ceil(div(k, t2[:, 2])))
    traffic_l2 = b * n_t2 * _blocked_traffic(
        t2[:, 0], t2[:, 1], t2[:, 2], t1[:, 0], t1[:, 1], t1[:, 2], dtype_bytes)
    n_t1 = n_t2 * (torch.ceil(t2[:, 0] / t1[:, 0])
                   * torch.ceil(t2[:, 1] / t1[:, 1])
                   * torch.ceil(t2[:, 2] / t1[:, 2]))
    traffic_l1 = b * n_t1 * _blocked_traffic(
        t1[:, 0], t1[:, 1], t1[:, 2], t0[:, 0], t0[:, 1], t0[:, 2], dtype_bytes)

    # register level: dataflow reuse model (paper §6.3, eq. 5); best of 3
    nx, ny = arch.tech.compute.systolic_dims
    reuse_ws = div(t0[:, 2], max(nx, 1))     # weight stationary: reuse along K
    reuse_os = div(t0[:, 2], max(ny, 1))     # output stationary
    reuse_as = div(t0[:, 0], max(nx, 1))     # activation stationary: along M
    reuse = torch.maximum(torch.maximum(reuse_ws, reuse_os), reuse_as)
    traffic_l0 = _reg_traffic(flops, nx, ny, reuse) * dtype_bytes

    t_compute = div(flops, arch.compute_throughput)
    # amax, not max: at a tie it splits the gradient, as jnp.max does
    times = torch.stack([
        torch.broadcast_to(as_f32(t_compute, tl.device), traffic_dram.shape),
        div(traffic_dram, bw_dram),
        div(traffic_l2, maximum(bw2, 1.0, tl.device)),
        div(traffic_l1, maximum(bw1, 1.0, tl.device)),
        div(traffic_l0, maximum(bw0, 1.0, tl.device)),
    ], dim=0)
    return tilings, torch.amax(times, dim=0) * (1.0 + 10.0 * pen)


def best_gemm_tiling(arch: MicroArch, m: int, n: int, k: int,
                     dtype_bytes: int = 2,
                     cfg: PPEConfig = PPEConfig()) -> Tuple[Tuple[int, int, int], ...]:
    """The (L2, L1, L0) tile triples minimizing predicted time.

    The L1 triple is the kernel's block-shape (bm, bn, bk) recommendation
    (`repro_torch.kernels.gemm`).
    """
    _, tiling = gemm_time(arch, m, n, k, dtype_bytes=dtype_bytes, cfg=cfg,
                          return_tiling=True)
    return tuple(tuple(int(x) for x in level) for level in tiling)


def elementwise_time(arch: MicroArch, n_elems: float, flops_per_elem: float,
                     dtype_bytes: int = 2, cfg: PPEConfig = PPEConfig()):
    n_elems = float(n_elems)
    flops = n_elems * flops_per_elem
    bytes_moved = 2.0 * n_elems * dtype_bytes
    t = maximum(div(flops, (arch.compute_throughput * cfg.vector_frac)),
                div(bytes_moved, arch.dram_bw), arch.device)
    return t + cfg.kernel_overhead_s


def gather_time(arch: MicroArch, rows: float, width: float,
                dtype_bytes: int = 2, cfg: PPEConfig = PPEConfig()):
    bytes_moved = 2.0 * float(rows) * float(width) * dtype_bytes
    return div(bytes_moved, arch.dram_bw) + cfg.kernel_overhead_s


def node_time(arch: MicroArch, node: Node, cfg: PPEConfig = PPEConfig()):
    """Time one compute node (comm nodes are timed by the network model)."""
    if node.kind == "gemm":
        return gemm_time(arch, node.m, node.n, node.k, b=node.b,
                         dtype_bytes=node.dtype_bytes, cfg=cfg)
    if node.kind == "elementwise":
        return elementwise_time(arch, node.n_elems, node.flops_per_elem,
                                node.dtype_bytes, cfg)
    if node.kind == "gather":
        return gather_time(arch, node.rows, node.width, node.dtype_bytes, cfg)
    if node.kind == "comm":
        raise ValueError("comm nodes are timed by repro_torch.core.placement")
    raise ValueError(f"unknown node kind {node.kind}")


def operational_intensity(node: Node) -> float:
    """Compulsory-traffic OI (flops / main-memory bytes) — used by the
    motivation study (paper Fig. 1)."""
    io = node.io_bytes
    return node.flops / io if io else 0.0


# ---------------------------------------------------------------------------
# Memory-capacity pressure (serving scenario hook)
# ---------------------------------------------------------------------------

CAPACITY_PRESSURE_KNEE = 0.85


def capacity_pressure_derate(occupancy: float,
                             knee: float = CAPACITY_PRESSURE_KNEE) -> float:
    """Bandwidth derate for main-memory capacity pressure (KV caches).

    No penalty below ``knee`` occupancy, a quadratic ramp to 1.5x between
    knee and full, and infeasible (inf) at >= 100% (the workload does not
    fit; `simulate.serving_breakdown` reports feasible=False).
    """
    occ = float(occupancy)
    if occ >= 1.0:
        return float("inf")
    over = max(occ - knee, 0.0) / max(1.0 - knee, 1e-9)
    return 1.0 + 0.5 * over * over


def capacity_pressure_derate_soft(occupancy,
                                  knee: float = CAPACITY_PRESSURE_KNEE):
    """Differentiable variant of `capacity_pressure_derate` for
    gradient-based refinement (`repro_torch.core.cooptimize`): the same
    quadratic ramp between ``knee`` and full occupancy, but the hard
    infeasibility wall at >= 100% becomes a steep quadratic barrier, so
    gradients keep pointing back toward the feasible region instead of
    vanishing into inf.  A float32 tensor; autograd and ``torch.func``
    transforms pass through."""
    occ = as_f32(occupancy, torch.device("cpu"))
    over = div(maximum(occ - knee, 0.0), max(1.0 - knee, 1e-9))
    wall = maximum(occ - 1.0, 0.0)
    return 1.0 + 0.5 * over * over + 1e3 * wall * wall
