"""Batched pathfinding engine: many hardware points per CrossFlow call.

The evaluation half of ``repro.core.pathfinder``, in PyTorch.  For a fixed
*skeleton* (compute graph, parallelism strategy, system graph, PPE config,
device) the whole CrossFlow prediction is float32 torch in the MicroArch's
numeric leaves, so:

  * `BatchedEvaluator` packs MicroArch candidates into a struct-of-arrays
    ``(B, HW_DIM)`` hardware matrix on the host, moves it to the device
    once and scores every row with one ``torch.func.vmap`` of
    `simulate.predict`; below ``min_batch_jit`` misses it scores each point
    eagerly on the point's own leaves instead, as the reference does;
  * an LRU `PredictionCache` keyed on (skeleton, hardware point) makes
    repeated points free;
  * `BatchedEvaluator.evaluate_matrix` scores an ``(N, HW_DIM)`` matrix
    without per-point MicroArch objects;
  * `evaluate` is the facade (points, label and matrix modes); `sweep`
    cross-products arches x shape cells x mesh shapes x techlib nodes and
    returns every point, with `pareto_front` and `hypervolume` over them;
  * `frontier_init` / `frontier_merge` carry a streaming Pareto frontier
    on the device across batches (``pathfind sweep --frontier-only``,
    `core/sweeppipeline.py`); `frontier_unpack` and the unbounded
    host-side `frontier_merge_states` read and combine such states.

Everything runs on the device the caller names, the card unless it asks
for ``"cpu"``; the points of one batch must all live there.  The rows are
the reference's with its bucketing off: the packed float32 batch at or
above ``min_batch_jit`` misses, the eager rows below it (the two differ at
float32 rounding, since the eager path keeps Python-float leaves).

Left out, because they are the JAX package's execution machinery rather
than the model, and where each goes (ROADMAP queue 1):

  * the compiled-function caches (``CompiledEntry``, ``pin_compiled``,
    ``compile_cache_stats``, ``clear_compiled_caches``) and cross-design
    bucketing: item 11 (b) decides on a torch counterpart
    (``compileahead``); nothing here is compiled, so nothing is cached
    but rows (and `evaluate_budgets`' vmapped functions, per skeleton);
  * ``shard_devices`` and ``evaluate_matrix(devices > 1)``: item 9
    (parallelism).  One card is one device; asking for more raises;
  * `sweep`'s ``strategies_fn`` hook, which nothing sets;
  * `PredictionCache`'s one-key ``get`` / ``put``: the evaluator looks up
    and inserts a batch at a time (``get_many`` / ``put_many``).

`evaluate_budgets` scores a stack of SOE budget vectors in one vmapped,
differentiable call; `hw_ctx` is the live hardware ctx of the traced
refine folds (`core/cooptimize.py`).  Kept without a caller in this
package, so that code written against the reference's public names runs
on either: the deprecated `evaluate_points` alias of `evaluate`.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import age as age_lib
from repro_torch.core import simulate
from repro_torch.core import techlib as techlib_lib
from repro_torch.core.age import Budgets, MicroArch
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy
from repro_torch.core.placement import SystemGraph
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.tensors import F32, as_f32

# ---------------------------------------------------------------------------
# Struct-of-arrays hardware points
# ---------------------------------------------------------------------------

# The MicroArch leaves the performance model actually consumes.  Everything
# else on MicroArch (n_mcu, link counts, on-chip latencies) is either unused
# by `simulate.predict` or static per technology entry and taken from the
# batch's template arch.
HW_FIELDS: Tuple[str, ...] = (
    "compute_throughput",
    "mem_capacity_l0", "mem_capacity_l1", "mem_capacity_l2",
    "mem_bw_l0", "mem_bw_l1", "mem_bw_l2",
    "dram_capacity", "dram_bw",
    "net_intra_bw", "net_inter_bw",
    "net_intra_latency", "net_inter_latency",
    # energy/cost coefficients for the objective layer, appended AFTER the
    # performance leaves so `unpack_hw`'s positional reads stay valid
    "energy_per_flop", "dram_energy_per_byte", "net_energy_per_byte",
    "static_power_w", "device_cost_usd",
)
HW_DIM = len(HW_FIELDS)

# columns of the energy/cost coefficient block (ctx keys for objectives)
HW_COEFF_FIELDS: Tuple[str, ...] = HW_FIELDS[13:]


def hw_coeffs(arch: MicroArch) -> Dict[str, object]:
    """Energy/cost coefficients of one hardware point, keyed per HW_FIELDS.

    Per-flop and per-byte dynamic energies, aggregate static power, and
    device capex from the per-tech cost table.  Plain arithmetic, so
    autograd flows through it when the leaves are tensors.
    """
    t = arch.tech
    return {
        "energy_per_flop": t.compute.energy_per_flop,
        "dram_energy_per_byte": t.dram.dynamic_energy_per_bit * 8.0,
        "net_energy_per_byte": t.net_inter.nominal_energy_per_bit * 8.0,
        "static_power_w": techlib_lib.static_power_w(
            t, arch.dram_capacity, arch.compute_throughput),
        "device_cost_usd": techlib_lib.device_cost_usd(
            t, arch.dram_capacity),
    }


def hw_ctx(arch: MicroArch) -> Dict[str, object]:
    """Objective-fold hardware ctx for a MicroArch: the hardware keys of
    the objectives' ctx contract, live-valued (tensors stay tensors)."""
    ctx = hw_coeffs(arch)
    ctx["compute_throughput"] = arch.compute_throughput
    ctx["dram_bw"] = arch.dram_bw
    ctx["net_inter_bw"] = arch.net_inter_bw
    ctx["dram_capacity"] = arch.dram_capacity
    return ctx


def _hw_leaves(arch: MicroArch) -> list:
    coeffs = hw_coeffs(arch)
    return [arch.compute_throughput, *arch.mem_capacity, *arch.mem_bw,
            arch.dram_capacity, arch.dram_bw, arch.net_intra_bw,
            arch.net_inter_bw, arch.net_intra_latency,
            arch.net_inter_latency] + [coeffs[k] for k in HW_COEFF_FIELDS]


def pack_hw_many(archs: Sequence[MicroArch]) -> np.ndarray:
    """`pack_hw` of every arch -> (B, HW_DIM) float32 on the host.

    Every tensor leaf crosses to the host in one stacked copy (a leaf read
    one at a time would wait on the device once per leaf).  Each value
    becomes a float64 first and float32 last, as the reference's
    ``float(leaf)`` into ``np.float32`` does.
    """
    rows = [_hw_leaves(a) for a in archs]
    tensors = [v.detach().reshape(()).to(torch.float64)
               for row in rows for v in row if torch.is_tensor(v)]
    host = iter(torch.stack(tensors).cpu().tolist() if tensors else ())
    return np.asarray([[next(host) if torch.is_tensor(v) else float(v)
                        for v in row] for row in rows],
                      dtype=np.float32).reshape(len(rows), HW_DIM)


def pack_hw(arch: MicroArch) -> np.ndarray:
    """Flatten the batchable MicroArch leaves into a (HW_DIM,) f32 vector.

    Host-side (numpy): packing thousands of points must not pay per-leaf
    device work; the batch crosses to the device once, already stacked.
    """
    return pack_hw_many([arch])[0]


def unpack_hw(template: MicroArch, v) -> MicroArch:
    """Rebuild a MicroArch from a (HW_DIM,) vector; static leaves (tech,
    latencies of on-chip levels, link counts, device) come from
    `template`."""
    return dataclasses.replace(
        template,
        compute_throughput=v[0],
        mem_capacity=(v[1], v[2], v[3]),
        mem_bw=(v[4], v[5], v[6]),
        dram_capacity=v[7],
        dram_bw=v[8],
        net_intra_bw=v[9],
        net_inter_bw=v[10],
        net_intra_latency=v[11],
        net_inter_latency=v[12],
    )


def _hw_key(arch: MicroArch) -> bytes:
    """Hashable identity of one hardware point (cache key component);
    `BatchedEvaluator` keys its rows by these bytes, packed a batch at a
    time."""
    return pack_hw(arch).tobytes()


# The five timing components one prediction returns (TimeBreakdown order).
METRICS: Tuple[str, ...] = ("total_s", "compute_s", "comm_s",
                            "exposed_comm_s", "pipeline_bubble_s")


def _breakdown_row(bd: simulate.TimeBreakdown) -> np.ndarray:
    return np.asarray([float(bd.total_s), float(bd.compute_s),
                       float(bd.comm_s), float(bd.exposed_comm_s),
                       float(bd.pipeline_bubble_s)], dtype=np.float64)


# ---------------------------------------------------------------------------
# LRU prediction cache
# ---------------------------------------------------------------------------


class PredictionCache:
    """LRU cache of prediction rows keyed on (skeleton, hardware point).

    Thread-safe: all bookkeeping happens under a lock.
    """

    def __init__(self, maxsize: int = 65536):
        self.maxsize = maxsize
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_many(self, keys: Sequence) -> List[Optional[np.ndarray]]:
        """Batched lookup: one lock pass for a whole hardware matrix."""
        out: List[Optional[np.ndarray]] = []
        with self._lock:
            for key in keys:
                row = self._data.get(key)
                if row is None:
                    self.misses += 1
                else:
                    self._data.move_to_end(key)
                    self.hits += 1
                out.append(row)
        return out

    def put_many(self, pairs: Sequence[Tuple]) -> None:
        """Batched insert (one lock pass); the oldest rows past ``maxsize``
        are dropped."""
        with self._lock:
            for key, row in pairs:
                self._data[key] = row
                self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._data)}


_PREDICTION_CACHE = PredictionCache()

# sentinel meaning "use whatever prediction_cache() returns at CALL time".
# A plain `cache=_PREDICTION_CACHE` default would freeze the singleton at
# import time, so replacing the module-level cache would silently leave
# default-arg callers on the dead object.  `None` still means "no cache".
DEFAULT_CACHE = object()


def resolve_cache(cache) -> Optional[PredictionCache]:
    """Map the `DEFAULT_CACHE` sentinel to the live singleton (late
    binding); pass real caches and None (= caching disabled) through."""
    return prediction_cache() if cache is DEFAULT_CACHE else cache


def prediction_cache() -> PredictionCache:
    return _PREDICTION_CACHE


def set_prediction_cache(cache: PredictionCache) -> PredictionCache:
    """Replace the process-wide prediction cache (takes effect for every
    default-arg caller immediately — see `DEFAULT_CACHE`)."""
    global _PREDICTION_CACHE
    _PREDICTION_CACHE = cache
    return cache


def cache_stats() -> Dict[str, int]:
    return _PREDICTION_CACHE.stats


def clear_prediction_cache() -> None:
    _PREDICTION_CACHE.clear()


# ---------------------------------------------------------------------------
# Batched evaluator (one skeleton, many hardware points)
# ---------------------------------------------------------------------------


def _device_name(device) -> str:
    """``cuda`` and ``cuda:0`` name one card: key and compare by index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _skeleton_key(graph_fp: str, strategy: Strategy,
                  system: SystemGraph, ppe: PPEConfig, overlap: bool,
                  n_microbatches: Optional[int], pod_bw: Optional[float],
                  systolic_dims: tuple, device: str) -> tuple:
    # the device is part of the key: a host row and a card row of one
    # point are two rows (they may differ at float32 rounding)
    return (graph_fp, strategy, system, ppe, overlap, n_microbatches,
            pod_bw, tuple(systolic_dims), device)


def _item9(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: one card is one device; spreading the batch over several "
        f"comes with parallelism (ROADMAP queue 1 item 9)")


class BatchedEvaluator:
    """Scores many MicroArch candidates on one (graph, strategy, system).

    The scalar prediction is `simulate.predict` on one unpacked hardware
    row; ``torch.func.vmap`` maps it over the hardware matrix on
    ``device`` (the card unless the caller asks for ``"cpu"``), where
    every candidate must live.
    """

    def __init__(self, graph: ComputeGraph, strategy: Strategy,
                 system: Optional[SystemGraph] = None,
                 ppe: PPEConfig = PPEConfig(), overlap: bool = True,
                 n_microbatches: Optional[int] = None,
                 pod_bw: Optional[float] = None,
                 cache: Optional[PredictionCache] = DEFAULT_CACHE,
                 device=None):
        self.graph = graph
        self.strategy = strategy
        self.system = system or simulate.default_system(strategy)
        self.ppe = ppe
        self.overlap = overlap
        self.n_microbatches = n_microbatches
        self.pod_bw = pod_bw
        self.cache = resolve_cache(cache)
        self.device = resolve_device(device)
        self._device_name = _device_name(self.device)
        self._graph_fp = graph.fingerprint()

    def _skeleton(self, template: MicroArch) -> tuple:
        return _skeleton_key(self._graph_fp, self.strategy, self.system,
                             self.ppe, self.overlap, self.n_microbatches,
                             self.pod_bw,
                             template.tech.compute.systolic_dims,
                             self._device_name)

    def _check_device(self, arch: MicroArch) -> None:
        if _device_name(arch.device) != self._device_name:
            raise ValueError(
                f"a hardware point on {arch.device} given to an evaluator "
                f"on {self.device}; build the points on the evaluator's "
                f"device")

    def _scalar_fn(self, template: MicroArch) -> Callable:
        def scalar(v):
            arch = unpack_hw(template, v)
            bd = simulate.predict(
                arch, self.graph, self.strategy, system=self.system,
                cfg=self.ppe, overlap=self.overlap,
                n_microbatches=self.n_microbatches, pod_bw=self.pod_bw)
            return torch.stack([as_f32(x, v.device) for x in (
                bd.total_s, bd.compute_s, bd.comm_s, bd.exposed_comm_s,
                bd.pipeline_bubble_s)])
        return scalar

    def _batched(self, template: MicroArch, hw: np.ndarray) -> np.ndarray:
        """One vmapped prediction over packed float32 rows: the matrix
        crosses to the device once and the rows come back once."""
        x = torch.as_tensor(hw, dtype=F32).to(self.device)
        with torch.no_grad():
            rows = torch.func.vmap(self._scalar_fn(template))(x)
        return rows.cpu().numpy().astype(np.float64)

    # -- public API -------------------------------------------------------
    def evaluate(self, archs: Sequence[MicroArch],
                 min_batch_jit: int = 2,
                 shard_devices: bool = False) -> np.ndarray:
        """Score MicroArch candidates -> (B, 5) rows ordered like METRICS.

        Cached points are returned for free; the misses are scored in one
        vmapped call on their packed float32 rows, or each on its own
        leaves when fewer than `min_batch_jit` misses remain (the
        reference's threshold for paying a compile; its meaning is kept).
        """
        if shard_devices:
            raise _item9("shard_devices")
        archs = list(archs)
        if not archs:
            return np.zeros((0, len(METRICS)), dtype=np.float64)
        sd0 = tuple(archs[0].tech.compute.systolic_dims)
        for a in archs:
            if tuple(a.tech.compute.systolic_dims) != sd0:
                raise ValueError("mixed systolic dims in one batch; group "
                                 "points with evaluate(points=...) instead")
            self._check_device(a)
        out = np.zeros((len(archs), len(METRICS)), dtype=np.float64)
        skel = self._skeleton(archs[0])
        vecs = pack_hw_many(archs)
        keys: List[Optional[tuple]] = [
            (skel, v.tobytes()) if self.cache is not None else None
            for v in vecs]
        misses: List[int] = []
        hits = self.cache.get_many(keys) if self.cache is not None \
            else [None] * len(archs)
        for i, row in enumerate(hits):
            if row is None:
                misses.append(i)
            else:
                out[i] = row
        if not misses:
            return out
        if len(misses) >= min_batch_jit:
            rows = self._batched(archs[0], vecs[misses])
        else:
            rows = np.stack([self._eager_row(archs[i]) for i in misses])
        out[misses] = rows
        if self.cache is not None:
            self.cache.put_many([(keys[i], rows[j])
                                 for j, i in enumerate(misses)])
        return out

    def evaluate_matrix(self, template: MicroArch, hw_matrix,
                        devices: Optional[int] = None) -> np.ndarray:
        """Score an (N, HW_DIM) struct-of-arrays hardware matrix directly:
        no per-point MicroArch objects and no cache keys; the matrix enters
        the device as one float32 array."""
        if devices is not None and devices > 1:
            raise _item9(f"evaluate_matrix(devices={devices})")
        self._check_device(template)
        hw = np.asarray(hw_matrix, dtype=np.float32)
        if hw.ndim != 2 or hw.shape[1] != HW_DIM:
            raise ValueError(f"hw_matrix must be (N, {HW_DIM}), "
                             f"got {hw.shape}")
        if hw.shape[0] == 0:
            return np.zeros((0, len(METRICS)), dtype=np.float64)
        return self._batched(template, hw)

    def _eager_row(self, arch: MicroArch) -> np.ndarray:
        bd = simulate.predict(arch, self.graph, self.strategy,
                              system=self.system, cfg=self.ppe,
                              overlap=self.overlap,
                              n_microbatches=self.n_microbatches,
                              pod_bw=self.pod_bw)
        return _breakdown_row(bd)


# ---------------------------------------------------------------------------
# Heterogeneous point sets (different graphs / strategies / systems)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalPoint:
    """One (hardware, workload, strategy, system) candidate."""

    arch: MicroArch
    graph: ComputeGraph
    strategy: Strategy
    system: Optional[SystemGraph] = None
    pod_bw: Optional[float] = None


def _evaluate_points_impl(points: Sequence[EvalPoint],
                          ppe: PPEConfig = PPEConfig(),
                          cache: Optional[PredictionCache] = DEFAULT_CACHE,
                          min_batch_jit: int = 4,
                          shard_devices: bool = False) -> np.ndarray:
    """Score a heterogeneous candidate list -> (N, 5) metric matrix.

    Points are grouped by skeleton (graph fingerprint, strategy, system,
    ppe, device); each group is one struct-of-arrays batch on its points'
    device.  Hardware-only axes (techlib nodes, budget variants) therefore
    collapse into single vmapped calls, while structure-changing axes
    (strategy, mesh) form their own groups.
    """
    if shard_devices:
        raise _item9("shard_devices")
    out = np.zeros((len(points), len(METRICS)), dtype=np.float64)
    groups: Dict[tuple, List[int]] = {}
    evaluators: Dict[tuple, BatchedEvaluator] = {}
    for i, p in enumerate(points):
        ev = BatchedEvaluator(p.graph, p.strategy, system=p.system, ppe=ppe,
                              pod_bw=p.pod_bw, cache=cache,
                              device=p.arch.device)
        key = ev._skeleton(p.arch)
        groups.setdefault(key, []).append(i)
        evaluators.setdefault(key, ev)
    for key, idxs in groups.items():
        out[idxs] = evaluators[key].evaluate(
            [points[i].arch for i in idxs], min_batch_jit=min_batch_jit)
    return out


def evaluate(points: Optional[Sequence[EvalPoint]] = None, *,
             spec=None, labels=None,
             template: Optional[MicroArch] = None, matrix=None,
             graph: Optional[ComputeGraph] = None,
             strategy: Optional[Strategy] = None,
             system: Optional[SystemGraph] = None,
             pod_bw: Optional[float] = None,
             ppe: PPEConfig = PPEConfig(),
             cache: Optional[PredictionCache] = DEFAULT_CACHE,
             min_batch_jit: int = 4,
             shard_devices: bool = False,
             devices: Optional[int] = None, device=None):
    """Score candidates — THE eval entry point, in one of its modes.

    Exactly one mode per call (mixing raises ``ValueError``):

    * **points mode** — ``evaluate(points=[EvalPoint, ...])``: a
      heterogeneous candidate list, grouped by skeleton so hardware-only
      axes collapse into single vmapped calls, each on its points' device;
      returns an ``(N, 5)`` float64 matrix ordered like `METRICS`.
    * **matrix mode** — ``evaluate(template=MicroArch, matrix=(N,
      HW_DIM), graph=..., strategy=...)``: the matrix-native path on the
      template's device.
    * **label mode** — ``evaluate(spec=SweepSpec, labels=[PointLabel,
      ...])``: resolves sweep labels through their scenario on ``device``
      (the card unless the caller asks for ``"cpu"``; PPE/profile come
      from the spec, not the ``ppe`` argument) and returns the scenario's
      *result records* (list of dicts), exactly what
      `sweeprunner.SweepRunner` commits per chunk.
    """
    n_modes = sum((points is not None,
                   spec is not None or labels is not None,
                   template is not None or matrix is not None))
    if n_modes != 1:
        raise ValueError(
            "evaluate() takes exactly one of: points=..., "
            "(spec=..., labels=...), or (template=..., matrix=...)")
    if device is not None and (points is not None or matrix is not None
                               or template is not None):
        raise ValueError("device= is label mode's; points and matrix "
                         "modes run on their hardware points' device")
    if points is not None:
        return _evaluate_points_impl(points, ppe=ppe, cache=cache,
                                     min_batch_jit=min_batch_jit,
                                     shard_devices=shard_devices)
    if matrix is not None or template is not None:
        if template is None or matrix is None or graph is None \
                or strategy is None:
            raise ValueError("matrix mode needs template=, matrix=, "
                             "graph= and strategy=")
        ev = BatchedEvaluator(graph, strategy, system=system, ppe=ppe,
                              pod_bw=pod_bw, cache=cache,
                              device=template.device)
        return ev.evaluate_matrix(template, matrix, devices=devices)
    if spec is None or labels is None:
        raise ValueError("label mode needs both spec= and labels=")
    from repro_torch.core import sweeprunner   # lazy: it imports us
    return sweeprunner._eval_labels_impl(spec, labels, cache=cache,
                                         shard_devices=shard_devices,
                                         device=device)


def evaluate_points(points: Sequence[EvalPoint],
                    ppe: PPEConfig = PPEConfig(),
                    cache: Optional[PredictionCache] = DEFAULT_CACHE,
                    min_batch_jit: int = 4,
                    shard_devices: bool = False) -> np.ndarray:
    """Deprecated alias — use ``evaluate(points=...)``."""
    warnings.warn("pathfinder.evaluate_points is deprecated; use "
                  "pathfinder.evaluate(points=...)",
                  DeprecationWarning, stacklevel=2)
    return _evaluate_points_impl(points, ppe=ppe, cache=cache,
                                 min_batch_jit=min_batch_jit,
                                 shard_devices=shard_devices)


# ---------------------------------------------------------------------------
# Budget-space batching (the SOE axis)
# ---------------------------------------------------------------------------


_BUDGET_FNS: "collections.OrderedDict[tuple, Callable]" = \
    collections.OrderedDict()
_BUDGET_FNS_MAXSIZE = 256
_BUDGET_LOCK = threading.Lock()


def evaluate_budgets(tech: techlib_lib.TechConfig, graph: ComputeGraph,
                     strategy: Strategy, budget_vectors,
                     system: Optional[SystemGraph] = None,
                     template: Optional[Budgets] = None,
                     ppe: PPEConfig = PPEConfig(),
                     pod_bw: Optional[float] = None,
                     device=None) -> torch.Tensor:
    """Score a (B, DIM) stack of SOE budget vectors in one vmapped call.

    The budget-space analogue of `BatchedEvaluator.evaluate`: goes through
    the differentiable AGE (``discrete=False``), so the (B,) float32
    result is also differentiable w.r.t. the budget stack.  (`soe.optimize`
    builds its own vmapped value and gradient over the same objective for
    the GD loop; use this for one-shot batched budget scans.)  A tensor
    stack is scored on its own device, an array on ``device`` (the card
    unless the caller asks for ``"cpu"``).  The vmapped function is
    memoized per (tech, graph, strategy, system, ppe, template) skeleton.
    """
    like = template or Budgets.default()
    key = (tech, graph.fingerprint(), strategy, system, ppe, pod_bw,
           like.node_area_mm2, like.proc_chip_area_mm2, like.power_w)
    with _BUDGET_LOCK:
        fn = _BUDGET_FNS.get(key)
        if fn is not None:
            _BUDGET_FNS.move_to_end(key)
    if fn is None:
        def f(w):
            budgets = Budgets.from_vector(w, like)
            arch = age_lib.generate(tech, budgets, discrete=False)
            bd = simulate.predict(arch, graph, strategy, system=system,
                                  cfg=ppe, pod_bw=pod_bw)
            return as_f32(bd.total_s, w.device)

        fn = torch.func.vmap(f)
        with _BUDGET_LOCK:
            fn = _BUDGET_FNS.setdefault(key, fn)
            while len(_BUDGET_FNS) > _BUDGET_FNS_MAXSIZE:
                _BUDGET_FNS.popitem(last=False)
    if torch.is_tensor(budget_vectors):
        W = budget_vectors.to(F32)
    else:
        W = torch.as_tensor(np.asarray(budget_vectors, dtype=np.float32),
                            device=resolve_device(device))
    return fn(W)


# ---------------------------------------------------------------------------
# Pareto frontier
# ---------------------------------------------------------------------------


def pareto_front(points: Sequence, objectives: Sequence[Callable]) -> List:
    """Non-dominated subset minimizing every objective (callables on points).

    O(n^2); returns points in input order.  A point is kept iff no other
    point is <= on all objectives and < on at least one.  Tie semantics:
    points exactly equal on ALL objectives do not dominate each other, so
    every copy of a non-dominated point survives, independent of input
    order.  Points with any non-finite objective are excluded — NaN
    compares false against everything, so such a point can never be
    dominated and would otherwise pollute the frontier.
    """
    vals = [tuple(float(obj(p)) for obj in objectives) for p in points]
    finite = [all(np.isfinite(v) for v in vi) for vi in vals]
    keep = []
    for i, vi in enumerate(vals):
        if not finite[i]:
            continue
        dominated = False
        for j, vj in enumerate(vals):
            if j == i or not finite[j]:
                continue
            if all(a <= b for a, b in zip(vj, vi)) \
                    and any(a < b for a, b in zip(vj, vi)):
                dominated = True
                break
        if not dominated:
            keep.append(points[i])
    return keep


def hypervolume(vals, ref) -> float:
    """Dominated hypervolume of objective rows against a reference corner.

    ``vals`` is (N, K) in canonical all-minimizing space and ``ref`` the
    (K,) worst corner; the result is the exact volume of the union of
    boxes ``[v, ref]``, by recursive dimension-sweep slicing: exact for
    any K, O(N^2) per level, intended for frontier-sized sets.  Rows with
    any non-finite coordinate or outside the reference box contribute
    nothing; dominated rows are harmless (their boxes are subsets).
    """
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    v = np.asarray(vals, dtype=np.float64).reshape(-1, ref.shape[0])
    keep = np.all(np.isfinite(v), axis=1) & np.all(v < ref, axis=1)
    v = v[keep]
    if not v.size:
        return 0.0

    def hv(rows: np.ndarray, r: np.ndarray) -> float:
        if rows.shape[1] == 1:
            return float(r[0] - rows[:, 0].min())
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        total = 0.0
        for i in range(rows.shape[0]):
            hi = rows[i + 1, 0] if i + 1 < rows.shape[0] else r[0]
            width = hi - rows[i, 0]
            if width > 0.0:
                # slab [rows[i,0], hi): its cross-section is dominated by
                # exactly the points entered so far
                total += width * hv(rows[:i + 1, 1:], r[1:])
        return total

    return hv(v, ref)


# ---------------------------------------------------------------------------
# Device-resident streaming Pareto frontier (carried across chunks)
# ---------------------------------------------------------------------------

# Default capacity of the carried frontier state (number of non-dominated
# candidates held on device).  Real sweep frontiers are tiny next to the
# point count; overflow is detected and reported, never silent.
FRONTIER_CAPACITY = 512

_INT32_MAX = torch.iinfo(torch.int32).max


def frontier_init(capacity: int, n_obj: int, payload_dim: int,
                  device=None) -> Tuple[torch.Tensor, ...]:
    """Empty carried frontier state for `frontier_merge`, on ``device``
    (the card unless the caller asks for ``"cpu"``).

    ``(vals, payload, idx, overflow)``: objective rows (+inf = empty slot),
    an opaque per-point payload (the raw metric rows, so surviving records
    can be rebuilt without ever materializing the full sweep), the global
    point index (-1 = empty), and a scalar count of finite candidates that
    were dropped because the frontier outgrew ``capacity``.
    """
    dev = resolve_device(device)
    return (torch.full((capacity, n_obj), math.inf, dtype=F32, device=dev),
            torch.zeros((capacity, payload_dim), dtype=F32, device=dev),
            torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort(keys)`` on the keys' device: the LAST key is primary.
    One stable sort per key, from the first (least significant) key to
    the last, each reordering the permutation the previous ones left."""
    order = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def frontier_merge(state: Tuple, vals, payload, idx
                   ) -> Tuple[torch.Tensor, ...]:
    """One streaming-skyline step: merge a batch into the carried state.

    Runs on the state's device with no host synchronization (the pipelined
    executor calls it behind the batched evaluation, so the state never
    leaves the card between superbatches).  Dominance follows
    `pareto_front`: a candidate is dropped iff some other candidate is <=
    on all objectives and < on at least one; exact ties never dominate
    each other, and rows with any non-finite objective (infeasible points,
    padding, empty slots) or idx -1 never enter the frontier.  A carried
    point can still be evicted by a later batch — the state always holds
    the skyline of everything seen so far, truncated to capacity in full
    lexicographic order (all objectives, then global point index;
    ``overflow`` counts what the truncation dropped).  The full-lex key
    makes the kept set a canonical function of the surviving point set —
    independent of how points are arranged across state slots and batch
    rows — because a dominator always sorts strictly before anything it
    dominates, and the point index breaks exact-tie races
    deterministically.  (Which points *survive* can still depend on merge
    history once overflow drops a future dominator — any bounded streaming
    skyline has that limit, which is why ``overflow > 0`` flags the
    frontier as inexact and cross-state merges use the unbounded
    `frontier_merge_states` instead.)
    """
    svals, spay, sidx, overflow = state
    dev = svals.device
    capacity = svals.shape[0]
    av = torch.cat([svals, torch.as_tensor(vals, dtype=F32, device=dev)])
    ap = torch.cat([spay, torch.as_tensor(payload, dtype=F32, device=dev)])
    ai = torch.cat([sidx, torch.as_tensor(idx, dtype=torch.int32,
                                          device=dev)])
    finite = torch.isfinite(av).all(dim=1) & (ai >= 0)
    # pairwise dominance: dominated[i] iff some finite j <= i on all
    # objectives and < on one ((CAP+B)^2 x K compares, on the device)
    le = (av[None, :, :] <= av[:, None, :]).all(dim=-1)
    lt = (av[None, :, :] < av[:, None, :]).any(dim=-1)
    dominated = (le & lt & finite[None, :]).any(dim=1)
    keep = finite & ~dominated
    # survivors first in full lex order (objectives, then point index),
    # empties pushed to +inf / INT32_MAX; + 0.0 makes -0.0 and 0.0 one key
    masked = torch.where(keep[:, None], av, math.inf) + 0.0
    idx_key = torch.where(keep, ai, _INT32_MAX)
    order = _lexsort([idx_key] + [masked[:, k] for k in
                                  range(av.shape[1] - 1, -1, -1)])
    n_keep = keep.sum(dtype=torch.int32)
    kept_beyond = n_keep - torch.clamp(n_keep, max=capacity)
    order = order[:capacity]
    mask = keep[order]
    return (torch.where(mask[:, None], av[order], math.inf),
            torch.where(mask[:, None], ap[order], 0.0),
            torch.where(mask, ai[order], -1).to(torch.int32),
            overflow + kept_beyond)


def frontier_host(state: Tuple) -> Tuple[np.ndarray, ...]:
    """A carried frontier state as host arrays, in the reference's dtypes
    (float32 vals and payload, int32 idx, a 0-d int32 overflow): what
    `sweepexec.save_frontier_state` writes."""
    return tuple(x.detach().cpu().numpy() if torch.is_tensor(x)
                 else np.asarray(x) for x in state)


def frontier_unpack(state: Tuple) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, int]:
    """Pull a carried frontier state to host -> (vals, payload, idx,
    n_overflowed) with empty slots stripped."""
    vals, payload, idx, overflow = frontier_host(state)
    live = idx >= 0
    return (vals[live].astype(np.float64), payload[live], idx[live],
            int(overflow))


def frontier_merge_states(a: Tuple, b: Tuple) -> Tuple[np.ndarray, ...]:
    """Merge two carried frontier states host-side — the cross-state
    reduction (the reference's sweep fabric merges its workers' states
    with it).

    Unlike the streaming `frontier_merge`, this merge is **unbounded**: it
    dedupes by global point index (the same point checkpointed twice is
    one point), drops dominated points with the exact f32 semantics of the
    device merge, and keeps EVERY survivor, growing the state instead of
    truncating to a capacity.  That makes the live set exactly
    commutative, associative, and idempotent — any merge order over any
    partition of states yields the same frontier.  The inputs' overflow
    counters are summed through, so ``overflow > 0`` still flags that some
    input was inexact.

    Slot layout of the result is canonical: survivors in full
    lexicographic order (objectives, then point index), padded to the
    larger input's capacity.  States must agree on objective and payload
    dimensions (same sweep spec).
    """
    av, ap, ai, ao = frontier_host(a)
    bv, bp, bi, bo = frontier_host(b)
    if av.shape[1:] != bv.shape[1:] or ap.shape[1:] != bp.shape[1:]:
        raise ValueError(
            f"frontier states disagree on objective/payload shape: "
            f"{av.shape[1:]}/{ap.shape[1:]} vs {bv.shape[1:]}/"
            f"{bp.shape[1:]} — were they produced by the same spec?")
    vals = np.concatenate([av, bv]).astype(np.float32)
    pay = np.concatenate([ap, bp]).astype(np.float32)
    idx = np.concatenate([ai, bi]).astype(np.int32)
    live = (idx >= 0) & np.all(np.isfinite(vals), axis=1)
    # dedupe by global point index: re-merging a state that already holds
    # a point must be a no-op (the duplicate rows are the same evaluated
    # point, so which copy survives is immaterial)
    first: Dict[int, int] = {}
    for k in np.flatnonzero(live):
        first.setdefault(int(idx[k]), int(k))
    ks = np.asarray(sorted(first.values()), dtype=np.int64)
    n = len(ks)
    cap = max(av.shape[0], bv.shape[0], n)
    overflow = np.asarray(int(ao) + int(bo), dtype=np.int32)
    if n:
        v = vals[ks]
        le = np.all(v[None, :, :] <= v[:, None, :], axis=-1)
        lt = np.any(v[None, :, :] < v[:, None, :], axis=-1)
        ks = ks[~np.any(le & lt, axis=1)]
        # canonical slot order: full lex (objectives, then point index)
        v = vals[ks]
        order = np.lexsort((idx[ks],) + tuple(
            v[:, k] for k in range(v.shape[1] - 1, -1, -1)))
        ks = ks[order]
        n = len(ks)
    out_v = np.full((cap, vals.shape[1]), np.inf, dtype=np.float32)
    out_p = np.zeros((cap, pay.shape[1]), dtype=np.float32)
    out_i = np.full((cap,), -1, dtype=np.int32)
    out_v[:n] = vals[ks]
    out_p[:n] = pay[ks]
    out_i[:n] = idx[ks]
    return out_v, out_p, out_i, overflow


# ---------------------------------------------------------------------------
# Design-space sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One evaluated design point of a `sweep()`."""

    arch: str                       # model architecture id
    cell: str                       # shape cell name
    mesh: Tuple[int, ...]
    logic: str
    hbm: str
    net: str
    strategy: Strategy
    time_s: float
    compute_s: float
    comm_s: float
    exposed_comm_s: float
    devices: int
    power_w: float
    chip_area_mm2: float

    def metric(self, name: str) -> float:
        return float(getattr(self, name))

    def as_csv_row(self) -> str:
        return (f"{self.arch},{self.cell},{'x'.join(map(str, self.mesh))},"
                f"{self.logic},{self.hbm},{self.net},{self.strategy.name},"
                f"{self.time_s:.6e},{self.compute_s:.6e},{self.comm_s:.6e},"
                f"{self.devices},{self.power_w:g},{self.chip_area_mm2:g}")


CSV_HEADER = ("arch,cell,mesh,logic,hbm,net,strategy,time_s,compute_s,"
              "comm_s,devices,power_w,chip_area_mm2")


@dataclasses.dataclass
class SweepResult:
    points: List[SweepPoint]
    n_evaluations: int

    def pareto(self, objectives: Sequence[str] = ("time_s", "devices")
               ) -> List[SweepPoint]:
        objs = [(lambda p, k=k: p.metric(k)) for k in objectives]
        return pareto_front(self.points, objs)

    def best(self) -> SweepPoint:
        return min(self.points, key=lambda p: p.time_s)

    def to_csv(self) -> str:
        return "\n".join([CSV_HEADER] + [p.as_csv_row()
                                         for p in self.points])


def _default_strategies(cfg, cell, mesh_shape) -> List[Strategy]:
    from repro_torch.core import planner   # lazy: planner imports us
    return planner.candidate_strategies(cfg, cell, mesh_shape)


def sweep(arches: Sequence[str], cells: Sequence[str],
          mesh_shapes: Sequence[Tuple[int, ...]],
          logic_nodes: Sequence[str] = ("N7",),
          hbms: Sequence[str] = ("HBM2E",),
          nets: Sequence[str] = ("IB-NDR-X8",),
          budgets: Optional[Budgets] = None,
          ppe: PPEConfig = PPEConfig(n_tilings=8),
          cache: Optional[PredictionCache] = DEFAULT_CACHE,
          profile=None, device=None) -> SweepResult:
    """Cross-product design-space sweep (the paper's §9 studies, batched).

    arches x cells define workload graphs, mesh_shapes define systems and
    candidate strategies, (logic, hbm, net) triples define AGE'd hardware
    on ``device`` (the card unless the caller asks for ``"cpu"``).  All
    hardware points sharing a skeleton are scored in one vmapped call.
    ``profile`` (a `repro_torch.calibrate` profile / dict / path) anchors
    every hardware point and the PPE kernel overhead to measured
    efficiencies.
    """
    from repro_torch.calibrate import profiles as profiles_lib
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import lmgraph, techlib
    from repro_torch.core.placement import mesh_system

    dev = resolve_device(device)
    budgets = budgets or Budgets.default()
    profile = profiles_lib.coerce(profile)
    ppe = profiles_lib.ppe_with_profile(ppe, profile)
    hw_axis = [((logic, hbm, net), profiles_lib.apply_profile(
        age_lib.generate(techlib.make_tech_config(logic, hbm, net), budgets,
                         device=dev), profile))
        for logic, hbm, net in itertools.product(logic_nodes, hbms, nets)]

    points: List[EvalPoint] = []
    labels: List[tuple] = []
    for arch_name in arches:
        cfg = get_config(arch_name)
        for cell_name in cells:
            cell = SHAPE_CELLS[cell_name]
            graph = lmgraph.build_graph(cfg, cell)
            for mesh in mesh_shapes:
                system = mesh_system(tuple(mesh))
                for st in _default_strategies(cfg, cell, tuple(mesh)):
                    for (logic, hbm, net), hw in hw_axis:
                        points.append(EvalPoint(hw, graph, st,
                                                system=system))
                        labels.append((arch_name, cell_name, tuple(mesh),
                                       logic, hbm, net, st))
    rows = evaluate(points=points, ppe=ppe, cache=cache)
    out = []
    for (arch_name, cell_name, mesh, logic, hbm, net, st), row in zip(labels,
                                                                      rows):
        out.append(SweepPoint(
            arch=arch_name, cell=cell_name, mesh=mesh, logic=logic, hbm=hbm,
            net=net, strategy=st, time_s=float(row[0]),
            compute_s=float(row[1]), comm_s=float(row[2]),
            exposed_comm_s=float(row[3]), devices=st.devices,
            power_w=float(budgets.power_w),
            chip_area_mm2=float(budgets.proc_chip_area_mm2)))
    return SweepResult(points=out, n_evaluations=len(out))
