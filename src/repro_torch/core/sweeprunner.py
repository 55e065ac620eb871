"""Chunked, checkpointed, resumable design-space sweep engine.

The PyTorch port of ``repro.core.sweeprunner``.  `pathfinder.sweep()`
scores one in-memory cross-product; the co-design studies the paper
automates (§7, §9) need many more points, hours of wall time, and fault
tolerance.  This module scales the batched engine into a *sweep runner*:

  * the (arch x cell x mesh x tech x budget-scale x strategy) cross-product
    is enumerated deterministically and partitioned into fixed-size
    **chunks** of design points;
  * chunks execute on one of the backends: ``pipeline`` (the default,
    ``auto``; `core/sweeppipeline.py`) overlaps host packing, device work
    and the JSONL commits over superbatches of chunks; ``serial`` scores
    one chunk after another, each one batched `pathfinder.evaluate` call;
    ``device`` is ``serial`` with each chunk's rows spread over every
    local device (``shard_devices``); ``thread`` and ``process`` run
    chunks in a pool of ``workers`` (threads, or processes started with
    ``spawn``, since CUDA cannot be forked) and commit them as they
    complete.  Every backend scores on the runner's device — the card
    unless the caller asks for ``"cpu"`` — and, with ``bucketing`` (asked
    for; off by default), through the designs' canonical buckets
    (`core/compileahead.py`), so every backend writes the same records
    bit for bit;
  * results **stream** to ``results.jsonl`` as chunks complete (plus a CSV
    view via `to_csv`), so a crashed sweep loses at most the in-flight
    chunks;
  * an append-only ``checkpoint.jsonl`` records every finished chunk keyed
    on the sweep-spec fingerprint and a hash of the chunk's point keys;
    `run(resume=True)` skips checkpointed chunks with **zero
    re-evaluation** and drops partial rows from an interrupted chunk;
  * ``run(frontier_only=True)`` streams every point through the
    device-resident Pareto reduction instead: only the frontier comes back
    (``frontier.jsonl``), and the carried state checkpoints to
    ``frontier_state.npz`` per committed superbatch.

A sweep directory is the reference's, byte for byte in its identities:
the same ``spec.json`` fingerprint, the same chunk hashes and the same
``checkpoint.jsonl`` protocol, with ``results.jsonl`` records equal to the
reference's (labels and keys exactly, numbers at float32 rounding), and
the same ``frontier_state.npz`` layout.  So a directory one package
started resumes in the other, on any backend.  The device, the backend,
``bucketing`` and ``compile_ahead`` are execution-only: no part of the
spec or its fingerprint.

Workload semantics (training step time vs prefill+decode serving) come from
the scenario registry in `repro_torch.core.scenarios`.  The CLI front-end
is ``python -m repro_torch.pathfind sweep [--scenario serving] [--out DIR]
[--resume] [--backend ...] [--frontier-only]``.

`RunStats` carries the run's prediction-cache and compiled-store deltas,
with the seconds the port's compile (the designs' traces) took and the
part of them that stalled evaluation.  `enable_compilation_cache` is the
reference's persistent-cache switch; nothing here is compiled to disk,
so it is a no-op that says so.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import warnings
from concurrent.futures import (ProcessPoolExecutor, ThreadPoolExecutor,
                                as_completed)
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, SHAPE_CELLS, get_config
from repro_torch.core import age as age_lib
from repro_torch.core import pathfinder, scenarios, sweepexec, techlib
from repro_torch.core.age import Budgets
from repro_torch.core.parallelism import Strategy
from repro_torch.core.placement import mesh_system
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.sweepexec import iter_jsonl as _iter_jsonl
from repro_torch.core.sweepexec import json_safe

SPEC_VERSION = 1


# ---------------------------------------------------------------------------
# Sweep specification (fully serializable — the resume identity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Everything that determines a sweep's point set, JSON-serializable.

    The fingerprint of the canonical JSON form keys the checkpoint: a
    resumed run must present the identical spec, and any change to the
    enumerated cross-product changes the per-chunk hashes too.
    """

    arches: Tuple[str, ...]
    mesh_shapes: Tuple[Tuple[int, ...], ...]
    # scenario may be passed as a `scenarios.ScenarioSpec`; __post_init__
    # normalizes it into the serialized (name, cells, slo_s, params) form
    scenario: str = "train"
    cells: Tuple[str, ...] = ()            # scenario cell override
    logic_nodes: Tuple[str, ...] = ("N7",)
    hbms: Tuple[str, ...] = ("HBM2E",)
    nets: Tuple[str, ...] = ("IB-NDR-X8",)
    budget_scales: Tuple[float, ...] = (1.0,)
    area_mm2: Optional[float] = None
    power_w: Optional[float] = None
    slo_s: Optional[float] = None
    n_tilings: int = 8
    chunk_size: int = 32
    # embedded calibration profile dict (calibrate/profiles.py) — part of
    # the spec so the fingerprint (= resume identity) changes with the
    # calibration; None keys byte-identical specs to pre-profile sweeps
    profile: Optional[Dict] = None
    # typed scenario params (`scenarios.ScenarioSpec.params`); list-valued
    # entries are sweep axes.  None is dropped from the serialized form so
    # param-less specs fingerprint byte-identically to older checkpoints
    scenario_params: Optional[Dict] = None
    # composed Pareto objective set (`core/objectives.py` names / aliases);
    # None = scenario defaults, dropped from the serialized form so
    # objective-less specs fingerprint byte-identically to older
    # checkpoints
    objectives: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if isinstance(self.scenario, scenarios.ScenarioSpec):
            ss = self.scenario
            object.__setattr__(self, "scenario", ss.name)
            if ss.cells:
                object.__setattr__(self, "cells", tuple(ss.cells))
            if ss.slo_s is not None:
                object.__setattr__(self, "slo_s", float(ss.slo_s))
            if ss.params:
                object.__setattr__(
                    self, "scenario_params",
                    {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in ss.params})
            if ss.objectives is not None:
                object.__setattr__(self, "objectives",
                                   tuple(ss.objectives))
        if self.objectives is not None:
            object.__setattr__(self, "objectives",
                               tuple(str(o) for o in self.objectives))

    @property
    def scenario_spec(self) -> scenarios.ScenarioSpec:
        """The typed scenario-construction view of this spec."""
        return scenarios.ScenarioSpec(
            name=self.scenario, cells=self.cells, slo_s=self.slo_s,
            params=self.scenario_params or (),
            objectives=self.objectives)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["mesh_shapes"] = [list(m) for m in self.mesh_shapes]
        for k in ("arches", "cells", "logic_nodes", "hbms", "nets",
                  "budget_scales"):
            d[k] = list(d[k])
        if d.get("profile") is None:      # keep old fingerprints stable
            d.pop("profile", None)
        sp = d.get("scenario_params")
        if sp is None:                    # ditto for param-less specs
            d.pop("scenario_params", None)
        else:
            d["scenario_params"] = {
                k: (list(v) if isinstance(v, (list, tuple)) else v)
                for k, v in sp.items()}
        if d.get("objectives") is None:   # ditto for objective-less specs
            d.pop("objectives", None)
        else:
            d["objectives"] = list(d["objectives"])
        return d

    @staticmethod
    def from_dict(d: Dict) -> "SweepSpec":
        d = dict(d)
        d["arches"] = tuple(d["arches"])
        d["mesh_shapes"] = tuple(tuple(int(x) for x in m)
                                 for m in d["mesh_shapes"])
        for k in ("cells", "logic_nodes", "hbms", "nets"):
            d[k] = tuple(d.get(k) or ())
        d["budget_scales"] = tuple(float(s)
                                   for s in d.get("budget_scales") or (1.0,))
        d.setdefault("profile", None)
        d.setdefault("scenario_params", None)
        d.setdefault("objectives", None)
        if d["objectives"] is not None:
            d["objectives"] = tuple(d["objectives"])
        return SweepSpec(**d)

    def fingerprint(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def resolved_arches(self) -> Tuple[str, ...]:
        out: List[str] = []
        for a in self.arches:
            if a == "all":
                out.extend(ARCH_IDS)
            else:
                out.append(a)
        return tuple(dict.fromkeys(out))

    def budgets(self, scale: float = 1.0) -> Budgets:
        b = Budgets.default()
        if self.area_mm2 is not None:
            b = dataclasses.replace(b, proc_chip_area_mm2=self.area_mm2)
        if self.power_w is not None:
            b = dataclasses.replace(b, power_w=self.power_w)
        if scale != 1.0:
            b = dataclasses.replace(
                b, power_w=b.power_w * scale,
                proc_chip_area_mm2=b.proc_chip_area_mm2 * scale,
                node_area_mm2=b.node_area_mm2 * scale)
        return b


@dataclasses.dataclass(frozen=True)
class PointLabel:
    """One enumerated design point, strings-only (checkpointable)."""

    arch: str
    cell: str                       # cell name, or "prefill+decode" pair id
    mesh: Tuple[int, ...]
    logic: str
    hbm: str
    net: str
    scale: float
    strategy: str                   # Strategy.name notation

    def key(self) -> str:
        return scenarios.point_key(self.arch, self.cell, self.mesh,
                                   self.logic, self.hbm, self.net,
                                   self.scale, self.strategy)


@dataclasses.dataclass(frozen=True)
class Chunk:
    index: int
    labels: Tuple[PointLabel, ...]

    def hash(self, spec_fp: str) -> str:
        blob = spec_fp + ":" + str(self.index) + ":" + \
            ",".join(lb.key() for lb in self.labels)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


def scenario_for(spec: SweepSpec, cell_id: str) -> scenarios.Scenario:
    """The scenario instance scoring one enumerated cell id of a spec
    (cells plus any swept scenario-param overrides carried in the cell
    id's ``@k=v,...`` variant suffix)."""
    return spec.scenario_spec.for_cell_id(cell_id).resolve()


def enumerate_labels(spec: SweepSpec) -> List[PointLabel]:
    """Deterministic cross-product of the sweep axes.

    Strategy candidates come from `planner.candidate_strategies` on the
    scenario's primary (last) cell, so the point set matches what the
    runtime can realize on each mesh.  A train-kind scenario with several
    `spec.cells` sweeps each cell as its own axis value (serving scenarios
    consume their cell pair as one unit); list-valued scenario params
    expand into variants whose cell ids carry the swept values as a
    ``@k=v,...`` suffix.
    """
    from repro_torch.core import planner

    base = scenarios.ScenarioSpec(name=spec.scenario).resolve()
    if isinstance(base, scenarios.TrainScenario) and len(spec.cells) > 1:
        variants = [scenarios.ScenarioSpec(name=spec.scenario,
                                           cells=(c,)).resolve()
                    for c in spec.cells]
    else:
        variants = [v.resolve() for v in spec.scenario_spec.variants()]
    labels: List[PointLabel] = []
    for arch in spec.resolved_arches():
        cfg = get_config(arch)
        for scn in variants:
            if not scn.applicable(cfg):
                continue
            primary = SHAPE_CELLS[scn.cells(cfg)[-1]]
            cell_id = scn.cell_id()
            for mesh in spec.mesh_shapes:
                for st in planner.candidate_strategies(cfg, primary,
                                                       tuple(mesh)):
                    for logic in spec.logic_nodes:
                        for hbm in spec.hbms:
                            for net in spec.nets:
                                for scale in spec.budget_scales:
                                    labels.append(PointLabel(
                                        arch=arch, cell=cell_id,
                                        mesh=tuple(mesh), logic=logic,
                                        hbm=hbm, net=net,
                                        scale=float(scale),
                                        strategy=st.name))
    return labels


def make_chunks(labels: Sequence[PointLabel], size: int) -> List[Chunk]:
    size = max(int(size), 1)
    return [Chunk(i // size, tuple(labels[i:i + size]))
            for i in range(0, len(labels), size)]


def order_chunks(chunks: Sequence[Chunk],
                 scores: Mapping[int, float]) -> List[Chunk]:
    """Schedule-only reordering: highest score first, index tie-break.

    Chunk identities (index, labels, hash) are untouched, so spec
    fingerprints, checkpoint done-lines and resume semantics cannot
    change — only the order work is *attempted* in.  Unscored /
    non-finite-scored chunks sort last, in index order; exact score ties
    fall back to index order, so a permutation of equal-scored inputs
    cannot change the output.
    """
    def key(c: Chunk):
        s = scores.get(c.index)
        if s is None or not np.isfinite(s):
            return (1, 0.0, c.index)
        return (0, -float(s), c.index)
    return sorted(chunks, key=key)


# ---------------------------------------------------------------------------
# Chunk evaluation
# ---------------------------------------------------------------------------

# AGE'd hardware points are immutable; memoize per process and device.
_HW_CACHE: Dict[tuple, object] = {}
_HW_LOCK = threading.Lock()


def _profile_key(spec: SweepSpec) -> Optional[str]:
    """Digest of the embedded profile for hardware-cache keys.

    `_hardware` runs once per resolved point, so the digest is memoized
    on the (frozen, but __dict__-carrying) spec instance — re-serializing
    the profile dict per point would put json+sha1 in the hot chunk loop.
    """
    if spec.profile is None:
        return None
    cached = spec.__dict__.get("_profile_digest")
    if cached is None:
        cached = hashlib.sha1(json.dumps(spec.profile, sort_keys=True)
                              .encode()).hexdigest()[:12]
        object.__setattr__(spec, "_profile_digest", cached)
    return cached


def _hardware(spec: SweepSpec, logic: str, hbm: str, net: str,
              scale: float, device=None):
    """The AGE'd (and, with ``spec.profile``, calibrated) MicroArch of one
    technology point, on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    dev = resolve_device(device)
    key = (logic, hbm, net, scale, spec.area_mm2, spec.power_w,
           _profile_key(spec), pathfinder._device_name(dev))
    with _HW_LOCK:
        hw = _HW_CACHE.get(key)
    if hw is None:
        tech = techlib.make_tech_config(logic, hbm, net)
        hw = age_lib.generate(tech, spec.budgets(scale), device=dev)
        if spec.profile is not None:
            from repro_torch.calibrate import profiles as profiles_lib
            hw = profiles_lib.apply_profile(hw, spec.profile)
        with _HW_LOCK:
            hw = _HW_CACHE.setdefault(key, hw)
    return hw


def spec_ppe(spec: SweepSpec) -> PPEConfig:
    """The PPE config a spec's points are scored with: tiling samples from
    the spec, kernel overhead from the embedded calibration profile."""
    ppe = PPEConfig(n_tilings=spec.n_tilings)
    if spec.profile is not None:
        from repro_torch.calibrate import profiles as profiles_lib
        ppe = profiles_lib.ppe_with_profile(ppe, spec.profile)
    return ppe


def resolve_label(spec: SweepSpec, lb: PointLabel,
                  device=None) -> scenarios.DesignPoint:
    """Resolve one enumerated label into a live `DesignPoint` whose
    hardware lives on ``device`` (AGE'd hardware memoized per process)."""
    return scenarios.DesignPoint(
        arch=lb.arch, cell=lb.cell, mesh=lb.mesh, logic=lb.logic,
        hbm=lb.hbm, net=lb.net, scale=lb.scale,
        strategy=Strategy.parse(lb.strategy), cfg=get_config(lb.arch),
        hw=_hardware(spec, lb.logic, lb.hbm, lb.net, lb.scale, device),
        system=mesh_system(lb.mesh))


# padding quantum of the pipelined executor's batches and of the device
# backend's split rows: per-skeleton miss counts vary from superbatch to
# superbatch (cache hits, mixed scenarios), so each batch is padded to a
# multiple of SHARD_BLOCK rows (x devices) and a sweep's batches take a
# handful of shapes
SHARD_BLOCK = 8


def _eval_labels_impl(spec: SweepSpec, labels: Sequence[PointLabel],
                      cache=pathfinder.DEFAULT_CACHE,
                      shard_devices: bool = False,
                      device=None,
                      bucketed: Optional[bool] = None) -> List[Dict]:
    """Score one chunk of labels -> result records (one batched call on
    ``device``, the card unless the caller asks for ``"cpu"``).

    The label-mode worker behind `pathfinder.evaluate` (the documented
    entry point).  ``cache`` defaults to the `pathfinder.DEFAULT_CACHE`
    sentinel, which resolves the live prediction cache at CALL time;
    ``cache=None`` disables caching.
    """
    cache = pathfinder.resolve_cache(cache)
    ppe = spec_ppe(spec)
    dps, scns, spans = [], [], []
    points: List[pathfinder.EvalPoint] = []
    for lb in labels:
        dp = resolve_label(spec, lb, device)
        scn = scenario_for(spec, lb.cell)
        eps = scn.eval_points(dp)
        spans.append((len(points), len(points) + len(eps)))
        points.extend(eps)
        dps.append(dp)
        scns.append(scn)
    rows = pathfinder.evaluate(points=points, ppe=ppe, cache=cache,
                               shard_devices=shard_devices,
                               shard_block=SHARD_BLOCK, bucketed=bucketed)
    out = []
    for dp, scn, (lo, hi) in zip(dps, scns, spans):
        rec = scn.record(dp, rows[lo:hi])
        rec["key"] = dp.key()
        out.append(rec)
    return out


def eval_labels(spec: SweepSpec, labels: Sequence[PointLabel],
                cache=pathfinder.DEFAULT_CACHE,
                shard_devices: bool = False, device=None) -> List[Dict]:
    """Deprecated alias — use ``pathfinder.evaluate(spec=..., labels=...)``
    (one documented facade over the historical eval entry points)."""
    warnings.warn("sweeprunner.eval_labels is deprecated; use "
                  "pathfinder.evaluate(spec=..., labels=...)",
                  DeprecationWarning, stacklevel=2)
    return _eval_labels_impl(spec, labels, cache=cache,
                             shard_devices=shard_devices, device=device)


def _process_eval(spec_dict: Dict, chunk_index: int,
                  labels: Tuple[PointLabel, ...], device: str,
                  bucketed: Optional[bool] = None) -> Tuple[int, List[Dict]]:
    """Worker-process entry of the ``process`` backend.  The chunk's labels
    travel with the task (plain string dataclasses pickle cheaply) —
    re-enumerating the whole cross-product per chunk would cost
    O(n_chunks x n_points) — and so do the runner's device and
    bucketing."""
    return chunk_index, _eval_labels_impl(SweepSpec.from_dict(spec_dict),
                                          labels, device=device,
                                          bucketed=bucketed)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunStats:
    """What one `SweepRunner.run` call did (resume accounting included).

    ``cache_hits``/``cache_misses`` are this run's prediction-cache delta
    and ``compile_hits``/``compile_misses`` the compiled-store delta
    (`pathfinder.compile_cache_stats`), so cache efficacy is visible per
    sweep instead of only as process-lifetime totals.
    ``compile_seconds`` is the wall time this run spent in the port's
    compile (tracing designs into their buckets, wherever it ran: the
    compile service's threads or the dispatch path) and
    ``stall_seconds`` the part that blocked evaluation; a healthy
    compile-ahead run shows compile_seconds > 0 with stall_seconds near
    0.  In frontier mode (``frontier_only``)
    ``records`` holds just the surviving Pareto frontier and
    ``n_frontier_overflowed`` counts candidates the bounded
    device-resident state had to drop (0 = the frontier is exact).
    """

    n_points_total: int
    n_chunks_total: int
    n_chunks_skipped: int
    n_chunks_evaluated: int
    n_points_evaluated: int
    elapsed_s: float
    backend: str
    out_dir: Optional[str]
    records: Optional[List[Dict]] = None
    cache_hits: int = 0
    cache_misses: int = 0
    compile_hits: int = 0
    compile_misses: int = 0
    compile_seconds: float = 0.0
    stall_seconds: float = 0.0
    frontier_only: bool = False
    n_frontier_overflowed: int = 0

    @property
    def complete(self) -> bool:
        return (self.n_chunks_skipped + self.n_chunks_evaluated
                == self.n_chunks_total)


BACKENDS = ("pipeline", "serial", "thread", "process", "device")


def pick_backend(backend: str = "auto") -> str:
    """``auto`` resolves to the pipelined executor, as in the reference: it
    overlaps host packing, device work and JSONL commits."""
    if backend == "auto":
        return "pipeline"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected "
                         "pipeline|serial|thread|process|device|auto")
    return backend


def enable_compilation_cache(cache_dir: str) -> bool:
    """The reference's persistent compilation cache (XLA executables
    serialized under ``cache_dir``, so a cold start or a ``--resume``
    skips recompiles): nothing in the port is compiled to disk.  Its
    compile is a design's trace on the host, kept in the process
    (`core/compileahead.py`); persisting the traces would be the
    counterpart, and nothing here does it yet.  Returns False: no cache
    was enabled."""
    del cache_dir
    return False


class SweepRunner:
    """Chunked, checkpointed executor for one `SweepSpec` on one device.

    Layout of ``out_dir`` (all appends flushed per chunk):

      spec.json         {"version", "fingerprint", "spec": {...}}
      results.jsonl     one record per design point, tagged with its chunk
      checkpoint.jsonl  one line per *finished* chunk: {"chunk","hash","n"}

    (a frontier-only run writes ``frontier_state.npz`` and
    ``frontier.jsonl`` in place of the last two).  The done-line is
    written after the chunk's rows, so a crash can only leave rows from an
    unfinished chunk behind; resume compacts them away before continuing.
    ``device`` (the card unless the caller asks for ``"cpu"``) is where
    every point is scored; it, the backend, ``workers`` (the pool size of
    the thread / process backends) and ``superbatch`` (design points per
    device dispatch on the pipeline) are execution-only.
    """

    def __init__(self, spec: SweepSpec, out_dir: Optional[str] = None,
                 backend: str = "auto", workers: Optional[int] = None,
                 cache=pathfinder.DEFAULT_CACHE,
                 superbatch: Optional[int] = None,
                 compile_ahead: Optional[int] = None,
                 bucketing: Optional[bool] = None, device=None):
        from repro_torch.core import sweeppipeline
        sweeppipeline.check_knobs(compile_ahead=compile_ahead)
        self.spec = spec
        self.out_dir = out_dir
        self.backend = pick_backend(backend)
        self.workers = workers or min(4, os.cpu_count() or 1)
        # DEFAULT_CACHE sentinel: resolve the live singleton at call time
        self.cache = pathfinder.resolve_cache(cache)
        self.superbatch = superbatch
        # compile-ahead lookahead depth / cross-design bucketing (None =
        # module defaults; execution-only knobs — no effect on chunk
        # hashes, point keys, records, or resume)
        self.compile_ahead = compile_ahead
        self.bucketing = bucketing
        self.device = resolve_device(device)
        self._fp = spec.fingerprint()

    # -- persistence ------------------------------------------------------
    @staticmethod
    def from_dir(out_dir: str, **kwargs) -> "SweepRunner":
        """Rebuild a runner from a previous run's spec.json (CLI --resume
        does this, so a resumed sweep needs no re-specified axes)."""
        return SweepRunner(_load_spec(out_dir), out_dir=out_dir, **kwargs)

    def read_results(self) -> List[Dict]:
        """All records currently streamed to results.jsonl."""
        _, res_path, _ = _paths(self.out_dir)
        return list(_iter_jsonl(res_path))

    # -- execution --------------------------------------------------------
    def _stat_snapshot(self) -> Tuple[Dict, Dict]:
        cache_stats = self.cache.stats if self.cache is not None \
            else {"hits": 0, "misses": 0}
        return cache_stats, pathfinder.compile_cache_stats()

    def _stat_delta(self, before: Tuple[Dict, Dict]) -> Dict[str, float]:
        (c0, k0), (c1, k1) = before, self._stat_snapshot()
        return {"cache_hits": c1["hits"] - c0["hits"],
                "cache_misses": c1["misses"] - c0["misses"],
                "compile_hits": k1["hits"] - k0["hits"],
                "compile_misses": k1["misses"] - k0["misses"],
                "compile_seconds": k1["compile_seconds"]
                - k0["compile_seconds"],
                "stall_seconds": k1["stall_seconds"] - k0["stall_seconds"]}

    def run(self, resume: bool = False, max_chunks: Optional[int] = None,
            collect: bool = True, verbose: bool = False,
            frontier_only: bool = False,
            frontier_capacity: int = pathfinder.FRONTIER_CAPACITY
            ) -> RunStats:
        """Execute (or continue) the sweep.

        resume      skip chunks recorded in checkpoint.jsonl (zero
                    re-evaluation); requires the identical spec.
        max_chunks  stop after N chunks (benchmarks/tests simulate an
                    interrupted sweep with this).
        collect     return the accumulated records on RunStats.records.
        frontier_only
                    device-resident streaming-Pareto mode: per-point rows
                    never materialize on host; RunStats.records holds only
                    the frontier (written to DIR/frontier.jsonl, with the
                    carried state checkpointed to DIR/frontier_state.npz
                    and no results/checkpoint stream).
        """
        if frontier_only:
            return self._run_frontier(max_chunks=max_chunks,
                                      capacity=frontier_capacity,
                                      resume=resume)
        t0 = time.perf_counter()
        stats0 = self._stat_snapshot()
        labels = enumerate_labels(self.spec)
        chunks = make_chunks(labels, self.spec.chunk_size)
        done: Dict[int, str] = {}
        journal: Optional[sweepexec.ChunkJournal] = None
        memory_rows: List[Dict] = []

        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            spec_path, res_path, ckpt_path = _paths(self.out_dir)
            if resume:
                done = _load_done(spec_path, ckpt_path, chunks, self._fp)
                # drop rows of unfinished chunks (a crash between the row
                # append and the done-line) so resumed output has no
                # duplicates
                sweepexec.ChunkJournal(res_path, "").compact(done)
            elif os.path.exists(ckpt_path):
                # never silently destroy a previous sweep's checkpoints: a
                # forgotten --resume must not cost hours of finished chunks
                raise FileExistsError(
                    f"{self.out_dir} already holds a checkpointed sweep; "
                    f"pass resume=True (CLI: --resume) to continue it, or "
                    f"point --out at a fresh directory")
            sweepexec.write_spec_head(spec_path, SPEC_VERSION, self._fp,
                                      self.spec.to_dict())
            journal = sweepexec.ChunkJournal(res_path, ckpt_path).open()
        elif resume:
            raise ValueError("resume=True requires an out_dir")

        pending = [c for c in chunks if c.index not in done]
        if max_chunks is not None:
            pending = pending[:max_chunks]

        n_eval_points = 0

        def commit(chunk: Chunk, records: List[Dict]):
            nonlocal n_eval_points
            n_eval_points += len(records)
            if journal is not None:
                journal.commit(chunk.index, chunk.hash(self._fp), records)
            else:
                memory_rows.extend(records)
            if verbose:
                print(f"# chunk {chunk.index} done "
                      f"({len(records)} points)", flush=True)

        try:
            self._execute(pending, commit)
        finally:
            if journal is not None:
                journal.close()

        records: Optional[List[Dict]] = None
        if collect:
            if self.out_dir is not None:
                records = [{k: v for k, v in r.items() if k != "chunk"}
                           for r in self.read_results()]
            else:
                records = memory_rows
        return RunStats(
            n_points_total=len(labels), n_chunks_total=len(chunks),
            n_chunks_skipped=len(done), n_chunks_evaluated=len(pending),
            n_points_evaluated=n_eval_points,
            elapsed_s=time.perf_counter() - t0, backend=self.backend,
            out_dir=self.out_dir, records=records,
            **self._stat_delta(stats0))

    def _executor(self):
        from repro_torch.core import sweeppipeline
        return sweeppipeline.PipelineExecutor(
            self.spec, cache=self.cache,
            superbatch=self.superbatch or sweeppipeline.SUPERBATCH,
            compile_ahead=self.compile_ahead, bucketing=self.bucketing,
            device=self.device)

    def _load_frontier_state(self, spec_path: str, state_path: str,
                             ckpt_path: str, chunks: List[Chunk],
                             capacity: int):
        """(carried state, done chunks) of an interrupted frontier sweep.

        Unlike `_load_done`, a mismatched chunk is fatal rather than
        re-evaluated: its points are already folded into the carried state
        and cannot be dropped again."""
        if os.path.exists(ckpt_path):
            raise ValueError(
                f"{self.out_dir} holds a full-sweep checkpoint, not a "
                f"frontier-state checkpoint; resume it without "
                f"--frontier-only, or point --out at a fresh directory")
        sweepexec.check_fingerprint(spec_path, self._fp)
        if not os.path.exists(state_path):
            return None, {}             # spec written, nothing merged yet
        return sweepexec.load_frontier_state(state_path, self._fp,
                                             capacity, chunks)

    def _run_frontier(self, max_chunks: Optional[int], capacity: int,
                      resume: bool) -> RunStats:
        """Frontier-only mode: stream every point through the
        device-resident Pareto reduction; only the surviving records come
        back to host (DIR/frontier.jsonl when an out_dir is set).  The
        carried state checkpoints to DIR/frontier_state.npz per committed
        superbatch, so an interrupted frontier sweep resumes with zero
        re-evaluation — in either package."""
        t0 = time.perf_counter()
        stats0 = self._stat_snapshot()
        labels = enumerate_labels(self.spec)
        chunks = make_chunks(labels, self.spec.chunk_size)
        state0 = None
        done: Dict[int, str] = {}
        state_path = None
        if self.out_dir is not None:
            # validate the destination BEFORE evaluating anything: a
            # guard that fires after the sweep would discard hours of
            # frontier compute
            spec_path, _, ckpt_path = _paths(self.out_dir)
            state_path = os.path.join(self.out_dir, "frontier_state.npz")
            if resume:
                state0, done = self._load_frontier_state(
                    spec_path, state_path, ckpt_path, chunks, capacity)
            else:
                os.makedirs(self.out_dir, exist_ok=True)
                if os.path.exists(ckpt_path):
                    raise FileExistsError(
                        f"{self.out_dir} already holds a checkpointed "
                        f"sweep; frontier-only output would shadow it — "
                        f"point --out at a fresh directory")
                if os.path.exists(state_path):
                    raise FileExistsError(
                        f"{self.out_dir} already holds a frontier-state "
                        f"checkpoint; pass resume=True (CLI: --resume) to "
                        f"continue it, or point --out at a fresh "
                        f"directory")
            sweepexec.write_spec_head(spec_path, SPEC_VERSION, self._fp,
                                      self.spec.to_dict())
        elif resume:
            raise ValueError("resume=True requires an out_dir")
        pending = [c for c in chunks if c.index not in done]
        if max_chunks is not None:
            pending = pending[:max_chunks]
        on_commit = None
        if state_path is not None:
            committed = dict(done)
            by_index = {c.index: c for c in chunks}

            def on_commit(indices, host_state):
                for i in indices:
                    committed[i] = by_index[i].hash(self._fp)
                sweepexec.save_frontier_state(state_path, host_state,
                                              committed, capacity, self._fp)
        records, n_over, n_points = self._executor().run_frontier(
            pending, capacity=capacity, state=state0, on_commit=on_commit,
            all_chunks=chunks)
        if self.out_dir is not None:
            front_path = os.path.join(self.out_dir, "frontier.jsonl")
            tmp = front_path + ".tmp"
            with open(tmp, "w") as fh:
                for rec in records:
                    fh.write(json.dumps(json_safe(rec)) + "\n")
            os.replace(tmp, front_path)
        return RunStats(
            n_points_total=len(labels), n_chunks_total=len(chunks),
            n_chunks_skipped=len(done), n_chunks_evaluated=len(pending),
            n_points_evaluated=n_points,
            elapsed_s=time.perf_counter() - t0, backend="pipeline",
            out_dir=self.out_dir, records=records,
            frontier_only=True, n_frontier_overflowed=n_over,
            **self._stat_delta(stats0))

    def _execute(self, pending: List[Chunk], commit):
        """Score ``pending`` on the runner's backend, committing each chunk
        through ``commit``: in chunk order (pipeline, serial) or as the
        chunks complete (thread, process)."""
        spec = self.spec
        if self.backend == "pipeline":
            self._executor().run(pending, commit)
        elif self.backend in ("serial", "device"):
            # the runner's bucketing goes down with each call (the
            # reference scopes the process default around the run)
            for c in pending:
                commit(c, _eval_labels_impl(
                    spec, c.labels, cache=self.cache,
                    shard_devices=self.backend == "device",
                    device=self.device, bucketed=self.bucketing))
        elif self.backend == "thread":
            with ThreadPoolExecutor(self.workers) as ex:
                futs = {ex.submit(_eval_labels_impl, spec, c.labels,
                                  self.cache, device=self.device,
                                  bucketed=self.bucketing): c
                        for c in pending}
                for f in as_completed(futs):
                    commit(futs[f], f.result())
        else:                                 # process
            import multiprocessing as mp
            ctx = mp.get_context("spawn")     # CUDA cannot be forked
            spec_dict = spec.to_dict()
            by_index = {c.index: c for c in pending}
            with ProcessPoolExecutor(self.workers, mp_context=ctx) as ex:
                futs = [ex.submit(_process_eval, spec_dict, c.index,
                                  c.labels, str(self.device),
                                  self.bucketing)
                        for c in pending]
                for f in as_completed(futs):
                    idx, records = f.result()
                    commit(by_index[idx], records)


# ---------------------------------------------------------------------------
# Output helpers
# ---------------------------------------------------------------------------

LABEL_FIELDS = ("arch", "cell", "mesh", "logic", "hbm", "net", "scale",
                "strategy", "devices")


def _paths(out_dir: str):
    return (os.path.join(out_dir, "spec.json"),
            os.path.join(out_dir, "results.jsonl"),
            os.path.join(out_dir, "checkpoint.jsonl"))


def _load_spec(out_dir: str) -> SweepSpec:
    with open(os.path.join(out_dir, "spec.json")) as fh:
        head = json.load(fh)
    return SweepSpec.from_dict(head["spec"])


def _load_done(spec_path: str, ckpt_path: str, chunks: List[Chunk],
               fingerprint: str) -> Dict[int, str]:
    """Finished chunks of a previous run, hash-verified against the
    current enumeration (a stale/corrupt line is just re-evaluated)."""
    sweepexec.check_fingerprint(spec_path, fingerprint)
    return sweepexec.ChunkJournal("", ckpt_path).load_done(chunks,
                                                           fingerprint)


def label_from_record(rec: Dict) -> PointLabel:
    """Rebuild the enumerated `PointLabel` of one result record (the
    inverse of `DesignPoint.label_fields`)."""
    return PointLabel(
        arch=str(rec["arch"]), cell=str(rec["cell"]),
        mesh=tuple(int(x) for x in str(rec["mesh"]).split("x")),
        logic=str(rec["logic"]), hbm=str(rec["hbm"]), net=str(rec["net"]),
        scale=float(rec["scale"]), strategy=str(rec["strategy"]))


def load_sweep(out_dir: str) -> Tuple[SweepSpec, List[Dict]]:
    """Load a checkpointed sweep's (spec, finished-chunk records).

    Only rows belonging to hash-verified finished chunks are returned (a
    crash-torn partial chunk is dropped exactly as `run(resume=True)`
    would), so consumers like ``pathfind size --from DIR`` read
    already-scored points with zero re-evaluation.  Nothing is evaluated,
    so nothing needs a device.
    """
    spec = _load_spec(out_dir)
    spec_path, res_path, ckpt_path = _paths(out_dir)
    chunks = make_chunks(enumerate_labels(spec), spec.chunk_size)
    done = _load_done(spec_path, ckpt_path, chunks, spec.fingerprint())
    records = [{k: v for k, v in rec.items() if k != "chunk"}
               for rec in _iter_jsonl(res_path)
               if rec.get("chunk") in done]
    return spec, records


def csv_fields(scenario: scenarios.Scenario) -> Tuple[str, ...]:
    return LABEL_FIELDS + tuple(scenario.fields)


def to_csv(records: Sequence[Dict], scenario: scenarios.Scenario) -> str:
    fields = csv_fields(scenario)

    def fmt(v):
        if isinstance(v, bool) or v is None:
            return str(v)
        if isinstance(v, float):
            return f"{v:.6e}" if (v and abs(v) < 1e-2) else f"{v:g}"
        return str(v)

    lines = [",".join(fields)]
    for r in records:
        lines.append(",".join(fmt(r.get(f)) for f in fields))
    return "\n".join(lines)


def pareto_records(records: Sequence[Dict],
                   objectives: Sequence[str]) -> List[Dict]:
    """Non-dominated subset of result records over numeric objective
    fields, in input order.

    Infeasible serving points (``feasible: false``), SLO-wall violations
    (``slo_ok: false`` — percentile SLOs are feasibility walls, matching
    the scenarios' `objective_values`), and records whose objective values
    are missing/None (what `json_safe` writes for non-finite metrics) or
    non-finite are excluded up front — an unusable design can otherwise
    survive the frontier on its one finite objective (e.g. best TTFT with
    infinite cost).  The dominance check is a sorted incremental skyline
    over NumPy rows (each candidate is compared only against the running
    frontier, which transitivity makes sufficient).

    Tie semantics: records exactly equal on ALL objectives do not dominate
    each other — every copy of a non-dominated point is kept, and the
    result order (input order) is deterministic regardless of how the
    lexsort breaks ties, as in `pathfinder.pareto_front`.

    Objective directions come from the `core/objectives.py` registry:
    max-direction objectives (goodput) are sign-flipped into canonical
    minimizing space before the skyline.  The default all-minimizing path
    is untouched (records never multiply by the +1 signs).
    """
    from repro_torch.core import objectives as objectives_lib
    signs = objectives_lib.canonical_signs(objectives)

    def objvals(r) -> Optional[List[float]]:
        try:
            vs = [float(r[k]) for k in objectives]
        except (KeyError, TypeError, ValueError):
            return None
        return vs if all(np.isfinite(v) for v in vs) else None

    recs, rows = [], []
    for r in records:
        if not r.get("feasible", True) or r.get("slo_ok") is False:
            continue
        vs = objvals(r)
        if vs is not None:
            recs.append(r)
            rows.append(vs)
    if not recs:
        return []
    vals = np.asarray(rows, dtype=np.float64)
    if any(s < 0 for s in signs):
        vals = vals * np.asarray(signs, dtype=np.float64)
    order = np.lexsort(vals.T[::-1])       # by first objective, then rest
    front = np.empty((0, vals.shape[1]))
    keep: List[int] = []
    for i in order:
        v = vals[i]
        if front.size and bool(np.any(
                np.all(front <= v, axis=1) & np.any(front < v, axis=1))):
            continue
        keep.append(int(i))
        front = np.vstack([front, v])
    return [recs[i] for i in sorted(keep)]
