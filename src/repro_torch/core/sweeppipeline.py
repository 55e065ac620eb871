"""Pipelined device-resident sweep executor — the 10^6-point hot path.

The PyTorch port of ``repro.core.sweeppipeline``.  The serial backend of
`sweeprunner` resolves labels, packs hardware vectors, runs the batched
evaluator and folds records in ONE synchronous loop per chunk, so a sweep
alternates host-side Python with device work and JSONL writes on the
critical path.  This module rebuilds that hot path as an asynchronous,
double-buffered pipeline (`SweepRunner(backend="pipeline")`, the default):

  * a **producer thread** resolves and packs superbatch N+1 while N runs
    on the card: per-label work is reduced to dict lookups — design
    skeletons (scenario, parsed strategy, system graph, workload graphs,
    evaluators, record templates) are memoized per (arch, cell, mesh,
    strategy), AGE'd-and-packed hardware rows per (logic, hbm, net, scale)
    in a process-global row cache — and prediction-cache probes are
    batched into one locked pass (`PredictionCache.get_many`); the
    ``(B, HW_DIM)`` miss matrix is a NumPy gather over unique rows, never
    a per-label Python pack;
  * the **device stage** (the caller's thread) dispatches consecutive
    chunks as one *superbatch* on the executor's own CUDA stream.  With
    bucketing (off by default, `core/compileahead.py`) every (design,
    eval-point) pair whose canonical graph landed in one bucket rides in
    one *megabatch*: the rows of many designs, each row gathering its
    design's coefficient packs, through one vmapped replay of the shared
    graph; without it, every eval point of a design is fused into one
    ``torch.func.vmap`` of the design function (a serving design's
    prefill and decode graphs are one call, not two).  Either way the
    packed matrix rides up from pinned host memory with
    ``non_blocking=True``, batches are block-padded, a batch of at least
    ``shard_min_rows`` rows is split over ``devices`` (shard *i* on
    ``cuda:i``, `pathfinder.run_sharded`), and the rows go back into a
    pinned host buffer the same way, followed by a recorded
    ``torch.cuda.Event``;
  * with ``compile_ahead`` > 0 the producer packs that many superbatches
    ahead of the device stage and hands their designs to the compile
    service (`compileahead.CompileService.warm_design`), so the designs'
    traces — the port's compile — run off the critical path; a design
    the service has not reached is traced inline by the device stage
    (``stall_seconds``);
  * a **writer thread** waits on each group's event (never on
    ``torch.cuda.synchronize()``, which would stall the superbatch behind
    it), folds records through the scenario's `metrics_fold` fast path and
    commits JSONL rows + checkpoint lines off the critical path,
    preserving chunk order — ``resume`` semantics are byte-identical to
    the synchronous backends (a crash loses at most the in-flight
    superbatches).

Every tensor of a dispatch is made on the executor's stream (the pinned
host buffers are host memory, whose reuse the caching host allocator
orders behind the copies); the one kind made elsewhere, a hardware
template's tensor leaves (AGE'd by the producer on its default stream,
finished before their row exists, since packing copies them to host),
gets ``record_stream`` for the executor's stream.  Host reads of device
tensors happen on that stream, or after its events.

`PipelineExecutor.run_frontier` is the device-resident reduction mode
behind ``pathfind sweep --frontier-only``: the scenario's objective fold
(`Scenario.frontier_fold`) and a streaming Pareto merge
(`pathfinder.frontier_merge`) run behind the batched evaluation on the
card, the carried frontier state stays there between superbatches, and
only the surviving frontier (plus its raw metric rows) comes to host, at
each committed superbatch's checkpoint and at the end — full per-point
rows never materialize.

The streaming frontier scores its rows as the full path does (bucketed
or not), so its payload rows are the records' rows bit for bit.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core import pathfinder, scenarios
from repro_torch.core.parallelism import Strategy
from repro_torch.core.placement import mesh_system

# design points per device dispatch: consecutive chunks are packed into one
# superbatch so per-dispatch overhead amortizes over ~10x more points than
# the default chunk size (commit granularity stays per chunk)
SUPERBATCH = 256
# superbatches packed (and their designs handed to the compile service)
# ahead of the device stage, so a cold sweep's traces run off the critical
# path (see repro_torch.core.compileahead); 0 disables lookahead
COMPILE_AHEAD = 2
# packed-superbatch lookahead per queue (producer -> device -> writer):
# 2 = double buffering at each stage boundary
QUEUE_DEPTH = 2
# minimum rows of one dispatch before splitting it over several devices
# pays (the reference's PMAP_MIN_ROWS): below it, one device's batch
SHARD_MIN_ROWS = 1024

# process-global packed-hardware rows, keyed like `sweeprunner._HW_CACHE`
# (tech axis + budget overrides + profile digest + device).  Packing pulls
# the leaves of a card-resident MicroArch to the host — paying that once
# per process instead of once per run keeps the producer's per-label cost
# at dict-lookup speed.  LRU-capped: each entry pins a MicroArch, and a
# long-lived process sweeping many tech/scale/profile axes must not grow
# it forever.
_ROW_CACHE: "collections.OrderedDict[tuple, tuple]" = \
    collections.OrderedDict()
_ROW_CACHE_MAXSIZE = 4096
_ROW_LOCK = threading.Lock()


def _row_cache_get(key) -> Optional[tuple]:
    with _ROW_LOCK:
        ent = _ROW_CACHE.get(key)
        if ent is not None:
            _ROW_CACHE.move_to_end(key)
        return ent


def _row_cache_put(key, ent: tuple) -> tuple:
    with _ROW_LOCK:
        ent = _ROW_CACHE.setdefault(key, ent)
        _ROW_CACHE.move_to_end(key)
        while len(_ROW_CACHE) > _ROW_CACHE_MAXSIZE:
            _ROW_CACHE.popitem(last=False)
        return ent


def check_knobs(compile_ahead: Optional[int] = None) -> None:
    """The execution knobs' own check: ``compile_ahead`` is a count of
    superbatches (``devices`` is checked where the executor resolves it,
    `pathfinder.shard_devices`)."""
    if compile_ahead is not None and compile_ahead < 0:
        raise ValueError(f"compile_ahead must be >= 0 superbatches, got "
                         f"{compile_ahead}")


def _join_producer(producer: threading.Thread, pack_q: "queue.Queue"):
    """Join the producer, draining its bounded queue while waiting.

    An exception that escapes the consumer loop (KeyboardInterrupt landing
    outside the inner try) leaves the producer blocked in a `put()` on the
    full queue with nobody reading; a bare `join()` would then hang
    forever.  Draining between join attempts unblocks it, and the
    producer's own error check / sentinel path finishes it off.
    """
    while True:
        producer.join(timeout=0.1)
        if not producer.is_alive():
            return
        try:
            while True:
                pack_q.get_nowait()
        except queue.Empty:
            pass


@dataclasses.dataclass
class _DesignSkeleton:
    """Everything shared by labels of one (arch, cell, mesh, strategy):
    resolved once, then every label in the cell is a pair of dict hits."""

    scn: scenarios.Scenario
    cfg: object
    strategy: Strategy
    system: object
    graphs: Tuple
    evaluators: Tuple[pathfinder.BatchedEvaluator, ...]
    fold: Optional[Callable]         # device frontier-objective fold
    mfold: Optional[Callable]        # host metric fold (record fast path)
    base_fields: Dict                # record template (label-field order)
    key_pre: str                     # "arch|cell|mesh" of point_key
    key_suf: str                     # strategy part of point_key
    # scenario identity (spec params + cell variant) baked into fold/mfold;
    # groups must not mix fold_keys even when the eval-shape keys coincide
    # (variants share graphs, not walls)
    fold_key: tuple = ()
    # systolic_dims -> per-eval-point skeleton key tuple
    skel_keys: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)

    @property
    def ppd(self) -> int:
        return len(self.graphs)


class _HostRows:
    """One dispatch's result rows on their way to the host: a pinned
    buffer filled by a non-blocking copy and the event recorded behind it
    (on the CPU, the rows themselves).  A megabatch's rows are shared by
    every (group, eval point) that rode in it, so they are read once."""

    def __init__(self, buf: torch.Tensor, event=None):
        self._buf, self._event = buf, event
        self._host: Optional[np.ndarray] = None

    def rows(self) -> np.ndarray:
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            host = self._buf.numpy().astype(np.float64)
            self._host = host.reshape(-1, host.shape[-1])
            self._buf = None
        return self._host


@dataclasses.dataclass
class _Group:
    """One batched design function inside a pack: all miss labels sharing
    a design skeleton + systolic dims."""

    skel: _DesignSkeleton
    keys: tuple                      # per-eval-point skeleton keys
    template: object                 # MicroArch supplying static leaves
    ridx: List[int] = dataclasses.field(default_factory=list)
    row_bytes: List[bytes] = dataclasses.field(default_factory=list)
    slots: List[tuple] = dataclasses.field(default_factory=list)
    gidx: List[int] = dataclasses.field(default_factory=list)
    # in-flight result: the group's rows, or (bucketed) one (rows, lo, hi)
    # slice of a megabatch per eval point
    out: object = None
    n: int = 0


@dataclasses.dataclass
class _Pack:
    """One packed superbatch: chunks + per-label resolution + cache hits
    + batched groups (built by the producer stage)."""

    chunks: List
    meta: List[List]                 # [ci][li] -> (skel, hw entry)
    cached: Dict[tuple, np.ndarray]  # (ci, li) -> (ppd, 5) f64 rows
    groups: Dict[tuple, _Group]


class PipelineExecutor:
    """Asynchronous producer -> device -> writer pipeline for one spec on
    ``device`` (the card unless the caller asks for ``"cpu"``).

    One instance per `SweepRunner.run` call; the packed hardware rows, the
    designs' canonical buckets and the batched functions (the
    process-wide `pathfinder._COMPILED` store) are memoized process-wide,
    so repeated runs stay warm.  ``devices`` (default 1) bounds how many
    devices a dispatch of at least ``shard_min_rows`` rows is split over;
    ``compile_ahead`` (default `COMPILE_AHEAD`) and ``bucketing``
    (default: the process default, off) are the reference's knobs.
    """

    def __init__(self, spec, cache=pathfinder.DEFAULT_CACHE,
                 superbatch: int = SUPERBATCH,
                 devices: Optional[int] = None,
                 threads: Optional[bool] = None,
                 compile_ahead: Optional[int] = None,
                 bucketing: Optional[bool] = None,
                 shard_min_rows: int = SHARD_MIN_ROWS, device=None):
        from repro_torch.core import compileahead, sweeprunner
        check_knobs(compile_ahead)
        self.spec = spec
        self.cache = pathfinder.resolve_cache(cache)
        self.device = resolve_device(device)
        self._dev_name = pathfinder._device_name(self.device)
        self.ppe = sweeprunner.spec_ppe(spec)
        self.superbatch = max(int(superbatch), spec.chunk_size, 1)
        self.shard_devs = pathfinder.shard_devices(self.device, devices)
        self.devices = len(self.shard_devs)
        self.shard_min_rows = shard_min_rows
        # producer/writer threads only pay off when the host has spare
        # cores for them: on <=3 cores the GIL serializes the Python
        # stages anyway, so the inline mode double-buffers through the
        # stream's asynchrony alone
        self.threads = threads if threads is not None \
            else (os.cpu_count() or 1) >= 4
        self.compile_ahead = COMPILE_AHEAD if compile_ahead is None \
            else int(compile_ahead)
        self.bucketing = compileahead.resolve_bucketed(bucketing)
        self.block = sweeprunner.SHARD_BLOCK
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._skels: Dict[tuple, _DesignSkeleton] = {}
        self._scn_fp = json.dumps(spec.scenario_spec.to_dict(),
                                  sort_keys=True)
        self._hw: Dict[tuple, tuple] = {}
        self._rows: List[np.ndarray] = []     # unique packed hw rows
        self._rowmat: Optional[np.ndarray] = None
        self._streamed: set = set()           # ids on the stream already
        # keys the compile service pinned on our behalf (see _prefetch);
        # the device stage releases a key's pins after its first dispatch
        self._aot_pins: "collections.Counter" = collections.Counter()
        self._pin_lock = threading.Lock()

    # -- memoized resolution ---------------------------------------------
    def _hw_entry(self, lb) -> tuple:
        """(hw arch, row index, row bytes, scale string) of one label."""
        from repro_torch.core import sweeprunner
        hkey = (lb.logic, lb.hbm, lb.net, lb.scale)
        ent = self._hw.get(hkey)
        if ent is None:
            gkey = hkey + (self.spec.area_mm2, self.spec.power_w,
                           sweeprunner._profile_key(self.spec),
                           self._dev_name)
            cached = _row_cache_get(gkey)
            if cached is None:
                hw = sweeprunner._hardware(self.spec, lb.logic, lb.hbm,
                                           lb.net, lb.scale, self.device)
                row = pathfinder.pack_hw(hw)
                cached = _row_cache_put(
                    gkey, (hw, row, row.tobytes(), f"{lb.scale:g}"))
            hw, row, rbytes, scale_str = cached
            ridx = len(self._rows)
            self._rows.append(row)
            self._rowmat = None
            ent = (hw, ridx, rbytes, scale_str)
            self._hw[hkey] = ent
        return ent

    def _skeleton(self, lb) -> _DesignSkeleton:
        from repro_torch.core import sweeprunner
        skey = (lb.arch, lb.cell, lb.mesh, lb.strategy)
        sk = self._skels.get(skey)
        if sk is None:
            hw = self._hw_entry(lb)[0]
            scn = sweeprunner.scenario_for(self.spec, lb.cell)
            cfg = get_config(lb.arch)
            st = Strategy.parse(lb.strategy)
            system = mesh_system(lb.mesh)
            dp = scenarios.DesignPoint(
                arch=lb.arch, cell=lb.cell, mesh=lb.mesh, logic=lb.logic,
                hbm=lb.hbm, net=lb.net, scale=lb.scale, strategy=st,
                cfg=cfg, hw=hw, system=system)
            eps = scn.eval_points(dp)
            evs = tuple(pathfinder.BatchedEvaluator(
                ep.graph, st, system=ep.system, ppe=self.ppe,
                pod_bw=ep.pod_bw, cache=None, device=self.device)
                for ep in eps)
            name = st.name
            mesh_str = "x".join(map(str, lb.mesh))
            base = {"arch": lb.arch, "cell": lb.cell, "mesh": mesh_str,
                    "logic": None, "hbm": None, "net": None, "scale": None,
                    "strategy": name, "devices": st.devices}
            sk = _DesignSkeleton(
                scn=scn, cfg=cfg, strategy=st, system=system,
                graphs=tuple(ep.graph for ep in eps), evaluators=evs,
                fold=scn.frontier_fold(cfg, st),
                mfold=scn.metrics_fold(cfg, st, lb.cell),
                base_fields=base,
                key_pre=f"{lb.arch}|{lb.cell}|{mesh_str}", key_suf=name,
                fold_key=(self._scn_fp, lb.cell))
            self._skels[skey] = sk
        return sk

    def _group_keys(self, sk: _DesignSkeleton, hw) -> tuple:
        sd = tuple(hw.tech.compute.systolic_dims)
        keys = sk.skel_keys.get(sd)
        if keys is None:
            keys = tuple(ev._skeleton(hw) for ev in sk.evaluators)
            sk.skel_keys[sd] = keys
        return keys

    def _design_point(self, lb, sk: _DesignSkeleton,
                      hw) -> scenarios.DesignPoint:
        return scenarios.DesignPoint(
            arch=lb.arch, cell=lb.cell, mesh=lb.mesh, logic=lb.logic,
            hbm=lb.hbm, net=lb.net, scale=lb.scale, strategy=sk.strategy,
            cfg=sk.cfg, hw=hw, system=sk.system)

    # -- the batched functions -------------------------------------------
    def _on_this_stream(self, tensors) -> None:
        """Tensors made on another stream (a template's leaves AGE'd by the
        producer, packs uploaded by the compile service; each finished
        before this stage can see it) are used on the executor's stream:
        `record_stream` keeps the allocator from reusing them early."""
        if self.stream is None:
            return
        for t in tensors:
            if torch.is_tensor(t) and id(t) not in self._streamed:
                t.record_stream(self.stream)
                self._streamed.add(id(t))

    def _template_on_stream(self, template) -> None:
        for f in dataclasses.fields(template):
            leaf = getattr(template, f.name)
            self._on_this_stream(leaf if isinstance(leaf, tuple)
                                 else (leaf,))

    def _design_scalar(self, group: _Group, template=None) -> Callable:
        """v (HW_DIM,) -> (ppd, 5) metric rows: every eval point of one
        design in one function (on ``template``, default the group's)."""
        scalars = [ev._scalar_fn(group.template if template is None
                                 else template)
                   for ev in group.skel.evaluators]

        def design(v):
            return torch.stack([f(v) for f in scalars])
        return design

    def _eval_build(self, group: _Group, n_dev: int) -> Callable:
        """(B, HW_DIM) -> (B, ppd, 5), or with ``n_dev`` > 1 rows
        ``(n_dev, B/n_dev, HW_DIM)`` split over the shard devices."""
        def build():
            self._template_on_stream(group.template)
            if n_dev <= 1:
                return torch.func.vmap(self._design_scalar(group))
            return pathfinder.sharded(
                lambda dev: torch.func.vmap(self._design_scalar(
                    group, pathfinder.arch_on(group.template, dev))),
                self.shard_devs[:n_dev], self.device)
        return build

    def _compiled_eval(self, group: _Group, n_dev: int) -> Callable:
        return pathfinder.compiled_entry(("design", group.keys, n_dev),
                                         self._eval_build(group, n_dev))

    def _design_vectors(self, group: _Group) -> List:
        """One canonical `DesignVector` per eval point of the group's
        design, registered under the keys the serial backend uses — so
        serial and pipelined sweeps share (and bit-match) the same
        buckets."""
        from repro_torch.core import compileahead
        dvs = [compileahead.design_vector(
            ("skel", key), ev._host_scalar(group.template),
            (pathfinder.HW_SPEC,), device=self.device,
            trace_key=("skel", key[:-1]))
            for key, ev in zip(group.keys, group.skel.evaluators)]
        for dv in dvs:
            self._on_this_stream(dv.packs)
        return dvs

    def _group_rows_fn(self, group: _Group) -> Callable:
        """(B, HW_DIM) -> (B, ppd, 5) through the design's buckets (or,
        without bucketing, the vmapped design function): the rows the
        streaming frontier folds, bit for bit the full path's."""
        if not self.bucketing:
            return self._compiled_eval(group, 1)
        from repro_torch.core import compileahead
        entries = [(compileahead.batch_entry(dv.bucket), dv)
                   for dv in self._design_vectors(group)]
        for key in group.keys:
            self._release_pins(("skel", key))

        def rows(hw):
            return torch.stack([entry(dv.row_packs(hw.shape[0]), hw)
                                for entry, dv in entries], dim=1)
        return rows

    def _frontier_fn(self, group: _Group) -> Callable:
        """(hw, idx, state) -> state: the group's rows, its objective fold
        and one `pathfinder.frontier_merge`.  The fold is part of the
        key: variants share eval shapes, not walls.  (The rows function
        is made before the store's lock is taken: it may trace.)"""
        design = self._group_rows_fn(group)

        def build():
            fold = torch.func.vmap(group.skel.fold)

            def step(hw, idx, state):
                rows = design(hw)                            # (B, ppd, 5)
                vals = torch.where((idx < 0)[:, None], math.inf,
                                   fold(rows, hw))           # (B, n_obj)
                return pathfinder.frontier_merge(
                    state, vals, rows.reshape(rows.shape[0], -1), idx)
            return step
        return pathfinder.compiled_entry(
            ("frontier", group.keys, group.skel.fold_key, self.bucketing),
            build)

    # -- packing (producer side) -----------------------------------------
    def pack(self, chunks: Sequence) -> _Pack:
        """Resolve + vectorize one superbatch of chunks: memoized skeleton
        and hardware-row lookups per label, one batched cache probe, and
        miss row-indices grouped per design function."""
        meta: List[List] = []
        cached: Dict[tuple, np.ndarray] = {}
        groups: Dict[tuple, _Group] = {}
        chunk_size = self.spec.chunk_size

        def group_for(sk, hw):
            # group identity includes the scenario fold_key: variants share
            # eval shapes (g.keys, so the design function and cache rows
            # stay shared) but their folds bake different walls/consts
            keys = self._group_keys(sk, hw)
            gkey = (keys, sk.fold_key)
            g = groups.get(gkey)
            if g is None:
                g = groups.setdefault(gkey, _Group(skel=sk, keys=keys,
                                                   template=hw))
            return g

        if self.cache is None:          # lean single-pass (no probes)
            for ci, chunk in enumerate(chunks):
                base_gidx = chunk.index * chunk_size
                row_meta = []
                meta.append(row_meta)
                for li, lb in enumerate(chunk.labels):
                    ent = self._hw_entry(lb)
                    sk = self._skeleton(lb)
                    row_meta.append((sk, ent))
                    g = group_for(sk, ent[0])
                    g.ridx.append(ent[1])
                    g.slots.append((ci, li))
                    g.gidx.append(base_gidx + li)
            return _Pack(chunks=list(chunks), meta=meta, cached=cached,
                         groups=groups)

        probe_keys: List[tuple] = []
        probe_slots: List[tuple] = []
        pending: List[tuple] = []       # (slot, gidx, sk, ent)
        for ci, chunk in enumerate(chunks):
            base_gidx = chunk.index * chunk_size
            row_meta = []
            meta.append(row_meta)
            for li, lb in enumerate(chunk.labels):
                ent = self._hw_entry(lb)
                sk = self._skeleton(lb)
                slot = (ci, li)
                row_meta.append((sk, ent))
                pending.append((slot, base_gidx + li, sk, ent))
                for skel_key in self._group_keys(sk, ent[0]):
                    probe_keys.append((skel_key, ent[2]))
                    probe_slots.append(slot)
        hits: Dict[tuple, List] = {}
        for slot, row in zip(probe_slots,
                             self.cache.get_many(probe_keys)):
            hits.setdefault(slot, []).append(row)
        for slot, gidx, sk, ent in pending:
            got = hits.get(slot)
            if got is not None and all(r is not None for r in got):
                cached[slot] = np.stack(got)
                continue
            hw, ridx, rbytes, _ = ent
            g = group_for(sk, hw)
            g.ridx.append(ridx)
            g.row_bytes.append(rbytes)
            g.slots.append(slot)
            g.gidx.append(gidx)
        return _Pack(chunks=list(chunks), meta=meta, cached=cached,
                     groups=groups)

    # -- device stage -----------------------------------------------------
    def _on_stream(self):
        """The executor's CUDA stream as the current one (a no-op on the
        CPU)."""
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _gather(self, g: _Group) -> np.ndarray:
        """(B, HW_DIM) f32 matrix of a group's rows — one NumPy gather
        over the unique-row table, no per-label packing.

        Runs on the dispatch thread while the producer may be appending
        rows for the NEXT pack, so work off a local snapshot: every index
        this group references existed when the pack was built, and a
        concurrent append can only grow the table past what we need.
        """
        idx = np.asarray(g.ridx, dtype=np.intp)
        mat = self._rowmat
        need = int(idx.max()) + 1 if idx.size else 0
        if mat is None or mat.shape[0] < need:
            mat = np.stack(self._rows[:max(need, len(self._rows))]) \
                .astype(np.float32)
            self._rowmat = mat
        return mat[idx]

    def _pad_plan(self, n: int) -> Tuple[int, int]:
        """(devices, padded row target) of an ``n``-row dispatch: one
        device below ``shard_min_rows``, the rows padded to a multiple of
        `sweeprunner.SHARD_BLOCK` x devices, so a sweep's batches take a
        handful of shapes."""
        n_dev = max(min(self.devices, n), 1)
        if n < self.shard_min_rows:
            n_dev = 1
        quantum = n_dev * self.block
        return n_dev, -(-n // quantum) * quantum

    def _padded(self, g: _Group) -> Tuple[np.ndarray, int]:
        hw = self._gather(g)
        n = hw.shape[0]
        n_dev, target = self._pad_plan(n)
        if target != n:
            hw = np.concatenate([hw, np.repeat(hw[-1:], target - n,
                                               axis=0)])
        return hw, n_dev

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the device: from pinned memory, non-blocking,
        on the executor's stream."""
        x = torch.from_numpy(host)
        if self.stream is None:
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    def _download(self, out: torch.Tensor) -> _HostRows:
        """Start ``out``'s copy into a pinned host buffer and record the
        event the writer waits on."""
        if self.stream is None:
            return _HostRows(out)
        buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        buf.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self.stream)
        return _HostRows(buf, event)

    def _release_pins(self, key: tuple) -> None:
        """Release the eviction pins the compile service took for ``key``
        (after the key's first dispatch of this run)."""
        with self._pin_lock:
            n = self._aot_pins.pop(key, 0)
        for _ in range(n):
            pathfinder.unpin_compiled(key)

    def _release_all_pins(self) -> None:
        with self._pin_lock:
            pins, self._aot_pins = self._aot_pins, collections.Counter()
        for key, n in pins.items():
            for _ in range(n):
                pathfinder.unpin_compiled(key)

    def _bucket_plan(self, pack: _Pack) -> Dict[int, tuple]:
        """The pack's (group, eval-point) pairs by canonical bucket:
        ``{bucket.id: (bucket, items)}``, items ``(group, eval_idx,
        design_vector, n_rows)``."""
        buckets: Dict[int, tuple] = {}
        for g in pack.groups.values():
            n = len(g.ridx)
            if not n:
                continue
            for e, dv in enumerate(self._design_vectors(g)):
                buckets.setdefault(dv.bucket.id, (dv.bucket, []))[1] \
                    .append((g, e, dv, n))
            for key in g.keys:
                self._release_pins(("skel", key))
        return buckets

    def _bucket_args(self, items: List[tuple], didx: np.ndarray,
                     n_dev: int) -> tuple:
        """One megabatch's per-row coefficient packs: row ``r`` gathers
        item ``didx[r]``'s design packs, on the device, with a leading
        device axis when split over ``n_dev`` devices."""
        from repro_torch.core import compileahead
        packs = compileahead.bucket_packs(
            [dv.packs for _, _, dv, _ in items],
            self._upload(didx.astype(np.int64)))
        if n_dev > 1:
            packs = tuple(p.reshape((n_dev, p.shape[0] // n_dev)
                                    + p.shape[1:]) for p in packs)
        return packs

    def dispatch(self, pack: _Pack) -> None:
        """Launch the pack's batched evaluation on the executor's stream;
        the rows stream back into pinned buffers while the caller goes on,
        until `finalize` folds them.

        With bucketing all (group, eval-point) pairs whose
        canonical graphs landed in one bucket are one megabatch through
        the bucket's vmapped graph, each design's packs riding along per
        row; without it, one dispatch per group."""
        from repro_torch.core import compileahead
        with self._on_stream(), torch.no_grad():
            if not self.bucketing:
                for g in pack.groups.values():
                    g.n = len(g.ridx)
                    if not g.n:
                        continue
                    hw, n_dev = self._padded(g)
                    if n_dev > 1:
                        hw = hw.reshape(n_dev, hw.shape[0] // n_dev,
                                        pathfinder.HW_DIM)
                    g.out = self._download(
                        self._compiled_eval(g, n_dev)(self._upload(hw)))
                return
            for g in pack.groups.values():
                g.n = len(g.ridx)
                if g.n:
                    g.out = [None] * g.skel.ppd
            for bucket, items in self._bucket_plan(pack).values():
                rows = np.concatenate([self._gather(g)
                                       for g, _, _, _ in items])
                didx = np.concatenate([np.full(n, j, dtype=np.intp)
                                       for j, (_, _, _, n)
                                       in enumerate(items)])
                n = rows.shape[0]
                n_dev, target = self._pad_plan(n)
                if target != n:
                    rows = np.concatenate(
                        [rows, np.repeat(rows[-1:], target - n, axis=0)])
                    didx = np.concatenate(
                        [didx, np.repeat(didx[-1:], target - n)])
                if n_dev > 1:
                    rows = rows.reshape(n_dev, target // n_dev,
                                        pathfinder.HW_DIM)
                out = compileahead.batch_entry(bucket, n_dev)(
                    self._bucket_args(items, didx, n_dev),
                    self._upload(rows))
                holder = self._download(out)
                off = 0
                for g, e, _, n_g in items:
                    g.out[e] = (holder, off, off + n_g)
                    off += n_g

    def finalize(self, pack: _Pack) -> List[List[Dict]]:
        """Wait on the pack's device results, fold records per chunk (in
        chunk order), and publish the fresh rows to the prediction cache
        under the same per-eval-point keys the serial backend uses.

        Metric folding is vectorized: each group's whole result batch
        goes through the scenario's `metrics_fold` in one NumPy pass, so
        the per-label Python is one dict merge + the point key."""
        md_store: List[List] = [[None] * len(c.labels)
                                for c in pack.chunks]
        rows_by_slot: Dict[tuple, np.ndarray] = {}
        puts: List[tuple] = []
        n_metrics = len(pathfinder.METRICS)
        for g in pack.groups.values():
            if not g.n:
                continue
            if isinstance(g.out, list):
                # bucketed: one (B, 5) slice per eval point, possibly from
                # different megabatches, stacked to the (B, ppd, 5) layout
                out = np.stack([holder.rows()[lo:hi]
                                for holder, lo, hi in g.out], axis=1)
            else:
                out = g.out.rows().reshape(-1, g.skel.ppd,
                                           n_metrics)[:g.n]
            g.out = None
            if g.skel.mfold is not None:
                for (ci, li), md in zip(g.slots,
                                        g.skel.mfold(out,
                                                     self._gather(g))):
                    md_store[ci][li] = md
            else:
                for j, slot in enumerate(g.slots):
                    rows_by_slot[slot] = out[j]
            if self.cache is not None:
                for j in range(g.n):
                    for pt, skel_key in enumerate(g.keys):
                        puts.append(((skel_key, g.row_bytes[j]),
                                     out[j, pt]))
        if puts:
            self.cache.put_many(puts)
        if pack.cached:
            # cache-hit slots: batch them per skeleton through the same
            # vectorized fold (a fully-warm sweep is all hits)
            by_sk: Dict[int, tuple] = {}
            for slot, rows in pack.cached.items():
                sk, ent = pack.meta[slot[0]][slot[1]]
                if sk.mfold is None:
                    rows_by_slot[slot] = rows
                else:
                    by_sk.setdefault(id(sk), (sk, []))[1].append(
                        (slot, rows, ent[1]))
            for sk, items in by_sk.values():
                rows = np.stack([r for _, r, _ in items])
                hwm = np.stack([self._rows[ri] for _, _, ri in items])
                for ((ci, li), _, _), md in zip(items,
                                                sk.mfold(rows, hwm)):
                    md_store[ci][li] = md
        out_records: List[List[Dict]] = []
        for ci, chunk in enumerate(pack.chunks):
            recs = []
            row_meta = pack.meta[ci]
            row_md = md_store[ci]
            for li, lb in enumerate(chunk.labels):
                sk, ent = row_meta[li]
                md = row_md[li]
                if md is not None:
                    # label fields from the skeleton template (dict
                    # insertion order == DesignPoint.label_fields)
                    rec = dict(sk.base_fields)
                    rec["logic"] = lb.logic
                    rec["hbm"] = lb.hbm
                    rec["net"] = lb.net
                    rec["scale"] = lb.scale
                    rec.update(md)
                    rec["key"] = (f"{sk.key_pre}|{lb.logic}|{lb.hbm}|"
                                  f"{lb.net}|{ent[3]}|{sk.key_suf}")
                else:
                    dp = self._design_point(lb, sk, ent[0])
                    rec = sk.scn.record(dp, rows_by_slot[(ci, li)])
                    rec["key"] = dp.key()
                recs.append(rec)
            out_records.append(recs)
        return out_records

    # -- compile-ahead (producer side) -------------------------------------
    def _prefetch(self, pack: _Pack) -> None:
        """Hand the pack's designs to the compile service, which traces
        them into their buckets, so they are ready, or in flight, by the
        time the device stage reaches this pack; a miss only means the
        device stage traces inline.  Without bucketing nothing is traced
        (nor compiled): the per-design functions run as they are."""
        if not (self.compile_ahead and self.bucketing):
            return
        from repro_torch.core import compileahead
        svc = compileahead.service()
        for g in pack.groups.values():
            if not g.ridx:
                continue
            for key, ev in zip(g.keys, g.skel.evaluators):
                if svc.warm_design(("skel", key), ev._host_scalar(g.template),
                                   (pathfinder.HW_SPEC,), device=self.device,
                                   trace_key=("skel", key[:-1])):
                    with self._pin_lock:
                        self._aot_pins[("skel", key)] += 1

    # -- the pipeline -----------------------------------------------------
    def _pack_slices(self, chunks: Sequence) -> List[Sequence]:
        per = max(self.superbatch // max(self.spec.chunk_size, 1), 1)
        return [chunks[i:i + per] for i in range(0, len(chunks), per)]

    def _produce(self, slices, pack_q: "queue.Queue",
                 errors: List[BaseException]) -> None:
        """The producer thread: pack each superbatch and hand its designs
        to the compile service, keeping ``compile_ahead`` packs in hand
        beyond the bounded queue, then the ``None`` sentinel; an error is
        recorded for the caller's thread to re-raise."""
        buf: "collections.deque" = collections.deque()
        try:
            for sl in slices:
                if errors:
                    break
                pack = self.pack(sl)
                self._prefetch(pack)
                buf.append(pack)
                while len(buf) > self.compile_ahead:
                    pack_q.put(buf.popleft())
            while buf and not errors:
                pack_q.put(buf.popleft())
        except BaseException as e:      # noqa: BLE001 — re-raised by caller
            errors.append(e)
        finally:
            pack_q.put(None)

    def _inline_packs(self, slices):
        """The inline mode's packs in order, each packed (and prefetched)
        ``compile_ahead`` superbatches before it is handed out."""
        buf: "collections.deque" = collections.deque()
        si = 0
        while si < len(slices) or buf:
            while si < len(slices) and len(buf) <= self.compile_ahead:
                nxt = self.pack(slices[si])
                si += 1
                self._prefetch(nxt)
                buf.append(nxt)
            yield buf.popleft()

    def run(self, chunks: Sequence, commit: Callable) -> int:
        """Evaluate ``chunks``, invoking ``commit(chunk, records)`` in
        chunk order.  Returns evaluated points.

        Threaded mode runs producer / device / writer on separate
        threads; inline mode (small hosts) gets the same double buffering
        from the stream alone: pack N+1 is resolved and dispatched before
        pack N's results are folded, so the card is never idle while
        records fold and commit.  An error in any stage ends the run and
        is re-raised on the caller's thread.
        """
        if not chunks:
            return 0
        slices = self._pack_slices(chunks)

        def flush(pack: _Pack) -> int:
            n = 0
            for chunk, recs in zip(pack.chunks, self.finalize(pack)):
                n += len(recs)
                commit(chunk, recs)
            return n

        if not self.threads:
            n_points = 0
            prev: Optional[_Pack] = None
            try:
                for pack in self._inline_packs(slices):
                    self.dispatch(pack)          # pack N on the device ...
                    if prev is not None:
                        n_points += flush(prev)  # ... while N-1 commits
                    prev = pack
                if prev is not None:
                    n_points += flush(prev)
            finally:
                self._release_all_pins()
            return n_points
        pack_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        write_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        errors: List[BaseException] = []
        n_points = [0]

        def write():
            # waits on pack N-1's events, folds records and commits JSONL
            # while the caller's thread keeps dispatching; on an error it
            # keeps draining so the bounded put()s never deadlock
            while True:
                pack = write_q.get()
                if pack is None:
                    return
                if errors:
                    continue
                try:
                    n_points[0] += flush(pack)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)

        producer = threading.Thread(target=self._produce,
                                    args=(slices, pack_q, errors),
                                    daemon=True, name="sweep-producer")
        writer = threading.Thread(target=write, daemon=True,
                                  name="sweep-writer")
        producer.start()
        writer.start()
        try:
            while True:
                pack = pack_q.get()
                if pack is None:
                    break
                if errors:
                    continue        # drain so the producer's put()s finish
                try:
                    # superbatch N runs on the card while N+1 packs
                    # (producer) and N-1 folds/commits (writer); the
                    # bounded write queue is the in-flight backpressure
                    self.dispatch(pack)
                    write_q.put(pack)
                except BaseException as e:   # noqa: BLE001
                    errors.append(e)
        except BaseException as e:           # noqa: BLE001 (interrupts)
            errors.append(e)
        finally:
            write_q.put(None)
            writer.join()
            _join_producer(producer, pack_q)
            self._release_all_pins()
        if errors:
            raise errors[0]
        return n_points[0]

    # -- frontier-only mode ----------------------------------------------
    def run_frontier(self, chunks: Sequence,
                     capacity: int = pathfinder.FRONTIER_CAPACITY,
                     state=None, on_commit: Optional[Callable] = None,
                     all_chunks: Optional[Sequence] = None,
                     ) -> Tuple[List[Dict], int, int]:
        """Device-resident streaming-frontier sweep over ``chunks``.

        Returns ``(frontier records, n_overflowed, n_points_evaluated)``.
        The prediction cache is bypassed (rows stay on the device;
        publishing them would mean materializing every row on host — the
        exact cost this mode exists to avoid) and per-point results are
        never collected: only the surviving frontier's records are
        rebuilt, from the carried state's payload rows.

        ``state`` seeds the carried frontier state (host arrays from a
        prior run's checkpoint, written by either package);
        ``on_commit(chunk_indices, host_state)`` fires after each merged
        superbatch with the chunk indices it folded in and the state
        copied to host — the checkpoint hook.  ``all_chunks`` is the full
        enumeration when ``chunks`` is only the pending subset: carried
        payload rows reference global point indices, so record rebuild
        needs every chunk, merged or not.
        """
        all_chunks = list(all_chunks) if all_chunks is not None \
            else list(chunks)
        if not all_chunks:
            return [], 0, 0
        sk0 = self._skeleton(all_chunks[0].labels[0])
        if sk0.fold is None:
            raise ValueError(
                f"scenario {sk0.scn.name!r} defines no frontier_fold; "
                f"--frontier-only needs a device-side objective fold")
        with self._on_stream():
            if state is None:
                state = pathfinder.frontier_init(
                    capacity, len(sk0.scn.objectives),
                    sk0.ppd * len(pathfinder.METRICS), device=self.device)
            else:
                state = tuple(torch.as_tensor(np.asarray(x),
                                              device=self.device)
                              for x in state)

        cache, self.cache = self.cache, None    # frontier bypasses caching
        n_points = 0
        try:
            def merge_pack(pack: _Pack, state) -> Tuple[tuple, int]:
                n_merged = 0
                with self._on_stream(), torch.no_grad():
                    for g in pack.groups.values():
                        n = len(g.ridx)
                        if not n:
                            continue
                        hw = self._gather(g)
                        target = -(-n // self.block) * self.block
                        if target != n:
                            hw = np.concatenate([hw, np.repeat(
                                hw[-1:], target - n, axis=0)])
                        idx = np.full(target, -1, dtype=np.int32)
                        idx[:n] = g.gidx
                        # the merge runs on the card while the next pack
                        # resolves on host
                        state = self._frontier_fn(g)(
                            self._upload(hw), self._upload(idx), state)
                        n_merged += n
                    if on_commit is not None:
                        on_commit([c.index for c in pack.chunks],
                                  pathfinder.frontier_host(state))
                return state, n_merged

            if not self.threads:
                for pack in self._inline_packs(self._pack_slices(chunks)):
                    state, n = merge_pack(pack, state)
                    n_points += n
            else:
                pack_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
                errors: List[BaseException] = []
                producer = threading.Thread(
                    target=self._produce,
                    args=(self._pack_slices(chunks), pack_q, errors),
                    daemon=True, name="sweep-producer")
                producer.start()
                try:
                    while True:
                        pack = pack_q.get()
                        if pack is None:
                            break
                        if errors:
                            continue    # drain so the producer finishes
                        try:
                            state, n = merge_pack(pack, state)
                            n_points += n
                        except BaseException as e:  # noqa: BLE001
                            errors.append(e)
                finally:
                    _join_producer(producer, pack_q)
                if errors:
                    raise errors[0]
            with self._on_stream():
                host = pathfinder.frontier_host(state)
        finally:
            self.cache = cache
            self._release_all_pins()

        records, n_over = self.frontier_records(host, all_chunks)
        return records, n_over, n_points

    def frontier_records(self, state,
                         all_chunks: Sequence) -> Tuple[List[Dict], int]:
        """Rebuild the surviving frontier's result records from a carried
        frontier state's payload rows: ``(records, n_overflowed)``.

        The state may come straight off `run_frontier`, a checkpoint, or
        a `pathfinder.frontier_merge_states` merge — payload rows
        reference global point indices, so ``all_chunks`` must be the
        FULL enumeration.  Records are re-filtered host-side in float64
        (the device merge works in f32, so razor-edge ties could otherwise
        differ from the full-materialization frontier).
        """
        from repro_torch.core import sweeprunner
        all_chunks = list(all_chunks)
        vals, payload, idx, n_over = pathfinder.frontier_unpack(state)
        by_index = {c.index: c for c in all_chunks}
        records: List[Dict] = []
        sk = None
        for i in np.argsort(idx):              # enumeration order
            gi = int(idx[i])
            chunk = by_index[gi // self.spec.chunk_size]
            lb = chunk.labels[gi % self.spec.chunk_size]
            sk = self._skeleton(lb)
            hw = self._hw_entry(lb)[0]
            dp = self._design_point(lb, sk, hw)
            rows = payload[i].astype(np.float64).reshape(
                sk.ppd, len(pathfinder.METRICS))
            rec = sk.scn.record(dp, rows)
            rec["key"] = dp.key()
            records.append(rec)
        if not records:
            return [], n_over
        records = sweeprunner.pareto_records(
            records, tuple(sk.scn.objectives))
        return records, n_over
