"""Compile-ahead: cross-design bucketed evaluation + the ahead-of-time service.

The PyTorch port of ``repro.core.compileahead``.  A sweep scores many
*designs* (mesh, strategy, workload graph), each over a batch of hardware
rows.  The reference traces each design's scalar function to a jaxpr,
abstracts every literal and closed-over constant into a coefficient slot,
and groups designs whose remaining structure is identical into one
`Bucket` with one compiled executable.  Here the same two layers are:

1. **Cross-design bucketing.**  `design_vector` traces a design's scalar
   function once, on the host (so tracing launches nothing on the card),
   and reduces it to a *canonical* `torch.fx` graph:

   * every operation whose inputs do not depend on the hardware row runs
     at trace time and its result becomes a constant, as JAX runs every
     operation on concrete values eagerly and only records those on
     tracers — so the per-GEMM tiling tables, the `torch.tensor` scalars
     of the roofline and everything computed from them alone are folded;
   * every constant a recorded operation reads becomes a positional
     coefficient slot, and so does every number literal in the value
     operands of float32 arithmetic (``x * 2.5``, ``x + n``; the
     counterpart of a jaxpr's weakly typed literals);
   * structure is kept: the op overloads, the wiring, ints and bools in
     every other place (dims, sizes, indices), dtypes, devices, and the
     exponent of ``pow.Tensor_Scalar`` (its overload picks another kernel
     for 2, 0.5, -1, ...), plus each slot's (dtype, shape);
   * the slots are stacked per (dtype, shape) class into
     `DesignVector.packs`, which go up to the device once per design.

   Designs with equal fingerprints share one `Bucket`; `Bucket.scalar_fn`
   replays the canonical graph with a design's packs bound, and
   `batch_entry` is its ``torch.func.vmap`` with packs and rows both
   batched, so one megabatch carries rows of many designs (each row
   gathers its design's packs).  Every backend dispatches the same
   canonical graph, so cross-backend records are bit for bit equal.

   The trace is a `TorchDispatchMode` that records the aten calls on real
   host tensors and builds the fx graph itself.  ``make_fx`` would give
   the same graph, but it snapshots a fake tensor of every value it
   records, which makes a trace over an order of magnitude slower; a
   sweep traces every design it scores.

2. **The ahead-of-time service.**  Nothing is compiled in the port: the
   "compile" of a design is its trace, its canonicalization and its
   packs' upload, and that is what ``compile_seconds`` and
   ``stall_seconds`` (`pathfinder.compile_cache_stats`) count.
   `CompileService` runs that work on its own threads ahead of the
   device stage: the pipelined executor's producer hands it the designs
   of upcoming superbatches (`CompileService.warm_design`).  Submissions
   are deduped per (key, signature), a submitted key is pinned against
   eviction until its first dispatch, and a design the service has not
   reached is traced inline by the dispatcher (counted as stall time).

Bucketing is execution-only: chunk hashes, point keys, record payloads
and frontier merges are unaffected; the per-design vmapped function gives
the bucketed rows at float32 rounding.  Unlike the reference it is off by
default: there one XLA compile per bucket serves many designs, here the
trace is paid per design, and a fresh process pays more in traces than
it saves in launches on the sweeps measured so far (PERF.md).  Callers
ask for it with ``bucketed=True`` / ``bucketing=True``, ``--bucketing``
or `set_bucketing_default`; ``REPRO_NO_BUCKETING=0`` turns the process
default on, ``REPRO_NO_BUCKETING=1`` (the reference's switch) keeps it
off.
"""

from __future__ import annotations

import collections
import dataclasses
import operator
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import pathfinder

__all__ = [
    "Bucket", "DesignVector", "design_vector", "batch_entry",
    "bucket_builder", "design_batch_fn", "bucketing_default",
    "set_bucketing_default", "resolve_bucketed", "bucket_stats",
    "CompileService", "service",
]

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# Bucketing default (the --no-bucketing escape hatch)
# ---------------------------------------------------------------------------

_BUCKETING_DEFAULT = os.environ.get(
    "REPRO_NO_BUCKETING", "1").lower() in ("0", "false", "no")


def bucketing_default() -> bool:
    """Whether canonical bucketed graphs are used when callers don't say:
    off unless env ``REPRO_NO_BUCKETING`` is 0 / false / no."""
    return _BUCKETING_DEFAULT


def set_bucketing_default(flag: bool) -> bool:
    """Set the process-wide bucketing default; returns the previous value."""
    global _BUCKETING_DEFAULT
    prev, _BUCKETING_DEFAULT = _BUCKETING_DEFAULT, bool(flag)
    return prev


def resolve_bucketed(flag: Optional[bool]) -> bool:
    return _BUCKETING_DEFAULT if flag is None else bool(flag)


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

# float32 arithmetic whose two value operands (schema positions 0 and 1)
# may hold a Python number: lifted into a slot, a 0-d float32 tensor gives
# the same float32 result
_LIFT_OPS = frozenset({aten.mul.Tensor, aten.add.Tensor, aten.sub.Tensor,
                       aten.div.Tensor})


@dataclasses.dataclass
class _Node:
    func: object                    # an aten OpOverload
    args: tuple                     # leaves mapped to refs (see _Recorder)
    kwargs: dict
    outs: tuple                     # ((dtype, shape) | None, ...) per output
    multi: bool                     # the op returns a tuple / list
    deps: tuple = ()                # the recorded nodes it reads


class _Ref(tuple):
    """A traced tensor: ("d", k) data input k, ("n", i, j) output j of
    node i, ("c", k) constant k; ("s", k) slot k once canonical."""


_SEQ = (list, tuple)


class _Recorder(TorchDispatchMode):
    """Records the aten calls that read the data inputs; runs everything
    (on the host's real tensors) and keeps the rest as constants."""

    def __init__(self):
        super().__init__()
        self.refs: Dict[int, _Ref] = {}
        self.live: set = set()                # ids of traced tensors
        self.alive: List[torch.Tensor] = []   # ids of refs stay unique
        self.consts: List[torch.Tensor] = []
        self.nodes: List[_Node] = []

    def data(self, t: torch.Tensor, k: int) -> None:
        self.refs[id(t)] = _Ref(("d", k))
        self.live.add(id(t))
        self.alive.append(t)

    def ref(self, t: torch.Tensor) -> _Ref:
        r = self.refs.get(id(t))
        if r is None:
            r = self.refs[id(t)] = _Ref(("c", len(self.consts)))
            self.alive.append(t)
            self.consts.append(t.detach().clone())
        return r

    def _live(self, args) -> bool:
        # an id in ``live`` is a traced tensor's: those stay alive, so no
        # other object can carry their id
        live = self.live
        for a in args:
            if type(a) in _SEQ:
                for b in a:
                    if id(b) in live:
                        return True
            elif id(a) in live:
                return True
        return False

    def _map(self, x, deps: List[int]):
        if isinstance(x, torch.Tensor):
            r = self.ref(x)
            if r[0] == "n":
                deps.append(r[1])
            return r
        if type(x) in _SEQ:
            return type(x)([self._map(y, deps) for y in x])
        return x

    def _check_writes(self, func, args, kwargs) -> None:
        # a folded op writing in place to a constant a recorded op has
        # read would leave the graph with the read-time snapshot
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in (v if type(v) in _SEQ else (v,)):
                r = self.refs.get(id(t))
                if r is not None and r[0] == "c":
                    raise NotImplementedError(
                        f"compileahead: {func} writes in place to a "
                        f"constant the traced graph has read")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.is_mutable:
            self._check_writes(func, args, kwargs)
        out = func(*args, **kwargs)
        if not (self._live(args) or (kwargs
                                     and self._live(kwargs.values()))):
            return out              # folded: its outputs are constants
        if func is aten._local_scalar_dense.default:
            raise RuntimeError(
                "compileahead: a value that depends on the hardware row was "
                "read on the host while tracing (data-dependent control "
                "flow), which no batched evaluation allows either")
        if func._schema.is_mutable:
            raise NotImplementedError(
                f"compileahead: {func} mutates a traced tensor in place")
        multi = isinstance(out, _SEQ)
        outs = tuple(out) if multi else (out,)
        i = len(self.nodes)
        deps: List[int] = []
        node = _Node(func, self._map(tuple(args), deps),
                     {k: self._map(v, deps) for k, v in kwargs.items()},
                     tuple((t.dtype, tuple(t.shape))
                           if isinstance(t, torch.Tensor) else None
                           for t in outs), multi, tuple(deps))
        for j, t in enumerate(outs):
            if isinstance(t, torch.Tensor):
                self.refs[id(t)] = _Ref(("n", i, j))
                self.live.add(id(t))
                self.alive.append(t)
        self.nodes.append(node)
        return out


def _trace(fn: Callable, data: Sequence[torch.Tensor]):
    """(recorder, output refs, multi): ``fn(*data)`` run on the host's
    tensors under the recorder."""
    rec = _Recorder()
    for k, t in enumerate(data):
        rec.data(t, k)
    with torch.no_grad(), rec:
        out = fn(*data)
    multi = isinstance(out, _SEQ)
    outs = tuple(out) if multi else (out,)
    for t in outs:
        if not torch.is_tensor(t):
            raise TypeError(f"compileahead: a design function returned "
                            f"{type(t).__name__}, not a tensor")
    return rec, tuple(rec.ref(t) for t in outs), multi


def _walk(x, visit):
    """Map the leaves of an aten argument (nested lists / tuples)."""
    if type(x) in _SEQ:
        return type(x)(_walk(y, visit) for y in x)
    return visit(x)


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _fp_leaf(x):
    """A hashable form of one argument leaf: a kept float literal is
    structure by value, dtypes and devices their names."""
    if isinstance(x, float):
        return ("f", x)
    if isinstance(x, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(x)
    return x


def _canonicalize(rec: _Recorder, out_refs: tuple):
    """Prune the recorded nodes to those the outputs need and abstract
    their constants and lifted literals into slots.

    Returns ``(nodes, slot_values, out_refs, fingerprint)``: the kept
    nodes renumbered, their args and the outputs with every constant or
    lifted literal replaced by ``("s", k)``; the host value of slot k;
    and a hashable fingerprint of the remaining structure."""
    need = bytearray(len(rec.nodes))
    for r in out_refs:
        if r[0] == "n":
            need[r[1]] = 1
    for i in range(len(rec.nodes) - 1, -1, -1):
        if need[i]:
            for d in rec.nodes[i].deps:
                need[d] = 1
    order = [i for i in range(len(rec.nodes)) if need[i]]
    renum = {old: new for new, old in enumerate(order)}
    slot_of: Dict[int, _Ref] = {}           # constant -> its slot
    values: List[torch.Tensor] = []

    def canon(r: _Ref) -> _Ref:
        if r[0] == "c":
            s = slot_of.get(r[1])
            if s is None:
                s = slot_of[r[1]] = _Ref(("s", len(values)))
                values.append(rec.consts[r[1]])
            return s
        if r[0] == "n":
            return _Ref(("n", renum[r[1]], r[2]))
        return r

    def leaf(x, lift: bool):
        """(canonical leaf, its fingerprint)."""
        if type(x) is _Ref:
            c = canon(x)
            return c, c
        if lift and _is_number(x):
            values.append(float(x))         # a float32 0-d slot
            c = _Ref(("s", len(values) - 1))
            return c, c
        return x, _fp_leaf(x)

    def arg(x, lift: bool = False):
        if type(x) in _SEQ:
            pairs = [leaf(y, False) for y in x]
            return type(x)(p[0] for p in pairs), tuple(p[1] for p in pairs)
        return leaf(x, lift)

    nodes: List[_Node] = []
    fp_nodes = []
    for old in order:
        node = rec.nodes[old]
        lift = node.func in _LIFT_OPS and node.outs[0] is not None \
            and node.outs[0][0] == torch.float32
        pairs = [arg(a, lift and i < 2) for i, a in enumerate(node.args)]
        kw = {k: arg(v) for k, v in node.kwargs.items()}
        nodes.append(_Node(node.func, tuple(p[0] for p in pairs),
                           {k: p[0] for k, p in kw.items()}, node.outs,
                           node.multi))
        fp_nodes.append((node.func, tuple(p[1] for p in pairs),
                         tuple(sorted((k, p[1]) for k, p in kw.items())),
                         len(node.outs), node.multi))
    outs = tuple(canon(r) for r in out_refs)
    fingerprint = (tuple(fp_nodes), outs, tuple(map(_slot_sig, values)))
    return nodes, values, outs, fingerprint


_LITERAL = (torch.float32, ())


def _slot_sig(v) -> tuple:
    """(dtype, shape) of a slot value: a tensor, or a lifted literal (a
    Python float, a float32 0-d slot)."""
    return _LITERAL if isinstance(v, float) else (v.dtype, tuple(v.shape))


def _pack(values: Sequence):
    """Group slots by (dtype, shape) and stack each class's values.

    The slot -> class assignment follows the slot signatures alone, which
    the fingerprint covers, so every bucket member maps slots to pack
    positions identically."""
    classes: List[tuple] = []
    class_pos: Dict[tuple, int] = {}
    members: List[List[int]] = []
    slots: List[Tuple[int, int]] = []
    for i, v in enumerate(values):
        ck = _slot_sig(v)
        c = class_pos.get(ck)
        if c is None:
            c = class_pos[ck] = len(classes)
            classes.append(ck)
            members.append([])
        slots.append((c, len(members[c])))
        members[c].append(i)
    packs = []
    for ck, m in zip(classes, members):
        if ck == _LITERAL:      # floats and float32 0-d tensors: exact
            packs.append(torch.tensor([float(values[i]) for i in m],
                                      dtype=torch.float32))
        else:
            packs.append(torch.stack([values[i] for i in m]))
    return tuple(classes), tuple(len(m) for m in members), tuple(slots), \
        tuple(packs)


def _graph_module(nodes: Sequence[_Node], slots, n_classes: int,
                  n_data: int, outs: tuple, multi: bool,
                  device: torch.device) -> torch.fx.GraphModule:
    """The canonical graph: ``(*packs, *data) -> outputs``.  Slot k reads
    ``packs[c][i]``; every device the host trace baked in becomes the
    first data input's device (``device`` where there is none), so a
    shard of rows on another card runs the same graph there."""
    g = torch.fx.Graph()
    packs = [g.placeholder(f"pack_{c}") for c in range(n_classes)]
    data = [g.placeholder(f"data_{k}") for k in range(n_data)]
    slot_nodes: Dict[int, torch.fx.Node] = {}
    values: Dict[Tuple[int, int], torch.fx.Node] = {}
    data_device: List[torch.fx.Node] = []

    def arg(x):
        if isinstance(x, _Ref):
            if x[0] == "d":
                return data[x[1]]
            if x[0] == "s":
                n = slot_nodes.get(x[1])
                if n is None:
                    c, i = slots[x[1]]
                    n = slot_nodes[x[1]] = g.call_function(
                        aten.select.int, (packs[c], 0, i))
                return n
            return values[(x[1], x[2])]
        if isinstance(x, torch.device):
            if not data:
                return device
            if not data_device:
                data_device.append(g.call_function(getattr,
                                                   (data[0], "device")))
            return data_device[0]
        return x

    for i, node in enumerate(nodes):
        fx = g.call_function(node.func, _walk(node.args, arg),
                             {k: _walk(v, arg)
                              for k, v in node.kwargs.items()})
        if node.multi:
            for j in range(len(node.outs)):
                values[(i, j)] = g.call_function(operator.getitem, (fx, j))
        else:
            values[(i, 0)] = fx
    res = [arg(r) for r in outs]
    g.output(tuple(res) if multi else res[0])
    return torch.fx.GraphModule(torch.nn.Module(), g)


# ---------------------------------------------------------------------------
# Buckets and design vectors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One equivalence class of design functions on one device: the
    canonical graph with every folded constant and lifted literal
    abstracted into coefficient slots, plus the slot -> packed-class
    indexing that rebinds a member design's values at dispatch time."""

    id: int
    graph: torch.fx.GraphModule     # (*packs, *data) -> outputs
    classes: Tuple[tuple, ...]      # (dtype, shape) per coefficient pack
    class_sizes: Tuple[int, ...]
    slots: Tuple[Tuple[int, int], ...]   # per slot: (class, index)
    n_data: int
    n_outs: int
    device: torch.device

    def scalar_fn(self) -> Callable:
        """``(packs_tuple, *data) -> outputs``, replaying the canonical
        graph: ``packs_tuple[c]`` stacks a design's class-``c``
        coefficients as one ``(class_sizes[c], *shape)`` tensor."""
        gm = self.graph

        def scalar(packs, *data):
            return gm(*packs, *data)
        return scalar


@dataclasses.dataclass(frozen=True)
class DesignVector:
    """A design reduced to (shared bucket, packed per-design coefficients
    on the bucket's device)."""

    bucket: Bucket
    packs: Tuple[torch.Tensor, ...]     # aligned with bucket.classes

    def row_packs(self, n: int) -> Tuple[torch.Tensor, ...]:
        """The packs of ``n`` rows of this design, gathered as a
        megabatch gathers them (so the rows are bit for bit a
        megabatch's)."""
        idx = torch.zeros(n, dtype=torch.long, device=self.bucket.device)
        return bucket_packs([self.packs], idx)


def bucket_packs(packs_by_item: Sequence[Tuple[torch.Tensor, ...]],
                 didx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-row coefficient packs of a megabatch: item ``didx[r]``'s packs
    for row ``r``, one gather on the device per class."""
    return tuple(torch.stack([p[c] for p in packs_by_item])
                 .index_select(0, didx)
                 for c in range(len(packs_by_item[0])))


_REG_LOCK = threading.Lock()
_BUCKETS: Dict[tuple, Bucket] = {}          # (device, fingerprint) -> bucket
_DESIGNS: "collections.OrderedDict[tuple, DesignVector]" = \
    collections.OrderedDict()
_DESIGNS_MAXSIZE = 4096
_INFLIGHT: Dict[tuple, threading.Event] = {}
_STATS = {"designs_traced": 0, "buckets": 0}


def _clear_registries() -> None:
    with _REG_LOCK:
        _BUCKETS.clear()
        _DESIGNS.clear()
        _TRACES.clear()
        _STRUCTURES.clear()
        _STATS["designs_traced"] = 0
        _STATS["buckets"] = 0


def bucket_stats() -> Dict[str, int]:
    """How many designs have been canonicalized and into how many buckets
    they collapsed (``buckets`` << ``designs_traced`` is the win)."""
    with _REG_LOCK:
        return dict(_STATS, designs_registered=len(_DESIGNS))


def _evict_designs_locked() -> None:
    excess = len(_DESIGNS) - _DESIGNS_MAXSIZE
    for key in list(_DESIGNS):
        if excess <= 0:
            break
        if not pathfinder.is_pinned(key):
            del _DESIGNS[key]
            excess -= 1


def _specs(in_specs) -> Tuple[Tuple[tuple, torch.dtype], ...]:
    """``((shape, dtype), ...)`` of data inputs given as tensors or
    `pathfinder.TensorSpec`s."""
    return tuple((tuple(s.shape), s.dtype) for s in in_specs)


@dataclasses.dataclass(frozen=True)
class _Structure:
    """A canonical structure (device-free): what designs with equal
    fingerprints share, kept once per fingerprint."""

    fp: tuple
    nodes: Tuple[_Node, ...]
    outs: tuple
    multi: bool
    n_data: int
    classes: Tuple[tuple, ...]
    class_sizes: Tuple[int, ...]
    slots: Tuple[Tuple[int, int], ...]


_STRUCTURES: Dict[tuple, _Structure] = {}   # fingerprint -> structure
# a design's host trace, shared by the devices it runs on: its structure
# and its packs on the host
_TRACES: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _host_trace(make_scalar: Callable, in_specs) -> tuple:
    """(structure, host packs) of a design: traced, canonicalized, and
    its structure interned."""
    specs = _specs(in_specs)
    rec, outs, multi = _trace(make_scalar(), [
        torch.zeros(shape, dtype=dtype) for shape, dtype in specs])
    nodes, values, outs, fp = _canonicalize(rec, outs)
    classes, sizes, slots, packs = _pack(values)
    fp = (tuple((s, str(d)) for s, d in specs), multi, fp)
    with _REG_LOCK:
        st = _STRUCTURES.get(fp)
        if st is None:
            st = _STRUCTURES[fp] = _Structure(
                fp=fp, nodes=tuple(nodes), outs=outs, multi=multi,
                n_data=len(specs), classes=classes, class_sizes=sizes,
                slots=slots)
    return st, packs


def _bucket_for(st: _Structure, dev: torch.device) -> Bucket:
    """The bucket of a structure on ``dev``: interned, its graph built
    only the first time the structure is seen there."""
    key = (str(dev), st.fp)
    with _REG_LOCK:
        bucket = _BUCKETS.get(key)
    if bucket is not None:
        return bucket
    fresh = Bucket(id=-1, graph=_graph_module(
        st.nodes, st.slots, len(st.classes), st.n_data, st.outs, st.multi,
        dev), classes=st.classes, class_sizes=st.class_sizes,
        slots=st.slots, n_data=st.n_data, n_outs=len(st.outs), device=dev)
    with _REG_LOCK:
        bucket = _BUCKETS.get(key)
        if bucket is None:
            bucket = _BUCKETS[key] = dataclasses.replace(fresh,
                                                         id=len(_BUCKETS))
            _STATS["buckets"] += 1
        return bucket


def design_vector(design_key: tuple, make_scalar: Callable[[], Callable],
                  in_specs, device=None, stalled: bool = True,
                  trace_key: Optional[tuple] = None) -> DesignVector:
    """Trace + canonicalize a design's scalar function (memoized per key).

    ``design_key`` identifies the design process-wide (the keys of the
    per-design store), ``make_scalar`` builds the scalar function (it must
    compute on the host: tracing runs it there), ``in_specs`` are its data
    inputs (tensors or `pathfinder.TensorSpec`s) and ``device`` where the
    bucket's graph runs (the card unless the caller asks for ``"cpu"``).
    ``trace_key`` (optional) names the host trace itself, which the same
    design on several devices shares.  The trace is this port's compile:
    its wall time goes to ``compile_seconds``, and to ``stall_seconds``
    when ``stalled`` (a dispatcher waiting on it).  A key another thread
    is tracing is waited for, not traced twice."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    while True:
        with _REG_LOCK:
            dv = _DESIGNS.get(design_key)
            if dv is not None:
                _DESIGNS.move_to_end(design_key)
                return dv
            ev = _INFLIGHT.get(design_key)
            if ev is None:
                ev = _INFLIGHT[design_key] = threading.Event()
                break
        t0 = time.perf_counter()
        ev.wait()
        if stalled:
            pathfinder._add_stall_seconds(time.perf_counter() - t0)
    t0 = time.perf_counter()
    try:
        with _REG_LOCK:
            tr = _TRACES.get(trace_key) if trace_key is not None else None
        if tr is None:
            tr = _host_trace(make_scalar, in_specs)
            if trace_key is not None:
                with _REG_LOCK:
                    _TRACES[trace_key] = tr
                    while len(_TRACES) > _DESIGNS_MAXSIZE:
                        _TRACES.popitem(last=False)
        st, packs = tr
        dv = DesignVector(bucket=_bucket_for(st, dev),
                          packs=tuple(p.to(dev) for p in packs))
        with _REG_LOCK:
            _STATS["designs_traced"] += 1
            _DESIGNS[design_key] = dv
            _evict_designs_locked()
        return dv
    finally:
        pathfinder._add_compile_seconds(time.perf_counter() - t0, stalled)
        with _REG_LOCK:
            _INFLIGHT.pop(design_key, None)
        ev.set()


def bucket_builder(bucket: Bucket, n_dev: int = 1) -> Callable:
    """Build closure for a bucket's vmapped wrapper, shared by
    `batch_entry` and the service.  ``n_dev > 1`` takes a leading device
    axis and runs shard ``i`` on device ``i`` (`pathfinder.run_sharded`)."""
    def build():
        inner = torch.func.vmap(bucket.scalar_fn())
        if n_dev <= 1:
            return inner
        return pathfinder.sharded(
            lambda dev: inner, pathfinder.shard_devices(bucket.device, n_dev),
            bucket.device)
    return build


def batch_entry(bucket: Bucket, n_dev: int = 1) -> "pathfinder.CompiledEntry":
    """The process-wide store entry of a bucket's vmapped function, under
    ``("cabucket", id, n_dev)`` in `pathfinder._COMPILED`, so its
    hit / miss accounting and LRU policy are every other entry's."""
    return pathfinder.compiled_entry(("cabucket", bucket.id, n_dev),
                                     bucket_builder(bucket, n_dev))


def design_batch_fn(design_key: tuple, make_scalar: Callable[[], Callable],
                    in_specs, device=None,
                    trace_key: Optional[tuple] = None) -> Callable:
    """Batched canonical dispatch for a single design.

    Returns ``fn(hw)`` taking a ``(B, *shape)`` batch of the design's
    (single) data input on the bucket's device; each row gathers the
    design's packs as a megabatch row does, so the rows are bit for bit
    those of a megabatched dispatch of the same bucket."""
    dv = design_vector(design_key, make_scalar, in_specs, device,
                       trace_key=trace_key)
    entry = batch_entry(dv.bucket, 1)

    def fn(hw):
        with torch.no_grad():
            return entry(dv.row_packs(hw.shape[0]), hw)
    return fn


# ---------------------------------------------------------------------------
# The ahead-of-time service
# ---------------------------------------------------------------------------


class CompileService:
    """A small pool of threads doing the port's compile work off-path.

    `warm_design` queues a design's trace (`design_vector`), the port's
    compile; the reference's ``warm`` readies an XLA executable, which
    has no counterpart here.  Dedupe is process-wide: a (key, signature)
    finished, in flight or queued is not submitted again.  Every queued
    submission pins its key (`pathfinder.pin_compiled`) so no LRU drops
    it between the work and the first dispatch; the dispatcher releases
    the pin after first use (the pipelined executor does), which is why
    `warm_design` reports whether it pinned.
    """

    def __init__(self, workers: Optional[int] = None):
        if workers is None:
            workers = int(os.environ.get("REPRO_COMPILE_WORKERS", "2"))
        self.workers = max(1, workers)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._pending: set = set()
        self._threads: List[threading.Thread] = []
        self._started = False

    def _ensure_threads(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.workers):
                t = threading.Thread(target=self._worker,
                                     name=f"compile-ahead-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.put(None)   # let sibling workers drain out too
                return
            work, pending = item
            try:
                work()
            except Exception:       # noqa: BLE001 — the dispatcher retraces
                pass                # inline and raises there
            finally:
                with self._lock:
                    self._pending.discard(pending)

    def _submit(self, key: tuple, sig: tuple, done: bool,
                work: Callable[[], None]) -> bool:
        with self._lock:
            if done or (key, sig) in self._pending:
                return False
            self._pending.add((key, sig))
        pathfinder.pin_compiled(key)
        self._ensure_threads()
        self._q.put((work, (key, sig)))
        return True

    def warm_design(self, design_key: tuple,
                    make_scalar: Callable[[], Callable], in_specs,
                    device=None, trace_key: Optional[tuple] = None) -> bool:
        """Queue `design_vector` of one design (not stalling anyone: its
        time is ``compile_seconds`` only).  True when queued (and
        ``design_key`` pinned: the caller owes one
        `pathfinder.unpin_compiled(design_key)` after first dispatch),
        False when the design is registered or in flight already."""
        with _REG_LOCK:
            done = design_key in _DESIGNS or design_key in _INFLIGHT
        sig = pathfinder.signature(tuple(in_specs))
        return self._submit(design_key, sig, done, lambda: design_vector(
            design_key, make_scalar, in_specs, device, stalled=False,
            trace_key=trace_key))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued job finished (tests, benchmarks)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._pending:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)

    def shutdown(self) -> None:
        if self._started:
            self._q.put(None)


_SERVICE: Optional[CompileService] = None
_SERVICE_LOCK = threading.Lock()


def service() -> CompileService:
    """The process-wide compile service (``REPRO_COMPILE_WORKERS``
    threads, default 2)."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None:
            _SERVICE = CompileService()
        return _SERVICE
