"""What one step costs rank 0, counted op by op: the dry-run's counters
(`repro_torch.launch.dryrun`).

`StepCounter` is a ``TorchDispatchMode`` run around one step on fake
tensors (or on real ones: it only reads shapes, dtypes and storages).  It
sees the ops rank 0 runs on its own tensors: a DTensor op is left to
DTensor (the mode returns ``NotImplemented``), which runs it on the local
shards and emits the collectives, and those local ops come back through
the mode.  DTensor's own metadata work (the ops its sharding propagation
runs at the global shape to learn an output's shape, a strided shard's
index arithmetic) is run but not counted.  It keeps:

  flops        dot FLOPs: 2 m n k of every mm, bmm, addmm, baddbmm (and
               2 n of a dot, 2 m n of an mv), and
               the convolution and attention ops ``torch.utils.
               flop_counter`` knows, plus each hand-written kernel's own
               formula (the kernel modules' ``flops``), reported by the
               kernels' fake-tensor rules through ``kernels.build.
               kernel_call`` (a counter is in ``build.COUNTERS`` while
               active)
  bytes        operand plus result bytes of every op that is neither a
               view nor an allocation, plus each kernel's formula: an
               unfused eager count, each op reading its inputs from memory
               and writing its outputs there
  collectives  the reference's ``collective_bytes``: per kind
               (all-gather, all-reduce, reduce-scatter, all-to-all,
               collective-permute) the result bytes rank 0 receives, and
               ``count``; from the ``_c10d_functional`` ops DTensor emits
               and the ``c10d`` ops of ``torch.distributed`` calls
  kernels      calls of each hand-written kernel (its fake-tensor rule)
  memory       ``argument_bytes`` (the step's inputs), ``output_bytes``
               (each leaf of what the step returns, as an undonated jitted
               step returns fresh buffers), ``temp_bytes`` (the most bytes
               held at once by storages that are neither inputs nor
               outputs) and ``peak_bytes`` (the most bytes held at once by
               every live storage, the inputs included), from the
               storages the step's ops allocate and free; a storage two
               tensors view is counted once
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# op name -> kind; ``_c10d_functional`` ops return what they receive,
# ``c10d`` ops take it as their first argument
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# ops that allocate or describe, and move no byte
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "lift_fresh_copy", "_local_scalar_dense", "wait_tensor",
             "device", "layout", "dim", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "resize_", "set_"}

def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's rank-local tensor; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _untraced() -> bool:
    """DTensor's ``_are_we_tracing`` for the counted step: False.  DTensor
    takes any fake mode for a trace and then skips its sharding caches,
    which symbolic shapes would break; the dry-run's shapes are concrete,
    and without the caches every op searches its layouts anew (minutes a
    step on a 2x16x16 mesh)."""
    return False


class _Metadata:
    """Marks DTensor's own metadata work, which the counter runs but does
    not count: the ops its sharding propagation runs at the global shape
    to learn an output's shape (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``), and the index arithmetic by
    which a strided shard finds its size and offsets (``_StridedShard.
    local_shard_size_and_offset``), which reads index tensors back to the
    host and so runs on real tensors, outside the fake mode.  It also
    lets DTensor's op dispatch and sharding propagation keep their caches
    under the fake mode (`_untraced`).  Installed while a counter is
    active, restored after.  A torch whose DTensor lacks a marked method
    is refused (the counter would count DTensor's global-shape ops as
    rank 0's); one that lacks an ``_are_we_tracing`` only steps slower."""

    depth = 0
    # (module, class or None, name, what to put there: the method marked
    # and run in the fake mode or outside it, or `_untraced`)
    TARGETS = (("torch.distributed.tensor._sharding_prop",
                "ShardingPropagator", "_propagate_tensor_meta_non_cached",
                "fake"),
               ("torch.distributed.tensor.placement_types", "_StridedShard",
                "local_shard_size_and_offset", "real"),
               ("torch.distributed.tensor._dispatch", None,
                "_are_we_tracing", "untraced"),
               ("torch.distributed.tensor._sharding_prop", None,
                "_are_we_tracing", "untraced"))
    _saved: List[tuple] = []

    @classmethod
    def _wrap(cls, fn, real: bool):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def marked(*args, **kwargs):
            cls.depth += 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                cls.depth -= 1
        return marked

    @classmethod
    def install(cls) -> None:
        import importlib
        import inspect
        if cls._saved:
            return
        for mod, owner, name, how in cls.TARGETS:
            where = importlib.import_module(mod)
            if owner is not None:
                where = getattr(where, owner, None)
            if where is None or not hasattr(where, name):
                if how == "untraced":
                    continue        # no cache to keep
                cls.remove()
                raise RuntimeError(
                    f"dryrun: this torch's DTensor has no {mod}."
                    f"{owner}.{name}; without it the counter would count "
                    f"DTensor's metadata ops as rank 0's")
            orig = inspect.getattr_static(where, name)
            if how == "untraced":
                wrapped = _untraced
            elif isinstance(orig, staticmethod):
                wrapped = staticmethod(cls._wrap(orig.__func__,
                                                 how == "real"))
            else:
                wrapped = cls._wrap(orig, how == "real")
            cls._saved.append((where, name, orig))
            setattr(where, name, wrapped)

    @classmethod
    def remove(cls) -> None:
        while cls._saved:
            where, name, orig = cls._saved.pop()
            setattr(where, name, orig)


class StepCounter(TorchDispatchMode):
    """Counts the ops of rank 0 while active (see the module's doc).

    ``args``: the step's inputs (trees of tensors or DTensors), whose
    storages are live when the step starts; `finish` with the step's
    outputs closes the memory count."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self.kernels: Dict[str, int] = collections.Counter()
        self.memory: Dict[str, int] = {}
        self._serial = 0
        self._live: Dict[int, tuple] = {}       # storage key -> (id, bytes)
        self._events: List[tuple] = []          # (id, +/- bytes)
        self._args = set()
        for t in _tensors(args):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key not in self._live:
                self._track(st, key, arg=True)
        self.argument_bytes = sum(n for i, n in self._live.values())

    # -- memory ------------------------------------------------------------
    def _track(self, st, key: int, arg: bool = False) -> None:
        self._serial += 1
        sid, n = self._serial, st.nbytes()
        self._live[key] = (sid, n)
        if arg:
            self._args.add(sid)
        else:
            self._events.append((sid, n))
        weakref.finalize(st, self._free, key, sid)

    def _free(self, key: int, sid: int) -> None:
        held = self._live.get(key)
        if held is not None and held[0] == sid:
            del self._live[key]
            if sid not in self._args:
                self._events.append((sid, -held[1]))

    def _allocated(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue                # a tensor with no storage
            if st._cdata not in self._live:
                self._track(st, st._cdata)

    def finish(self, outputs: Any) -> Dict[str, int]:
        """Close the memory count with the step's ``outputs``; returns (and
        keeps in ``memory``) the four byte counts."""
        out_ids = set()
        out_bytes = 0
        for t in _tensors(outputs):
            loc = _local(t)
            out_bytes += _nbytes(loc)
            held = self._live.get(loc.untyped_storage()._cdata)
            if held is not None:
                out_ids.add(held[0])
        live = peak = temp = temp_peak = 0
        for sid, n in self._events:
            live += n
            peak = max(peak, live)
            if sid not in out_ids:
                temp += n
                temp_peak = max(temp_peak, temp)
        self.memory = {"argument_bytes": int(self.argument_bytes),
                       "output_bytes": int(out_bytes),
                       "temp_bytes": int(temp_peak),
                       "peak_bytes": int(self.argument_bytes + peak)}
        return self.memory

    # -- the mode ------------------------------------------------------------
    def kernel_call(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel, from its fake-tensor rule:
        the kernel's formula FLOPs and bytes."""
        self.kernels[name] += 1
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        _Metadata.install()
        build.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.COUNTERS.remove(self)
        if not build.COUNTERS:
            _Metadata.remove()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on the shards
        out = func(*args, **kwargs)
        if _Metadata.depth:
            return out                  # DTensor's metadata work
        self._allocated(out)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                got = out if ns != "c10d" else (args[0] if args else ())
                self.collectives[kind] += float(sum(
                    _nbytes(t) for t in _tensors(got)))
                self.collectives["count"] += 1
            return
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        elif name in ("dot", "vdot", "mv"):    # 2 n, 2 m n
            self.flops += 2.0 * args[0].numel()
        if func.is_view or name in _NO_BYTES:
            return
        self.bytes += float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                            + sum(_nbytes(t) for t in _tensors(out)))

