"""Sharding rules: a DeepFlow ``ShardingPlan`` -> DTensor placements for
parameters, optimizer state, inputs and caches, as
``repro.parallel.sharding``.

The planner (`repro_torch.core.planner`) emits logical-axis rules in the
paper's strategy vocabulary (RC kernel parallelism -> ``model``, DP ->
``pod`` x ``data``, EP / SP reusing ``model``, ``fsdp`` -> ``data`` for
ZeRO-style parameter and moment sharding); this module resolves them
against a mesh.  A *spec* is the reference's ``PartitionSpec`` as a tuple:
one entry per tensor dim, None or a tuple of mesh axis names.  A leaf's
*placements* are the DTensor form of its spec on the mesh: one
``Shard(dim)`` or ``Replicate()`` per mesh dim.  Each function returns
placements, and `*_specs` beside it the specs they come from.

``mesh`` is a ``DeviceMesh`` or any object with the mesh's axis names
(``mesh_dim_names`` or ``axis_names``) and its ``shape`` (a dict of axis
sizes, as `repro_torch.launch.mesh.AbstractMesh` and the reference's
meshes have), so the rules are checked without devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.planner import ShardingPlan
from repro_torch.models import common
from repro_torch.tree import tree_map

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def mesh_axes(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:                       # a stand-in with a shape dict
        names = tuple(mesh.shape)
    return tuple(names)


def mesh_shape(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "items"):
        return dict(shape)
    return dict(zip(mesh_axes(mesh), shape))      # a DeviceMesh


def resolve_rules(plan: ShardingPlan, mesh, fsdp: bool = True
                  ) -> Dict[str, Optional[Tuple[str, ...]]]:
    """Plan rules -> rules valid on ``mesh`` (absent axes dropped)."""
    rules = common.rules_from_plan(plan.rules)
    if not fsdp:
        rules["fsdp"] = None
    names = mesh_axes(mesh)
    out = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
            continue
        if isinstance(v, str):
            v = (v,)
        v = tuple(a for a in v if a in names)
        out[k] = v or None
    return out


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        entry = (entry,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in entry:
        n *= sizes[a]
    return n


def _entry(e) -> Optional[Tuple[str, ...]]:
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


def guard_spec(mesh, spec, shape) -> Spec:
    """Drop entries whose mesh-axis product does not divide the dim:
    that dim is replicated (whisper's 20 kv heads on a 16-way ``model``
    axis, batch-1 cells, ...).  Replication is always semantically safe."""
    parts = []
    for i, dim in enumerate(shape):
        entry = _entry(spec[i]) if i < len(spec) else None
        if entry is not None and dim % _axis_size(mesh, entry):
            entry = None
        parts.append(entry)
    return tuple(parts)


def placements(mesh, spec: Spec) -> tuple:
    """A spec's placements on ``mesh``: ``Shard(d)`` on each mesh dim that
    tensor dim ``d`` names, ``Replicate()`` on the rest.  A tensor dim over
    several mesh dims is split in mesh-dim order, major first, as a
    ``PartitionSpec`` entry ``("pod", "data")`` is."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _entry(entry) or ():
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards two "
                                 f"dims")
            out[i] = Shard(d)
    return tuple(out)


def param_specs(model, plan: ShardingPlan, mesh, fsdp: bool = True):
    rules = resolve_rules(plan, mesh, fsdp)
    return tree_map(lambda s, d: guard_spec(mesh, s, d.shape),
                    model.param_pspecs(rules), model.defs)


def param_shardings(model, plan: ShardingPlan, mesh, fsdp: bool = True):
    """Each parameter's placements (the AdamW moments and the gradients
    take the same)."""
    return tree_map(lambda s: placements(mesh, s),
                    param_specs(model, plan, mesh, fsdp))


def batch_specs(cfg: ArchConfig, cell: ShapeCell, plan: ShardingPlan,
                mesh) -> Dict[str, Spec]:
    """Inputs: the batch dim over the DP axes (replicated where they do
    not divide it: batch-1 long-context cells)."""
    rules = resolve_rules(plan, mesh)
    dp = rules.get("batch")
    if dp is not None and cell.global_batch % _axis_size(mesh, dp):
        dp = None
    specs = {"tokens": (dp,), "labels": (dp,)}
    if cfg.is_encoder_decoder:
        specs["frames"] = (dp, None, None)
    if cfg.frontend == "vision_stub" and cfg.n_patch_tokens:
        specs["embeds"] = (dp, None, None)
    if cell.kind == "prefill":
        specs.pop("labels", None)
    return specs


def batch_shardings(cfg: ArchConfig, cell: ShapeCell, plan: ShardingPlan,
                    mesh) -> Dict[str, tuple]:
    return {k: placements(mesh, s)
            for k, s in batch_specs(cfg, cell, plan, mesh).items()}


def cache_specs(cfg: ArchConfig, plan: ShardingPlan, mesh, caches_tree):
    """KV caches: batch over DP, kv heads over ``model``; under SP the
    cache's sequence dim takes ``model`` and kv heads move to ``data``
    (long_500k: batch 1, few kv heads).  Recurrent states (rank 2 and 3):
    batch over DP, the last dim over ``lru`` (or ``heads``)."""
    rules = resolve_rules(plan, mesh)
    names = mesh_axes(mesh)
    dp = rules.get("batch")
    sp = rules.get("kv_seq")
    heads = rules.get("heads") if not sp else (
        ("data",) if "data" in names else None)

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd
        # the (batch, heads/width, [seq, dim]) block found by rank; stacked
        # caches have a leading layers axis (never sharded)
        off = nd - 4 if nd >= 4 else max(nd - 3, 0)
        if nd >= 4:
            parts[off] = dp
            parts[off + 1] = heads
            if sp:
                parts[off + 2] = sp
        elif nd >= 2:
            parts[off] = dp
            parts[-1] = rules.get("lru") or rules.get("heads")
        return guard_spec(mesh, tuple(parts), shape)

    return tree_map(spec_for, caches_tree)


def cache_shardings(cfg: ArchConfig, plan: ShardingPlan, mesh,
                    caches_tree):
    return tree_map(lambda s: placements(mesh, s),
                    cache_specs(cfg, plan, mesh, caches_tree))


def scalar_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(mesh_axes(mesh))


def shard_factor(mesh, spec: Spec) -> int:
    """Devices a leaf of ``spec`` is split over (its full bytes over one
    rank's)."""
    n = 1
    for entry in spec:
        n *= _axis_size(mesh, entry)
    return n


def local_box(shape, mesh, placements, coord=None) -> Tuple[slice, ...]:
    """The slices of a leaf of ``shape`` that the rank at mesh coordinate
    ``coord`` (default: this rank's) holds under ``placements`` on the
    ``DeviceMesh``: each ``Shard(d)`` splits dim ``d`` in mesh-dim order
    as ``torch.chunk`` does, DTensor's own layout."""
    if coord is None:
        coord = mesh.get_coordinate()
    start, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d = p.dim
            chunk = -(-size[d] // mesh.size(i))
            off = min(chunk * coord[i], size[d])
            start[d] += off
            size[d] = min(chunk, size[d] - off)
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def distribute(tree: Any, mesh, shardings: Any) -> Any:
    """Leaves every rank holds in full (the same values on each) -> DTensors
    of ``shardings``' placements: each rank keeps its own shard, and no
    byte crosses ranks."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, pl: distribute_tensor(
        t, mesh, pl, src_data_rank=None), tree, shardings)
