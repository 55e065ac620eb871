"""CrossFlow -> runtime bridge: pick the sharding plan for a real mesh.

Given (arch config, shape cell, physical mesh), the planner enumerates the
parallelism strategies the runtime supports, scores each with CrossFlow,
and emits the argmin as a `ShardingPlan`.  The prediction is recorded so a
run can be compared against it.

All candidates are scored in one call of the batched engine
(``pathfinder.evaluate``), on the device of the hardware point, as the
reference scores them: one group per skeleton, vmapped when a group has
``min_batch_jit`` points or more, each point on its own leaves below that,
and through the engine's prediction cache, so a replanned (arch, cell,
mesh) is free.

`candidate_strategies` is also the strategy axis of the sweep engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import age as age_lib
from repro_torch.core import lmgraph, pathfinder
from repro_torch.core.age import MicroArch
from repro_torch.core.parallelism import Strategy
from repro_torch.core.placement import mesh_system
from repro_torch.core.roofline import PPEConfig


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """What the runtime actually consumes."""

    arch: str
    cell: str
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    strategy: Strategy              # paper notation (RC-..-d..-p..)
    # logical-axis -> mesh-axis rules (the sharding slice consumes this)
    rules: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]
    predicted_step_s: float
    predicted_breakdown: Dict[str, float]
    notes: str = ""

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))


# Logical activation/weight axes used across the models (MaxText-style).
DEFAULT_RULES: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = (
    ("batch", ("pod", "data")),     # activations: batch over DP axes
    ("seq", None),                  # sequence replicated (SP overrides)
    ("embed", None),                # d_model replicated on activations
    ("heads", ("model",)),          # attention heads over TP
    ("kv_heads", ("model",)),       # kv heads over TP (grouped for small kv)
    ("mlp", ("model",)),            # ffn hidden over TP
    ("vocab", ("model",)),          # embedding/logits vocab dim over TP
    ("experts", ("model",)),        # MoE experts over TP axis (EP)
    ("kv_seq", None),               # KV-cache seq dim (SP shards for 500k)
    ("lru", ("model",)),            # RG-LRU / xLSTM recurrence width
    ("stage", None),                # pipeline stage axis (LP > 1)
)


def candidate_strategies(cfg: ArchConfig, cell: ShapeCell,
                         mesh_shape: Tuple[int, ...]) -> List[Strategy]:
    """Strategies the runtime can realize on this mesh.

    The runtime maps KP -> the 'model' mesh axis and DP -> pod*data, so the
    candidates here vary how the *model* axis is used (RC head/ffn sharding,
    EP for MoE, SP for long-context) — the physical mesh stays fixed.
    """
    total = 1
    for s in mesh_shape:
        total *= s
    model = mesh_shape[-1]
    dp = total // model
    cands = [Strategy("RC", kp1=1, kp2=model, dp=dp, lp=1)]
    if cfg.is_moe:
        cands.append(Strategy("RC", kp1=1, kp2=model, dp=dp, lp=1, ep=model))
    if cell.name == "long_500k":
        cands.append(Strategy("RC", kp1=1, kp2=model, dp=dp, lp=1, sp=model))
    if cell.kind == "train" and cfg.n_layers >= 32 and len(mesh_shape) == 3:
        # pipeline over the pod axis for deep models on multi-pod meshes
        cands.append(Strategy("RC", kp1=1, kp2=model,
                              dp=dp // mesh_shape[0], lp=mesh_shape[0]))
    return cands


def plan(cfg: ArchConfig, cell: ShapeCell, mesh_shape: Tuple[int, ...],
         mesh_axes: Tuple[str, ...],
         arch_hw: Optional[MicroArch] = None,
         ppe: Optional[PPEConfig] = None, device=None) -> ShardingPlan:
    """Pick the best runtime-realizable strategy by CrossFlow prediction
    (on ``device``, the card unless the caller asks for ``"cpu"``; an
    ``arch_hw`` given brings its own device)."""
    hw = arch_hw or age_lib.tpu_v5e_microarch(device=device)
    ppe = ppe or PPEConfig(n_tilings=8)        # fast mode for planning
    system = mesh_system(mesh_shape)
    graph = lmgraph.build_graph(cfg, cell)
    cands = candidate_strategies(cfg, cell, mesh_shape)
    rows = pathfinder.evaluate(
        points=[pathfinder.EvalPoint(hw, graph, st, system=system)
                for st in cands], ppe=ppe)
    best = None
    for st, row in zip(cands, rows):
        t = float(row[0])
        if best is None or t < best[0]:
            best = (t, st, row)
    assert best is not None
    t, st, row = best
    rules = list(DEFAULT_RULES)
    notes = []
    if st.sp > 1:
        rules = [(a, ("model",)) if a == "kv_seq" else (a, ax)
                 for a, ax in rules]
        notes.append("SP: kv_seq sharded over model axis for long context")
    if cfg.family in ("hybrid", "ssm"):
        notes.append("KP restricted to head/width sharding for recurrences "
                     "(contraction dim stateful; DESIGN.md applicability)")
    if cfg.is_moe and cfg.moe_impl == "scatter_ep":
        notes.append("planner recommends moe_impl='grouped_tp': the "
                     "baseline scatter-EP dispatch lowers to a replicated "
                     "buffer all-reduce under GSPMD (EXPERIMENTS.md §Perf, "
                     "25x collective reduction)")
    return ShardingPlan(
        arch=cfg.name, cell=cell.name, mesh_shape=tuple(mesh_shape),
        mesh_axes=tuple(mesh_axes), strategy=st, rules=tuple(rules),
        predicted_step_s=t,
        predicted_breakdown={
            "compute_s": float(row[1]),
            "comm_s": float(row[2]),
            "exposed_comm_s": float(row[3]),
        },
        notes="; ".join(notes))
