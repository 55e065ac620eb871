"""Scenario registry — named workload scenarios for design-space sweeps.

The PyTorch port of ``repro.core.scenarios``.  The paper's §9 studies
sweep *training* iteration time; full-stack co-design studies (DFModel,
COSMIC) also need *inference/serving* workloads, where the objectives are
latency-SLO attainment and tokens/sec/device rather than step time.  A
`Scenario` packages, for one named workload:

  * which shape cells an architecture runs (training cell, or a
    prefill + decode pair for serving),
  * how one labeled design point expands into batched-engine `EvalPoint`s,
  * how raw metric rows fold back into a result record, and
  * the objective fields a Pareto frontier should minimize.

`repro_torch.core.sweeprunner` drives every registered architecture config
through a scenario; the CLI exposes it as ``python -m repro_torch.pathfind
sweep --scenario serving ...``.

The serving scenario is the paper-model's inference mode: the prefill phase
is a `prefill`-kind graph (TTFT objective), the decode phase a `decode`-kind
graph (one token per sequence per step), and KV-cache *capacity* pressure —
weights + KV resident bytes vs per-device main memory — derates decode
bandwidth via `roofline.capacity_pressure_derate` (the decode graph's
attention GEMMs already charge KV *bandwidth* per step).

The folds here are the reference's host folds, in float64 numpy, line for
line: `Scenario.record` and `Scenario.metrics_fold` fed the same metric
rows and hardware give the reference's records bit for bit.
`Scenario.refine_objectives`, cooptimize's differentiable fold, and
`Scenario.frontier_fold`, the device-resident streaming frontier's
objective fold, are the reference's over float32 tensors (their array
module ``xp`` is `tensors.XP`).
The checkpoint and failure timings the goodput objective reads come from
the port's `repro_torch.checkpoint.manager` and `repro_torch.runtime.fault`,
as the reference's come from its modules of those names.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.configs.base import ArchConfig, SHAPE_CELLS, get_config
from repro_torch.core import lmgraph, simulate, traffic
from repro_torch.core import objectives as objectives_lib
from repro_torch.core.age import MicroArch
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy
from repro_torch.core.pathfinder import EvalPoint
from repro_torch.core.placement import SystemGraph
from repro_torch.core.tensors import XP, as_f32, div
from repro_torch.runtime import fault

DTYPE_BYTES = 2                     # bf16 weights / KV cache


def point_key(arch: str, cell: str, mesh: Tuple[int, ...], logic: str,
              hbm: str, net: str, scale: float, strategy_name: str) -> str:
    """THE design-point identity string.

    Both `DesignPoint.key` (result records) and
    `sweeprunner.PointLabel.key` (checkpoint chunk hashes) delegate here —
    resume correctness depends on the two staying byte-identical, so there
    is exactly one formatter.
    """
    return "|".join([arch, cell, "x".join(map(str, mesh)), logic, hbm,
                     net, f"{scale:g}", strategy_name])


# ---------------------------------------------------------------------------
# Labeled design points
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One fully-resolved sweep candidate (labels + live objects)."""

    arch: str                       # model architecture id
    cell: str                       # cell name, or "prefill+decode" pair id
    mesh: Tuple[int, ...]
    logic: str
    hbm: str
    net: str
    scale: float                    # budget-scale variant (1.0 = nominal)
    strategy: Strategy
    cfg: ArchConfig
    hw: MicroArch
    system: SystemGraph

    def key(self) -> str:
        """Stable identity used in result records and resume bookkeeping."""
        return point_key(self.arch, self.cell, self.mesh, self.logic,
                         self.hbm, self.net, self.scale,
                         self.strategy.name)

    def label_fields(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "cell": self.cell,
            "mesh": "x".join(map(str, self.mesh)),
            "logic": self.logic, "hbm": self.hbm, "net": self.net,
            "scale": self.scale, "strategy": self.strategy.name,
            "devices": self.strategy.devices,
        }


# graphs are immutable once built; share them across threads and chunks
_GRAPH_CACHE: Dict[Tuple[str, str], ComputeGraph] = {}
_GRAPH_LOCK = threading.Lock()


def workload_graph(arch: str, cell_name: str) -> ComputeGraph:
    key = (arch, cell_name)
    with _GRAPH_LOCK:
        g = _GRAPH_CACHE.get(key)
    if g is None:
        g = lmgraph.build_graph(get_config(arch), SHAPE_CELLS[cell_name])
        with _GRAPH_LOCK:
            g = _GRAPH_CACHE.setdefault(key, g)
    return g


# ---------------------------------------------------------------------------
# Serving memory model
# ---------------------------------------------------------------------------


def weight_bytes(cfg: ArchConfig, dtype_bytes: int = DTYPE_BYTES) -> float:
    """Resident parameter bytes of one full replica."""
    return float(cfg.param_count()) * dtype_bytes


def kv_cache_bytes(cfg: ArchConfig, kv_len: int, batch: int,
                   dtype_bytes: int = DTYPE_BYTES) -> float:
    """Total KV-cache (+ recurrent-state) bytes for `batch` live sequences.

    Attention layers hold K+V per token: global layers over the full
    context, local layers over min(context, window).  Recurrent blocks
    (RG-LRU, m/sLSTM) hold O(1)-per-sequence state instead — this is
    exactly why hybrid archs win the long-context serving sweeps.
    """
    hd = cfg.resolved_head_dim
    if cfg.is_encoder_decoder:
        # the decoder holds self-KV over the trained decoder length plus
        # cross-KV over the encoded source sequence; its layers must NOT
        # also be charged the decoder-only full-context KV below
        dec = min(cfg.decoder_len, kv_len)
        per_seq = cfg.n_layers * 2.0 * cfg.n_kv_heads * hd * \
            (dec + kv_len) * dtype_bytes
        return per_seq * batch
    per_seq = 0.0
    for i in range(cfg.n_layers):
        bk = cfg.block_kind(i)
        if bk == "attn":
            ctx = kv_len
            if cfg.attn_kind(i) == "local":
                ctx = min(kv_len, cfg.local_window)
            per_seq += 2.0 * cfg.n_kv_heads * hd * ctx * dtype_bytes
        elif bk == "rglru":
            w = cfg.lru_width or cfg.d_model
            per_seq += (w + cfg.conv1d_width * w) * 4  # f32 carry state
        else:                                          # mlstm / slstm
            per_seq += cfg.n_heads * hd * hd * 4
    return per_seq * batch


def _kv_shard_degree(cfg: ArchConfig, st: Strategy) -> int:
    """How many ways the KV cache is split: DP/LP always shard batch and
    layers; the model axis shards KV heads only up to n_kv_heads (GQA
    floor) unless sequence parallelism shards the context dim instead."""
    kp_shard = min(st.kp, max(cfg.n_kv_heads, 1))
    if st.sp > 1:
        kp_shard = st.kp
    return st.dp * st.lp * max(kp_shard, 1)


def serving_bytes_per_device(cfg: ArchConfig, st: Strategy,
                             cell) -> Tuple[float, float]:
    """(weight bytes, KV-cache bytes) resident per device for one decode
    cell under one strategy — the serving capacity model shared by
    `ServingScenario.record` and the cooptimize refinement objective."""
    w_dev = weight_bytes(cfg) / max(st.kp * st.lp, 1)
    kv_dev = kv_cache_bytes(cfg, cell.seq_len, cell.global_batch) \
        / _kv_shard_degree(cfg, st)
    return w_dev, kv_dev


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


class Scenario:
    """One named workload: cells, eval-point expansion, record schema."""

    name: str = ""
    description: str = ""
    # record fields holding metrics (after the shared label fields)
    fields: Tuple[str, ...] = ()
    # record fields a Pareto frontier optimizes (canonically minimized;
    # max-direction registry objectives are sign-flipped by
    # `objective_values` / the frontier folds — see core/objectives.py)
    objectives: Tuple[str, ...] = ()
    # the continuous subset of `objectives` that `refine_objectives` folds
    # (discrete objectives like device count are fixed within a refinement)
    refine_objective_fields: Tuple[str, ...] = ()
    # which per-unit ctx the objective registry folds read: "step"
    # (training iterations) or "token" (serving) — picks the alias family
    # `--objectives energy,cost,goodput` resolves through
    objective_kind: str = "step"
    # set by `with_objectives`: composed registry objectives + their params
    _custom: bool = False
    extra_objectives: Tuple = ()
    obj_params: Optional[Dict[str, float]] = None
    _obj_signs: Tuple[float, ...] = ()

    # hardware ctx keys the objective folds read (all are HW_FIELDS, so
    # every fold variant — scalar record, vectorized metrics, traced
    # frontier — reads them from the same packed columns)
    _CTX_HW_KEYS: Tuple[str, ...] = (
        "compute_throughput", "dram_bw", "net_inter_bw", "dram_capacity",
        "energy_per_flop", "dram_energy_per_byte", "net_energy_per_byte",
        "static_power_w", "device_cost_usd")

    # ------------------------------------------------ objective layer
    def with_objectives(self, names: Optional[Sequence[str]] = None,
                        params: Optional[Mapping[str, float]] = None
                        ) -> "Scenario":
        """Compose registry objectives onto a copy of this scenario.

        ``names`` (aliases like "energy"/"cost"/"goodput", canonical
        registry names, or this scenario's own base objective fields)
        REPLACE the objective tuple; registry objectives among them (plus
        their deps) are appended to ``fields`` and computed by every fold
        variant.  With ``names=None`` the base objectives stand and only
        the objective model params change.  Returns ``self`` untouched
        when nothing changes — the default scenarios stay the shared
        singletons with byte-identical PR7 behavior.
        """
        import copy
        base_objectives = self.objectives
        resolved = objectives_lib.resolve_names(
            names, self.objective_kind, base_objectives) \
            if names else base_objectives
        merged = {**objectives_lib.PARAM_DEFAULTS, **dict(params or {})}
        if resolved == base_objectives and not params:
            return self
        scn = copy.copy(self)
        scn.objectives = resolved
        scn.obj_params = merged
        scn.extra_objectives = objectives_lib.computation_order(resolved)
        scn.fields = self.fields + tuple(
            o.name for o in scn.extra_objectives
            if o.name not in self.fields)
        refine = []
        for n in resolved:
            o = objectives_lib.REGISTRY.get(n)
            if o is not None:
                if o.continuous:
                    refine.append(n)
            elif n in type(self).refine_objective_fields:
                refine.append(n)
        scn.refine_objective_fields = tuple(refine)
        scn._obj_signs = objectives_lib.canonical_signs(resolved)
        scn._custom = (resolved != base_objectives
                       or bool(scn.extra_objectives))
        return scn

    def _objective_consts(self, cfg: ArchConfig,
                          strategy: Strategy) -> Dict[str, float]:
        """Host-constant ctx entries of one design: the objective model
        params plus the goodput derate (checkpoint write/restore timings
        over the fleet-MTBF model; see the functions at the end of this
        module).  No hardware dependence — computed once per fold
        closure."""
        p = dict(self.obj_params or objectives_lib.PARAM_DEFAULTS)
        devices = float(strategy.devices)
        # train checkpoints optimizer state (bf16 weights + f32 master +
        # Adam moments ~ 12 B/param); serving restores bf16 weights only
        per_param = 12.0 if self.objective_kind == "step" \
            else float(DTYPE_BYTES)
        ckpt_bytes = float(cfg.param_count()) * per_param
        write_s = ckpt_manager.checkpoint_write_s(
            ckpt_bytes, devices, p["ckpt_write_gbps"])
        restore_s = ckpt_manager.checkpoint_restore_s(
            ckpt_bytes, devices, p["ckpt_read_gbps"])
        mtbf = fault.fleet_mtbf_s(p["device_mtbf_s"], devices)
        if self.objective_kind == "step":
            frac = fault.goodput_fraction(write_s, restore_s, mtbf)
        else:
            frac = fault.availability(restore_s, mtbf)
        p.update({"devices": devices, "goodput_fraction": frac,
                  "ckpt_write_s": write_s, "ckpt_restore_s": restore_s,
                  "fleet_mtbf_s": mtbf})
        return p

    def _objective_extras_scalar(self, dp: "DesignPoint",
                                 units: Dict[str, float]) -> Dict[str, float]:
        """Registry objective values for one scalar record.

        Hardware inputs are rounded through f32 (`pack_hw` packs f32
        columns) so this path is bitwise identical to the vectorized
        metrics fold reading those columns back as f64.  They are read
        from the packed row itself: each value is the reference's
        ``float(np.float32(leaf))``, and the leaves of a card-resident
        point cross to the host in one copy, not one per leaf.
        """
        from repro_torch.core import pathfinder
        hw = pathfinder.pack_hw(dp.hw)
        ctx: Dict[str, object] = {
            k: float(hw[pathfinder.HW_FIELDS.index(k)])
            for k in (*pathfinder.HW_COEFF_FIELDS, "compute_throughput",
                      "dram_bw", "net_inter_bw", "dram_capacity")}
        ctx.update(self._objective_consts(dp.cfg, dp.strategy))
        ctx.update(units)
        vals = objectives_lib.evaluate(np, self.extra_objectives, ctx)
        return {k: float(v) for k, v in vals.items()}

    def _wrap_metrics_fold(self, base_fold, cfg: ArchConfig,
                           strategy: Strategy, units_fn):
        """Extend a legacy vectorized metrics fold with the composed
        registry objectives (no-op passthrough on default scenarios).

        ``units_fn(rows, recs) -> {unit: (B,) f64}`` supplies the
        scenario-kind unit values; hardware coefficients come from the
        packed f32 hw columns, mirroring `_objective_extras_scalar`
        op-for-op.
        """
        if not self._custom or base_fold is None:
            return base_fold
        from repro_torch.core import pathfinder
        idx = {k: pathfinder.HW_FIELDS.index(k)
               for k in self._CTX_HW_KEYS}
        consts = self._objective_consts(cfg, strategy)
        extras = self.extra_objectives

        def fold(rows, hw):
            recs = base_fold(rows, hw)
            ctx: Dict[str, object] = {
                k: hw[:, i].astype(np.float64) for k, i in idx.items()}
            ctx.update(consts)
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                ctx.update(units_fn(rows, recs))
                vals = objectives_lib.evaluate(np, extras, ctx)
            cols = {k: np.asarray(v) for k, v in vals.items()}
            for i, r in enumerate(recs):
                for k, col in cols.items():
                    r[k] = float(col[i])
            return recs
        return fold

    def _custom_refine_fold(self, dp: "DesignPoint", units_fn):
        """Differentiable refine fold over a composed objective set.

        ``units_fn(xp, bds, ctx) -> values`` maps the per-eval-point
        `simulate.TimeBreakdown`s (soft-derated, barrier-penalized —
        gradients must point back into the feasible region) to base
        objective/unit values; registry objectives evaluate on top of the
        LIVE hardware ctx (`pathfinder.hw_ctx`), so DVFS voltage reaches
        energy through `techlib.dynamic_energy_scale`.  Returns canonical
        (sign-applied) scalars ordered like `refine_objective_fields`.
        ``xp`` is `tensors.XP`, the folds' array module over tensors.
        """
        consts = self._objective_consts(dp.cfg, dp.strategy)
        extras = self.extra_objectives
        fields = self.refine_objective_fields
        signs = objectives_lib.canonical_signs(fields)

        def fold(bds, ctx):
            vals: Dict[str, object] = dict(ctx)
            vals.update(consts)
            vals.update(units_fn(XP, bds, vals))
            objectives_lib.evaluate(XP, extras, vals)
            return tuple(s * vals[f] for s, f in zip(signs, fields))
        return fold

    def _custom_frontier_fold(self, cfg: ArchConfig, strategy: Strategy,
                              values_fn):
        """Traced frontier fold over a composed objective set.

        ``values_fn(xp, rows, ctx) -> (values, ok)`` supplies the base
        objective/unit values from one design's metric rows (ctx already
        holds the hardware coefficients + per-design consts); composed
        registry objectives are evaluated on top, canonical signs applied
        (max-direction negated), and everything outside the feasible/SLO
        region masks to +inf so the device Pareto merge excludes it.
        ``xp`` is `tensors.XP`.
        """
        from repro_torch.core import pathfinder
        idx = {k: pathfinder.HW_FIELDS.index(k)
               for k in self._CTX_HW_KEYS}
        consts = self._objective_consts(cfg, strategy)
        extras = self.extra_objectives
        names = self.objectives
        signs = objectives_lib.canonical_signs(names)

        def fold(rows, hw_vec):
            ctx: Dict[str, object] = {k: hw_vec[i] for k, i in idx.items()}
            ctx.update(consts)
            values, ok = values_fn(XP, rows, ctx)
            ctx.update(values)
            objectives_lib.evaluate(XP, extras, ctx)
            return XP.stack([XP.where(ok, s * as_f32(ctx[n], rows.device),
                                      XP.inf)
                             for s, n in zip(signs, names)])
        return fold

    def cells(self, cfg: ArchConfig) -> Tuple[str, ...]:
        """Shape cells this scenario needs for one architecture."""
        raise NotImplementedError

    def cell_id(self) -> str:
        """The label used in point keys / records for this scenario."""
        return "+".join(self.cells(None))

    def points_per_design(self) -> int:
        """How many EvalPoints one design point expands to."""
        raise NotImplementedError

    def applicable(self, cfg: ArchConfig) -> bool:
        return True

    def eval_points(self, dp: DesignPoint) -> List[EvalPoint]:
        raise NotImplementedError

    def record(self, dp: DesignPoint, rows: np.ndarray) -> Dict:
        """Fold the (points_per_design, 5) metric rows into one record."""
        raise NotImplementedError

    def objective_values(self, rec: Dict) -> Optional[Tuple[float, ...]]:
        """This scenario's Pareto objective tuple for one result record,
        or None if the record is infeasible / has missing or non-finite
        objectives (mirrors the `sweeprunner.pareto_records` filter)."""
        if not rec.get("feasible", True):
            return None
        try:
            vs = tuple(float(rec[k]) for k in self.objectives)
        except (KeyError, TypeError, ValueError):
            return None
        if not all(np.isfinite(v) for v in vs):
            return None
        signs = self._obj_signs
        if signs and any(s != 1.0 for s in signs):
            vs = tuple(s * v for s, v in zip(signs, vs))
        return vs

    def refine_objectives(self, dp: DesignPoint):
        """Differentiable objective fold for cross-stack refinement
        (`repro_torch.core.cooptimize`).

        Returns ``fold(bds, ctx) -> tuple`` mapping the per-eval-point
        predicted `simulate.TimeBreakdown`s (one per `eval_points` entry)
        and the candidate's live hardware ctx (`pathfinder.hw_ctx` —
        capacity, bandwidths, energy coefficients, all theta-dependent
        tensors) to this scenario's *continuous* objective scalars, ordered
        like `refine_objective_fields` (discrete objectives such as device
        count are omitted — they are fixed within one refinement).
        Max-direction objectives are sign-flipped: every scalar is
        canonically minimized.  Autograd and ``torch.func`` transforms
        pass through every fold.
        """
        raise NotImplementedError

    def frontier_fold(self, cfg: ArchConfig, strategy: Strategy):
        """Traceable objective fold for the device-resident streaming
        frontier (`repro_torch.core.sweeppipeline`, ``pathfind sweep
        --frontier-only``).

        Returns ``fold(rows, hw_vec) -> (n_obj,) float32 tensor`` mapping
        one design's ``(points_per_design, 5)`` metric rows and its packed
        hardware vector (`pathfinder.HW_FIELDS` order) to the FULL
        `objectives` tuple, canonically signed — ``torch.func.vmap``ped
        behind the batched evaluation on the device, so frontier sweeps
        never pull per-point rows to host.  Must mirror `objective_values`
        exactly: an infeasible/unusable record maps to a non-finite
        objective (the frontier merge excludes it).  ``None`` = this
        scenario has no device fold (frontier-only unsupported).
        """
        return None

    def metrics_fold(self, cfg: ArchConfig, strategy: Strategy, cell_id):
        """Host-side vectorized fold for the pipelined executor's record
        stage.

        Returns ``fold(rows, hw) -> List[Dict]`` mapping a batch of
        ``(B, points_per_design, 5)`` metric rows and the matching
        ``(B, HW_DIM)`` packed hardware matrix to exactly the metric
        fields `record` appends after the label fields (same keys, same
        order, same values — parity-tested per scenario).  Per-design
        constants are captured at skeleton-build time and the arithmetic
        runs over the whole batch in NumPy, so the per-label cost is one
        dict literal.  ``None`` = no fast fold; the executor falls back
        to `record` on a resolved `DesignPoint`.
        """
        return None


class TrainScenario(Scenario):
    """Per-iteration training step time (the paper's Fig. 9 axis)."""

    name = "train"
    description = "training step time on one shape cell"
    fields = ("time_s", "compute_s", "comm_s", "exposed_comm_s")
    objectives = ("time_s", "devices")
    refine_objective_fields = ("time_s",)

    def __init__(self, cell: str = "train_4k", name: str = "train"):
        self.cell = cell
        self.name = name

    def _step_tokens(self) -> float:
        cell = SHAPE_CELLS[self.cell]
        return float(cell.global_batch) * cell.seq_len

    def cells(self, cfg) -> Tuple[str, ...]:
        return (self.cell,)

    def cell_id(self) -> str:
        return self.cell

    def points_per_design(self) -> int:
        return 1

    def eval_points(self, dp: DesignPoint) -> List[EvalPoint]:
        g = workload_graph(dp.arch, self.cell)
        return [EvalPoint(dp.hw, g, dp.strategy, system=dp.system)]

    def record(self, dp: DesignPoint, rows: np.ndarray) -> Dict:
        row = rows[0]
        rec = {**dp.label_fields(),
               "time_s": float(row[0]), "compute_s": float(row[1]),
               "comm_s": float(row[2]), "exposed_comm_s": float(row[3])}
        if not self._custom:
            return rec
        tokens = self._step_tokens()
        t = float(row[0])
        with np.errstate(divide="ignore", invalid="ignore"):
            base = float(np.float64(tokens) / np.float64(t))
        rec.update(self._objective_extras_scalar(dp, {
            "step_time_s": t, "step_compute_s": float(row[1]),
            "step_comm_s": float(row[2]), "base_tokens_per_s": base}))
        return rec

    def refine_objectives(self, dp: DesignPoint):
        if self._custom:
            tokens = self._step_tokens()
            devices = float(dp.strategy.devices)

            def units(xp, bds, vals):
                t = bds[0].total_s
                return {"time_s": t, "devices": devices,
                        "step_time_s": t,
                        "step_compute_s": bds[0].compute_s,
                        "step_comm_s": bds[0].comm_s,
                        "base_tokens_per_s": div(tokens, t)}
            return self._custom_refine_fold(dp, units)

        def fold(bds, ctx):
            return (bds[0].total_s,)               # step time; devices fixed
        return fold

    def frontier_fold(self, cfg: ArchConfig, strategy: Strategy):
        devices = float(strategy.devices)
        if self._custom:
            tokens = self._step_tokens()

            def values_fn(xp, rows, ctx):
                t = rows[0, 0]
                return ({"time_s": t, "devices": devices,
                         "step_time_s": t, "step_compute_s": rows[0, 1],
                         "step_comm_s": rows[0, 2],
                         "base_tokens_per_s": div(tokens, t)},
                        xp.isfinite(t))
            return self._custom_frontier_fold(cfg, strategy, values_fn)

        def fold(rows, hw_vec):
            return XP.stack([rows[0, 0], devices])
        return fold

    def metrics_fold(self, cfg: ArchConfig, strategy: Strategy, cell_id):
        def fold(rows, hw):
            return [{"time_s": r[0], "compute_s": r[1], "comm_s": r[2],
                     "exposed_comm_s": r[3]}
                    for r in rows[:, 0, :4].tolist()]
        if not self._custom:
            return fold
        tokens = self._step_tokens()

        def units(rows, recs):
            t = rows[:, 0, 0].astype(np.float64)
            return {"step_time_s": t,
                    "step_compute_s": rows[:, 0, 1].astype(np.float64),
                    "step_comm_s": rows[:, 0, 2].astype(np.float64),
                    "base_tokens_per_s": tokens / t}
        return self._wrap_metrics_fold(fold, cfg, strategy, units)


class ServingScenario(Scenario):
    """Prefill + decode inference: TTFT / TPOT / tokens-per-sec-per-device
    with KV-cache memory pressure (see module docstring)."""

    name = "serving"
    description = "prefill+decode serving: TTFT, tokens/s/device, KV pressure"
    fields = ("ttft_s", "tpot_s", "tokens_per_s", "tokens_per_s_per_device",
              "cost_device_s_per_token", "hbm_occupancy", "kv_derate",
              "feasible", "slo_ok")
    objectives = ("ttft_s", "cost_device_s_per_token")
    refine_objective_fields = ("ttft_s", "cost_device_s_per_token")
    objective_kind = "token"

    def __init__(self, prefill_cell: str = "prefill_32k",
                 decode_cell: str = "decode_32k",
                 slo_s: Optional[float] = None, name: str = "serving"):
        self.prefill_cell = prefill_cell
        self.decode_cell = decode_cell
        self.slo_s = slo_s
        self.name = name

    def cells(self, cfg) -> Tuple[str, ...]:
        return (self.prefill_cell, self.decode_cell)

    def cell_id(self) -> str:
        return f"{self.prefill_cell}+{self.decode_cell}"

    def points_per_design(self) -> int:
        return 2

    def applicable(self, cfg: ArchConfig) -> bool:
        if "long" in (self.prefill_cell + self.decode_cell):
            return cfg.supports_long_context
        return True

    def eval_points(self, dp: DesignPoint) -> List[EvalPoint]:
        gp = workload_graph(dp.arch, self.prefill_cell)
        gd = workload_graph(dp.arch, self.decode_cell)
        return [EvalPoint(dp.hw, gp, dp.strategy, system=dp.system),
                EvalPoint(dp.hw, gd, dp.strategy, system=dp.system)]

    def record(self, dp: DesignPoint, rows: np.ndarray) -> Dict:
        prefill = simulate.TimeBreakdown(
            total_s=rows[0][0], compute_s=rows[0][1], comm_s=rows[0][2],
            exposed_comm_s=rows[0][3])
        decode = simulate.TimeBreakdown(
            total_s=rows[1][0], compute_s=rows[1][1], comm_s=rows[1][2],
            exposed_comm_s=rows[1][3])
        cell = SHAPE_CELLS[self.decode_cell]
        st = dp.strategy
        w_dev, kv_dev = serving_bytes_per_device(dp.cfg, st, cell)
        bd = simulate.serving_breakdown(
            prefill, decode, batch=cell.global_batch, devices=st.devices,
            weight_bytes_per_device=w_dev, kv_bytes_per_device=kv_dev,
            dram_capacity=float(dp.hw.dram_capacity), slo_s=self.slo_s)
        rec = {**dp.label_fields(),
               "ttft_s": bd.ttft_s, "tpot_s": bd.tpot_s,
               "tokens_per_s": bd.tokens_per_s,
               "tokens_per_s_per_device": bd.tokens_per_s_per_device,
               "cost_device_s_per_token": bd.cost_device_s_per_token,
               "kv_bytes_per_device": bd.kv_bytes_per_device,
               "weight_bytes_per_device": bd.weight_bytes_per_device,
               "hbm_occupancy": bd.hbm_occupancy,
               "kv_derate": bd.kv_derate,
               "feasible": bd.feasible, "slo_ok": bd.slo_ok}
        if not self._custom:
            return rec
        batch = float(max(cell.global_batch, 1))
        rec.update(self._objective_extras_scalar(dp, {
            "token_compute_s": float(rows[1][1]) / batch,
            "token_comm_s": float(rows[1][2]) / batch,
            "device_s_per_token": float(bd.cost_device_s_per_token),
            "base_tokens_per_s": float(bd.tokens_per_s)}))
        return rec

    def refine_objectives(self, dp: DesignPoint):
        from repro_torch.core import roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(dp.cfg, dp.strategy, cell)
        devices = dp.strategy.devices
        batch = max(cell.global_batch, 1)
        if self._custom:
            def units(xp, bds, vals):
                occ = div(w_dev + kv_dev,
                          xp.maximum(vals["dram_capacity"], 1.0))
                tpot = bds[1].total_s \
                    * roofline.capacity_pressure_derate_soft(occ)
                cost = div(devices * tpot, batch)
                return {"ttft_s": bds[0].total_s,
                        "cost_device_s_per_token": cost,
                        "token_compute_s": div(bds[1].compute_s, batch),
                        "token_comm_s": div(bds[1].comm_s, batch),
                        "device_s_per_token": cost,
                        "base_tokens_per_s": div(batch, tpot)}
            return self._custom_refine_fold(dp, units)

        def fold(bds, ctx):
            occ = div(w_dev + kv_dev, XP.maximum(ctx["dram_capacity"], 1.0))
            tpot = bds[1].total_s \
                * roofline.capacity_pressure_derate_soft(occ)
            ttft = bds[0].total_s
            return (ttft, div(devices * tpot, batch))   # (ttft_s, cost/token)
        return fold

    def frontier_fold(self, cfg: ArchConfig, strategy: Strategy):
        from repro_torch.core import pathfinder, roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(cfg, strategy, cell)
        devices = float(strategy.devices)
        batch = float(cell.global_batch)
        knee = roofline.CAPACITY_PRESSURE_KNEE
        cap_i = pathfinder.HW_FIELDS.index("dram_capacity")

        def derated(xp, rows, capacity):
            # the exact (hard-walled) capacity derate of `record` /
            # `simulate.serving_breakdown` over tensors: an infeasible
            # point's decode step is +inf
            occ = div(w_dev + kv_dev, xp.maximum(capacity, 1.0))
            over = div(xp.maximum(occ - knee, 0.0), max(1.0 - knee, 1e-9))
            derate = xp.where(occ >= 1.0, xp.inf, 1.0 + 0.5 * over * over)
            return rows[1, 0] * derate

        if self._custom:
            def values_fn(xp, rows, ctx):
                ttft = rows[0, 0]
                tpot = derated(xp, rows, ctx["dram_capacity"])
                cost = div(devices * tpot, max(batch, 1.0))
                ok = xp.isfinite(tpot) & xp.isfinite(ttft)
                return ({"ttft_s": ttft, "tpot_s": tpot,
                         "cost_device_s_per_token": cost,
                         "token_compute_s": div(rows[1, 1], max(batch, 1.0)),
                         "token_comm_s": div(rows[1, 2], max(batch, 1.0)),
                         "device_s_per_token": cost,
                         "base_tokens_per_s": div(batch, tpot)}, ok)
            return self._custom_frontier_fold(cfg, strategy, values_fn)

        def fold(rows, hw_vec):
            tpot = derated(XP, rows, hw_vec[cap_i])
            cost = div(devices * tpot, batch) if batch else XP.inf
            return XP.stack([rows[0, 0], cost])
        return fold

    def metrics_fold(self, cfg: ArchConfig, strategy: Strategy, cell_id):
        from repro_torch.core import pathfinder, roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(cfg, strategy, cell)
        w_f, kv_f = float(w_dev), float(kv_dev)
        cap_i = pathfinder.HW_FIELDS.index("dram_capacity")
        batch, devices = cell.global_batch, strategy.devices
        knee = roofline.CAPACITY_PRESSURE_KNEE
        slo_s = self.slo_s

        def fold(rows, hw):
            # `simulate.serving_breakdown` over the whole batch at once;
            # every expression mirrors the scalar path op-for-op so the
            # IEEE results (and so the records) are bit-identical
            cap = np.maximum(hw[:, cap_i].astype(np.float64), 1.0)
            occ = (w_f + kv_f) / cap
            over = np.maximum(occ - knee, 0.0) / max(1.0 - knee, 1e-9)
            derate = np.where(occ >= 1.0, np.inf, 1.0 + 0.5 * over * over)
            ttft = rows[:, 0, 0]
            tpot = rows[:, 1, 0] * derate
            feasible = np.isfinite(tpot) & np.isfinite(ttft)
            with np.errstate(divide="ignore", invalid="ignore"):
                tokens = np.where(feasible & (tpot > 0), batch / tpot, 0.0)
                cost = np.where(feasible & (batch > 0),
                                devices * tpot / batch, np.inf)
            per_dev = tokens / max(devices, 1)
            slo = [None] * len(occ) if slo_s is None \
                else (ttft <= slo_s).tolist()
            return [
                {"ttft_s": t, "tpot_s": tp, "tokens_per_s": tk,
                 "tokens_per_s_per_device": pd,
                 "cost_device_s_per_token": c,
                 "kv_bytes_per_device": kv_f,
                 "weight_bytes_per_device": w_f,
                 "hbm_occupancy": o, "kv_derate": dr,
                 "feasible": f, "slo_ok": s}
                for t, tp, tk, pd, c, o, dr, f, s in zip(
                    ttft.tolist(), tpot.tolist(), tokens.tolist(),
                    per_dev.tolist(), cost.tolist(), occ.tolist(),
                    derate.tolist(), feasible.tolist(), slo)]
        if not self._custom:
            return fold
        batch_f = float(max(batch, 1))

        def units(rows, recs):
            return {
                "token_compute_s": rows[:, 1, 1].astype(np.float64)
                / batch_f,
                "token_comm_s": rows[:, 1, 2].astype(np.float64) / batch_f,
                "device_s_per_token": np.array(
                    [r["cost_device_s_per_token"] for r in recs],
                    dtype=np.float64),
                "base_tokens_per_s": np.array(
                    [r["tokens_per_s"] for r in recs], dtype=np.float64)}
        return self._wrap_metrics_fold(fold, cfg, strategy, units)


class ServingTrafficScenario(ServingScenario):
    """Traffic-driven continuous-batching serving (`core/traffic.py`).

    Same prefill/decode phase costs and KV-capacity derate as `serving`,
    but scored against a request arrival process: Poisson QPS, lognormal
    prompt/output lengths, chunked prefill riding decode steps.  Records
    carry TTFT/TPOT *percentiles*, Erlang utilization, the max sustainable
    QPS, and the raw phase costs (``prefill_s`` / derated
    ``decode_step_s``) the inverse fleet-sizing query replays without
    re-evaluating any sweep point.  Configured percentile SLOs act as
    feasibility walls: violating records keep their metrics but fold to
    non-finite objectives (excluded from every frontier).
    """

    name = "serving-traffic"
    description = ("continuous-batching serving under a QPS arrival "
                   "process: TTFT/TPOT percentiles, SLO walls, fleet cost")
    fields = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
              "util", "qps_max", "tokens_per_s", "tokens_per_s_per_device",
              "cost_device_s_per_token", "prefill_s", "decode_step_s",
              "hbm_occupancy", "kv_derate", "feasible", "slo_ok")
    objectives = ("ttft_p99_s", "cost_device_s_per_token")
    refine_objective_fields = ("ttft_p99_s", "cost_device_s_per_token")

    def __init__(self, prefill_cell: str = "prefill_32k",
                 decode_cell: str = "decode_32k",
                 params: Optional[Mapping] = None,
                 name: str = "serving-traffic",
                 variant: Optional[Mapping[str, float]] = None):
        self.prefill_cell = prefill_cell
        self.decode_cell = decode_cell
        self.params = {**traffic.PARAM_DEFAULTS, **(params or {})}
        self.traffic, self.policy, self.slo = \
            traffic.split_params(self.params)
        self.slo_s = self.slo.get("ttft_p99")    # legacy single-SLO view
        self.name = name
        self.variant = dict(variant or {})

    def cell_id(self) -> str:
        return traffic.encode_variant(
            f"{self.prefill_cell}+{self.decode_cell}", self.variant)

    def _consts(self, devices: float) -> traffic.ServeConsts:
        pc = SHAPE_CELLS[self.prefill_cell]
        dc = SHAPE_CELLS[self.decode_cell]
        return traffic.build_consts(
            self.traffic, self.policy, slots=dc.global_batch,
            prefill_tokens=float(pc.global_batch) * pc.seq_len,
            devices=devices)

    def _amortize_consts(self) -> Tuple[float, float]:
        """(decode slots, prefill-steps-per-output-token) for the energy
        attribution: decode-step compute/comm is shared by the batch
        slots; prefill work amortizes as (prompt_mean / prefill_tokens)
        prefill-graph executions per request over its output_mean
        generated tokens."""
        pc = SHAPE_CELLS[self.prefill_cell]
        dc = SHAPE_CELLS[self.decode_cell]
        prefill_tokens = max(float(pc.global_batch) * pc.seq_len, 1.0)
        k = (float(self.traffic.prompt_mean) / prefill_tokens) \
            / max(float(self.traffic.output_mean), 1.0)
        return float(max(dc.global_batch, 1)), k

    def objective_values(self, rec: Dict) -> Optional[Tuple[float, ...]]:
        if rec.get("slo_ok") is False:           # percentile walls are
            return None                          # feasibility walls here
        return super().objective_values(rec)

    def record(self, dp: DesignPoint, rows: np.ndarray) -> Dict:
        from repro_torch.core import roofline
        cell = SHAPE_CELLS[self.decode_cell]
        st = dp.strategy
        w_dev, kv_dev = serving_bytes_per_device(dp.cfg, st, cell)
        w_f, kv_f = float(w_dev), float(kv_dev)
        knee = roofline.CAPACITY_PRESSURE_KNEE
        # mirror the vectorized fold op-for-op (f64 throughout) so the
        # pipelined executor's records are bit-identical to this path
        cap = max(float(dp.hw.dram_capacity), 1.0)
        occ = (w_f + kv_f) / cap
        over = max(occ - knee, 0.0) / max(1.0 - knee, 1e-9)
        derate = np.inf if occ >= 1.0 else 1.0 + 0.5 * over * over
        t_pf = float(rows[0][0])
        t_d = float(rows[1][0]) * derate
        c = self._consts(float(st.devices))
        stats = traffic.continuous_batching_stats(
            np, np.float64(t_pf), np.float64(t_d), c)
        ok = traffic.slo_ok(stats, self.slo)
        f = lambda k: float(np.asarray(stats[k]))  # noqa: E731
        rec = {**dp.label_fields(),
               **{k: f(k) for k in
                  ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                   "util", "qps_max", "tokens_per_s",
                   "tokens_per_s_per_device", "cost_device_s_per_token")},
               "prefill_s": t_pf, "decode_step_s": t_d,
               "kv_bytes_per_device": kv_f,
               "weight_bytes_per_device": w_f,
               "hbm_occupancy": occ, "kv_derate": derate,
               "feasible": bool(np.asarray(stats["feasible"])),
               "slo_ok": bool(np.asarray(ok))}
        if not self._custom:
            return rec
        slots_f, k_pf = self._amortize_consts()
        rec.update(self._objective_extras_scalar(dp, {
            "token_compute_s": float(rows[1][1]) / slots_f
            + float(rows[0][1]) * k_pf,
            "token_comm_s": float(rows[1][2]) / slots_f
            + float(rows[0][2]) * k_pf,
            "device_s_per_token": rec["cost_device_s_per_token"],
            "base_tokens_per_s": rec["tokens_per_s"]}))
        return rec

    def refine_objectives(self, dp: DesignPoint):
        from repro_torch.core import roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(dp.cfg, dp.strategy, cell)
        c = self._consts(float(dp.strategy.devices))
        if self._custom:
            slots_f, k_pf = self._amortize_consts()

            def units(xp, bds, vals):
                occ = div(w_dev + kv_dev,
                          xp.maximum(vals["dram_capacity"], 1.0))
                t_d = bds[1].total_s \
                    * roofline.capacity_pressure_derate_soft(occ)
                st = traffic.continuous_batching_stats(
                    xp, bds[0].total_s, t_d, c, mask_infeasible=False)
                wall = xp.maximum(st["util"] - 1.0, 0.0)
                barrier = 1.0 + 1e3 * wall * wall
                # minimized values scale UP with the barrier, the
                # maximized throughput scales DOWN — descent always
                # points back inside the feasible region
                return {"ttft_p99_s": st["ttft_p99_s"] * barrier,
                        "cost_device_s_per_token":
                            st["cost_device_s_per_token"] * barrier,
                        "device_s_per_token":
                            st["cost_device_s_per_token"] * barrier,
                        "base_tokens_per_s": st["tokens_per_s"] / barrier,
                        "token_compute_s": div(bds[1].compute_s, slots_f)
                        + bds[0].compute_s * k_pf,
                        "token_comm_s": div(bds[1].comm_s, slots_f)
                        + bds[0].comm_s * k_pf}
            return self._custom_refine_fold(dp, units)

        def fold(bds, ctx):
            occ = div(w_dev + kv_dev, XP.maximum(ctx["dram_capacity"], 1.0))
            t_d = bds[1].total_s \
                * roofline.capacity_pressure_derate_soft(occ)
            st = traffic.continuous_batching_stats(
                XP, bds[0].total_s, t_d, c, mask_infeasible=False)
            # the hard util wall is flat after clamping; a soft barrier
            # keeps descent pointed back inside the feasible region
            wall = XP.maximum(st["util"] - 1.0, 0.0)
            barrier = 1.0 + 1e3 * wall * wall
            return (st["ttft_p99_s"] * barrier,
                    st["cost_device_s_per_token"] * barrier)
        return fold

    def frontier_fold(self, cfg: ArchConfig, strategy: Strategy):
        from repro_torch.core import pathfinder, roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(cfg, strategy, cell)
        w_f, kv_f = float(w_dev), float(kv_dev)
        knee = roofline.CAPACITY_PRESSURE_KNEE
        cap_i = pathfinder.HW_FIELDS.index("dram_capacity")
        c = self._consts(float(strategy.devices))
        slo = self.slo

        def stats(xp, rows, capacity):
            occ = div(w_f + kv_f, xp.maximum(capacity, 1.0))
            over = div(xp.maximum(occ - knee, 0.0), max(1.0 - knee, 1e-9))
            derate = xp.where(occ >= 1.0, xp.inf, 1.0 + 0.5 * over * over)
            return traffic.continuous_batching_stats(
                xp, rows[0, 0], rows[1, 0] * derate, c)

        if self._custom:
            slots_f, k_pf = self._amortize_consts()

            def values_fn(xp, rows, ctx):
                st = stats(xp, rows, ctx["dram_capacity"])
                # slo_ok AND feasible: a masked-infeasible point's
                # tokens_per_s is 0, which would otherwise survive the
                # non-finite goodput masking as a finite -0.0 objective
                ok = traffic.slo_ok(st, slo, xp=xp) & st["feasible"]
                return ({"ttft_p99_s": st["ttft_p99_s"],
                         "cost_device_s_per_token":
                             st["cost_device_s_per_token"],
                         "device_s_per_token":
                             st["cost_device_s_per_token"],
                         "base_tokens_per_s": st["tokens_per_s"],
                         "token_compute_s": div(rows[1, 1], slots_f)
                         + rows[0, 1] * k_pf,
                         "token_comm_s": div(rows[1, 2], slots_f)
                         + rows[0, 2] * k_pf}, ok)
            return self._custom_frontier_fold(cfg, strategy, values_fn)

        def fold(rows, hw_vec):
            st = stats(XP, rows, hw_vec[cap_i])
            ok = traffic.slo_ok(st, slo, xp=XP)
            return XP.stack([
                XP.where(ok, st["ttft_p99_s"], XP.inf),
                XP.where(ok, st["cost_device_s_per_token"], XP.inf)])
        return fold

    def metrics_fold(self, cfg: ArchConfig, strategy: Strategy, cell_id):
        from repro_torch.core import pathfinder, roofline
        cell = SHAPE_CELLS[self.decode_cell]
        w_dev, kv_dev = serving_bytes_per_device(cfg, strategy, cell)
        w_f, kv_f = float(w_dev), float(kv_dev)
        cap_i = pathfinder.HW_FIELDS.index("dram_capacity")
        knee = roofline.CAPACITY_PRESSURE_KNEE
        c = self._consts(float(strategy.devices))
        slo = self.slo
        keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                "util", "qps_max", "tokens_per_s",
                "tokens_per_s_per_device", "cost_device_s_per_token")

        def fold(rows, hw):
            cap = np.maximum(hw[:, cap_i].astype(np.float64), 1.0)
            occ = (w_f + kv_f) / cap
            over = np.maximum(occ - knee, 0.0) / max(1.0 - knee, 1e-9)
            derate = np.where(occ >= 1.0, np.inf, 1.0 + 0.5 * over * over)
            t_pf = rows[:, 0, 0].astype(np.float64)
            t_d = rows[:, 1, 0].astype(np.float64) * derate
            stats = traffic.continuous_batching_stats(np, t_pf, t_d, c)
            ok = traffic.slo_ok(stats, slo)
            cols = [np.asarray(stats[k]).tolist() for k in keys]
            return [
                {**dict(zip(keys, vals)),
                 "prefill_s": tp, "decode_step_s": td,
                 "kv_bytes_per_device": kv_f,
                 "weight_bytes_per_device": w_f,
                 "hbm_occupancy": o, "kv_derate": dr,
                 "feasible": fz, "slo_ok": sk}
                for vals, tp, td, o, dr, fz, sk in zip(
                    zip(*cols), t_pf.tolist(), t_d.tolist(), occ.tolist(),
                    derate.tolist(), np.asarray(stats["feasible"]).tolist(),
                    np.asarray(ok).tolist())]
        if not self._custom:
            return fold
        slots_f, k_pf = self._amortize_consts()

        def units(rows, recs):
            return {
                "token_compute_s": rows[:, 1, 1].astype(np.float64)
                / slots_f + rows[:, 0, 1].astype(np.float64) * k_pf,
                "token_comm_s": rows[:, 1, 2].astype(np.float64)
                / slots_f + rows[:, 0, 2].astype(np.float64) * k_pf,
                "device_s_per_token": np.array(
                    [r["cost_device_s_per_token"] for r in recs],
                    dtype=np.float64),
                "base_tokens_per_s": np.array(
                    [r["tokens_per_s"] for r in recs], dtype=np.float64)}
        return self._wrap_metrics_fold(fold, cfg, strategy, units)


# ---------------------------------------------------------------------------
# Registry + ScenarioSpec (THE way scenarios are constructed)
# ---------------------------------------------------------------------------


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, replace: bool = False) -> Scenario:
    if scenario.name in _REGISTRY and not replace:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def _canon_params(params) -> Tuple[Tuple[str, object], ...]:
    """Sorted (key, value) pairs; multi-valued entries (sweep axes) become
    float tuples, scalars become floats, None stays None."""
    if not params:
        return ()
    items = dict(params)
    out = []
    for k in sorted(items):
        v = items[k]
        if isinstance(v, (list, tuple)):
            v = tuple(float(x) for x in v)
            if len(v) == 1:
                v = v[0]
        elif v is not None:
            v = float(v)
        out.append((str(k), v))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Typed, JSON-serializable scenario construction request.

    The single way scenarios are built across `SweepSpec`, `cooptimize`,
    `pathfinder.sweep`, and the CLI: a registry name plus optional cell
    overrides, a legacy scalar SLO, and typed per-scenario ``params``
    (see `traffic.PARAM_DEFAULTS` for the serving-traffic keys).  A param
    set to a *list* of values declares a sweep axis: `variants()` expands
    the cross product, and each variant's swept values ride in the cell-id
    as a ``@k=v,...`` suffix so point keys, chunk hashes, and checkpoint
    resume work unchanged.  Construction is side-effect free; `resolve()`
    returns the live `Scenario`.
    """

    name: str = "train"
    cells: Tuple[str, ...] = ()
    slo_s: Optional[float] = None
    params: Tuple[Tuple[str, object], ...] = ()
    # params keys that came from a sweep axis (encoded into the cell id)
    variant_keys: Tuple[str, ...] = ()
    # composed Pareto objective set (None = the scenario's defaults —
    # serialized only when set, so pre-objective specs fingerprint
    # byte-identically)
    objectives: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "cells", tuple(self.cells))
        object.__setattr__(self, "params", _canon_params(self.params))
        object.__setattr__(self, "variant_keys",
                           tuple(self.variant_keys))
        if self.objectives is not None:
            object.__setattr__(self, "objectives",
                               tuple(str(o) for o in self.objectives))

    # -------------------------------------------------- construction
    @classmethod
    def coerce(cls, obj, cells: Sequence[str] = (),
               slo_s: Optional[float] = None,
               params: Optional[Mapping] = None,
               objectives: Optional[Sequence[str]] = None
               ) -> "ScenarioSpec":
        """Normalize a scenario name / dict / spec into a ScenarioSpec."""
        if isinstance(obj, ScenarioSpec):
            return obj
        if isinstance(obj, str):
            return cls(name=obj, cells=tuple(cells), slo_s=slo_s,
                       params=_canon_params(params),
                       objectives=objectives)
        if isinstance(obj, Mapping):
            return cls.from_dict(obj)
        raise TypeError(f"cannot build a ScenarioSpec from {type(obj)!r}")

    @property
    def param_dict(self) -> Dict[str, object]:
        return dict(self.params)

    def to_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"name": self.name}
        if self.cells:
            d["cells"] = list(self.cells)
        if self.slo_s is not None:
            d["slo_s"] = self.slo_s
        if self.params:
            d["params"] = {k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in self.params}
        if self.objectives is not None:
            d["objectives"] = list(self.objectives)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "ScenarioSpec":
        objs = d.get("objectives")
        return cls(name=d.get("name", "train"),
                   cells=tuple(d.get("cells", ())),
                   slo_s=d.get("slo_s"),
                   params=_canon_params(d.get("params")),
                   objectives=tuple(objs) if objs is not None else None)

    # -------------------------------------------------- axis expansion
    def axes(self) -> Dict[str, Tuple[float, ...]]:
        """The multi-valued params — the scenario's sweep axes."""
        return {k: v for k, v in self.params if isinstance(v, tuple)}

    def variants(self) -> List["ScenarioSpec"]:
        """Expand sweep-axis params into scalar variant specs (sorted-key
        cross product; a spec with no axes yields itself)."""
        axes = self.axes()
        if not axes:
            return [self]
        keys = sorted(axes)
        out = []
        for combo in itertools.product(*(axes[k] for k in keys)):
            p = self.param_dict
            p.update(zip(keys, combo))
            out.append(dataclasses.replace(
                self, params=_canon_params(p), variant_keys=tuple(keys)))
        return out

    def for_cell_id(self, cell_id: str) -> "ScenarioSpec":
        """The variant spec for one recorded cell id (cells + any swept
        param overrides carried in its ``@k=v,...`` suffix)."""
        base, over = traffic.decode_variant(cell_id)
        p = self.param_dict
        p.update(over)
        return dataclasses.replace(
            self, cells=tuple(base.split("+")), params=_canon_params(p),
            variant_keys=tuple(sorted(over)))

    # -------------------------------------------------- resolution
    def resolve(self) -> Scenario:
        """Build the live Scenario (registry lookup + overrides)."""
        base = _REGISTRY.get(self.name)
        if base is None:
            raise KeyError(f"unknown scenario {self.name!r}; "
                           f"registered: {sorted(_REGISTRY)}")
        if self.axes():
            raise ValueError(
                f"scenario {self.name!r} has multi-valued params "
                f"{sorted(self.axes())}: expand with variants() first")
        # objective model knobs split off FIRST so economic/reliability
        # constants never reach scenarios that take no workload params
        obj_params, params = objectives_lib.split_objective_params(
            self.param_dict)
        if isinstance(base, ServingTrafficScenario):
            pc, dc = base.prefill_cell, base.decode_cell
            if self.cells:
                if len(self.cells) != 2:
                    raise ValueError("serving scenario takes exactly two "
                                     "cells (prefill, decode)")
                pc, dc = self.cells
            merged = dict(base.params)
            if self.slo_s is not None:
                merged["slo_ttft_p99"] = self.slo_s
            merged.update(params)
            variant = {k: merged[k] for k in self.variant_keys}
            scn: Scenario = ServingTrafficScenario(
                prefill_cell=pc, decode_cell=dc, params=merged,
                name=base.name, variant=variant)
        elif params:
            raise ValueError(f"scenario {self.name!r} takes no params; "
                             f"got {sorted(params)}")
        elif isinstance(base, TrainScenario) and self.cells:
            scn = TrainScenario(cell=self.cells[0], name=base.name)
        elif isinstance(base, ServingScenario) and (self.slo_s is not None
                                                    or self.cells):
            pc, dc = base.prefill_cell, base.decode_cell
            if self.cells:
                if len(self.cells) != 2:
                    raise ValueError("serving scenario takes exactly two "
                                     "cells (prefill, decode)")
                pc, dc = self.cells
            scn = ServingScenario(prefill_cell=pc, decode_cell=dc,
                                  slo_s=self.slo_s, name=base.name)
        else:
            scn = base
        if self.objectives is not None or obj_params:
            scn = scn.with_objectives(self.objectives, obj_params)
        return scn


def get_scenario(name: str, slo_s: Optional[float] = None,
                 cells: Sequence[str] = ()) -> Scenario:
    """Compat shim over `ScenarioSpec` — the pre-PR6 lookup signature."""
    return ScenarioSpec(name=name, cells=tuple(cells),
                        slo_s=slo_s).resolve()


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


register_scenario(TrainScenario())
register_scenario(ServingScenario())
# long-context serving: recurrent/hybrid archs only (O(1) state is the win)
register_scenario(ServingScenario(prefill_cell="prefill_32k",
                                  decode_cell="long_500k",
                                  name="serving-long"))
# traffic-driven continuous batching (QPS arrivals, percentile SLO walls)
register_scenario(ServingTrafficScenario())
