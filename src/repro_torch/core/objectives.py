"""First-class objective layer: typed, composable Pareto axes.

A copy of the reference's ``repro.core.objectives``: it imports nothing
but the standard library, so only this paragraph differs.  The port calls
its folds with ``xp=numpy`` and, in the scenarios' differentiable refine
folds, with ``xp=tensors.XP`` (torch functions that take what
``jax.numpy``'s take).  The checkpoint and failure models named below are
copied into ``core/scenarios.py``.

Scenarios (repro.core.scenarios) historically hard-coded their objective
tuples ("time_s", "devices") in four parallel fold implementations.  This
module extracts the figure-of-merit into a typed registry so every layer
of the stack — scalar records, vectorized metrics folds, traced frontier
folds, cooptimize's differentiable refinement, and the CLI — composes the
SAME definition, written once against an array-module parameter ``xp``
(numpy or jax.numpy), PR6-traffic-style.

Three objective families ship through the registry:

* **energy** (J/step, J/token): dynamic energy from techlib
  energy-per-flop and DRAM/network per-byte energies applied to the
  modeled compute/communication seconds, plus static power integrated
  over wall-clock device occupancy.  Traceable through
  ``techlib.dynamic_energy_scale`` so cooptimize trades DVFS voltage
  against energy under the existing joint power clamp.
* **cost** ($/step, $/token TCO): capex amortization of the per-tech
  device cost table over ``device_lifetime_s`` plus the energy bill at
  ``energy_price_usd_per_kwh`` × ``pue``.
* **goodput** (tokens/s, maximized): throughput derated by
  checkpoint/restore/failure overheads — Young's optimal checkpoint
  interval from ``repro.checkpoint.manager`` write/restore timings and a
  fleet MTBF model from ``repro.runtime.fault``.

Every fold reads a flat ``ctx`` dict.  The contract (scenario folds build
it; see ``Scenario.with_objectives``):

hardware coefficients (from ``pathfinder.pack_hw`` columns or a traced
MicroArch):
  compute_throughput, dram_bw, net_inter_bw, energy_per_flop,
  dram_energy_per_byte, net_energy_per_byte, static_power_w,
  device_cost_usd

per-design constants:
  devices, goodput_fraction

unit values (scenario-kind specific):
  kind "step":  step_time_s, step_compute_s, step_comm_s,
                base_tokens_per_s
  kind "token": token_compute_s, token_comm_s, device_s_per_token,
                base_tokens_per_s

Dynamic energy is attributed to work actually done (underated
compute/comm seconds); static energy to wall-clock occupancy
(step_time_s / device_s_per_token), which carries the feasibility
derates — an infeasible point's +inf occupancy makes its energy +inf, so
the frontier fold's non-finite masking needs no special cases.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

# J per kWh: converts energy_price_usd_per_kwh to $/J
_J_PER_KWH = 3.6e6


@dataclasses.dataclass(frozen=True)
class Objective:
    """One registered figure of merit.

    ``fold(xp, ctx)`` is the single implementation shared by the scalar
    record path (xp=numpy over python floats), the vectorized metrics
    fold (xp=numpy over arrays), and the traced frontier/refine folds
    (xp=jax.numpy over tracers) — parity across folds by construction.
    """

    name: str                     # canonical record field name
    unit: str
    direction: str                # "min" | "max"
    description: str
    fold: Callable[..., object]   # fold(xp, ctx) -> value
    requires: Tuple[str, ...] = ()    # ctx keys read (documentation)
    deps: Tuple[str, ...] = ()        # objective names computed first
    kind: Optional[str] = None        # "step" | "token" | None (any)
    continuous: bool = True           # usable as a refine objective


def _energy_per_step(xp, ctx):
    dyn = (ctx["step_compute_s"]
           * (ctx["compute_throughput"] * ctx["energy_per_flop"]
              + ctx["dram_bw"] * ctx["dram_energy_per_byte"])
           + ctx["step_comm_s"]
           * ctx["net_inter_bw"] * ctx["net_energy_per_byte"])
    return ctx["devices"] * (dyn + ctx["step_time_s"] * ctx["static_power_w"])


def _energy_per_token(xp, ctx):
    dyn = (ctx["token_compute_s"]
           * (ctx["compute_throughput"] * ctx["energy_per_flop"]
              + ctx["dram_bw"] * ctx["dram_energy_per_byte"])
           + ctx["token_comm_s"]
           * ctx["net_inter_bw"] * ctx["net_energy_per_byte"])
    # device_s_per_token already aggregates the fleet (devices x s/token)
    return (ctx["devices"] * dyn
            + ctx["static_power_w"] * ctx["device_s_per_token"])


def _cost_per_step(xp, ctx):
    capex = (ctx["device_cost_usd"] / ctx["device_lifetime_s"]
             * ctx["devices"] * ctx["step_time_s"])
    opex = (ctx["energy_j_per_step"] * ctx["pue"]
            * ctx["energy_price_usd_per_kwh"] / _J_PER_KWH)
    return capex + opex


def _cost_per_token(xp, ctx):
    capex = (ctx["device_cost_usd"] / ctx["device_lifetime_s"]
             * ctx["device_s_per_token"])
    opex = (ctx["energy_j_per_token"] * ctx["pue"]
            * ctx["energy_price_usd_per_kwh"] / _J_PER_KWH)
    return capex + opex


def _goodput(xp, ctx):
    return ctx["base_tokens_per_s"] * ctx["goodput_fraction"]


_HW_KEYS = ("compute_throughput", "dram_bw", "net_inter_bw")
_ENERGY_KEYS = ("energy_per_flop", "dram_energy_per_byte",
                "net_energy_per_byte", "static_power_w")

REGISTRY: Dict[str, Objective] = {o.name: o for o in (
    Objective(
        name="energy_j_per_step", unit="J/step", direction="min",
        description="fleet energy per training step: dynamic "
                    "(flops + DRAM + network) on modeled busy seconds "
                    "plus static power over step wall-clock",
        fold=_energy_per_step, kind="step",
        requires=_HW_KEYS + _ENERGY_KEYS
        + ("devices", "step_time_s", "step_compute_s", "step_comm_s")),
    Objective(
        name="energy_j_per_token", unit="J/token", direction="min",
        description="fleet energy per generated token: dynamic energy on "
                    "per-token busy seconds plus static power over "
                    "device-seconds-per-token occupancy",
        fold=_energy_per_token, kind="token",
        requires=_HW_KEYS + _ENERGY_KEYS
        + ("devices", "token_compute_s", "token_comm_s",
           "device_s_per_token")),
    Objective(
        name="cost_usd_per_step", unit="$/step", direction="min",
        description="TCO per step: device capex amortized over "
                    "device_lifetime_s plus the energy bill at "
                    "energy_price_usd_per_kwh x PUE",
        fold=_cost_per_step, deps=("energy_j_per_step",), kind="step",
        requires=("device_cost_usd", "device_lifetime_s", "pue",
                  "energy_price_usd_per_kwh", "devices", "step_time_s")),
    Objective(
        name="cost_usd_per_token", unit="$/token", direction="min",
        description="TCO per token: capex amortization on "
                    "device-seconds-per-token plus the energy bill",
        fold=_cost_per_token, deps=("energy_j_per_token",), kind="token",
        requires=("device_cost_usd", "device_lifetime_s", "pue",
                  "energy_price_usd_per_kwh", "device_s_per_token")),
    Objective(
        name="goodput_tokens_per_s", unit="tokens/s", direction="max",
        description="throughput derated by checkpoint/restore/failure "
                    "overheads (Young's interval over fleet MTBF for "
                    "train; steady-state availability for serving)",
        fold=_goodput, kind=None,
        requires=("base_tokens_per_s", "goodput_fraction")),
)}

# CLI/spec shorthand per scenario kind: `--objectives energy,cost` means
# J/step + $/step on train, J/token + $/token on the serving family
ALIASES: Dict[str, Dict[str, str]] = {
    "step": {"energy": "energy_j_per_step",
             "cost": "cost_usd_per_step",
             "goodput": "goodput_tokens_per_s"},
    "token": {"energy": "energy_j_per_token",
              "cost": "cost_usd_per_token",
              "goodput": "goodput_tokens_per_s"},
}

# objective model parameters: overridable per-spec via --scenario-param
# (scalar only — these are economic/reliability constants, not sweep axes)
PARAM_DEFAULTS: Dict[str, float] = {
    "energy_price_usd_per_kwh": 0.10,
    "pue": 1.3,                              # datacenter overhead factor
    "device_lifetime_s": 5 * 365.25 * 86400.0,   # 5y amortization
    "device_mtbf_s": 2.0e7,                  # per-device, ~231 days
    "ckpt_write_gbps": 1.0,                  # per-device checkpoint write
    "ckpt_read_gbps": 2.0,                   # per-device restore read
}


def split_objective_params(params) -> Tuple[Dict[str, float],
                                            Dict[str, object]]:
    """Split a scenario param dict into (objective params, rest).

    Mirrors ``traffic.split_params`` shape-wise but must run FIRST in
    ``ScenarioSpec.resolve`` so objective knobs never reach scenarios
    that take no params.  Only EXPLICITLY-provided objective params are
    returned (``Scenario.with_objectives`` merges `PARAM_DEFAULTS`
    later) — resolve() uses emptiness to decide whether the scenario
    needs customizing at all.  Objective params are model constants, not
    design axes — a comma-list value is rejected rather than silently
    making the economy a sweep dimension.
    """
    obj: Dict[str, float] = {}
    rest: Dict[str, object] = {}
    for k, v in dict(params or {}).items():
        if k in PARAM_DEFAULTS:
            if isinstance(v, (tuple, list)):
                raise ValueError(
                    f"objective param {k!r} cannot be a sweep axis "
                    f"(got {v!r}); objective params are scalar model "
                    f"constants")
            obj[k] = float(v)
        else:
            rest[k] = v
    return obj, rest


def resolve_names(names: Sequence[str], kind: str,
                  base: Sequence[str]) -> Tuple[str, ...]:
    """Resolve user objective names to canonical record field names.

    Accepts per-kind aliases ("energy", "cost", "goodput"), canonical
    registry names valid for ``kind``, and the scenario's own base
    objective field names (e.g. "ttft_p99_s", "devices").
    """
    alias = ALIASES.get(kind, {})
    out = []
    for raw in names:
        name = alias.get(raw, raw)
        if name in REGISTRY:
            o = REGISTRY[name]
            if o.kind is not None and o.kind != kind:
                raise ValueError(
                    f"objective {name!r} is per-{o.kind}; the scenario "
                    f"is per-{kind} (use the 'energy'/'cost'/'goodput' "
                    f"aliases to get the kind-matched variant)")
        elif name not in base:
            valid = sorted(set(alias)
                           | {n for n, o in REGISTRY.items()
                              if o.kind in (None, kind)} | set(base))
            raise ValueError(f"unknown objective {raw!r}; valid: "
                             f"{', '.join(valid)}")
        if name not in out:
            out.append(name)
    if not out:
        raise ValueError("empty objective list")
    return tuple(out)


def computation_order(names: Sequence[str]) -> Tuple[Objective, ...]:
    """Registry objectives among ``names`` plus their deps, deps-first."""
    order: list = []

    def visit(name: str) -> None:
        o = REGISTRY.get(name)
        if o is None or o in order:
            return
        for d in o.deps:
            visit(d)
        order.append(o)

    for n in names:
        visit(n)
    return tuple(order)


def direction(name: str) -> str:
    o = REGISTRY.get(name)
    return o.direction if o is not None else "min"


def canonical_signs(names: Sequence[str]) -> Tuple[float, ...]:
    """+1 for minimized objectives, -1 for maximized.

    Canonical objective space is all-minimizing: frontier folds and
    ``objective_values`` emit ``sign * value`` so Pareto dominance,
    lexsort skylines, and cooptimize's descent never branch on
    direction.
    """
    return tuple(-1.0 if direction(n) == "max" else 1.0 for n in names)


def evaluate(xp, objs: Sequence[Objective], ctx: Dict[str, object]
             ) -> Dict[str, object]:
    """Evaluate registry objectives in dependency order.

    Each result is fed back into ``ctx`` so dependents (cost reads
    energy) see it; returns {name: value} for exactly ``objs``.
    """
    out: Dict[str, object] = {}
    for o in objs:
        v = o.fold(xp, ctx)
        ctx[o.name] = v
        out[o.name] = v
    return out
