"""Cross-stack co-optimization engine — sweep -> refine (paper §7-§9).

The PyTorch port of ``repro.core.cooptimize``.  The sweep engine
(`repro_torch.core.sweeprunner`) brute-forces the *discrete*
cross-product (arch x mesh x tech node x strategy x budget scale); its
Pareto frontier is only as good as the grid.  This module takes the
frontier of a checkpointed sweep and runs **batched gradient-based
refinement** around each frontier point, jointly over

  (a) continuous technology knobs — a DVFS operating voltage
      (`techlib.freq_at_voltage`, alpha-power-law frequency, V^2 dynamic
      energy) and HBM bandwidth / capacity scaling,
  (b) the hardware budget vector W = {A_i, P_i, R_i}, advanced by the
      SOE's eq.-6 update (`soe.eq6_update`), and
  (c) the discrete parallelism-strategy / mesh-shape axis, enumerated in
      an outer loop whose candidates are ranked from the sweep's own
      records (zero re-evaluation of already-scored points).

The joint parameter vector is theta = [W (17) | u (3)] where u holds the
knobs normalized to [0, 1]; one step evaluates all S starts with a
``torch.func.vmap`` of ``torch.func.grad_and_value``, applies eq. 6 to the
budget block and a clipped EMA step to the knob block, and a
power-feasibility penalty couples the two (overclocking the core or
widening HBM must be paid for out of the power simplex's headroom).  A
refined point is re-scored through the standard discrete path — AGE with
floors, the DVFS voltage clamped to the power budget via
`techlib.solve_voltage_for_power` — and streamed in the sweep's JSONL
record schema, so `sweeprunner.pareto_records`, `to_csv` and either
package's readers compose unchanged.  Everything runs on the device the
caller names, the card unless it asks for ``"cpu"``; the starts are the
reference's numpy stream.

CLI: ``python -m repro_torch.pathfind cooptimize --from <sweep-out-dir>``
(a directory written by either package's runner).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import age as age_lib
from repro_torch.core import pathfinder, scenarios, simulate, soe, \
    sweeprunner, techlib
from repro_torch.core.age import Budgets, COMPONENTS
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.sweepexec import json_safe
from repro_torch.core.sweeprunner import SweepSpec
from repro_torch.core.techlib import TechConfig, dynamic_energy_scale, \
    freq_at_voltage, solve_voltage_for_power
from repro_torch.core.tensors import F32, clip, div, maximum

BUDGET_DIM = soe._DIM                   # 17: {A_i, P_i, R_i}
KNOBS = ("voltage", "hbm_bw_scale", "hbm_cap_scale")
KNOB_DIM = len(KNOBS)
THETA_DIM = BUDGET_DIM + KNOB_DIM

_PF_CORE = COMPONENTS.index("core")     # power-frac offsets into W
_PF_DRAM = COMPONENTS.index("dram")


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Knobs of the sweep->refine pipeline (defaults fit one CLI run)."""

    top_k: int = 4                  # frontier seeds to refine
    candidates_per_seed: int = 2    # discrete (mesh, strategy) peers each
    steps: int = 24                 # GD steps (T)
    starts: int = 4                 # multi-start batch (S)
    lr: float = 0.05
    beta: float = 0.7               # eq.-6 EMA discount
    seed: int = 0
    min_frac: float = 1e-3          # budget simplex floor
    scale_lo: float = 0.5           # HBM bw/capacity scaling bounds
    scale_hi: float = 2.0
    power_penalty: float = 25.0     # objective multiplier per unit excess


@dataclasses.dataclass
class RefineStats:
    """What one `refine_sweep` call did."""

    scenario: str
    n_records: int                  # sweep records loaded (scored points)
    n_frontier: int                 # sweep Pareto-frontier size
    n_seeds: int                    # frontier points refined
    n_candidates: int               # discrete candidates refined in total
    n_refined: int                  # refined records emitted
    n_unimproved: int               # candidates where GD never beat theta0
    n_dominating: int               # refined records dominating >=1 seed
    n_objective_evals: int          # continuous-objective evaluations
    elapsed_s: float
    out_path: Optional[str]
    records: List[Dict]             # the refined records, stream order
    frontier: List[Dict]            # the sweep frontier records used


# ---------------------------------------------------------------------------
# Technology knobs (continuous, differentiable)
# ---------------------------------------------------------------------------


def knob_bounds(tech: TechConfig, cfg: RefineConfig
                ) -> Tuple[Tuple[float, float], ...]:
    """Physical (lo, hi) per knob, ordered like KNOBS."""
    c = tech.compute
    return ((c.minimum_voltage, c.maximum_voltage),
            (cfg.scale_lo, cfg.scale_hi),
            (cfg.scale_lo, cfg.scale_hi))


def knobs_from_unit(u, tech: TechConfig, cfg: RefineConfig):
    """Map the normalized knob block u in [0,1]^3 to physical values."""
    bounds = knob_bounds(tech, cfg)
    return tuple(lo + u[i] * (hi - lo)
                 for i, (lo, hi) in enumerate(bounds))


def unit_from_knobs(vals: Sequence[float], tech: TechConfig,
                    cfg: RefineConfig) -> np.ndarray:
    bounds = knob_bounds(tech, cfg)
    return np.asarray([(v - lo) / max(hi - lo, 1e-9)
                       for v, (lo, hi) in zip(vals, bounds)],
                      dtype=np.float32)


def nominal_knobs(tech: TechConfig) -> Tuple[float, float, float]:
    """The identity operating point: nominal voltage, unscaled HBM."""
    return (tech.compute.nominal_voltage, 1.0, 1.0)


def apply_tech_knobs(arch, tech: TechConfig, voltage, hbm_bw_scale,
                     hbm_cap_scale):
    """DVFS + HBM scaling on an AGE'd MicroArch (differentiable).

    The voltage knob moves the compute operating point along the
    alpha-power-law f(V) curve relative to nominal (`freq_at_voltage`);
    the HBM knobs scale main-memory bandwidth and capacity.  The embedded
    tech config's energy-per-flop is rescaled by the V^2 dynamic-energy
    law, so energy objectives (`pathfinder.hw_coeffs` reads
    ``arch.tech``) see the DVFS operating point.  With a tensor voltage
    that tech config holds a tensor: nothing keys a cache on it (the
    roofline's cache skips transformed leaves, and no skeleton key is
    built in the refinement).  At the nominal point (Vnom, 1, 1) this is
    the identity, so a refinement started there reproduces the seed.
    """
    c = tech.compute
    f_ratio = freq_at_voltage(voltage, c.nominal_voltage, 1.0,
                              c.threshold_voltage)
    e_scale = dynamic_energy_scale(voltage, c.nominal_voltage)
    tech_v = dataclasses.replace(tech, compute=dataclasses.replace(
        c, energy_per_flop=c.energy_per_flop * e_scale))
    return dataclasses.replace(
        arch,
        tech=tech_v,
        compute_throughput=arch.compute_throughput * f_ratio,
        core_frequency=arch.core_frequency * f_ratio,
        dram_bw=arch.dram_bw * hbm_bw_scale,
        dram_capacity=arch.dram_capacity * hbm_cap_scale)


def power_excess(w, tech: TechConfig, voltage, hbm_bw_scale, hbm_cap_scale):
    """Fraction of the node power budget the knobs overdraw
    (differentiable).

    Core dynamic power scales as V^2 * f(V) (`dynamic_energy_scale` x the
    alpha-power-law rate); HBM power is dominated by bandwidth with a
    static floor per stack.  The knobs may spend the power simplex's
    *unused* mass (1 - sum P_i) for free; anything beyond that is excess,
    which the refinement objective penalizes multiplicatively.
    """
    c = tech.compute
    f_ratio = freq_at_voltage(voltage, c.nominal_voltage, 1.0,
                              c.threshold_voltage)
    core_scale = dynamic_energy_scale(voltage, c.nominal_voltage) * f_ratio
    dram_scale = 0.8 * hbm_bw_scale + 0.2 * hbm_cap_scale
    pf = w[soe._NC:2 * soe._NC]
    headroom = maximum(1.0 - torch.sum(pf), 0.0)
    extra = (pf[_PF_CORE] * (core_scale - 1.0)
             + pf[_PF_DRAM] * (dram_scale - 1.0))
    return maximum(extra - headroom, 0.0)


def feasible_knobs(tech: TechConfig, budgets: Budgets, v_request: float,
                   s_bw: float, s_cap: float,
                   cfg: RefineConfig = RefineConfig()
                   ) -> Tuple[float, float, float]:
    """Clamp requested knobs to what the power budget affords.

    The knobs' only free funding is the power simplex's unused mass
    (1 - sum P_i).  The HBM overdraw (the same 0.8/0.2 split
    `power_excess` penalizes) gets first claim, with the *bandwidth*
    scale shrunk until it fits (capacity is usually the binding serving
    constraint, so it is sacrificed last); the remaining headroom caps the
    DVFS voltage via `techlib.solve_voltage_for_power`, the highest
    voltage whose relative core power fits.  Undervolting is always
    allowed; overclocking requires the budget vector to have granted real
    headroom.  Host floats throughout.
    """
    c = tech.compute
    pf = {k: float(v) for k, v in budgets.power_frac.items()}
    headroom = max(1.0 - sum(pf.values()), 0.0)
    pf_dram = pf.get("dram", 0.0)
    dram_over = pf_dram * (0.8 * s_bw + 0.2 * s_cap - 1.0)
    if dram_over > headroom and pf_dram > 0.0:
        s_bw = max((headroom / pf_dram + 1.0 - 0.2 * s_cap) / 0.8,
                   cfg.scale_lo)
        dram_over = pf_dram * (0.8 * s_bw + 0.2 * s_cap - 1.0)
    remaining = max(headroom - max(dram_over, 0.0), 0.0)
    share = pf.get("core", 0.0)
    if share <= 0.0:
        return c.nominal_voltage, float(s_bw), float(s_cap)
    allowed = (share + remaining) / share       # relative core power cap
    scale_at = lambda v: (dynamic_energy_scale(v, c.nominal_voltage)
                          * freq_at_voltage(v, c.nominal_voltage, 1.0,
                                            c.threshold_voltage))
    v_cap = solve_voltage_for_power(
        allowed, float(scale_at(c.maximum_voltage)), c.maximum_voltage,
        c.threshold_voltage, c.minimum_voltage)
    v = float(min(max(v_request, c.minimum_voltage), v_cap))
    return v, float(s_bw), float(s_cap)


def feasible_voltage(tech: TechConfig, budgets: Budgets,
                     v_request: float) -> float:
    """Voltage-only view of `feasible_knobs` (HBM at nominal scale)."""
    return feasible_knobs(tech, budgets, v_request, 1.0, 1.0)[0]


# ---------------------------------------------------------------------------
# Continuous refinement (budget block: eq. 6; knob block: clipped EMA GD)
# ---------------------------------------------------------------------------


def make_refine_objective(tech: TechConfig, like: Budgets,
                          scn: scenarios.Scenario,
                          dp: scenarios.DesignPoint, ppe: PPEConfig,
                          norms: Sequence[float], cfg: RefineConfig,
                          profile: Optional[Dict] = None):
    """f(theta) -> scalar: the differentiable cross-stack objective.

    Sums this scenario's continuous objectives, each normalized by the
    seed record's value (so multi-objective scenarios trade off at the
    seed's operating point), and multiplies in the power-excess penalty.
    ``profile`` (a calibration-profile dict embedded in the sweep spec)
    anchors every candidate MicroArch to measured efficiencies through
    the port's `calibrate.profiles`, so the refinement optimizes the
    calibrated model, not the nominal one.  The hardware is built on
    theta's device.
    """
    from repro_torch.calibrate import profiles as profiles_lib
    eps = scn.eval_points(dp)
    fold = scn.refine_objectives(dp)
    # abs(): canonical objective values are negative for max-direction
    # objectives (goodput) — the norm must stay a positive magnitude
    norms = [max(abs(float(n)), 1e-30) for n in norms]

    def f(theta):
        w = theta[:BUDGET_DIM]
        v, s_bw, s_cap = knobs_from_unit(theta[BUDGET_DIM:], tech, cfg)
        budgets = Budgets.from_vector(w, like)
        arch = age_lib.generate(tech, budgets, discrete=False)
        arch = apply_tech_knobs(arch, tech, v, s_bw, s_cap)
        if profile is not None:
            arch = profiles_lib.apply_profile(arch, profile)
        bds = [simulate.predict(arch, ep.graph, ep.strategy,
                                system=ep.system, cfg=ppe,
                                pod_bw=ep.pod_bw) for ep in eps]
        objs = fold(bds, pathfinder.hw_ctx(arch))
        scalar = sum(div(o, n) for o, n in zip(objs, norms))
        pen = power_excess(w, tech, v, s_bw, s_cap)
        return scalar * (1.0 + cfg.power_penalty * pen)

    return f


def initial_thetas(tech: TechConfig, like: Budgets,
                   cfg: RefineConfig) -> np.ndarray:
    """(S, THETA_DIM) float32 start stack on the host: start 0 is the seed
    operating point (projected template budgets, nominal knobs); the rest
    pair projected Dirichlet budget draws with uniform knob positions."""
    def project(w):
        return soe._project_simplexes(torch.as_tensor(w, dtype=F32),
                                      cfg.min_frac).numpy()

    rng = np.random.default_rng(cfg.seed)
    u0 = unit_from_knobs(nominal_knobs(tech), tech, cfg)
    w0 = project(like.as_vector("cpu").numpy())
    rows = [np.concatenate([w0, u0])]
    nc, nper = soe._NC, soe._NP
    for _ in range(1, max(cfg.starts, 1)):
        draw = np.concatenate(
            [rng.dirichlet(np.ones(nc)), rng.dirichlet(np.ones(nc)),
             rng.dirichlet(np.ones(nper))]).astype(np.float32)
        # blend toward the seed budgets: a raw Dirichlet draw routinely
        # starves some component to ~0 and lands on an inf/NaN objective,
        # wasting the start for the whole descent
        w = project(0.5 * w0 + 0.5 * draw)
        u = np.clip(u0 + rng.uniform(-0.25, 0.25, KNOB_DIM), 0.0,
                    1.0).astype(np.float32)
        rows.append(np.concatenate([w, u]))
    return np.stack(rows)


def refine_theta(objective, theta0s: np.ndarray, cfg: RefineConfig,
                 device=None) -> Tuple[np.ndarray, float, int]:
    """Batched multi-start descent on theta; returns (best theta, best
    value, #objective evaluations).

    Every start advances in one step: vmapped value and gradient, the
    shared eq.-6 update (`soe.eq6_update`) on the budget block, and a
    normalized-gradient EMA step clipped to [0,1] on the knob block, on
    ``device`` (the card unless the caller asks for ``"cpu"``).  Start 0
    is evaluated before any update, so the returned best is never worse
    than the seed operating point.
    """
    W = torch.as_tensor(np.asarray(theta0s, dtype=np.float32),
                        device=resolve_device(device))   # (S, THETA_DIM)
    S = W.shape[0]
    vg = torch.func.vmap(torch.func.grad_and_value(objective))
    proj_w = functools.partial(soe._project_simplexes,
                               min_frac=cfg.min_frac)
    B, lr, beta = BUDGET_DIM, cfg.lr, cfg.beta

    def step(W, M, done, last):
        G, vals = vg(W)
        Ww, Mw = soe.eq6_update(W[:, :B], M[:, :B], G[:, :B], lr, beta,
                                proj_w)
        Gu = G[:, B:]
        gn = torch.linalg.vector_norm(Gu, dim=1, keepdim=True)
        Gu = torch.where(gn > 0, Gu / (gn + 1e-12), Gu)
        Mu = beta * M[:, B:] + (1.0 - beta) * (W[:, B:] - lr * Gu)
        W_proj = torch.cat([Ww, clip(Mu, 0.0, 1.0)], dim=1)
        M_new = torch.cat([Mw, Mu], dim=1)
        conv = torch.abs(last - vals) < 1e-7 * maximum(vals, 1e-12)
        frozen = done[:, None]
        return (torch.where(frozen, W, W_proj),
                torch.where(frozen, M, M_new), done | conv, vals)

    M = W
    done = torch.zeros(S, dtype=torch.bool, device=W.device)
    last = torch.full((S,), math.inf, dtype=F32, device=W.device)
    done_np = np.zeros(S, dtype=bool)
    best_theta, best_val = soe._host(W[0]), math.inf
    n_evals = 0
    for _ in range(cfg.steps):
        if bool(np.all(done_np)):
            break
        n_evals += S
        W_before = W
        W, M, done, vals = step(W, M, done, last)
        # values and the done mask cross to the host in one copy
        host = soe._host(torch.stack([vals.to(torch.float64),
                                      done.to(torch.float64)]))
        vals_np, done_np = host[0], host[1] > 0
        # nan-safe argmin (a diverged start must not blind best tracking)
        finite = np.where(np.isfinite(vals_np), vals_np, np.inf)
        i = int(np.argmin(finite))
        if finite[i] < best_val:
            best_val, best_theta = float(finite[i]), soe._host(W_before[i])
        last = vals
    return best_theta, best_val, n_evals


# ---------------------------------------------------------------------------
# Discrete realization + record schema
# ---------------------------------------------------------------------------


def realize_theta(tech: TechConfig, like: Budgets, theta: np.ndarray,
                  cfg: RefineConfig, profile: Optional[Dict] = None,
                  device=None):
    """Re-materialize a refined theta as concrete hardware on ``device``:
    discrete AGE (floors applied) + the knob transform, with the knobs
    jointly clamped to the power budget via `feasible_knobs`.  Returns
    (MicroArch, Budgets, knob dict).  ``profile`` applies the same
    calibration the continuous objective optimized, so re-scoring stays
    consistent."""
    from repro_torch.calibrate import profiles as profiles_lib
    w = np.asarray(theta[:BUDGET_DIM], dtype=np.float64)
    budgets = Budgets.from_vector(w, like)
    v_req, s_bw, s_cap = knobs_from_unit(theta[BUDGET_DIM:], tech, cfg)
    v, s_bw, s_cap = feasible_knobs(tech, budgets, float(v_req),
                                    float(s_bw), float(s_cap), cfg)
    arch = age_lib.generate(tech, budgets, discrete=True, device=device)
    arch = apply_tech_knobs(arch, tech, v, float(s_bw), float(s_cap))
    if profile is not None:
        arch = profiles_lib.apply_profile(arch, profile)
    knobs = {"voltage": float(v), "hbm_bw_scale": float(s_bw),
             "hbm_cap_scale": float(s_cap)}
    return arch, budgets, knobs


def _budget_fields(budgets: Budgets) -> Dict[str, Dict[str, float]]:
    rnd = lambda d: {k: round(float(v), 5) for k, v in d.items()}
    return {"area_frac": rnd(budgets.area_frac),
            "power_frac": rnd(budgets.power_frac),
            "perim_frac": rnd(budgets.perim_frac)}


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a Pareto-dominates b: <= on every objective, < on at least one
    (ties on all objectives dominate neither way)."""
    return all(x <= y for x, y in zip(a, b)) \
        and any(x < y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The sweep -> refine pipeline
# ---------------------------------------------------------------------------


def _candidate_rank(scn: scenarios.Scenario, seed_vals):
    """Sort key: objectives normalized by the seed's values, summed.

    Values are canonical (max-direction objectives already negated), so
    smaller is uniformly better; the seed norm is an absolute magnitude.
    """
    def key(rec):
        vs = scn.objective_values(rec)
        return sum(v / max(abs(s), 1e-30) for v, s in zip(vs, seed_vals))
    return key


def refine_sweep(src: Union[str, Tuple[SweepSpec, List[Dict]]],
                 cfg: RefineConfig = RefineConfig(),
                 out_path: Optional[str] = None,
                 verbose: bool = False, device=None) -> RefineStats:
    """Refine the Pareto frontier of a (checkpointed) sweep on ``device``
    (the card unless the caller asks for ``"cpu"``).

    ``src`` is either a sweep out-dir written by either package's runner
    (spec + finished-chunk records are loaded via `sweeprunner.load_sweep`;
    refined records stream to ``DIR/refined.jsonl`` unless ``out_path``
    overrides) or an in-memory ``(spec, records)`` pair.  Already-scored
    sweep points are never re-evaluated: frontier seeds and their discrete
    (mesh, strategy) candidates are selected and ranked purely from the
    loaded records, the continuous search only evaluates novel theta
    points, and a candidate whose descent never left the seed operating
    point is reported as unimproved instead of being re-scored.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if isinstance(src, str):
        spec, records = sweeprunner.load_sweep(src)
        if out_path is None:
            out_path = os.path.join(src, "refined.jsonl")
    else:
        spec, records = src
    # objectives/SLO walls are variant-independent, so any variant of the
    # spec's ScenarioSpec works for frontier filtering; per-candidate
    # scoring below re-resolves the exact variant from each record's cell
    scn = spec.scenario_spec.variants()[0].resolve()
    frontier = sweeprunner.pareto_records(records, scn.objectives)
    seeds = sorted(frontier, key=lambda r: scn.objective_values(r))
    seeds = seeds[:max(cfg.top_k, 0)]
    ppe = sweeprunner.spec_ppe(spec)
    seed_vals = [scn.objective_values(r) for r in frontier]

    out_fh = None
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        out_fh = open(out_path, "w")

    refined: List[Dict] = []
    n_candidates = n_unimproved = n_dominating = n_evals = 0
    tried: set = set()
    try:
        for seed in seeds:
            sv = scn.objective_values(seed)
            peers = [r for r in records
                     if all(r.get(f) == seed.get(f) for f in
                            ("arch", "cell", "logic", "hbm", "net", "scale"))
                     and scn.objective_values(r) is not None]
            peers.sort(key=_candidate_rank(scn, sv))
            for ci, cand in enumerate(peers[:max(cfg.candidates_per_seed,
                                                 1)]):
                if cand["key"] in tried:
                    continue
                tried.add(cand["key"])
                n_candidates += 1
                lb = sweeprunner.label_from_record(cand)
                scn_pt = sweeprunner.scenario_for(spec, lb.cell)
                dp = sweeprunner.resolve_label(spec, lb, dev)
                tech = techlib.make_tech_config(lb.logic, lb.hbm, lb.net)
                like = spec.budgets(lb.scale)
                norms = [float(cand[f])
                         for f in scn_pt.refine_objective_fields]
                f = make_refine_objective(tech, like, scn_pt, dp, ppe,
                                          norms, cfg,
                                          profile=spec.profile)
                theta0s = initial_thetas(tech, like, cfg)
                theta, val, evals = refine_theta(f, theta0s, cfg,
                                                 device=dev)
                n_evals += evals
                if np.array_equal(theta, theta0s[0]):
                    # descent never beat the seed operating point: the
                    # seed record already covers it — re-scoring would
                    # re-evaluate an already-scored sweep point
                    n_unimproved += 1
                    continue
                arch, budgets, knobs = realize_theta(
                    tech, like, theta, cfg, profile=spec.profile,
                    device=dev)
                dp_r = dataclasses.replace(dp, hw=arch)
                rows = pathfinder.evaluate(
                    points=scn_pt.eval_points(dp_r), ppe=ppe)
                rec = scn_pt.record(dp_r, rows)
                rec["key"] = dp_r.key() + f"#refined{len(refined)}"
                rec["seed_key"] = seed["key"]
                rec["candidate_key"] = cand["key"]
                rec["refined"] = True
                rec["knobs"] = knobs
                rec["budgets"] = _budget_fields(budgets)
                rec["refine_objective"] = float(val)
                rv = scn.objective_values(rec)
                rec["dominates_seed"] = bool(
                    rv is not None
                    and any(dominates(rv, s) for s in seed_vals if s))
                if rec["dominates_seed"]:
                    n_dominating += 1
                refined.append(rec)
                if out_fh is not None:
                    out_fh.write(json.dumps(json_safe(rec)) + "\n")
                    out_fh.flush()
                if verbose:
                    print(f"# refined {cand['key']} -> "
                          f"{rec['key']}: objective {val:.4g} "
                          f"(dominates_seed={rec['dominates_seed']})",
                          flush=True)
    finally:
        if out_fh is not None:
            out_fh.close()

    return RefineStats(
        scenario=scn.name, n_records=len(records),
        n_frontier=len(frontier), n_seeds=len(seeds),
        n_candidates=n_candidates, n_refined=len(refined),
        n_unimproved=n_unimproved, n_dominating=n_dominating,
        n_objective_evals=n_evals, elapsed_s=time.perf_counter() - t0,
        out_path=out_path, records=refined, frontier=frontier)
