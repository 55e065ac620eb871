"""Traffic-driven serving: arrival processes, continuous batching, SLOs.

A copy of the reference's ``repro.core.traffic``; only this paragraph and
the shape-cell import differ.  The port calls the ``xp``-generic functions
with ``xp=numpy`` (records, metrics folds) and with ``xp=tensors.XP``
(the scenarios' differentiable refine folds): a namespace over torch whose
functions take what ``jax.numpy``'s take (``torch.maximum`` takes no
Python float, and ``torch.max(x, axis=0)`` returns a pair).

The static serving scenario scores one resident batch per design — a
per-device metric.  Capacity planning needs the *system* question: given a
request arrival process (QPS, prompt/output length distributions) and a
continuous-batching server (JetStream-style prefill -> insert-into-slot ->
generate), what are the TTFT/TPOT *percentiles*, and how many devices does
it take to serve X QPS inside an SLO?  This module holds the analytic
occupancy model that answers both, layered on the same prefill/decode phase
costs `simulate.serving_breakdown` uses.

Model (documented here once; every consumer shares `continuous_batching_stats`):

  * Requests arrive Poisson at ``qps``; prompt and output lengths are
    lognormal with configured mean and coefficient of variation (cv=0 means
    deterministic).
  * The decode engine steps ``slots`` sequences at once (the decode cell's
    global batch); each step costs the capacity-derated decode-step time
    ``t_d``.  Prefill work is *chunked* into ``prefill_chunk``-token pieces
    that ride along decode steps (chunked prefill), each stretching its
    carrier step by ``t_chunk = prefill_chunk * t_prefill / prefill_tokens``.
  * With chunk arrival rate ``lam_c = qps * chunks_per_req`` the mean step
    time has the closed form ``t_step = t_d / (1 - lam_c * t_chunk)`` and
    the maximum sustainable arrival rate is::

        qps_max = slots / ((chunks_per_req + output_mean) * t_d
                           + slots * chunks_per_req * t_chunk)

    ``util = qps / qps_max`` is the Erlang utilization; ``util >= 1`` is the
    feasibility wall.
  * A request holds a slot for ``(chunks_per_req + output_len)`` steps; slot
    contention is approximated as an M/M/c queue: the Erlang-C waiting
    probability plus an exponential tail give closed-form queue-wait
    percentiles.  TTFT percentiles add the prompt's own chunked-prefill
    completion at the matching prompt-length percentile (quantiles combined
    additively — a standard conservative approximation).
  * TPOT percentiles come from the two-point step-time mixture: a fraction
    ``f = lam_c * t_d / (1 - lam_c * t_chunk)`` of steps carry a prefill
    chunk (cost ``t_d + t_chunk``), the rest cost ``t_d``.

Everything downstream of the two phase costs is arithmetic in the array
module ``xp`` (NumPy or jax.numpy), so the scalar record path, the
pipelined executor's vectorized fold, and the jit/vmap-traced frontier fold
share one op-for-op implementation — the parity and traceability contracts
fall out by construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# percentiles reported for TTFT / TPOT; field names use pXX suffixes
PERCENTILES: Tuple[float, ...] = (0.50, 0.99)
PCT_NAMES: Tuple[str, ...] = tuple(f"p{int(round(p * 100))}"
                                   for p in PERCENTILES)

_EPS = 1e-12


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Max abs error ~1.15e-9 — far below the fidelity of the queueing
    approximations consuming it; avoids a scipy dependency.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"percentile must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                 + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r
                                 + b[3]) * r + b[4]) * r + 1)


def lognormal_quantile(mean: float, cv: float, p: float) -> float:
    """Quantile of a lognormal given its mean and coefficient of variation.

    cv == 0 degenerates to the deterministic distribution (quantile = mean).
    """
    if mean <= 0:
        raise ValueError(f"length mean must be positive, got {mean}")
    if cv <= 0:
        return float(mean)
    s2 = math.log1p(cv * cv)
    mu = math.log(mean) - 0.5 * s2
    return float(math.exp(mu + math.sqrt(s2) * _norm_ppf(p)))


# ---------------------------------------------------------------------------
# Typed traffic / batching-policy parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Request arrival process: Poisson QPS + lognormal length mixes."""

    qps: float = 8.0                # request arrivals per second (Poisson)
    prompt_mean: float = 2048.0     # mean prompt tokens
    prompt_cv: float = 1.0          # prompt-length coefficient of variation
    output_mean: float = 256.0      # mean generated tokens
    output_cv: float = 1.0          # output-length coefficient of variation

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "TrafficModel":
        return cls(**{f.name: float(d[f.name]) for f in
                      dataclasses.fields(cls) if f.name in d})


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """Continuous-batching server policy knobs (the sweepable axes)."""

    prefill_chunk: float = 512.0    # tokens per interleaved prefill chunk

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "BatchingPolicy":
        return cls(**{f.name: float(d[f.name]) for f in
                      dataclasses.fields(cls) if f.name in d})


# parameter names ScenarioSpec accepts for the traffic scenario, with
# defaults — SLO walls default to None (= no wall)
PARAM_DEFAULTS: Dict[str, Optional[float]] = {
    **TrafficModel().to_dict(), **BatchingPolicy().to_dict(),
    "slo_ttft_p50": None, "slo_ttft_p99": None,
    "slo_tpot_p50": None, "slo_tpot_p99": None,
}
SLO_KEYS: Tuple[str, ...] = ("slo_ttft_p50", "slo_ttft_p99",
                             "slo_tpot_p50", "slo_tpot_p99")


def split_params(params: Mapping) -> Tuple[TrafficModel, BatchingPolicy,
                                           Dict[str, float]]:
    """(traffic, policy, slo walls) from one flat ScenarioSpec param dict."""
    unknown = set(params) - set(PARAM_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown traffic scenario params {sorted(unknown)}; "
                       f"known: {sorted(PARAM_DEFAULTS)}")
    slo = {k[len("slo_"):]: float(params[k]) for k in SLO_KEYS
           if params.get(k) is not None}
    return (TrafficModel.from_dict(params), BatchingPolicy.from_dict(params),
            slo)


# ---------------------------------------------------------------------------
# The analytic continuous-batching model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeConsts:
    """Per-design host constants for `continuous_batching_stats`.

    Everything here is independent of the hardware vector, so folds can
    close over one instance and trace only the two phase-cost inputs.
    """

    qps: float                      # arrival rate (requests/s)
    slots: int                      # decode batch slots (decode cell batch)
    prefill_tokens: float           # tokens scored by the prefill graph
    chunk: float                    # prefill chunk size (tokens)
    chunks_per_req: float           # E[prompt]/chunk + 1 (ceil bound)
    output_mean: float              # E[output tokens]
    prompt_q: Tuple[float, ...]     # prompt-length quantiles @ PERCENTILES
    lgamma: Tuple[float, ...]       # log(k!) for k = 0..slots
    devices: float                  # devices per replica (for cost fields)


def build_consts(traffic: TrafficModel, policy: BatchingPolicy, *,
                 slots: int, prefill_tokens: float,
                 devices: float) -> ServeConsts:
    chunk = max(float(policy.prefill_chunk), 1.0)
    return ServeConsts(
        qps=float(traffic.qps), slots=int(slots),
        prefill_tokens=max(float(prefill_tokens), 1.0), chunk=chunk,
        chunks_per_req=float(traffic.prompt_mean) / chunk + 1.0,
        output_mean=max(float(traffic.output_mean), 1.0),
        prompt_q=tuple(lognormal_quantile(traffic.prompt_mean,
                                          traffic.prompt_cv, p)
                       for p in PERCENTILES),
        lgamma=tuple(math.lgamma(k + 1) for k in range(int(slots) + 1)),
        devices=float(devices))


def _erlang_c_log_pwait(xp, log_a, rho, c: ServeConsts):
    """log P(wait) of an M/M/c queue via a log-space Erlang-C sum.

    ``slots`` is a static Python int, so the k-sum unrolls at trace time
    (<= a few hundred fused scalar ops under vmap — negligible next to the
    graph evaluation itself).
    """
    B = c.slots
    wait_t = B * log_a - c.lgamma[B] - xp.log(1.0 - rho)
    terms = [k * log_a - c.lgamma[k] for k in range(B)] + [wait_t]
    lt = xp.stack(terms)
    m = xp.max(lt, axis=0)
    lse = m + xp.log(xp.sum(xp.exp(lt - m), axis=0))
    return wait_t - lse


def continuous_batching_stats(xp, t_prefill_s, t_decode_step_s,
                              c: ServeConsts,
                              mask_infeasible: bool = True
                              ) -> Dict[str, object]:
    """All traffic metrics from the two phase costs, in array module `xp`.

    ``t_prefill_s`` is the prefill-graph batch time (``prefill_tokens``
    tokens), ``t_decode_step_s`` the capacity-derated decode-step time.
    Both may be arrays (vectorized fold), 0-d np scalars (record path), or
    traced jnp values (frontier/refine folds) — the arithmetic is
    identical, which is what makes record/metrics_fold parity and
    frontier-fold traceability hold by construction.  Infeasible inputs
    (non-finite costs or ``util >= 1``) are computed on clamped values and
    masked out at the end; ``mask_infeasible=False`` skips the masking and
    returns the smooth clamped values instead (for gradient-based
    refinement, which adds its own soft barrier on ``util``).
    """
    finite = xp.isfinite(t_prefill_s) & xp.isfinite(t_decode_step_s)
    t_pf = xp.where(finite, t_prefill_s, 1.0)
    t_d = xp.where(finite, t_decode_step_s, 1.0)

    c_tok = t_pf / c.prefill_tokens              # prefill seconds per token
    t_chunk = c.chunk * c_tok                    # one interleaved chunk
    lam_c = c.qps * c.chunks_per_req             # chunk arrivals per second
    m_steps = c.chunks_per_req + c.output_mean   # slot-holding steps/request

    qps_max = c.slots / (m_steps * t_d
                         + c.slots * c.chunks_per_req * t_chunk)
    util = c.qps / qps_max
    feasible = finite & (util < 1.0)

    # clamped copies keep the queue math finite on infeasible points; the
    # final where() masks them to inf/0 anyway
    rho = xp.minimum(util, 1.0 - 1e-9)
    t_step = t_d / xp.maximum(1.0 - lam_c * t_chunk, _EPS)
    s_mean = m_steps * t_step                    # mean slot-holding time
    frac_chunk = xp.clip(lam_c * t_step, 0.0, 1.0)   # steps carrying a chunk

    log_a = xp.log(xp.maximum(rho * c.slots, _EPS))
    log_pw = _erlang_c_log_pwait(xp, log_a, rho, c)
    wait_scale = s_mean / (c.slots * (1.0 - rho))

    out: Dict[str, object] = {}
    for p, nm, lq in zip(PERCENTILES, PCT_NAMES, c.prompt_q):
        wait_q = wait_scale * xp.maximum(log_pw - math.log(1.0 - p), 0.0)
        own_prefill = (lq / c.chunk + 1.0) * t_step
        ttft = wait_q + own_prefill
        tpot = xp.where(frac_chunk > 1.0 - p, t_d + t_chunk, t_d)
        if mask_infeasible:
            ttft = xp.where(feasible, ttft, xp.inf)
            tpot = xp.where(feasible, tpot, xp.inf)
        out[f"ttft_{nm}_s"] = ttft
        out[f"tpot_{nm}_s"] = tpot

    goodput = c.qps * c.output_mean              # output tokens/s served
    out["util"] = util
    out["qps_max"] = xp.where(finite, qps_max, 0.0)
    served = xp.where(feasible, goodput, 0.0) if mask_infeasible \
        else goodput * xp.ones_like(util)
    out["tokens_per_s"] = served
    out["tokens_per_s_per_device"] = served / max(c.devices, 1.0)
    # device-seconds per output token *at capacity* — the fleet-sizing cost
    cost = c.devices / xp.maximum(qps_max * c.output_mean, _EPS)
    out["cost_device_s_per_token"] = xp.where(feasible, cost, xp.inf) \
        if mask_infeasible else cost
    out["feasible"] = feasible
    return out


def slo_ok(stats: Mapping, slo: Mapping[str, float], xp=np):
    """Elementwise SLO-wall check: True where every configured percentile
    wall holds (``slo`` keys like ``"ttft_p99"`` in seconds).  Infeasible
    points carry inf percentiles and therefore fail every wall."""
    ok = stats["feasible"]
    for key, wall in slo.items():
        ok = ok & (stats[f"{key}_s"] <= wall)
    return ok


# ---------------------------------------------------------------------------
# Scenario-variant suffix codec (batching-policy sweep axes)
# ---------------------------------------------------------------------------
#
# Swept scenario params ride inside the cell-id string as a "@k=v,..."
# suffix, so `point_key`, chunk hashes, and checkpoint resume all work
# unchanged.  The codec lives here (pure string <-> floats) and is shared
# by scenarios.ScenarioSpec and the fleet-sizing query.


def encode_variant(cell_id: str, overrides: Mapping[str, float]) -> str:
    if not overrides:
        return cell_id
    body = ",".join(f"{k}={float(v):g}" for k, v in sorted(overrides.items()))
    return f"{cell_id}@{body}"


def decode_variant(cell_id: str) -> Tuple[str, Dict[str, float]]:
    base, _, body = cell_id.partition("@")
    if not body:
        return base, {}
    out: Dict[str, float] = {}
    for item in body.split(","):
        k, _, v = item.partition("=")
        if not _ or not k:
            raise ValueError(f"malformed scenario-variant suffix in "
                             f"cell id {cell_id!r}")
        out[k] = float(v)
    return base, out


# ---------------------------------------------------------------------------
# Inverse query: minimum fleet size serving X QPS inside the SLOs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetCandidate:
    """One swept design's answer to the sizing query."""

    key: str
    replicas: int                   # replicas of the swept configuration
    devices_per_replica: int
    devices: int                    # replicas * devices_per_replica
    per_replica_qps: float
    metrics: Dict[str, float]       # traffic stats at the chosen size
    rank_value: Optional[float] = None  # objective column under rank_by


# objective-record column behind each `size_fleet(rank_by=...)` choice;
# None = the default total-device-count ranking (no column needed)
RANK_COLUMNS: Dict[str, Optional[str]] = {
    "devices": None,
    "cost_per_token": "cost_usd_per_token",
    "energy_per_token": "energy_j_per_token",
}


@dataclasses.dataclass
class FleetPlan:
    qps: float
    slo: Dict[str, float]
    best: Optional[FleetCandidate]
    candidates: List[FleetCandidate]     # feasible, sorted by devices
    n_records: int
    n_sized: int                    # records that could meet the SLOs
    n_unsizeable: int               # designs no replica count can save
    n_evals: int                    # closed-form model evaluations spent


def _record_consts(rec: Mapping, traffic: TrafficModel,
                   policy: BatchingPolicy, qps: float) -> ServeConsts:
    """Per-record ServeConsts: cell shapes + any swept-variant overrides
    carried in the record's cell id."""
    from repro_torch.configs.base import SHAPE_CELLS
    base, over = decode_variant(str(rec["cell"]))
    cells = base.split("+")
    if len(cells) != 2:
        raise ValueError(f"fleet sizing needs a prefill+decode record, "
                         f"got cell {rec['cell']!r}")
    tr = dataclasses.replace(
        traffic, qps=qps,
        **{k: v for k, v in over.items()
           if k in {f.name for f in dataclasses.fields(TrafficModel)}
           and k != "qps"})
    po = BatchingPolicy.from_dict({**policy.to_dict(),
                                   **{k: v for k, v in over.items()
                                      if k in policy.to_dict()}})
    pc, dc = SHAPE_CELLS[cells[0]], SHAPE_CELLS[cells[1]]
    return build_consts(tr, po, slots=dc.global_batch,
                        prefill_tokens=float(pc.global_batch) * pc.seq_len,
                        devices=float(rec["devices"]))


def _meets(t_pf: float, t_d: float, c: ServeConsts,
           slo: Mapping[str, float]):
    st = continuous_batching_stats(np, np.float64(t_pf), np.float64(t_d), c)
    ok = bool(np.asarray(slo_ok(st, slo)))
    return ok, {k: (bool(v) if k == "feasible" else float(np.asarray(v)))
                for k, v in st.items()}


def size_fleet(records: Sequence[Mapping], qps: float, *,
               slo: Mapping[str, float],
               traffic: TrafficModel = TrafficModel(),
               policy: BatchingPolicy = BatchingPolicy(),
               top_k: int = 5, max_replicas: int = 1 << 20,
               rank_by: str = "devices") -> FleetPlan:
    """Minimum device count serving ``qps`` under percentile SLO walls.

    For each swept record carrying its phase costs (``prefill_s``,
    capacity-derated ``decode_step_s``), the offered load is split across
    ``n`` identical replicas (per-replica arrival rate ``qps / n``) and the
    closed-form model decides SLO attainment.  Every traffic metric
    improves monotonically as per-replica load drops, so the minimal
    feasible ``n`` is found by doubling + bisection — no sweep point is
    ever re-evaluated.  Designs whose zero-load limit already violates an
    SLO can never be saved by adding replicas and are skipped.

    ``rank_by`` picks the best/candidate ordering: ``devices`` (default,
    total fleet size) or a per-token objective column the sweep carried —
    ``cost_per_token`` ($/token, `cost_usd_per_token`) /
    ``energy_per_token`` (J/token, `energy_j_per_token`), both from a
    sweep run with ``--objectives cost,energy``.  Ranking reads the
    already-streamed objective columns — zero re-evaluation either way;
    candidates missing the column sort last, and a record set carrying
    the column nowhere raises (the sweep was run without the objective).
    """
    slo = dict(slo)
    bad = set(slo) - {k[len("slo_"):] for k in SLO_KEYS}
    if bad:
        raise KeyError(f"unknown SLO keys {sorted(bad)}")
    if rank_by not in RANK_COLUMNS:
        raise ValueError(f"unknown rank_by {rank_by!r}; choose from "
                         f"{sorted(RANK_COLUMNS)}")
    rank_col = RANK_COLUMNS[rank_by]
    if rank_col is not None:
        sized = [r for r in records
                 if "prefill_s" in r and "decode_step_s" in r]
        if sized and not any(r.get(rank_col) is not None for r in sized):
            raise ValueError(
                f"rank_by={rank_by!r} needs the {rank_col!r} objective "
                f"column, which no record carries; rerun the sweep with "
                f"--objectives energy,cost")
    cands: List[FleetCandidate] = []
    n_evals = n_unsizeable = 0
    seen = 0
    for rec in records:
        if "prefill_s" not in rec or "decode_step_s" not in rec:
            continue                    # not a traffic-scenario record
        seen += 1
        t_pf, t_d = rec["prefill_s"], rec["decode_step_s"]
        if t_pf is None or t_d is None or \
                not (math.isfinite(float(t_pf))
                     and math.isfinite(float(t_d))):
            n_unsizeable += 1           # capacity-infeasible design
            continue
        t_pf, t_d = float(t_pf), float(t_d)
        c1 = _record_consts(rec, traffic, policy, qps)
        # zero-load limit: lam_c -> 0, wait -> 0; unreachable SLOs fail here
        c0 = dataclasses.replace(c1, qps=min(qps * 1e-9, 1e-9))
        ok0, _ = _meets(t_pf, t_d, c0, slo)
        n_evals += 1
        if not ok0:
            n_unsizeable += 1
            continue
        n = 1
        ok, st = _meets(t_pf, t_d, c1, slo)
        n_evals += 1
        while not ok and n < max_replicas:          # doubling phase
            n *= 2
            ok, st = _meets(t_pf, t_d,
                            dataclasses.replace(c1, qps=qps / n), slo)
            n_evals += 1
        if not ok:
            n_unsizeable += 1
            continue
        lo = n // 2                                  # bisect (lo fails)
        while n - lo > 1:
            mid = (lo + n) // 2
            okm, stm = _meets(t_pf, t_d,
                              dataclasses.replace(c1, qps=qps / mid), slo)
            n_evals += 1
            if okm:
                n, st = mid, stm
            else:
                lo = mid
        dev = int(rec["devices"])
        rank_val = None
        if rank_col is not None:
            v = rec.get(rank_col)
            if v is not None and math.isfinite(float(v)):
                rank_val = float(v)
        cands.append(FleetCandidate(
            key=str(rec.get("key", "")), replicas=n, devices_per_replica=dev,
            devices=n * dev, per_replica_qps=qps / n, metrics=st,
            rank_value=rank_val))
    if rank_col is None:
        cands.sort(key=lambda c: (c.devices, c.replicas, c.key))
    else:
        # objective-ranked: missing columns last, devices as tie-break
        cands.sort(key=lambda c: (c.rank_value is None,
                                  c.rank_value if c.rank_value is not None
                                  else 0.0, c.devices, c.replicas, c.key))
    return FleetPlan(qps=float(qps), slo=slo,
                     best=cands[0] if cands else None,
                     candidates=cands[:max(top_k, 0)], n_records=seen,
                     n_sized=len(cands), n_unsizeable=n_unsizeable,
                     n_evals=n_evals)
