"""Differentiable fitting engine: measurements -> techlib/PPE parameters.

The calibration parameter vector collects the efficiency and overhead
knobs the performance model exposes, treated as ONE batched vector:

  compute_eff        achieved / nominal compute throughput (MXU derate)
  dram_bw_eff        main-memory bandwidth efficiency
  l2/l1/l0_bw_eff    per-level on-chip bandwidth efficiencies
  vector_eff         vector-pipe (elementwise) efficiency — consumed by
                     sweeps through `profiles.ppe_with_profile`, which
                     folds vector_eff/compute_eff into PPE vector_frac
  kernel_overhead_s  software-stack launch latency (PPE overhead)
  net_alpha_eff      collective latency (alpha) scale on the techlib link
                     latency — a scale, not an absolute, so the identity
                     parameter set stays a strict no-op on the MicroArch
  net_beta_eff       collective bandwidth efficiency (beta derate)

Predictions flow through the port's performance model — `roofline.gemm_time`
/ `roofline.elementwise_time` for kernels and `simulate.predict` for
end-to-end model steps — on a MicroArch whose leaves are scaled by the
parameters, so torch autograd gives the loss's exact gradient and the fit
is multi-start GD.  The batched update mirrors the SOE's eq.-6 shape
(`soe.eq6_update`: normalized gradient, parameter-space EMA, projection)
with a log-space box projection replacing the budget simplex.

Selection is by the *report* metric: among {identity, analytic seed, every
GD start's best iterate}, `fit` returns the candidate with the lowest mean
relative error on the measurement set, so a calibrated profile can never
validate worse than the uncalibrated techlib entry it started from.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import roofline, simulate
from repro_torch.core.age import MicroArch
from repro_torch.core.parallelism import Strategy
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.tensors import F32

# (name, default, lo, hi) — defaults are the identity / PPE defaults, so
# theta0 reproduces the uncalibrated model exactly.
PARAM_SPECS: Tuple[Tuple[str, float, float, float], ...] = (
    ("compute_eff", 1.0, 0.01, 50.0),
    ("dram_bw_eff", 1.0, 0.01, 50.0),
    ("l2_bw_eff", 1.0, 0.02, 20.0),
    ("l1_bw_eff", 1.0, 0.02, 20.0),
    ("l0_bw_eff", 1.0, 0.02, 20.0),
    ("vector_eff", 1.0, 0.01, 50.0),
    ("kernel_overhead_s", 3e-6, 1e-8, 1e-2),
    ("net_alpha_eff", 1.0, 1e-2, 1e6),
    ("net_beta_eff", 1.0, 1e-3, 100.0),
)
PARAM_NAMES: Tuple[str, ...] = tuple(s[0] for s in PARAM_SPECS)
# measurement kinds the default fit consumes (gemm_pallas is reported but
# not fitted, as in the reference: one efficiency vector describes the
# library's GEMM, and the hand-written kernel is validated against it)
KINDS_FITTED: Tuple[str, ...] = ("gemm", "elementwise", "collective",
                                 "train_step", "prefill", "decode_step")
N_PARAMS = len(PARAM_SPECS)
_LOG_LO = np.log(np.asarray([s[2] for s in PARAM_SPECS], dtype=np.float64))
_LOG_HI = np.log(np.asarray([s[3] for s in PARAM_SPECS], dtype=np.float64))


def default_params() -> Dict[str, float]:
    """The identity parameter set (uncalibrated model)."""
    return {name: default for name, default, _, _ in PARAM_SPECS}


def params_to_theta(params: Dict[str, float]) -> np.ndarray:
    """Params dict -> log-space theta vector (fit coordinates)."""
    full = {**default_params(), **params}
    vals = np.asarray([max(float(full[n]), 1e-30) for n in PARAM_NAMES])
    return np.clip(np.log(vals), _LOG_LO, _LOG_HI)


def theta_to_params(theta) -> Dict[str, float]:
    vals = np.exp(np.asarray(theta, dtype=np.float64))
    return {n: float(v) for n, v in zip(PARAM_NAMES, vals)}


def scale_microarch(arch: MicroArch, params: Dict[str, float]) -> MicroArch:
    """Apply efficiency parameters to a MicroArch (tensors pass through).

    Every parameter here is a *scale* with identity 1.0, so the default
    parameter set is a strict no-op.  The remaining two fitted parameters
    live elsewhere: ``kernel_overhead_s`` and ``vector_eff`` ride on the
    PPEConfig (`profiles.ppe_with_profile`).
    """
    bw = arch.mem_bw
    alpha = params.get("net_alpha_eff", 1.0)
    return dataclasses.replace(
        arch,
        compute_throughput=arch.compute_throughput
        * params.get("compute_eff", 1.0),
        dram_bw=arch.dram_bw * params.get("dram_bw_eff", 1.0),
        mem_bw=(bw[0] * params.get("l0_bw_eff", 1.0),
                bw[1] * params.get("l1_bw_eff", 1.0),
                bw[2] * params.get("l2_bw_eff", 1.0)),
        net_intra_bw=arch.net_intra_bw * params.get("net_beta_eff", 1.0),
        net_inter_bw=arch.net_inter_bw * params.get("net_beta_eff", 1.0),
        net_intra_latency=arch.net_intra_latency * alpha,
        net_inter_latency=arch.net_inter_latency * alpha,
    )


# ---------------------------------------------------------------------------
# Per-measurement predictors (theta is a float32 tensor; autograd-safe)
# ---------------------------------------------------------------------------


def _graph_overhead_count(graph) -> float:
    """Number of kernel launches one prediction charges overhead for."""
    return float(sum(node.meta.get("repeat", 1)
                     for node in graph.nodes.values()
                     if node.kind != "comm"))


def _model_skeleton(rec: Dict):
    """(graph, strategy) for one model-step measurement record — the
    prediction side of the identical (reduced cfg, smoke cell) pair the
    microbench measured.  ``decode_step`` builds the decode-kind graph
    (one token over the full KV context — the KV-bandwidth path)."""
    from repro_torch.configs.base import ShapeCell, get_config, reduced
    from repro_torch.core import lmgraph
    kind = {"train_step": "train", "prefill": "prefill",
            "decode_step": "decode"}[rec["kind"]]
    cell = ShapeCell(f"cal_{kind}", int(rec["seq"]), int(rec["batch"]),
                     kind)
    cfg = reduced(get_config(str(rec["arch"])))
    graph = lmgraph.build_graph(cfg, cell)
    return graph, Strategy("RC", kp1=1, kp2=1, dp=1)


def build_predictor(measurements: Sequence[Dict], template: MicroArch,
                    ppe: PPEConfig = PPEConfig()) -> Callable:
    """-> ``predict_all(theta_log) -> (R,) tensor`` of predicted times.

    One closure per measurement record, all flowing through the roofline /
    simulate paths with a zero-overhead PPEConfig on the template's
    device; the ``kernel_overhead_s`` parameter is added explicitly (per
    launch for kernels, per graph node for model steps).
    """
    ppe0 = dataclasses.replace(ppe, kernel_overhead_s=0.0)
    closures: List[Callable] = []
    for rec in measurements:
        kind = rec["kind"]
        if kind in ("gemm", "gemm_pallas"):
            m, n, k = int(rec["m"]), int(rec["n"]), int(rec["k"])
            db = int(rec.get("dtype_bytes", 4))

            def f(p, m=m, n=n, k=k, db=db):
                arch = scale_microarch(template, p)
                return (roofline.gemm_time(arch, m, n, k, dtype_bytes=db,
                                           cfg=ppe0)
                        + p["kernel_overhead_s"])
        elif kind == "elementwise":
            n_elems = float(rec["n_elems"])

            def f(p, n_elems=n_elems):
                arch = scale_microarch(template, p)
                arch = dataclasses.replace(
                    arch, compute_throughput=template.compute_throughput
                    * p["vector_eff"])
                return (roofline.elementwise_time(arch, n_elems, 2.0,
                                                  dtype_bytes=4, cfg=ppe0)
                        + p["kernel_overhead_s"])
        elif kind == "collective":
            payload = float(rec["bytes"])
            n_dev = int(rec["devices"])
            base_bw = float(template.net_intra_bw)
            base_lat = float(template.net_intra_latency)

            def f(p, payload=payload, n_dev=n_dev, base_bw=base_bw,
                  base_lat=base_lat):
                # ring all-reduce alpha-beta: (n-1) latency hops plus
                # 2(n-1)/n of the payload over the efficient link bw;
                # alpha = the techlib link latency scaled by the fitted
                # net_alpha_eff (the same scaling scale_microarch applies)
                wire = 2.0 * (n_dev - 1) / n_dev * payload
                return (base_lat * p["net_alpha_eff"] * (n_dev - 1)
                        + wire / (base_bw * p["net_beta_eff"]))
        elif kind in ("train_step", "prefill", "decode_step"):
            graph, st = _model_skeleton(rec)
            n_launch = _graph_overhead_count(graph)

            def f(p, graph=graph, st=st, n_launch=n_launch):
                arch = scale_microarch(template, p)
                bd = simulate.predict(arch, graph, st, cfg=ppe0)
                return bd.total_s + p["kernel_overhead_s"] * n_launch
        else:
            raise ValueError(f"unknown measurement kind {kind!r}")
        closures.append(f)

    def predict_all(theta_log):
        p = {name: torch.exp(theta_log[i])
             for i, name in enumerate(PARAM_NAMES)}
        return torch.stack([torch.as_tensor(f(p), dtype=F32,
                                            device=template.device)
                            for f in closures])

    return predict_all


def predict_measurements(measurements: Sequence[Dict], template: MicroArch,
                         params: Optional[Dict[str, float]] = None,
                         ppe: PPEConfig = PPEConfig()) -> np.ndarray:
    """Concrete (host-side) predicted times, one per measurement record.

    The single prediction path shared by the fit loss and the validation
    reporter — `report.validation_report` scores exactly what `fit`
    optimized, so the two cannot drift apart.
    """
    predict_all = build_predictor(measurements, template, ppe)
    with torch.no_grad():
        return _predict_np(predict_all,
                           params_to_theta(params or default_params()),
                           template.device)


def _predict_np(predict_all: Callable, theta, device) -> np.ndarray:
    theta = torch.as_tensor(np.asarray(theta), dtype=F32, device=device)
    return predict_all(theta).cpu().numpy().astype(np.float64)


def mean_relative_error(measurements: Sequence[Dict],
                        predicted: np.ndarray) -> float:
    meas = np.asarray([float(r["t_s"]) for r in measurements])
    return float(np.mean(np.abs(predicted - meas) / np.maximum(meas,
                                                               1e-12)))


# ---------------------------------------------------------------------------
# Multi-start batched fit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitConfig:
    steps: int = 80
    starts: int = 6
    lr: float = 0.15
    beta: float = 0.7               # parameter-space EMA (eq.-6 style)
    seed: int = 0
    jitter: float = 0.5             # log-space start spread


@dataclasses.dataclass
class FitResult:
    params: Dict[str, float]
    theta: np.ndarray               # log-space
    loss: float                     # selected candidate's fit loss
    loss_identity: float            # identity-params fit loss
    mre: float                      # selected candidate's mean rel. error
    mre_identity: float
    history: List[float]
    n_evals: int
    selected: str                   # "identity" | "seed" | "fit"

    @property
    def improved(self) -> bool:
        return self.mre < self.mre_identity


def _loss_fn(predict_all: Callable, measured: torch.Tensor,
             weights: torch.Tensor) -> Callable:
    """Weighted mean squared log error (smooth, scale-free)."""
    log_meas = torch.log(measured.clamp_min(1e-12))

    def loss(theta_log):
        pred = predict_all(theta_log)
        d = torch.log(torch.maximum(pred, pred.new_tensor(1e-12))) - log_meas
        return torch.sum(weights * d * d) / torch.sum(weights)

    return loss


def _kind_weights(measurements: Sequence[Dict]) -> np.ndarray:
    """Balance kinds: each measurement kind contributes equal total weight
    (a 10-shape GEMM sweep must not drown two model-step records)."""
    kinds = [r["kind"] for r in measurements]
    counts = {k: kinds.count(k) for k in set(kinds)}
    return np.asarray([1.0 / counts[k] for k in kinds], dtype=np.float32)


def analytic_seed(measurements: Sequence[Dict],
                  template: MicroArch) -> Dict[str, float]:
    """Closed-form anchor (the fig-6 methodology, per parameter): peak
    achieved GEMM rate -> compute_eff, fastest kernel -> overhead,
    achieved collective bandwidth -> net_beta_eff."""
    params = default_params()
    gemm = [r for r in measurements if r["kind"] == "gemm"]
    if gemm:
        rate = max(float(r["flops"]) / max(float(r["t_s"]), 1e-12)
                   for r in gemm)
        params["compute_eff"] = rate / max(
            float(template.compute_throughput), 1e-12)
        params["kernel_overhead_s"] = min(float(r["t_s"]) for r in gemm) / 2
    elem = [r for r in measurements if r["kind"] == "elementwise"]
    if elem:
        bw = max(float(r["bytes"]) / max(float(r["t_s"]), 1e-12)
                 for r in elem)
        params["dram_bw_eff"] = bw / max(float(template.dram_bw), 1e-12)
    coll = [r for r in measurements if r["kind"] == "collective"]
    if coll:
        r = max(coll, key=lambda r: float(r["bytes"]))
        n_dev = int(r["devices"])
        wire = 2.0 * (n_dev - 1) / n_dev * float(r["bytes"])
        bw = wire / max(float(r["t_s"]), 1e-12)
        params["net_beta_eff"] = bw / max(float(template.net_intra_bw),
                                          1e-12)
        alpha = min(float(c["t_s"]) for c in coll) / max(n_dev - 1, 1)
        params["net_alpha_eff"] = alpha \
            / max(float(template.net_intra_latency), 1e-12)
    return theta_to_params(params_to_theta(params))   # clip into bounds


def fit_update(W: torch.Tensor, M: torch.Tensor, G: torch.Tensor, lr: float,
               beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched fit step — the eq.-6 shape (`soe.eq6_update`) with the
    budget simplex replaced by the log-space parameter box: normalized
    gradient descent, parameter-space EMA, clip projection."""
    G = torch.nan_to_num(G, nan=0.0, posinf=0.0, neginf=0.0)
    gnorm = torch.linalg.vector_norm(G, dim=1, keepdim=True)
    G = torch.where(gnorm > 0, G / (gnorm + 1e-12), G)
    W_new = W - lr * G
    M_new = beta * M + (1.0 - beta) * W_new
    lo = torch.as_tensor(_LOG_LO, dtype=W.dtype, device=W.device)
    hi = torch.as_tensor(_LOG_HI, dtype=W.dtype, device=W.device)
    return torch.minimum(torch.maximum(M_new, lo), hi), M_new


def _initial_thetas(seed_theta: np.ndarray, cfg: FitConfig) -> np.ndarray:
    """(S, N_PARAMS) stack: start 0 identity, start 1 the analytic seed,
    the rest log-space jitter around the seed."""
    rng = np.random.default_rng(cfg.seed)
    rows = [params_to_theta(default_params()), np.asarray(seed_theta)]
    for _ in range(2, max(cfg.starts, 2)):
        jit = rng.uniform(-cfg.jitter, cfg.jitter, N_PARAMS)
        rows.append(np.clip(seed_theta + jit, _LOG_LO, _LOG_HI))
    return np.stack(rows[:max(cfg.starts, 2)]).astype(np.float32)


def fit(measurements: Sequence[Dict], template: MicroArch,
        ppe: PPEConfig = PPEConfig(), cfg: FitConfig = FitConfig(),
        kinds: Optional[Sequence[str]] = None) -> FitResult:
    """Fit the calibration vector to a measurement set.

    All S starts advance together (per step: every start's value and
    autograd gradient, then one vectorized update); per-start best iterates
    are kept and the final winner is chosen by mean relative error, with
    the identity and the analytic seed always in the candidate pool.  The
    arithmetic runs on the template's device.

    ``kinds`` restricts which measurement kinds enter the fit.  The
    default excludes ``gemm_pallas``, as the reference does — it still
    appears in the validation report as its own group.
    """
    if kinds is None:
        kinds = tuple(k for k in KINDS_FITTED)
    measurements = [r for r in measurements
                    if "t_s" in r and r.get("kind") in kinds]
    if not measurements:
        raise ValueError("no measurements to fit")
    dev = template.device
    predict_all = build_predictor(measurements, template, ppe)
    measured = torch.tensor([float(r["t_s"]) for r in measurements],
                            dtype=F32, device=dev)
    weights = torch.as_tensor(_kind_weights(measurements), device=dev)
    loss = _loss_fn(predict_all, measured, weights)

    seed_params = analytic_seed(measurements, template)
    W = torch.as_tensor(_initial_thetas(params_to_theta(seed_params), cfg),
                        device=dev)
    S = W.shape[0]

    M = W
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    last = torch.full((S,), float("inf"), device=dev)
    best_theta = W.cpu().numpy()               # per-start best iterate
    best_loss = np.full(S, np.inf)
    history: List[float] = []
    n_evals = 0
    for _ in range(cfg.steps):
        if bool(done.all()):
            break
        n_evals += S
        W_before = W.cpu().numpy()
        W, M, done, vals = _fit_step(W, M, done, last, loss=loss, lr=cfg.lr,
                                     beta=cfg.beta)
        vals_np = vals.cpu().numpy().astype(np.float64)
        history.append(float(np.nanmin(vals_np)))
        improved = np.isfinite(vals_np) & (vals_np < best_loss)
        best_loss = np.where(improved, vals_np, best_loss)
        best_theta = np.where(improved[:, None], W_before, best_theta)
        last = vals

    # candidate pool: identity, analytic seed, every start's best iterate
    cands: List[Tuple[str, np.ndarray]] = [
        ("identity", params_to_theta(default_params())),
        ("seed", params_to_theta(seed_params)),
    ] + [("fit", best_theta[s]) for s in range(S)
         if np.isfinite(best_loss[s])]
    meas_np = measured.cpu().numpy().astype(np.float64)
    best = None
    with torch.no_grad():
        for label, theta in cands:
            pred = _predict_np(predict_all, theta, dev)
            mre = float(np.mean(np.abs(pred - meas_np)
                                / np.maximum(meas_np, 1e-12)))
            if best is None or mre < best[0]:
                best = (mre, label, np.asarray(theta, dtype=np.float64))
        mre_best, label, theta = best
        theta0 = params_to_theta(default_params())
        pred0 = _predict_np(predict_all, theta0, dev)
        mre0 = float(np.mean(np.abs(pred0 - meas_np)
                             / np.maximum(meas_np, 1e-12)))
        loss_best = float(loss(torch.as_tensor(theta, dtype=F32, device=dev)))
        loss0 = float(loss(torch.as_tensor(theta0, dtype=F32, device=dev)))
    return FitResult(
        params=theta_to_params(theta), theta=theta,
        loss=loss_best, loss_identity=loss0,
        mre=mre_best, mre_identity=mre0, history=history,
        n_evals=n_evals, selected=label)


def value_and_grad_rows(loss: Callable, W: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S,) losses and (S, N) gradients, one autograd pass per start —
    the reference's ``vmap(value_and_grad(loss))``."""
    vals, grads = [], []
    for s in range(W.shape[0]):
        theta = W[s].detach().clone().requires_grad_(True)
        val = loss(theta)
        (grad,) = torch.autograd.grad(val, theta)
        vals.append(val.detach())
        grads.append(grad)
    return torch.stack(vals), torch.stack(grads)


def _fit_step(W, M, done, last, *, loss, lr, beta):
    vals, G = value_and_grad_rows(loss, W)
    W_proj, M_new = fit_update(W, M, G, lr, beta)
    conv = torch.abs(last - vals) < 1e-8 * vals.clamp_min(1e-12)
    frozen = done[:, None]
    return (torch.where(frozen, W, W_proj), torch.where(frozen, M, M_new),
            done | conv, vals)
