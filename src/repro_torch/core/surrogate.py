"""Learned surrogate + acquisition-driven exploration, PyTorch port — the
"DeepFlow" loop over the CrossFlow analytical core.

The counterpart of ``repro.core.surrogate``.  Instead of enumerating every
grid point, a cheap learned model predicts the objective vector of
unevaluated points and real (pipeline) evaluations are spent only where
the model says a point is promising or uncertain:

  * `Featurizer` — deterministic featurization of enumerated
    `PointLabel`s (arch/cell/strategy one-hots, mesh + parallelism
    numerics, budget scale, scenario-variant overrides, and the AGE'd
    hardware's `pathfinder.pack_hw` leaf vector in log space),
    standardized over the spec's full enumeration so evaluated and
    unevaluated labels featurize identically; float64 NumPy, the
    reference's matrix;
  * `build_dataset` / `load_training_records` — sweep JSONL rows into
    (X, Y, feasible) training sets, read through `sweepexec.iter_jsonl`
    and filtered to hash-verified committed chunks.  Objective targets
    are `canonical_signs`-signed via the scenario's own
    `objective_values`, so infeasible/SLO-violating/non-finite rows
    become classifier-only examples;
  * `fit_surrogate` / `predict` — an ensemble of small MLPs whose members
    advance together on ``device``: one
    ``torch.func.vmap(torch.func.grad_and_value(loss))`` and one batched
    Adam update a step, convergence-frozen by mask, nan-safe best
    tracking, bootstrap-resampled rows per member, all drawn from
    ``np.random.default_rng(seed)`` as the reference draws them.
    Ensemble spread is the epistemic uncertainty; a shared feasibility
    logit is the classifier target.  `predict` is plain NumPy, as in the
    reference;
  * `ucb_acquisition` / `epi_acquisition` — multi-objective acquisition
    over the signed axes: scores are dominance *margins* against the
    current Pareto frontier, invariant under `canonical_signs` flips and
    under frontier permutation, with exact ties scoring exactly equal;
  * `explore` — the search loop: seed chunks, fit, rank every pending
    chunk by its best label's acquisition, spend real label-mode
    `pathfinder.evaluate` calls on ``device`` on the top chunks, repeat
    until the eval budget or frontier stagnation fires.  Output uses the
    standard sweep-dir layout (spec head + `ChunkJournal` commits with
    unchanged chunk hashes), so an explored directory is a partial sweep
    either package resumes, and real evaluations route through the live
    prediction cache (`pathfinder.DEFAULT_CACHE`);
  * `rank_chunks` / `order_fabric_dir` — the fabric work order: rank a
    directory's chunks from already-scored records and write
    ``order.json`` (`sweepfabric.write_chunk_order`), so lease-claiming
    workers serve frontier-adjacent chunks first.  The order is
    advisory and schedule-only.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import objectives as objectives_lib
from repro_torch.core import pathfinder, sweepexec, sweeprunner
from repro_torch.core.parallelism import Strategy
from repro_torch.core.traffic import decode_variant

# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Featurizer:
    """Deterministic label -> feature-vector map for one sweep spec.

    Vocabularies and standardization moments come from the spec's FULL
    enumeration (`from_spec`), not from whichever subset happens to be
    evaluated — an unevaluated label must featurize identically before
    and after it is scored, or acquisition ranking would drift between
    rounds.  Labels from *other* specs (seed training rows) still
    transform: unknown vocabulary values one-hot to all-zeros.  The
    hardware columns pack the AGE'd hardware of ``device`` (the card
    unless the caller asks for ``"cpu"``); the matrix is float64 NumPy.
    """

    arch_vocab: Tuple[str, ...]
    cell_vocab: Tuple[str, ...]
    strategy_vocab: Tuple[str, ...]
    variant_keys: Tuple[str, ...]
    mesh_rank: int
    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def from_spec(spec, labels: Optional[Sequence] = None,
                  device=None) -> "Featurizer":
        labels = list(labels) if labels is not None \
            else sweeprunner.enumerate_labels(spec)
        if not labels:
            raise ValueError("spec enumerates no labels to featurize")
        cells, keys = set(), set()
        for lb in labels:
            base, over = decode_variant(lb.cell)
            cells.add(base)
            keys.update(over)
        fz = Featurizer(
            arch_vocab=tuple(sorted({lb.arch for lb in labels})),
            cell_vocab=tuple(sorted(cells)),
            strategy_vocab=tuple(sorted({lb.strategy for lb in labels})),
            variant_keys=tuple(sorted(keys)),
            mesh_rank=max(len(lb.mesh) for lb in labels),
            mean=np.zeros(0), std=np.ones(0))
        raw = fz._raw(spec, labels, device)
        std = raw.std(axis=0)
        return dataclasses.replace(fz, mean=raw.mean(axis=0),
                                   std=np.maximum(std, 1e-9))

    @property
    def dim(self) -> int:
        return (len(self.arch_vocab) + len(self.cell_vocab)
                + len(self.strategy_vocab) + len(self.variant_keys)
                + self.mesh_rank + 1        # mesh dims + product
                + 8                         # strategy numerics
                + 1                         # budget scale
                + pathfinder.HW_DIM)

    def _raw(self, spec, labels: Sequence, device=None) -> np.ndarray:
        a_ix = {a: i for i, a in enumerate(self.arch_vocab)}
        c_ix = {c: i for i, c in enumerate(self.cell_vocab)}
        s_ix = {s: i for i, s in enumerate(self.strategy_vocab)}
        v_ix = {k: i for i, k in enumerate(self.variant_keys)}
        na, nc, ns, nv = (len(a_ix), len(c_ix), len(s_ix), len(v_ix))
        mesh0 = na + nc + ns + nv
        strat0 = mesh0 + self.mesh_rank + 1
        scale0 = strat0 + 8
        hw0 = scale0 + 1
        out = np.zeros((len(labels), self.dim), dtype=np.float64)
        strategies: Dict[str, Strategy] = {}
        # AGE'd hardware is memoized per process (`sweeprunner._hardware`)
        # but pack it once per distinct tech point here anyway
        hw_vecs: Dict[tuple, np.ndarray] = {}
        for i, lb in enumerate(labels):
            row = out[i]
            base, over = decode_variant(lb.cell)
            if lb.arch in a_ix:
                row[a_ix[lb.arch]] = 1.0
            if base in c_ix:
                row[na + c_ix[base]] = 1.0
            if lb.strategy in s_ix:
                row[na + nc + s_ix[lb.strategy]] = 1.0
            for k, v in over.items():
                if k in v_ix:
                    row[na + nc + ns + v_ix[k]] = float(v)
            mesh = tuple(lb.mesh)[:self.mesh_rank]
            for j, d in enumerate(mesh):
                row[mesh0 + j] = math.log2(max(int(d), 1))
            row[mesh0 + self.mesh_rank] = math.log2(
                max(int(np.prod(mesh)) if mesh else 1, 1))
            st = strategies.get(lb.strategy)
            if st is None:
                st = strategies.setdefault(lb.strategy,
                                           Strategy.parse(lb.strategy))
            row[strat0:strat0 + 8] = (
                math.log2(st.kp1), math.log2(st.kp2), math.log2(st.dp),
                math.log2(st.lp), float(st.ep), float(st.sp),
                math.log2(st.devices), 1.0 if st.kind == "CR" else 0.0)
            row[scale0] = float(lb.scale)
            hk = (lb.logic, lb.hbm, lb.net, lb.scale)
            hv = hw_vecs.get(hk)
            if hv is None:
                hw = sweeprunner._hardware(spec, lb.logic, lb.hbm, lb.net,
                                           lb.scale, device)
                # leaves span ~17 decades (bytes vs seconds): log10
                hv = hw_vecs.setdefault(
                    hk, np.log10(np.abs(np.asarray(
                        pathfinder.pack_hw(hw), dtype=np.float64)) + 1e-30))
            row[hw0:hw0 + pathfinder.HW_DIM] = hv
        return out

    def transform(self, spec, labels: Sequence, device=None) -> np.ndarray:
        """Standardized (N, dim) feature matrix for labels."""
        return (self._raw(spec, labels, device) - self.mean) / self.std

    def transform_records(self, spec, records: Sequence[Mapping],
                          device=None) -> np.ndarray:
        return self.transform(
            spec, [sweeprunner.label_from_record(r) for r in records],
            device)


# ---------------------------------------------------------------------------
# Training-set ingestion (sweep JSONL rows through the durability reader)
# ---------------------------------------------------------------------------


def load_training_records(out_dir: str) -> Tuple[object, List[Dict]]:
    """(spec, committed records) of a sweep directory, for training.

    Rows stream through `sweepexec.iter_jsonl` — the torn-line-tolerant
    reader every durability consumer shares — filtered to hash-verified
    committed chunks, exactly as `sweeprunner.load_sweep` / resume do
    (an interrupted writer's torn tail line or partial chunk never
    reaches the training set).  A frontier-only directory falls back to
    its materialized ``frontier.jsonl``.  Fabric directories should be
    merged first (the coordinator does this on completion).
    """
    head = sweepexec.load_spec_head(os.path.join(out_dir, "spec.json"))
    spec = sweeprunner.SweepSpec.from_dict(head["spec"])
    fp = spec.fingerprint()
    res = os.path.join(out_dir, "results.jsonl")
    ckpt = os.path.join(out_dir, "checkpoint.jsonl")
    records: List[Dict] = []
    if os.path.exists(ckpt):
        chunks = sweeprunner.make_chunks(
            sweeprunner.enumerate_labels(spec), spec.chunk_size)
        done = sweepexec.ChunkJournal("", ckpt).load_done(chunks, fp)
        records = [{k: v for k, v in rec.items() if k != "chunk"}
                   for rec in sweepexec.iter_jsonl(res)
                   if rec.get("chunk") in done]
    if not records:
        records = list(sweepexec.iter_jsonl(
            os.path.join(out_dir, "frontier.jsonl")))
    return spec, records


def dedupe_records(records: Sequence[Mapping]) -> List[Dict]:
    """First-wins dedupe by record key (seed rows + freshly committed
    rows can overlap when exploring a previously-swept spec)."""
    seen, out = set(), []
    for r in records:
        k = r.get("key")
        if k is None or k not in seen:
            seen.add(k)
            out.append(dict(r))
    return out


@dataclasses.dataclass
class Dataset:
    """Featurized training set: regression targets in canonical-signed
    *standardized* space (NaN where the row is classifier-only), plus the
    feasibility labels."""

    X: np.ndarray                   # (N, D) standardized features
    Y: np.ndarray                   # (N, K) standardized canonical targets
    feasible: np.ndarray            # (N,) bool
    objectives: Tuple[str, ...]
    signs: Tuple[float, ...]
    y_mean: np.ndarray              # (K,) canonical-space moments
    y_std: np.ndarray


def build_dataset(spec, records: Sequence[Mapping],
                  featurizer: Optional[Featurizer] = None, device=None
                  ) -> Tuple[Featurizer, Dataset]:
    """Featurize scored records into a `Dataset` under ``spec``'s axes.

    Objective targets go through the scenario's own `objective_values`
    (canonical `canonical_signs`-signed, None for infeasible / SLO-wall /
    missing / non-finite rows — the same filter every frontier applies),
    so the regression head never trains on values a frontier would drop;
    those rows keep their features as feasibility-classifier negatives.
    """
    fz = featurizer or Featurizer.from_spec(spec, device=device)
    scn = spec.scenario_spec.variants()[0].resolve()
    objectives = tuple(scn.objectives)
    signs = objectives_lib.canonical_signs(objectives)
    n, k = len(records), len(objectives)
    Y = np.full((n, k), np.nan, dtype=np.float64)
    feas = np.zeros(n, dtype=bool)
    scns: Dict[str, object] = {}
    for i, rec in enumerate(records):
        cell = str(rec.get("cell", ""))
        s = scns.get(cell)
        if s is None:
            try:
                s = scns.setdefault(cell,
                                    sweeprunner.scenario_for(spec, cell))
            except Exception:
                s = scns.setdefault(cell, scn)
        vs = s.objective_values(rec)
        if vs is not None:
            Y[i] = vs
            feas[i] = True
    if feas.any():
        y_mean = np.nanmean(Y[feas], axis=0)
        y_std = np.maximum(np.nanstd(Y[feas], axis=0), 1e-9)
    else:
        y_mean, y_std = np.zeros(k), np.ones(k)
    X = fz.transform_records(spec, records, device)
    return fz, Dataset(X=X, Y=(Y - y_mean) / y_std, feasible=feas,
                       objectives=objectives, signs=tuple(signs),
                       y_mean=y_mean, y_std=y_std)


# ---------------------------------------------------------------------------
# Ensemble surrogate (vmapped MLPs in the soe batched-GD idiom)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    ensemble: int = 4               # bootstrap members (epistemic spread)
    hidden: int = 32
    steps: int = 300
    lr: float = 0.01
    l2: float = 1e-4
    seed: int = 0


@dataclasses.dataclass
class SurrogateModel:
    """Fitted ensemble: flattened member params + everything needed to
    map predictions back to raw objective units."""

    params: np.ndarray              # (M, P) flattened member params
    featurizer: Featurizer
    objectives: Tuple[str, ...]
    signs: Tuple[float, ...]
    y_mean: np.ndarray
    y_std: np.ndarray
    hidden: int
    loss: float                     # final mean training loss
    # the step at which each member froze (its loss moved by under 1e-7
    # of itself), or the step count where it never did
    stop_steps: Tuple[int, ...] = ()

    @property
    def n_objectives(self) -> int:
        return len(self.objectives)


# how closely two fits of one seed agree, across packages or devices
# (float32 Adam over a few hundred steps, summed in another order by each):
# FIT_RTOL of each prediction, plus FIT_ATOL in the model's standardized
# units (mu and sigma take FIT_ATOL times the objective's training spread,
# p_feasible FIT_ATOL itself)
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6


def _param_count(d: int, h: int, k: int) -> int:
    return d * h + h + h * (k + 1) + (k + 1)


def _forward_np(theta: np.ndarray, X: np.ndarray, d: int, h: int,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    o = 0
    W1 = theta[o:o + d * h].reshape(d, h); o += d * h
    b1 = theta[o:o + h]; o += h
    W2 = theta[o:o + h * (k + 1)].reshape(h, k + 1); o += h * (k + 1)
    b2 = theta[o:o + k + 1]
    out = np.tanh(X @ W1 + b1) @ W2 + b2
    return out[:, :k], out[:, k]


def fit_surrogate(spec, records: Sequence[Mapping],
                  cfg: SurrogateConfig = SurrogateConfig(),
                  featurizer: Optional[Featurizer] = None,
                  device=None) -> SurrogateModel:
    """Fit the bootstrap MLP ensemble on scored records, on ``device``
    (the card unless the caller asks for ``"cpu"``).

    All M members train as ONE batch — ``torch.func.vmap(
    torch.func.grad_and_value)`` over the stacked flattened params plus a
    single batched Adam update, with per-member convergence freezing and
    nan-safe best tracking, the `soe._optimize_batched` machinery.  Each
    member sees its own with-replacement bootstrap resample; the spread
    of member predictions is the epistemic uncertainty `predict` reports.
    Loss = masked MSE on the standardized canonical objectives (feasible
    rows only) + BCE on the feasibility logit (all rows) + L2.  The
    initial members and the resamples come from
    ``np.random.default_rng(cfg.seed)`` in the reference's order; the
    step counter enters the bias corrections as a float32 tensor, as the
    reference's ``jnp.float32(t)`` does.  The best-so-far parameters of a
    member are those before the step whose loss improved its best.
    """
    dev = resolve_device(device)
    fz, ds = build_dataset(spec, records, featurizer=featurizer, device=dev)
    n, d = ds.X.shape
    if n == 0:
        raise ValueError("no records to fit a surrogate on")
    k, h, m = len(ds.objectives), cfg.hidden, max(cfg.ensemble, 1)
    p = _param_count(d, h, k)
    rng = np.random.default_rng(cfg.seed)
    W0 = rng.normal(0.0, 1.0 / math.sqrt(d + 1), size=(m, p))
    IDX = rng.integers(0, n, size=(m, n))       # bootstrap resamples
    f32 = torch.float32

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(f32)

    # each member's resampled rows, gathered once: (M, N, ...)
    idx = torch.as_tensor(IDX, device=dev)
    Xr = on_dev(ds.X)[idx]
    Yr = on_dev(np.nan_to_num(ds.Y, nan=0.0))[idx]
    Mr = on_dev(np.isfinite(ds.Y))[idx]
    Fr = on_dev(ds.feasible)[idx]
    lr, l2 = cfg.lr, cfg.l2
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)

    def loss(theta, X, Y, msk, f):
        o = 0
        W1 = theta[o:o + d * h].reshape(d, h); o += d * h
        b1 = theta[o:o + h]; o += h
        W2 = theta[o:o + h * (k + 1)].reshape(h, k + 1); o += h * (k + 1)
        b2 = theta[o:o + k + 1]
        out = torch.tanh(X @ W1 + b1) @ W2 + b2
        pred, logit = out[:, :k], out[:, k]
        mse = torch.sum(msk * (pred - Y) ** 2) \
            / torch.maximum(torch.sum(msk), one)
        bce = torch.mean(torch.maximum(logit, zero) - logit * f
                         + torch.log1p(torch.exp(-torch.abs(logit))))
        return mse + bce + l2 * torch.mean(theta ** 2)

    vg = torch.func.vmap(torch.func.grad_and_value(loss))
    floor = torch.full((), 1e-9, dtype=f32, device=dev)

    def step(W, Ma, Va, t, done, last):
        G, vals = vg(W, Xr, Yr, Mr, Fr)
        Ma2 = 0.9 * Ma + 0.1 * G
        Va2 = 0.999 * Va + 0.001 * G * G
        mh = Ma2 / (1.0 - 0.9 ** t)
        vh = Va2 / (1.0 - 0.999 ** t)
        W2 = W - lr * mh / (torch.sqrt(vh) + 1e-8)
        conv = torch.abs(last - vals) < 1e-7 * torch.maximum(vals, floor)
        frozen = done[:, None]
        return (torch.where(frozen, W, W2), torch.where(frozen, Ma, Ma2),
                torch.where(frozen, Va, Va2), done | conv, vals)

    W = on_dev(W0)
    Ma = torch.zeros_like(W)
    Va = torch.zeros_like(W)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    last = torch.full((m,), math.inf, dtype=f32, device=dev)
    best = W.to(torch.float64).cpu().numpy()
    best_vals = np.full(m, np.inf)
    stop = np.full(m, cfg.steps, dtype=np.int64)
    done_np = np.zeros(m, dtype=bool)
    with torch.no_grad():
        for t in range(1, cfg.steps + 1):
            if bool(np.all(done_np)):
                break
            W_before = W
            W, Ma, Va, done, vals = step(
                W, Ma, Va, torch.tensor(float(t), dtype=f32, device=dev),
                done, last)
            # the values and the done mask cross to the host in one copy
            host = torch.stack([vals.to(torch.float64),
                                done.to(torch.float64)]).cpu().numpy()
            v, now_done = host[0], host[1] > 0
            stop[now_done & ~done_np] = t
            done_np = now_done
            # nan-safe per-member best: one diverged member must not blind
            # the healthy ones (same contract as soe._optimize_batched)
            v = np.where(np.isfinite(v), v, np.inf)
            better = v < best_vals
            if better.any():
                best_vals[better] = v[better]
                best[better] = W_before.to(torch.float64).cpu().numpy()[
                    better]
            last = vals
    fin = best_vals[np.isfinite(best_vals)]
    return SurrogateModel(
        params=best, featurizer=fz, objectives=ds.objectives,
        signs=ds.signs, y_mean=ds.y_mean, y_std=ds.y_std, hidden=h,
        loss=float(fin.mean()) if fin.size else float("inf"),
        stop_steps=tuple(int(x) for x in stop))


def predict(model: SurrogateModel, X: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mu, sigma, p_feasible) over standardized feature rows.

    ``mu`` is in RAW objective units (signed back out of canonical
    space), ``sigma`` the ensemble's epistemic spread (objective units,
    sign-free), ``p_feasible`` the mean classifier probability.
    Inference is plain NumPy on purpose: row counts change every
    exploration round, and recompiling a jitted forward per shape would
    cost more than the matmuls it saves.
    """
    d = len(model.featurizer.mean)
    k, h = model.n_objectives, model.hidden
    mus, logits = [], []
    for theta in model.params:
        mu, logit = _forward_np(theta, X, d, h, k)
        mus.append(mu)
        logits.append(logit)
    mu_std = np.mean(mus, axis=0)
    sig_std = np.std(mus, axis=0)
    mu_can = mu_std * model.y_std + model.y_mean
    sigma = (sig_std + 1e-9) * model.y_std
    signs = np.asarray(model.signs)
    p = 1.0 / (1.0 + np.exp(-np.mean(logits, axis=0)))
    return mu_can * signs, sigma, p


# ---------------------------------------------------------------------------
# Multi-objective acquisition over canonical-signed axes
# ---------------------------------------------------------------------------


_erf = np.vectorize(math.erf)


def _canonical(vals, signs) -> np.ndarray:
    v = np.asarray(vals, dtype=np.float64)
    if v.ndim == 1:
        v = v.reshape(1, -1) if v.size else v.reshape(0, 0)
    if signs is None:
        return v
    return v * np.asarray(signs, dtype=np.float64)


def dominance_margin(z: np.ndarray, front: np.ndarray) -> np.ndarray:
    """Per-candidate dominance margin against a canonical frontier.

    ``margin_i = min over frontier rows f of (max over axes j of
    z_ij - f_j)`` — negative iff the candidate would enter the frontier
    (it beats some frontier point on its worst axis), with magnitude the
    depth of the improvement.  Min/max over the frontier *set* makes the
    margin independent of frontier row order, and exactly-tied
    candidates get exactly equal margins — the two invariants the
    property suite pins.  An empty frontier means everything improves
    (margin -inf).
    """
    z = np.asarray(z, dtype=np.float64)
    if front.size == 0:
        return np.full(z.shape[0], -np.inf)
    diff = z[:, None, :] - front[None, :, :]
    return np.min(np.max(diff, axis=2), axis=1)


def ucb_acquisition(mu, sigma, frontier, signs=None,
                    kappa: float = 1.0) -> np.ndarray:
    """Optimistic (UCB) Pareto acquisition; higher = more worth a real
    evaluation.

    The optimistic candidate ``mu*signs - kappa*|sigma|`` (canonical
    all-minimizing space, so subtracting uncertainty is optimism on
    every axis regardless of the objective's direction) is scored by its
    negated dominance margin against the frontier.  Sign flips via
    `canonical_signs` cancel exactly (mu and frontier flip together,
    sigma is sign-free), so the ranking is invariant under re-expressing
    a min objective as a max one.
    """
    z = _canonical(mu, signs) - float(kappa) * np.abs(
        np.asarray(sigma, dtype=np.float64))
    return -dominance_margin(z, _canonical(frontier, signs))


def epi_acquisition(mu, sigma, frontier, signs=None) -> np.ndarray:
    """Expected Pareto improvement; higher = more worth a real
    evaluation.

    The dominance margin ``m`` of the mean prediction is treated as a
    Gaussian with the ensemble's aggregate spread ``s`` (RMS over axes);
    the score is the classic expected improvement of ``-m`` over 0:
    ``EI = (-m) * Phi(-m/s) + s * phi(m/s)`` — strictly positive
    whenever there is uncertainty, dominated by ``-m`` when the model is
    confident.  Shares `dominance_margin`'s sign-flip and permutation
    invariants.
    """
    m = dominance_margin(_canonical(mu, signs),
                         _canonical(frontier, signs))
    if np.all(np.isinf(m)):        # empty frontier: everything improves
        return np.full(m.shape, np.inf)
    s = np.sqrt(np.mean(np.square(np.asarray(sigma, dtype=np.float64)),
                        axis=1)) + 1e-12
    u = -m / s
    cdf = 0.5 * (1.0 + _erf(u / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * np.square(u)) / math.sqrt(2.0 * math.pi)
    return (-m) * cdf + s * pdf


def feasibility_weighted(acq: np.ndarray, p_feasible: np.ndarray
                         ) -> np.ndarray:
    """Discount acquisition by the classifier head: a point predicted
    infeasible is pulled toward the round's worst finite score (never
    below it) — scale-free, so the discount cannot flip the ranking
    invariants of the underlying acquisition."""
    a = np.asarray(acq, dtype=np.float64)
    p = np.clip(np.asarray(p_feasible, dtype=np.float64), 0.0, 1.0)
    finite = a[np.isfinite(a)]
    floor = float(finite.min()) if finite.size else 0.0
    return np.where(np.isfinite(a), p * a + (1.0 - p) * floor, a)


def chunk_scores(chunks: Sequence, label_scores: np.ndarray
                 ) -> Dict[int, float]:
    """Per-chunk acquisition = the best label score inside the chunk
    (``label_scores`` aligned with the concatenated chunk labels, i.e.
    `enumerate_labels` order).  -inf labels (already evaluated) never
    lift a chunk."""
    out: Dict[int, float] = {}
    off = 0
    for c in chunks:
        n = len(c.labels)
        seg = label_scores[off:off + n]
        out[c.index] = float(np.max(seg)) if n else -np.inf
        off += n
    return out


# ---------------------------------------------------------------------------
# The explore loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExploreConfig:
    eval_budget: Optional[int] = None   # max real-evaluated points
    eval_frac: float = 0.25             # budget as fraction of the grid
    init_chunks: int = 4                # seed evaluations (spread evenly)
    batch_chunks: int = 4               # top-acquisition chunks per round
    stagnation: int = 3                 # stop after N frontier-stable rounds
    acquisition: str = "ucb"            # "ucb" | "epi"
    kappa: float = 1.0                  # UCB exploration weight
    min_fit_rows: int = 8               # rows needed before the first fit
    surrogate: SurrogateConfig = SurrogateConfig()


@dataclasses.dataclass
class ExploreStats:
    objectives: Tuple[str, ...]
    n_points_total: int
    n_chunks_total: int
    n_points_evaluated: int
    n_chunks_evaluated: int
    n_chunks_skipped: int               # committed before this run
    rounds: int
    stop: str                           # "budget"|"stagnation"|"exhausted"
    elapsed_s: float
    out_dir: Optional[str]
    records: List[Dict]                 # committed rows (this dir)
    frontier: List[Dict]                # pareto over records (+ seed rows)


def explore(spec, out_dir: Optional[str] = None,
            cfg: ExploreConfig = ExploreConfig(),
            resume: bool = False,
            train_records: Optional[Sequence[Mapping]] = None,
            cache=pathfinder.DEFAULT_CACHE,
            verbose: bool = False, device=None) -> ExploreStats:
    """Acquisition-driven search replacing exhaustive enumeration.

    Rounds of: fit the surrogate on every committed row (plus optional
    seed ``train_records``), rank pending chunks by their best label's
    feasibility-weighted acquisition against the current Pareto
    frontier, spend real label-mode `pathfinder.evaluate` calls on the
    top ``batch_chunks``, commit them through the standard
    `ChunkJournal` protocol.  Stops when the eval budget is exhausted,
    the frontier key-set has not changed for ``stagnation`` rounds, or
    the grid runs out.  The output directory is a normal partial sweep
    (same spec head, chunk hashes and commit protocol as `SweepRunner`),
    so resume / `load_sweep` / `cooptimize --from` all apply; pass
    ``resume=True`` to continue an interrupted exploration with zero
    re-evaluation.  Evaluations, the featurizer's hardware and the fits
    run on ``device`` (the card unless the caller asks for ``"cpu"``).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    labels = sweeprunner.enumerate_labels(spec)
    chunks = sweeprunner.make_chunks(labels, spec.chunk_size)
    fp = spec.fingerprint()
    scn = spec.scenario_spec.variants()[0].resolve()
    objectives = tuple(scn.objectives)
    budget = int(cfg.eval_budget) if cfg.eval_budget is not None \
        else max(1, math.ceil(cfg.eval_frac * len(labels)))

    done: Dict[int, str] = {}
    journal: Optional[sweepexec.ChunkJournal] = None
    committed: List[Dict] = []
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        spec_path = os.path.join(out_dir, "spec.json")
        res_path = os.path.join(out_dir, "results.jsonl")
        ckpt_path = os.path.join(out_dir, "checkpoint.jsonl")
        journal = sweepexec.ChunkJournal(res_path, ckpt_path)
        if resume:
            sweepexec.check_fingerprint(spec_path, fp)
            done = journal.load_done(chunks, fp)
            journal.compact(done)
            committed = [{k: v for k, v in r.items() if k != "chunk"}
                         for r in journal.read_records(done)]
        elif os.path.exists(ckpt_path):
            raise FileExistsError(
                f"{out_dir} already holds a checkpointed sweep; pass "
                f"resume=True (CLI: --resume) to continue it, or point "
                f"--out at a fresh directory")
        sweepexec.write_spec_head(spec_path, sweeprunner.SPEC_VERSION, fp,
                                  spec.to_dict())
        journal.open()
    elif resume:
        raise ValueError("resume=True requires an out_dir")

    fz = Featurizer.from_spec(spec, labels, device=dev)
    Xall = fz.transform(spec, labels, dev)
    evaluated = np.zeros(len(labels), dtype=bool)
    spans: Dict[int, slice] = {}
    off = 0
    for c in chunks:
        spans[c.index] = slice(off, off + len(c.labels))
        off += len(c.labels)
    for i in done:
        evaluated[spans[i]] = True

    seed_rows = dedupe_records(train_records or [])
    n_skipped = len(done)
    n_eval_points = 0
    n_eval_chunks = 0
    rounds = 0
    stagnant = 0
    stop = "exhausted"
    prev_front_keys: Optional[frozenset] = None

    def pending() -> List:
        return [c for c in chunks if c.index not in done]

    def run_chunks(batch: Sequence) -> None:
        nonlocal n_eval_points, n_eval_chunks
        for c in batch:
            recs = pathfinder.evaluate(spec=spec, labels=c.labels,
                                       cache=cache, device=dev)
            if journal is not None:
                journal.commit(c.index, c.hash(fp), recs)
            committed.extend(
                {k: v for k, v in r.items() if k != "chunk"}
                for r in recs)
            done[c.index] = c.hash(fp)
            evaluated[spans[c.index]] = True
            n_eval_points += len(recs)
            n_eval_chunks += 1
            if verbose:
                print(f"# explore: chunk {c.index} evaluated "
                      f"({len(recs)} points)", flush=True)

    def train_rows() -> List[Dict]:
        return dedupe_records(committed + seed_rows)

    def spread(cands: Sequence, n: int) -> List:
        if n >= len(cands):
            return list(cands)
        ix = np.unique(np.linspace(0, len(cands) - 1, n).round()
                       .astype(int))
        return [cands[i] for i in ix]

    try:
        # -- seed evaluations: an even spread, only as many as the
        #    training floor demands (seed train_records count toward it)
        while n_eval_points < budget and pending():
            rows = train_rows()
            feasible = sum(
                1 for r in rows
                if sweeprunner.pareto_records([r], objectives))
            if len(rows) >= cfg.min_fit_rows and feasible >= 1:
                break
            want = max(cfg.init_chunks, 1)
            batch = []
            for c in spread(pending(), want):
                if n_eval_points + sum(len(b.labels) for b in batch) \
                        + len(c.labels) > budget:
                    continue        # the budget is a hard ceiling
                batch.append(c)
            if not batch:
                break
            run_chunks(batch)
            if len(train_rows()) == len(rows):
                break                       # nothing new came back: bail

        while pending() and n_eval_points < budget \
                and stagnant < cfg.stagnation:
            rounds += 1
            rows = train_rows()
            model = fit_surrogate(spec, rows, cfg=cfg.surrogate,
                                  featurizer=fz, device=dev)
            front = sweeprunner.pareto_records(rows, objectives)
            fvals = np.asarray(
                [[float(r[o]) for o in objectives] for r in front],
                dtype=np.float64).reshape(len(front), len(objectives))
            mask = ~evaluated
            mu, sigma, p = predict(model, Xall[mask])
            if not len(front):
                # no feasible point yet: the frontier acquisitions are
                # degenerate, so chase predicted feasibility instead
                acq = p.copy()
            elif cfg.acquisition == "epi":
                acq = epi_acquisition(mu, sigma, fvals, model.signs)
            else:
                acq = ucb_acquisition(mu, sigma, fvals, model.signs,
                                      kappa=cfg.kappa)
            if len(front):
                acq = feasibility_weighted(acq, p)
            scores = np.full(len(labels), -np.inf)
            scores[mask] = acq
            ranked = sweeprunner.order_chunks(
                pending(), chunk_scores(chunks, scores))
            batch = []
            points = 0
            for c in ranked:
                if len(batch) >= cfg.batch_chunks:
                    break
                if n_eval_points + points + len(c.labels) > budget \
                        and batch:
                    break
                batch.append(c)
                points += len(c.labels)
            if not batch or n_eval_points + len(batch[0].labels) > budget:
                stop = "budget"
                break
            run_chunks(batch)
            keys = frozenset(
                r.get("key") for r in sweeprunner.pareto_records(
                    train_rows(), objectives))
            if prev_front_keys is not None and keys == prev_front_keys:
                stagnant += 1
            else:
                stagnant = 0
            prev_front_keys = keys
            if verbose:
                print(f"# explore: round {rounds} -> "
                      f"{n_eval_points}/{budget} points, frontier "
                      f"{len(keys)} keys, stagnant {stagnant}",
                      flush=True)
        if stagnant >= cfg.stagnation:
            stop = "stagnation"
        elif not pending():
            stop = "exhausted"
        elif stop != "budget" and n_eval_points >= budget:
            stop = "budget"
    finally:
        if journal is not None:
            journal.close()

    frontier = sweeprunner.pareto_records(train_rows(), objectives)
    return ExploreStats(
        objectives=objectives, n_points_total=len(labels),
        n_chunks_total=len(chunks), n_points_evaluated=n_eval_points,
        n_chunks_evaluated=n_eval_chunks, n_chunks_skipped=n_skipped,
        rounds=rounds, stop=stop, elapsed_s=time.perf_counter() - t0,
        out_dir=out_dir, records=committed, frontier=frontier)


# ---------------------------------------------------------------------------
# Fabric work order (surrogate-guided lease-queue priority)
# ---------------------------------------------------------------------------


def rank_chunks(spec, records: Sequence[Mapping],
                cfg: ExploreConfig = ExploreConfig(),
                device=None) -> List[int]:
    """Acquisition-ranked chunk indices of ``spec`` (best first), from
    already-scored records — the input to `sweepfabric.write_chunk_order`.
    Every chunk ranks (a fabric serves the full enumeration regardless);
    the order only decides what the fleet's first minutes are spent on.
    The fit runs on ``device`` (the card unless the caller asks for
    ``"cpu"``).
    """
    dev = resolve_device(device)
    labels = sweeprunner.enumerate_labels(spec)
    chunks = sweeprunner.make_chunks(labels, spec.chunk_size)
    fz = Featurizer.from_spec(spec, labels, device=dev)
    rows = dedupe_records(records)
    scn = spec.scenario_spec.variants()[0].resolve()
    objectives = tuple(scn.objectives)
    model = fit_surrogate(spec, rows, cfg=cfg.surrogate, featurizer=fz,
                          device=dev)
    front = sweeprunner.pareto_records(rows, objectives)
    fvals = np.asarray(
        [[float(r[o]) for o in objectives] for r in front],
        dtype=np.float64).reshape(len(front), len(objectives))
    mu, sigma, p = predict(model, fz.transform(spec, labels, dev))
    if cfg.acquisition == "epi":
        acq = epi_acquisition(mu, sigma, fvals, model.signs)
    else:
        acq = ucb_acquisition(mu, sigma, fvals, model.signs,
                              kappa=cfg.kappa)
    acq = feasibility_weighted(acq, p)
    ordered = sweeprunner.order_chunks(chunks, chunk_scores(chunks, acq))
    return [c.index for c in ordered]


def order_fabric_dir(fabric_dir: str, records: Sequence[Mapping],
                     cfg: ExploreConfig = ExploreConfig(),
                     device=None) -> List[int]:
    """Rank an initialized fabric directory's chunks and write its
    ``order.json`` (advisory, fingerprint-guarded, schedule-only — see
    `sweepfabric.write_chunk_order`).  Returns the written order."""
    from repro_torch.core import sweepfabric
    spec, _ = sweepfabric.load_dir(fabric_dir)
    order = rank_chunks(spec, records, cfg=cfg, device=device)
    sweepfabric.write_chunk_order(fabric_dir, order, spec.fingerprint())
    return order


__all__ = [
    "Dataset", "ExploreConfig", "ExploreStats", "Featurizer",
    "SurrogateConfig", "SurrogateModel", "build_dataset", "chunk_scores",
    "dedupe_records", "dominance_margin", "epi_acquisition", "explore",
    "feasibility_weighted", "fit_surrogate", "load_training_records",
    "order_fabric_dir", "predict", "rank_chunks", "ucb_acquisition",
]
