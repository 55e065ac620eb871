"""Search and Optimization Engine (DeepFlow paper §7), PyTorch port.

Finds the budget breakdown W* = {A_i, P_i, R_i} minimizing predicted
iteration time f(W), subject to ΣA_i <= 1, ΣP_i <= 1, ΣR_i <= 1, with the
paper's update rule (eq. 6):

    W_t   = W_{t-1} - η g_t
    Ŵ_t   = W_t / ||W_t||
    M_t   = β M_{t-1} + (1-β) Ŵ_t          (exponential averaging in
    W_t   = Project(M_t) onto C_A, C_P, C_R  parameter space, not gradients)

multi-start (S starting points), T max steps (paper: T=100, S=10).

The objective is the *differentiable* CrossFlow path (AGE with
discrete=False + roofline + fixed-order event sim), so g_t is an exact
gradient — the paper treats CrossFlow as a black box.  A finite-difference
fallback (``grad_mode="fd"``) reproduces the paper's setup exactly.

In "auto" grad mode all S starting points advance together: one
``torch.func.vmap(torch.func.grad_and_value(f))`` and one vectorized eq.-6
update per step, on the device the caller names (the card unless it asks
for ``"cpu"``).  An objective that ``torch.func`` cannot transform (it
reads a value on the host, or branches on one) falls back to the
sequential FD loop, as the reference falls back for a non-traceable one.

The discrete parallelism-strategy dimension is co-optimized by exhaustive
enumeration around the GD loop (`co_optimize`), matching the paper's §9.2
"parallelism-strategy + architecture" studies; strategy ranking goes
through the batched evaluator's prediction cache.  One-shot batched budget
scans (no GD) go through `pathfinder.evaluate_budgets`.

The starts are drawn from ``np.random.default_rng(cfg.seed)``, the
reference's stream, so both packages start from the same W.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import age as age_lib
from repro_torch.core import simulate
from repro_torch.core.age import Budgets, COMPONENTS, PERIM_COMPONENTS
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy, enumerate_strategies
from repro_torch.core.placement import SystemGraph
from repro_torch.core.roofline import PPEConfig
from repro_torch.core.techlib import TechConfig
from repro_torch.core.tensors import F32, as_f32, div, maximum

_NC = len(COMPONENTS)
_NP = len(PERIM_COMPONENTS)
_DIM = 2 * _NC + _NP


@dataclasses.dataclass
class SOEConfig:
    lr: float = 0.05
    beta: float = 0.7               # momentum / EMA discount (paper eq. 6)
    steps: int = 100                # T (paper: 100)
    starts: int = 10                # S (paper: 10)
    seed: int = 0
    grad_mode: str = "auto"         # "auto" (batched autograd) | "fd" (paper)
    fd_eps: float = 1e-3
    min_frac: float = 1e-3


@dataclasses.dataclass
class SOEResult:
    budgets: Budgets
    time_s: float
    strategy: Optional[Strategy]
    history: List[float]
    n_queries: int


def _project_simplexes(w: torch.Tensor, min_frac: float) -> torch.Tensor:
    """Project each constraint group (area, power, perimeter) of the last
    axis onto {x >= min_frac, Σx <= 1} — scale-down projection (budgets
    may be under-used, never over-used).  ``w`` is one (DIM,) vector or an
    (S, DIM) stack, each row projected on its own."""
    def proj(seg):
        seg = maximum(seg, min_frac)
        total = torch.sum(seg, dim=-1, keepdim=True)
        n = seg.shape[-1]
        # scale only the mass above the floor so the floor is preserved
        # (and the projection is idempotent)
        alpha = div(1.0 - n * min_frac, maximum(total - n * min_frac,
                                                1e-12))
        scaled = min_frac + (seg - min_frac) * alpha
        return torch.where(total > 1.0, scaled, seg)
    a, p, r = w[..., :_NC], w[..., _NC:2 * _NC], w[..., 2 * _NC:]
    return torch.cat([proj(a), proj(p), proj(r)], dim=-1)


def eq6_update(W: torch.Tensor, M: torch.Tensor, G: torch.Tensor, lr: float,
               beta: float, project: Callable
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched eq.-6 step: normalized-gradient descent, W-space
    normalization, parameter-space EMA, projection.

    ``W``, ``M``, ``G`` are (S, D) stacks (S starts advancing together);
    ``project`` maps an (S, D) parameter stack onto the constraint set.
    Returns (projected parameters, new EMA state).  Shared by both SOE
    optimization paths and by the cross-stack refinement engine
    (`repro_torch.core.cooptimize`), which applies it to the budget block
    of its joint (budget, technology-knob) parameter vector.
    """
    G = torch.nan_to_num(G, nan=0.0, posinf=0.0, neginf=0.0)
    gnorm = torch.linalg.vector_norm(G, dim=1, keepdim=True)
    G = torch.where(gnorm > 0, G / (gnorm + 1e-12), G)
    W_new = W - lr * G                                   # W_t = W_{t-1} - η g
    W_hat = W_new / (torch.linalg.vector_norm(W_new, dim=1, keepdim=True)
                     + 1e-12)
    M_new = beta * M + (1.0 - beta) * W_hat              # EMA in W-space
    return project(M_new), M_new


def make_objective(tech: TechConfig, graph: ComputeGraph, strategy: Strategy,
                   system: Optional[SystemGraph] = None,
                   template: Optional[Budgets] = None,
                   ppe: PPEConfig = PPEConfig(),
                   pod_bw: Optional[float] = None) -> Callable:
    """f(W) -> predicted iteration time: a differentiable float32 0-d
    tensor on W's device."""
    like = template or Budgets.default()

    def f(w: torch.Tensor):
        budgets = Budgets.from_vector(w, like)
        arch = age_lib.generate(tech, budgets, discrete=False)
        bd = simulate.predict(arch, graph, strategy, system=system, cfg=ppe,
                              pod_bw=pod_bw)
        return as_f32(bd.total_s, w.device)

    return f


def _initial_starts(cfg: SOEConfig, like: Budgets,
                    device=None) -> List[torch.Tensor]:
    """Start 0 is the template; the rest Dirichlet draws.  Every start is
    routed through `_project_simplexes` — a raw Dirichlet draw sums to 1
    but its smallest components routinely sit below the `min_frac` floor
    the iterates are projected onto, so unprojected starts would begin
    outside the constraint set start 0 is in."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    starts = [like.as_vector(dev)]
    for _ in range(1, cfg.starts):
        starts.append(torch.tensor(rng.dirichlet(np.ones(_NC)).tolist()
                                   + rng.dirichlet(np.ones(_NC)).tolist()
                                   + rng.dirichlet(np.ones(_NP)).tolist(),
                                   dtype=F32, device=dev))
    return [_project_simplexes(w, cfg.min_frac) for w in starts]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _optimize_sequential(objective: Callable, cfg: SOEConfig, like: Budgets,
                         on_step: Optional[Callable] = None,
                         device=None) -> SOEResult:
    """One start at a time with the paper-style FD gradient: the path of
    ``grad_mode="fd"`` and of arbitrary (non-traceable) objectives."""
    n_queries = 0

    def grad_fn(w):
        nonlocal n_queries
        base = float(objective(w))
        g = np.zeros(_DIM, dtype=np.float32)
        for i in range(_DIM):
            wp = _host(w).copy()
            wp[i] += cfg.fd_eps
            g[i] = (float(objective(torch.as_tensor(wp, device=w.device)))
                    - base) / cfg.fd_eps
            n_queries += 1
        return torch.as_tensor(g, device=w.device), base

    project = functools.partial(_project_simplexes, min_frac=cfg.min_frac)
    best_w, best_t, history = None, math.inf, []
    for w in _initial_starts(cfg, like, device):
        m = w
        last = math.inf
        for t in range(cfg.steps):
            g, val = grad_fn(w)
            history.append(val)
            if val < best_t:
                best_t, best_w = val, w
            W, M = eq6_update(w[None, :], m[None, :], g[None, :],
                              cfg.lr, cfg.beta, project)
            w, m = W[0], M[0]
            if on_step is not None:
                on_step(t, _host(W))
            if abs(last - val) < 1e-7 * max(val, 1e-12):
                break
            last = val
    final_t = float(objective(best_w))
    if final_t < best_t:
        best_t = final_t
    return SOEResult(budgets=Budgets.from_vector(_host(best_w), like),
                     time_s=float(best_t), strategy=None,
                     history=history, n_queries=n_queries)


def _optimize_batched(objective: Callable, cfg: SOEConfig, like: Budgets,
                      on_step: Optional[Callable] = None,
                      device=None) -> SOEResult:
    """All S starting points advance together: one vmapped value and
    gradient plus one vectorized eq.-6 update per step.  Converged starts
    are frozen by mask so per-start early stopping matches the sequential
    semantics."""
    W = torch.stack(_initial_starts(cfg, like, device))     # (S, DIM)
    vg = torch.func.vmap(torch.func.grad_and_value(objective))
    proj = functools.partial(_project_simplexes, min_frac=cfg.min_frac)
    lr, beta = cfg.lr, cfg.beta

    def step(W, M, done, last):
        G, vals = vg(W)
        W_proj, M_new = eq6_update(W, M, G, lr, beta, proj)
        conv = torch.abs(last - vals) < 1e-7 * maximum(vals, 1e-12)
        frozen = done[:, None]
        W_out = torch.where(frozen, W, W_proj)
        M_out = torch.where(frozen, M, M_new)
        return W_out, M_out, done | conv, vals

    M = W
    done = torch.zeros(cfg.starts, dtype=torch.bool, device=W.device)
    last = torch.full((cfg.starts,), math.inf, dtype=F32, device=W.device)
    done_np = np.zeros(cfg.starts, dtype=bool)
    history: List[float] = []
    best_w, best_t = None, math.inf
    n_queries = 0
    for t in range(cfg.steps):
        if bool(np.all(done_np)):
            break
        # the vmapped value and gradient evaluate ALL S starts every step
        # (the done mask only freezes state), so every step costs S queries
        n_queries += cfg.starts
        W_before = W
        W, M, done, vals = step(W, M, done, last)
        if on_step is not None:
            on_step(t, _host(W))
        # values and the done mask cross to the host in one copy
        host = _host(torch.stack([vals.to(torch.float64),
                                  done.to(torch.float64)]))
        vals_np, done_np = host[0], host[1] > 0
        history.extend(float(v) for v in vals_np)
        # nan-safe argmin: one diverged start (nan objective) must not
        # blind the best-so-far tracking for the healthy starts
        finite = np.where(np.isfinite(vals_np), vals_np, np.inf)
        i = int(np.argmin(finite))
        if finite[i] < best_t:
            best_t, best_w = float(finite[i]), W_before[i]
        last = vals
    final_t = float(objective(best_w))
    if final_t < best_t:
        best_t = final_t
    return SOEResult(budgets=Budgets.from_vector(_host(best_w), like),
                     time_s=float(best_t), strategy=None,
                     history=history, n_queries=n_queries)


# What ``torch.func`` raises for an objective it cannot transform: a value
# read on the host (``float``, ``.item()``, ``numpy()``) or Python control
# flow on a tensor — the reference's ``TracerArrayConversionError`` and
# ``ConcretizationTypeError`` — or an objective that returns no scalar
# tensor.  Matched by message: any other RuntimeError (a CUDA error, an
# out-of-memory, a fault of the model) propagates.
_UNTRACEABLE = (
    "vmap: It looks like you're",
    "Can't call numpy() on Tensor that requires grad",
    "Cannot access data pointer of Tensor that doesn't have storage",
    "grad_and_value(f)(*args): Expected f(*args) to return",
)


def untraceable(err: BaseException) -> bool:
    """True when ``err`` is ``torch.func`` refusing an objective that reads
    or branches on a value (see `_UNTRACEABLE`), or a TypeError (the
    reference falls back on those too)."""
    if isinstance(err, TypeError):
        return True
    return (type(err) is RuntimeError
            and str(err).startswith(_UNTRACEABLE))


def optimize(objective: Callable, cfg: SOEConfig = SOEConfig(),
             template: Optional[Budgets] = None,
             on_step: Optional[Callable] = None, device=None) -> SOEResult:
    """Projected GD with parameter-space exponential averaging (eq. 6).

    grad_mode="auto" runs the batched multi-start path (one vmapped update
    advances every start); "fd" or an objective ``torch.func`` cannot
    transform falls back to the sequential paper-style loop.  ``on_step(t,
    W)`` (host-side, W an (S, DIM) np array of the post-projection
    iterates) is invoked after every update.  The starts live on
    ``device``, the card unless the caller asks for ``"cpu"``.
    """
    like = template or Budgets.default()
    dev = resolve_device(device)
    if cfg.grad_mode == "fd":
        return _optimize_sequential(objective, cfg, like, on_step=on_step,
                                    device=dev)
    try:
        return _optimize_batched(objective, cfg, like, on_step=on_step,
                                 device=dev)
    except (RuntimeError, TypeError) as err:
        if not untraceable(err):
            raise
    # objective not transformable (true black box): paper-style FD loop
    return _optimize_sequential(objective, cfg, like, on_step=on_step,
                                device=dev)


def rank_strategies(tech: TechConfig, graph: ComputeGraph,
                    strategies: Sequence[Strategy],
                    system: Optional[SystemGraph] = None,
                    template: Optional[Budgets] = None,
                    ppe: PPEConfig = PPEConfig(),
                    device=None) -> List[Tuple[float, Strategy]]:
    """Score every strategy on the template budgets, cheapest first.

    Scoring goes through the batched pathfinding engine (one evaluation per
    graph/strategy skeleton, with the process-wide prediction cache), on
    ``device``, the card unless the caller asks for ``"cpu"``.
    """
    from repro_torch.core import pathfinder   # lazy: pathfinder imports us
    like = template or Budgets.default()
    # exactly the arch the per-point objective f(like.as_vector()) builds
    budgets = Budgets.from_vector(like.as_vector(resolve_device(device)),
                                  like)
    arch = age_lib.generate(tech, budgets, discrete=False)
    points = [pathfinder.EvalPoint(arch, graph, st, system=system)
              for st in strategies]
    rows = pathfinder.evaluate(points=points, ppe=ppe)
    ranked = [(float(rows[i, 0]), st) for i, st in enumerate(strategies)]
    ranked.sort(key=lambda x: x[0])
    return ranked


def co_optimize(tech: TechConfig, graph: ComputeGraph, n_devices: int,
                system: Optional[SystemGraph] = None,
                cfg: SOEConfig = SOEConfig(),
                template: Optional[Budgets] = None,
                strategies: Optional[Sequence[Strategy]] = None,
                max_strategies: int = 24,
                search_arch: bool = True,
                ppe: PPEConfig = PPEConfig(), device=None) -> SOEResult:
    """Joint (parallelism strategy x hardware budget) search (paper §9.2).

    With search_arch=False only the strategy is optimized on the template
    budgets (the paper's "parallelism strategy optimization alone"
    baseline).  Runs on ``device``, the card unless the caller asks for
    ``"cpu"``.
    """
    like = template or Budgets.default()
    dev = resolve_device(device)
    if strategies is None:
        strategies = list(enumerate_strategies(n_devices, max_lp=4))
    # rank strategies on template budgets, then refine the top few
    ranked = rank_strategies(tech, graph, strategies, system=system,
                             template=like, ppe=ppe, device=dev)
    if not search_arch:
        t, st = ranked[0]
        return SOEResult(budgets=like, time_s=t, strategy=st, history=[],
                         n_queries=len(ranked))
    best: Optional[SOEResult] = None
    for t0, st in ranked[:max(1, max_strategies // 8)]:
        f = make_objective(tech, graph, st, system=system, template=like,
                           ppe=ppe)
        res = optimize(f, cfg=cfg, template=like, device=dev)
        res = dataclasses.replace(res, strategy=st)
        if best is None or res.time_s < best.time_s:
            best = res
    assert best is not None
    return best
