"""repro_torch.core — CrossFlow (the paper's performance model) in PyTorch.

    techlib     technology components library          (paper §4.1)
    age         micro-architecture generator engine    (paper §4.2-4.4)
    graph       compute-graph IR                       (paper §3, §5)
    lmgraph     arch config x shape cell -> compute graph
    parallelism strategy space                         (paper §3.3)
    transform   super-graph transformation             (paper §5.1)
    placement   device mapping + routing               (paper §5.2)
    roofline    hierarchical roofline PPE              (paper §6.1-6.4)
    simulate    event-driven end-to-end estimation     (paper §6.5) + predict()
    pathfinder  batched evaluation (torch.func.vmap over predict), the
                prediction cache, Pareto front, in-memory sweep
    planner     CrossFlow -> runtime: the sharding plan for a mesh
    scenarios   the scenario registry: memory accounting, eval points,
                record, metrics, refine and frontier folds
    sweepexec   the JSONL reader/writer pair of the record files, the
                chunk journal, the frontier-state checkpoints
    sweeprunner the chunked, resumable sweep runner and its backends
    sweeppipeline  the pipelined executor (the runner's default) and the
                device-resident streaming frontier
    soe, cooptimize  DeepFlow's search: eq.-6 descent, sweep -> refine
    tensors     float32 scalar helpers mirroring jax.numpy's weak typing
"""

from repro_torch.core import age, graph, lmgraph, parallelism, pathfinder, \
    placement, planner, roofline, scenarios, simulate, sweepexec, techlib, transform
from repro_torch.core.age import Budgets, MicroArch
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy
from repro_torch.core.simulate import predict
