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
    scenarios   memory accounting (kv_cache_bytes; the folds come later)
    sweepexec   the JSONL reader/writer pair of the record files
    tensors     float32 scalar helpers mirroring jax.numpy's weak typing

The rest of the DeepFlow search layers (soe, the sweep runner,
cooptimize) come with later slices of the port.
"""

from repro_torch.core import age, graph, lmgraph, parallelism, pathfinder, \
    placement, planner, roofline, scenarios, simulate, sweepexec, techlib, transform
from repro_torch.core.age import Budgets, MicroArch
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.parallelism import Strategy
from repro_torch.core.simulate import predict
