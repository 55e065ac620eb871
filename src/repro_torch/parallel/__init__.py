"""repro_torch.parallel — the runtime's parallelism, as ``repro.parallel``.

  sharding.py     the planner's logical-axis rules -> DTensor placements
                  for parameters, moments, inputs and caches
  collectives.py  the bucketed all-reduce (per dtype) and the mean
                  all-reduce
  pipeline.py     GPipe over a mesh's ``stage`` axis (point-to-point
                  sends of activations between neighbouring stages)
"""

import contextlib


@contextlib.contextmanager
def replicating(active: bool = True):
    """DTensor's implicit replication (plain tensors act as replicated
    DTensors) while ``active``, restored to what it was on exit, so it
    nests: ``implicit_replication()`` itself switches it off on any exit,
    and the train step's backward runs after the model's forward has left
    its own."""
    if not active:
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
