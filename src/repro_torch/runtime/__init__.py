"""repro_torch.runtime — int8 gradient compression with error feedback and
the fault-tolerance runtime, as ``repro.runtime``."""

from repro_torch.runtime.compression import compress, compression_ratio, \
    decompress, init_error_state
from repro_torch.runtime.fault import PreemptionHandler, StragglerWatchdog, \
    elastic_plan

__all__ = ["PreemptionHandler", "StragglerWatchdog", "compress",
           "compression_ratio", "decompress", "elastic_plan",
           "init_error_state"]
