"""repro_torch.data — the synthetic data pipeline, as ``repro.data``."""

from repro_torch.data.pipeline import DataConfig, PrefetchIterator, \
    synth_batch

__all__ = ["DataConfig", "PrefetchIterator", "synth_batch"]
