"""repro_torch.optim — AdamW on trees (nested dicts) of tensors, as
``repro.optim``."""

from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply, \
    global_norm, init, schedule

__all__ = ["AdamWConfig", "AdamWState", "apply", "global_norm", "init",
           "schedule"]
