"""repro_torch.checkpoint — async, atomic, keep-N checkpoints in the
reference's on-disk layout, as ``repro.checkpoint``."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
