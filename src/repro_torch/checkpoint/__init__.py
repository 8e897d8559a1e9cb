"""Atomic, async, keep-N checkpoints in the JAX package's on-disk layout."""

from repro_torch.checkpoint.manager import (COMMIT, CheckpointManager,
                                            latest_step, restore, save)

__all__ = ["COMMIT", "CheckpointManager", "latest_step", "restore", "save"]
