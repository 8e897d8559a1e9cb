"""Optimizers, schedules and gradient compression for training, as the JAX
package's ``repro.optim`` writes them."""

from repro_torch.optim.optimizers import (Optimizer, adamw, adafactor, sgd,
                                          clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.compression import compress_int8, decompress_int8

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine", "compress_int8",
           "decompress_int8"]
