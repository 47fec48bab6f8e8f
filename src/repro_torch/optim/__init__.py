"""Optimizer substrate: schedules and composable transforms over
``core.frodo``, the port of the JAX package's ``repro.optim``."""
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)
from repro_torch.optim.transforms import (add_decoupled_weight_decay, chain,
                                          default_decay_mask,
                                          scale_by_schedule)

__all__ = ["constant", "linear_warmup", "cosine_decay", "warmup_cosine",
           "scale_by_schedule", "add_decoupled_weight_decay", "chain",
           "default_decay_mask"]
