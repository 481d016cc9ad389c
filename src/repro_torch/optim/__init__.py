"""The reference's AdamW, written out by hand (``torch.optim.AdamW``
differs from it), and its learning-rate schedules."""
from .adamw import OptState, adamw_init, adamw_update, adamw_update_
from .schedules import (Schedule, constant_schedule, cosine_schedule,
                        linear_warmup_cosine)

__all__ = ["OptState", "adamw_init", "adamw_update", "adamw_update_",
           "Schedule", "constant_schedule", "cosine_schedule",
           "linear_warmup_cosine"]
