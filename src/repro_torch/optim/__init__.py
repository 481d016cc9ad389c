"""The reference's AdamW, written out by hand (``torch.optim.AdamW``
differs from it)."""
from .adamw import OptState, adamw_init, adamw_update

__all__ = ["OptState", "adamw_init", "adamw_update"]
