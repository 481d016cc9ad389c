"""Checkpoints of parameter trees, in the reference package's layout: either
package restores the other's."""
from .ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
