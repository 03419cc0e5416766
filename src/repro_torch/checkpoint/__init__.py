"""Checkpoints of the port's state: npz payload + JSON manifest."""
from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
