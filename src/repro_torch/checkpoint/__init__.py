"""Atomic checkpoints (port of ``repro.checkpoint``), in the reference's
on-disk format."""
from .checkpoint import (CheckpointCorruptError, available_steps,
                         latest_step, load_checkpoint_arrays,
                         restore_checkpoint, save_checkpoint)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "available_steps", "load_checkpoint_arrays", "CheckpointCorruptError",
]
