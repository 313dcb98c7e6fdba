"""Checkpoints in the reference's on-disk format: sharded npz, a
manifest with checksums, a COMMIT marker, async saves and retention."""
from .ckpt import (CheckpointManager, latest_step, restore_checkpoint,
                   save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
