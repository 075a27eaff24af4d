"""Checkpoints of the port: save / restore trees of tensors (parameters,
optimizer state) in the JAX package's format, with a step-driven manager
that saves in the background and resumes."""

from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_tree, save_tree)

__all__ = ["CheckpointManager", "latest_step", "restore_tree", "save_tree"]
