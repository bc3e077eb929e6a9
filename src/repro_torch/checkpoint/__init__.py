"""Checkpoints of the port's training state (port of `repro/checkpoint`)."""
from .manager import CheckpointManager, save_pytree, load_pytree
