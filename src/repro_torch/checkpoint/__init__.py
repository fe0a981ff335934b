"""Checkpointing (port of `repro.checkpoint`): atomic, checksummed,
keep-last-k snapshots of the port's trees of tensors."""
from .checkpointer import CheckpointCorruption, Checkpointer

__all__ = ["CheckpointCorruption", "Checkpointer"]
