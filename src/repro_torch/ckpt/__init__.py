"""Checkpoint store (port of ``repro.ckpt``)."""
from repro_torch.ckpt.store import CheckpointStore

__all__ = ["CheckpointStore"]
