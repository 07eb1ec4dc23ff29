"""Checkpoints in the JAX package's on-disk layout (``checkpointer.py``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer, treedef_str

__all__ = ["Checkpointer", "treedef_str"]
