"""Atomic keep-k async checkpointing, in the JAX package's on-disk format."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore, save)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
