"""Checkpoints in the JAX package's format (``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
