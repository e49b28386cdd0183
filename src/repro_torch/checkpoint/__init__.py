"""Atomic checkpoints in the reference's on-disk format."""
from .store import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, list_steps,
)
