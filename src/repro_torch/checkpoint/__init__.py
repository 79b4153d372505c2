"""Checkpoint substrate: the atomic, async, verified ``CheckpointManager``,
on the reference's on-disk layout."""

from .manager import BackgroundJob, CheckpointCorruptError, CheckpointManager  # noqa: F401
