"""``repro_torch.checkpoint`` — snapshots of a run's global state on disk
(port of ``repro.checkpoint``; layout in ``checkpointer``)."""
from repro_torch.checkpoint.checkpointer import (
    CheckpointStats,
    Checkpointer,
    global_stats,
)

__all__ = ["CheckpointStats", "Checkpointer", "global_stats"]
