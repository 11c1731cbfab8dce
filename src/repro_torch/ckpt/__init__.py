"""Checkpointing, re-mesh restore and straggler mitigation (port of
``repro.ckpt``): a restore places onto devices or onto a mesh of ranks
(a distributed session's straggler re-mesh restores onto its new live
mesh), and the timing collector gathers over the ranks."""

from .async_snap import AsyncCheckpointManager
from .checkpoint import (
    CheckpointManager,
    all_steps,
    latest_step,
    load_shard_group,
    restore_checkpoint,
    save_checkpoint,
)
from .remesh import reshard, restore_to_mesh
from .straggler import StragglerDetector, TimingCollector

__all__ = [
    "AsyncCheckpointManager",
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "load_shard_group",
    "all_steps",
    "latest_step",
    "reshard",
    "restore_to_mesh",
    "StragglerDetector",
    "TimingCollector",
]
