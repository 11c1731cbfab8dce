"""Straggler detection (port of ``repro.ckpt.straggler``).  Checkpoints,
asynchronous snapshots and elastic re-mesh restores come with multi-GPU
runs and checkpoints (ROADMAP queue 1, item 5)."""

from .straggler import StragglerDetector, TimingCollector

__all__ = ["StragglerDetector", "TimingCollector"]
