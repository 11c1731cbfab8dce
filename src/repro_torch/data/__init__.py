"""Deterministic synthetic data pipeline (multi-task, multi-modal)."""

from .pipeline import (DataConfig, MultiTaskMixture, SyntheticLM, TaskStream,
                       shard_batch)

__all__ = ["DataConfig", "SyntheticLM", "TaskStream", "MultiTaskMixture",
           "shard_batch"]
