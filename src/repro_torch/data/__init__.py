"""Deterministic synthetic data pipeline (multi-task, multi-modal)."""

from .pipeline import DataConfig, MultiTaskMixture, SyntheticLM, TaskStream

__all__ = ["DataConfig", "SyntheticLM", "TaskStream", "MultiTaskMixture"]
