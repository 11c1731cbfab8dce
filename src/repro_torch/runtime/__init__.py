"""Executable MT MM models and the wave engine that runs a plan on them
(port of ``repro.runtime``, single process)."""

from .engine import WaveEngine
from .mtmodel import (ExecComponent, ExecFlow, MTModel, tiny_multitask_clip,
                      tiny_ofasys)

__all__ = ["ExecComponent", "ExecFlow", "MTModel", "WaveEngine",
           "tiny_multitask_clip", "tiny_ofasys"]
