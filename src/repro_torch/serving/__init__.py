"""Serving: continuous batching over a request queue on a paged KV pool.

  * :mod:`.queue`   — requests, admission control, lifecycle events.
  * :mod:`.pages`   — the paged-KV allocator (physical pages, trash page 0).
  * :mod:`.batcher` — fixed-slot continuous batcher with stacked prefill.
  * :mod:`.mix`     — the live request mix, bucketized, and its planner tower.
  * :mod:`.session` — :class:`ServingSession`: admit → decode → evict →
    replan on mix shifts.
"""

from .batcher import ContinuousBatcher, SlotState
from .mix import DEFAULT_PROMPT_BUCKETS, MixSnapshot, MixTracker, prompt_bucket
from .pages import PagePool, pages_needed
from .queue import Request, RequestQueue
from .session import RequestResult, ServingConfig, ServingSession

__all__ = [
    "ContinuousBatcher",
    "SlotState",
    "PagePool",
    "pages_needed",
    "DEFAULT_PROMPT_BUCKETS",
    "MixSnapshot",
    "MixTracker",
    "prompt_bucket",
    "Request",
    "RequestQueue",
    "RequestResult",
    "ServingConfig",
    "ServingSession",
]
