"""Straggler detection: per-host step-time ring buffer + re-plan trigger
(port of ``repro/ckpt/straggler.py``).

The detector keeps a ring buffer of per-host step times and flags hosts
whose median exceeds the cluster median by ``threshold``×.
:class:`repro_torch.launch.events.StragglerEventSource` wraps it as a
session event source, so a :class:`repro_torch.session.SpindleSession`
drains it each step and a ``StragglerDetected`` event replans.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def world_size() -> int:
    """Processes of the ``torch.distributed`` group (1 without one)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


@dataclass
class StragglerDetector:
    n_hosts: int
    window: int = 32  # ring buffer length (steps)
    threshold: float = 1.5  # flag hosts slower than threshold × cluster median
    min_samples: int = 8
    on_straggler: Optional[Callable[[List[int]], None]] = None

    _times: Dict[int, collections.deque] = field(default_factory=dict)

    def __post_init__(self):
        self._times = {
            h: collections.deque(maxlen=self.window) for h in range(self.n_hosts)
        }

    def record(self, host: int, step_seconds: float) -> None:
        self._times[host].append(step_seconds)

    def record_all(self, step_seconds: Sequence[float]) -> None:
        for h, t in enumerate(step_seconds):
            self.record(h, t)

    def medians(self) -> Dict[int, float]:
        return {
            h: float(np.median(buf)) if len(buf) >= self.min_samples else float("nan")
            for h, buf in self._times.items()
        }

    def stragglers(self) -> List[int]:
        med = self.medians()
        vals = [v for v in med.values() if v == v]  # drop NaN
        if len(vals) < max(2, self.n_hosts // 2):
            return []
        cluster = float(np.median(vals))
        return [h for h, v in med.items() if v == v and v > self.threshold * cluster]

    def check(self) -> List[int]:
        s = self.stragglers()
        if s and self.on_straggler is not None:
            self.on_straggler(s)
        return s


@dataclass
class TimingCollector:
    """Aggregated per-host timing stream for the detector (rank-0 pattern).

    The detector compares per-host medians, so it can flag only when one
    instance sees every host's times.  Each process contributes its local
    step time through :meth:`gather`:

    * **multi-process** (a ``torch.distributed`` group of more than one
      process) — the local time is all-gathered over the world and only
      rank 0 receives the per-host vector (its first ``n_hosts``
      entries); every other rank gets ``None`` and feeds nothing, so
      exactly one detector flags;
    * **in-process** — the caller IS every host: the local time once per
      host, scaled by ``skew`` (host index → step-time multiplier), so a
      deterministic degradation can be injected.

    This aggregates the observations; a distributed
    :class:`repro_torch.session.SpindleSession` then broadcasts rank 0's
    events to every rank before anyone replans (``SpindleSession.poll``).
    """

    n_hosts: int
    skew: Dict[int, float] = field(default_factory=dict)

    def gather(self, local_seconds: float) -> Optional[List[float]]:
        if world_size() > 1:
            dist = torch.distributed
            dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
            mine = torch.tensor([local_seconds], dtype=torch.float32,
                                device=dev)
            parts = [torch.empty_like(mine)
                     for _ in range(dist.get_world_size())]
            dist.all_gather(parts, mine)
            if dist.get_rank() != 0:
                return None  # rank-0 collector: only one detector feed
            return [float(t) for t in torch.cat(parts)[:self.n_hosts].cpu()]
        return [local_seconds * self.skew.get(h, 1.0)
                for h in range(self.n_hosts)]
