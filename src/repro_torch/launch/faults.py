"""Fault injection: hard host failures and transient flaps as events (port
of ``repro/launch/faults.py``: one seed gives the same trace in both
packages).

:class:`FaultInjector` is an :class:`~repro_torch.launch.events.EventSource`
that simulates both the fault *and* the failure detector in one place,
on the same seam :class:`~repro_torch.launch.events.ScriptedEventSource` uses:
the 0-based poll index is the step counter (a session polls its sources
once per training step), so ``FaultScript(step=4, hosts=(1,))`` kills
host 1 after step 4, exactly like ``fire_at=[4]``.

Two failure classes:

  * **Hard kill** (``down_for=None``): the host's runtime connection
    died — unambiguous, reported as :class:`HostFailed` immediately.
    Device state on the host is gone; the session rolls back to the last
    durable snapshot and replays.
  * **Transient flap** (``down_for=k``): the host merely stops
    heartbeating for ``k`` polls.  A missed heartbeat is NOT a failure:
    the host gets a bounded retry window (``retry_window`` extra polls)
    before it is reported dead, so short blips never trigger a rollback.
    A flapped host that outlives the window is evicted like a hard
    failure (``transient=True``); when it heartbeats again the injector
    re-fires with the smaller dead set and the session restores it via
    the existing ``ClusterSpec.restore`` path.

Faults are scripted (a ``FaultScript`` schedule), probabilistic
(``p_fail``/``p_flap`` per host per poll, seeded), or both.  Emission
follows the straggler-source convention: at most one :class:`HostFailed`
per poll, only on a *change* of the reported-dead set, always carrying
the FULL set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .events import Event, HostFailed


@dataclass(frozen=True)
class FaultScript:
    """One scheduled outage: ``hosts`` go down after poll ``step``."""

    step: int
    hosts: Tuple[int, ...]
    down_for: Optional[int] = None  # None = hard kill; k = flap of k polls

    def __post_init__(self):
        if self.step < 0:
            raise ValueError(f"FaultScript.step must be >= 0, got {self.step}")
        if self.down_for is not None and self.down_for < 1:
            raise ValueError(
                f"FaultScript.down_for must be >= 1 polls, got {self.down_for}"
            )


class FaultInjector:
    """Pollable source of :class:`HostFailed` events (see module doc)."""

    def __init__(
        self,
        n_hosts: int,
        *,
        schedule: Sequence[FaultScript] = (),
        p_fail: float = 0.0,
        p_flap: float = 0.0,
        flap_polls: int = 3,
        retry_window: int = 1,
        seed: int = 0,
    ):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        for s in schedule:
            bad = [h for h in s.hosts if not 0 <= h < n_hosts]
            if bad:
                raise ValueError(f"scripted hosts {bad} out of range "
                                 f"0..{n_hosts - 1}")
        self.n_hosts = n_hosts
        self.schedule = sorted(schedule, key=lambda s: s.step)
        self.p_fail = float(p_fail)
        self.p_flap = float(p_flap)
        self.flap_polls = int(flap_polls)
        self.retry_window = int(retry_window)
        self._rng = np.random.default_rng(seed)
        self._polls = 0
        self._dead: Set[int] = set()          # permanent hard kills
        self._down: Dict[int, int] = {}       # flapping host -> polls left
        self._missed: Dict[int, int] = {}     # flapping host -> beats missed
        self._reported_flaps: Set[int] = set()
        self._last_reported: Tuple[int, ...] = ()
        self.injected_hard = 0
        self.injected_flaps = 0
        self.debounced_flaps = 0  # flaps that returned inside the window

    @property
    def dead_hosts(self) -> Tuple[int, ...]:
        """The currently-reported dead set (what consumers last saw)."""
        return self._last_reported

    def _begin(self, host: int, down_for: Optional[int]) -> None:
        if host in self._dead or host in self._down:
            return
        if down_for is None:
            self._dead.add(host)
            self.injected_hard += 1
        else:
            self._down[host] = int(down_for)
            self._missed[host] = 0
            self.injected_flaps += 1

    def poll(self) -> List[Event]:
        i = self._polls
        self._polls += 1
        for s in self.schedule:
            if s.step == i:
                for h in s.hosts:
                    self._begin(h, s.down_for)
        if self.p_fail > 0.0 or self.p_flap > 0.0:
            for h in range(self.n_hosts):
                if h in self._dead or h in self._down:
                    continue
                r = float(self._rng.random())
                if r < self.p_fail:
                    self._begin(h, None)
                elif r < self.p_fail + self.p_flap:
                    self._begin(h, 1 + int(self._rng.integers(
                        max(1, self.flap_polls))))
        # advance flaps: one missed heartbeat per poll; report only past
        # the retry window, and un-report hosts that heartbeat again
        for h in list(self._down):
            self._missed[h] += 1
            self._down[h] -= 1
            if self._down[h] <= 0:  # host heartbeats again
                del self._down[h]
                missed = self._missed.pop(h)
                if h in self._reported_flaps:
                    self._reported_flaps.discard(h)
                elif missed <= self.retry_window:
                    self.debounced_flaps += 1
            elif self._missed[h] > self.retry_window:
                self._reported_flaps.add(h)
        reported = tuple(sorted(self._dead | self._reported_flaps))
        if reported != self._last_reported:
            self._last_reported = reported
            return [HostFailed(reported, transient=not self._dead)]
        return []
