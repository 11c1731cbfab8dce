"""Runtime event taxonomy + event sources for the session lifecycle (port of
``repro/launch/events.py``).

The paper's §5.5 dynamicity hook — "the plan is regenerated when the input
workload changes" — needs the *changes* to arrive as first-class values the
session can dispatch on:

  * :class:`TaskArrived` / :class:`TaskCompleted` — the multi-task workload
    shifted (a task joined or finished); the session replans through the
    :class:`repro_torch.core.plancache.PlanCache`.
  * :class:`StragglerDetected` / :class:`HostFailed` — slow or dead hosts;
    the session replans against a shrunken cluster.
  * :class:`RequestArrived` / :class:`RequestCompleted` — the *serving*
    workload shifted (an inference request was admitted or finished); the
    :class:`repro_torch.serving.session.ServingSession` maps the active
    request mix to a planner workload signature and replans when the mix
    drifts.
  * :class:`LeaseChanged`, :class:`JobArrived`, :class:`JobFinished` — the
    fleet scheduler's events.

Event *sources* are pollable producers the session drains once per step
(:class:`EventSource` protocol).  :class:`StragglerEventSource` wraps the
straggler detector (:mod:`repro_torch.ckpt.straggler`) and is fed step
times by the session or the training loop; :class:`RequestQueueSource`
drains the request queue's buffered burst; :class:`ScriptedEventSource`
replays a fixed script.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Protocol, Tuple, runtime_checkable

import torch

from ..ckpt.straggler import StragglerDetector, TimingCollector


# --------------------------------------------------------------------------
# Event taxonomy
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Event:
    """Base class for session lifecycle events; ``kind`` keys replan policy."""

    kind = "event"


@dataclass(frozen=True)
class TaskArrived(Event):
    """A new task joined the multi-task workload mid-run."""

    task: str
    kind = "task_arrived"


@dataclass(frozen=True)
class TaskCompleted(Event):
    """A task finished (converged / drained) and leaves the workload."""

    task: str
    kind = "task_completed"


@dataclass(frozen=True)
class StragglerDetected(Event):
    """Hosts whose median step time exceeds the cluster median threshold."""

    hosts: Tuple[int, ...]
    kind = "straggler"


@dataclass(frozen=True)
class HostFailed(Event):
    """Hosts crashed hard — no cooperative snapshot turn was possible.

    Unlike :class:`StragglerDetected` (a *performance* signal: the host is
    alive, its state is intact, the session snapshots before shrinking),
    a hard failure loses the host's device state outright: the session
    must roll back to the last durable snapshot, re-mesh over survivors,
    and deterministically replay the lost steps (DESIGN.md §17).

    Follows the straggler convention: ``hosts`` carries the FULL
    currently-dead set, so a transient host that returns is reported by
    firing again with the smaller set (``transient=True`` marks events
    from a flap rather than a confirmed permanent crash), and ``()``
    means every previously-dead host recovered."""

    hosts: Tuple[int, ...]
    transient: bool = False
    kind = "host_failed"


@dataclass(frozen=True)
class RequestArrived(Event):
    """An inference request was admitted into the serving queue."""

    rid: int
    family: str = "text"
    prompt_len: int = 0
    kind = "request_arrived"


@dataclass(frozen=True)
class RequestCompleted(Event):
    """An inference request finished decoding and left its batch slot."""

    rid: int
    family: str = "text"
    generated: int = 0
    kind = "request_completed"


@dataclass(frozen=True)
class LeaseChanged(Event):
    """An externally-arbitrated device lease replaced the session's cluster.

    Carries the new sub-cluster view (a :class:`repro_torch.core.placement.
    ClusterSpec`, typically a canonical fleet-lease view with an explicit
    ``host_map``).  The session replans over it exactly like a topology
    change — the lease arbiter, not the session, owns which physical
    devices back the view."""

    cluster: Any  # repro_torch.core.placement.ClusterSpec (kept Any: no dep cycle)
    kind = "lease_changed"


@dataclass(frozen=True)
class JobArrived(Event):
    """A job joined the fleet's compound workload (multi-tenant scheduler)."""

    name: str
    job_kind: str = "train"
    kind = "job_arrived"


@dataclass(frozen=True)
class JobFinished(Event):
    """A fleet job drained its workload and released its device lease."""

    name: str
    kind = "job_finished"


EVENT_KINDS = (
    "task_arrived",
    "task_completed",
    "straggler",
    "host_failed",
    "request_arrived",
    "request_completed",
    "lease_changed",
    "job_arrived",
    "job_finished",
)


# --------------------------------------------------------------------------
# Event sources
# --------------------------------------------------------------------------


@runtime_checkable
class EventSource(Protocol):
    """A pollable producer of events, drained once per session step."""

    def poll(self) -> List[Event]:
        """Return (and clear) any events that fired since the last poll."""


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without
    one) — the host index of an unaggregated step time."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


@dataclass
class StragglerEventSource:
    """Straggler detection as a session event source.

    Producers (the training loop, or the session itself via
    ``record``/``record_step``) feed per-host step times; ``poll`` emits one
    :class:`StragglerDetected` per *change* in the flagged host set — a
    host stays flagged across consecutive polls without refiring, so one
    degradation triggers one replan, not one per step.  The event always
    carries the FULL currently-flagged set; recovery (the set emptying
    again) fires ``StragglerDetected(())``.

    With a :class:`repro_torch.ckpt.straggler.TimingCollector` attached,
    ``record_step(local_seconds)`` feeds the detector the per-host vector
    (the in-process skew path) — the only feed under which a per-process
    caller can flag.  Without one, ``record_step`` records this process's
    host only (the detector then never flags by itself).
    """

    detector: StragglerDetector
    collector: Optional[TimingCollector] = None
    _last_flagged: Tuple[int, ...] = ()

    def record(self, host: int, step_seconds: float) -> None:
        self.detector.record(host, step_seconds)

    def record_step(self, step_seconds: float) -> None:
        """One local step time in — the full per-host stream (when a
        collector aggregates) into the detector."""
        if self.collector is None:
            self.detector.record(process_index(), step_seconds)
            return
        vec = self.collector.gather(step_seconds)
        if vec is not None:
            self.detector.record_all(vec)

    def poll(self) -> List[Event]:
        hosts = tuple(self.detector.stragglers())
        if hosts != self._last_flagged:
            self._last_flagged = hosts
            return [StragglerDetected(hosts)]
        return []


@dataclass
class RequestQueueSource:
    """Serving request lifecycle as a session event source.

    Wraps a :class:`repro_torch.serving.queue.RequestQueue` (duck-typed: anything
    with ``drain_events() -> List[Event]``).  The queue *notes* one
    :class:`RequestArrived` per admission and the serving session notes one
    :class:`RequestCompleted` per eviction; ``poll`` drains the accumulated
    burst so a whole admission/eviction cycle coalesces into ONE replan
    (exactly like a phase shift arriving as a burst of task events)."""

    queue: Any  # repro_torch.serving.queue.RequestQueue (avoids an import cycle)

    def poll(self) -> List[Event]:
        return self.queue.drain_events()


@dataclass
class ScriptedEventSource:
    """Deterministic event source for tests/benchmarks.

    Default: a fixed queue drained one event per poll.  With ``fire_at``
    (one 0-based poll index per event, ascending), each event instead fires
    on its scheduled poll — a session polls once per training step, so
    ``fire_at=[4]`` injects the event after step 4 (the fault-injection CI
    hook: "straggler at step N").
    """

    events: List[Event]
    fire_at: Optional[List[int]] = None
    _polls: int = field(default=0, repr=False)

    def __post_init__(self):
        # own copies: poll() drains destructively and must not consume a
        # caller-shared list; a partial schedule would silently strand the
        # unscheduled tail, so it is an error
        self.events = list(self.events)
        if self.fire_at is not None:
            if len(self.fire_at) != len(self.events):
                raise ValueError(
                    f"fire_at schedules {len(self.fire_at)} of "
                    f"{len(self.events)} events — every event needs a slot"
                )
            if sorted(self.fire_at) != list(self.fire_at):
                raise ValueError(
                    "fire_at must be ascending — the drain loop only ever "
                    "inspects the head, an out-of-order schedule would "
                    "silently shift the scenario"
                )
            self.fire_at = list(self.fire_at)

    def poll(self) -> List[Event]:
        if self.fire_at is None:
            return [self.events.pop(0)] if self.events else []
        i = self._polls
        self._polls += 1
        out: List[Event] = []
        while self.events and self.fire_at and self.fire_at[0] <= i:
            self.fire_at.pop(0)
            out.append(self.events.pop(0))
        return out
