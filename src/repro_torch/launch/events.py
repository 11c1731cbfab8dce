"""Serving lifecycle events (the part of ``repro/launch/events.py`` that
serving needs).

The JAX module also defines the training, straggler, fault and fleet
events and imports ``repro.ckpt.straggler``; those arrive with the slices
that raise them.  :class:`RequestQueueSource` drains a request queue's
buffered events once per serving step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List


@dataclass(frozen=True)
class Event:
    """Base class for session lifecycle events; ``kind`` keys replan policy."""

    kind = "event"


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


@dataclass
class RequestQueueSource:
    """Serving request lifecycle as a pollable event source: ``poll``
    drains the queue's accumulated burst (anything with
    ``drain_events() -> List[Event]``)."""

    queue: Any  # repro_torch.serving.queue.RequestQueue (no import cycle)

    def poll(self) -> List[Event]:
        return self.queue.drain_events()
