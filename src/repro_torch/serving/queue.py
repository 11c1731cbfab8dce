"""Request queue with admission control (port of ``repro/serving/queue.py``).

:meth:`RequestQueue.submit` rejects work beyond ``max_pending`` so a
traffic burst degrades to client backpressure instead of unbounded memory
growth; every admission notes a :class:`~repro_torch.launch.events.
RequestArrived` and every completion a :class:`~repro_torch.launch.events.
RequestCompleted`, drained through :class:`~repro_torch.launch.events.
RequestQueueSource`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from ..launch.events import Event, RequestArrived, RequestCompleted


@dataclass
class Request:
    """One inference request: ``tokens`` is the (P,) prompt (a numpy array,
    tensor or anything ``numpy.asarray`` takes); ``family`` keys the
    request's workload class in the mix signature.  Encoder-decoder and
    VLM archs carry their stub modality inputs in ``extras``: ``frames``
    (S_enc, d) and ``embeds`` (P_img, d), each a numpy array or a tensor;
    the batcher stacks them at prefill."""

    rid: int
    tokens: Any
    max_new_tokens: int
    family: str = "text"
    arrival: float = 0.0
    eos_id: Optional[int] = None
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[-1])


class RequestQueue:
    """FIFO pending queue + bounded admission + lifecycle event buffer."""

    def __init__(self, max_pending: int = 1024):
        self.max_pending = max_pending
        self._pending: Deque[Request] = deque()
        self._events: List[Event] = []
        self.submitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, req: Request) -> bool:
        """Admit ``req`` (True) or reject it when the queue is full (False)."""
        if len(self._pending) >= self.max_pending:
            self.rejected += 1
            return False
        self._pending.append(req)
        self.submitted += 1
        self._events.append(
            RequestArrived(rid=req.rid, family=req.family, prompt_len=req.prompt_len)
        )
        return True

    def pop(self) -> Optional[Request]:
        """Next pending request in arrival order (None when empty)."""
        return self._pending.popleft() if self._pending else None

    def requeue_front(self, reqs: List[Request]) -> None:
        """Return popped-but-unadmitted requests to the head of the queue in
        their original order (admission deferral must not reorder FIFO)."""
        for req in reversed(reqs):
            self._pending.appendleft(req)

    def peek(self) -> Optional[Request]:
        return self._pending[0] if self._pending else None

    def note_completion(self, req: Request, generated: int) -> None:
        """Record a finished request (the serving session calls this on
        eviction)."""
        self._events.append(
            RequestCompleted(rid=req.rid, family=req.family, generated=generated)
        )

    def drain_events(self) -> List[Event]:
        """Return-and-clear the buffered lifecycle events."""
        out, self._events = self._events, []
        return out
