"""Fleet job registry: what is admitted, what it runs on, how it's doing
(port of ``repro/fleet/jobs.py``).

A :class:`JobSpec` is the immutable submission record — one training job
(a named planner workload, planned and replanned as a plan-only
:class:`repro_torch.session.SpindleSession`) or one serving job (a real
:class:`repro_torch.serving.session.ServingSession` over an arch from
``repro_torch.config``), with a priority weight and an arrival time in fleet
(virtual) seconds.  A :class:`JobHandle` is the scheduler's mutable
per-job state: the live session, the applied lease, the job's virtual
clock, and its step-latency trace (per-job p99 in the bench).

Job lifecycle::

    pending --arrival--> queued --non-empty lease--> running --drained--> done
                           ^                            |
                           +------- lost all hosts -----+
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .lease import Lease

__all__ = ["JobSpec", "JobHandle"]

JOB_KINDS = ("train", "serve")


@dataclass(frozen=True)
class JobSpec:
    """Immutable submission record for one fleet job."""

    name: str
    #: "train" (plan-only wavefront job over a named workload) |
    #: "serve" (ServingSession over an arch, driven by a request trace)
    kind: str = "train"
    #: repro_torch.core.workloads entry (train jobs)
    workload: str = "multitask_clip"
    #: repro_torch.config arch name (serve jobs); the reduced config unless
    #: the fleet's ``model_cache`` holds a model for the arch
    arch: str = "qwen3-0.6b"
    #: training steps to run (train jobs)
    steps: int = 16
    #: scripted request trace length (serve jobs); request i arrives at
    #: serving step i with a ``prompt_len`` prompt and ``gen_len`` budget
    requests: int = 4
    prompt_len: int = 16
    gen_len: int = 6
    slots: int = 2
    cache_len: int = 64
    #: lease-share weight (>= 1); a priority-2 job targets twice the hosts
    priority: int = 1
    #: fleet virtual time (seconds) at which the job becomes admissible
    arrival: float = 0.0

    def __post_init__(self):
        if self.kind not in JOB_KINDS:
            raise ValueError(
                f"job {self.name!r}: unknown kind {self.kind!r}; "
                f"choose from {JOB_KINDS}"
            )
        if self.priority < 1:
            raise ValueError(f"job {self.name!r}: priority must be >= 1")
        if self.arrival < 0:
            raise ValueError(f"job {self.name!r}: arrival must be >= 0")
        if self.kind == "train" and self.steps < 1:
            raise ValueError(f"job {self.name!r}: steps must be >= 1")
        if self.kind == "serve":
            if self.requests < 1:
                raise ValueError(f"job {self.name!r}: requests must be >= 1")
            if self.prompt_len + self.gen_len - 1 > self.cache_len:
                raise ValueError(
                    f"job {self.name!r}: prompt_len + gen_len - 1 "
                    f"({self.prompt_len + self.gen_len - 1}) exceeds "
                    f"cache_len={self.cache_len}"
                )


@dataclass
class JobHandle:
    """Mutable scheduler-side state of one admitted job."""

    spec: JobSpec
    #: SpindleSession (train) or ServingSession (serve); built at admission
    session: Any = None
    state: str = "pending"  # pending | queued | running | done
    #: currently APPLIED lease (None while pending/queued without devices)
    lease: Optional[Lease] = None
    #: the job's virtual clock — fleet seconds at which its last step ended
    clock: float = 0.0
    admitted_at: float = 0.0
    done_at: Optional[float] = None
    steps_done: int = 0
    #: per-step completion-to-completion latency (includes queue waits and
    #: renewal replans — the fairness signal the bench reports p99 over)
    step_times: List[float] = field(default_factory=list)
    #: end time of the previous step (latency accounting origin)
    last_end: float = 0.0
    #: steps completed after the most recent fleet rebalance (CI gate:
    #: every surviving job must make progress post-eviction)
    post_rebalance_steps: int = 0
    #: lease renewals adopted (grant version bumps applied)
    renewals: int = 0
    #: scripted request trace not yet submitted (serve jobs)
    pending_requests: List[Any] = field(default_factory=list)
    # --- co-location (colocate policy; serve jobs riding a train lease) ---
    #: name of the training job whose idle windows this tenant fills
    co_host: Optional[str] = None
    #: decode/chunk steps that landed inside a host idle window
    colocated_steps: int = 0
    #: idle windows offered across all host steps
    windows_seen: int = 0
    #: windows skipped because the serve step did not fit (too short)
    deferred_windows: int = 0
    #: tenant KV pool budget in device bytes ((kv_pages-1) * page bytes)
    kv_budget_bytes: float = 0.0
    #: min per-device memory headroom of the host plan at bind time
    window_headroom_bytes: float = 0.0
    # --- fault tolerance (revocations and host failures) ---
    #: lease revocations this job failed to yield in time (force-evicted)
    forced_revokes: int = 0
    #: in-flight serving requests requeued after a host loss (serve jobs)
    requeued_requests: int = 0

    @property
    def name(self) -> str:
        return self.spec.name

    def summary(self) -> Dict[str, Any]:
        import numpy as np

        st = self.step_times
        return {
            "name": self.spec.name,
            "kind": self.spec.kind,
            "priority": self.spec.priority,
            "arrival": self.spec.arrival,
            "state": self.state,
            "steps_done": self.steps_done,
            "done_at": self.done_at,
            "renewals": self.renewals,
            "post_rebalance_steps": self.post_rebalance_steps,
            "p50_step_s": float(np.percentile(st, 50)) if st else 0.0,
            "p99_step_s": float(np.percentile(st, 99)) if st else 0.0,
            "forced_revokes": self.forced_revokes,
            "requeued_requests": self.requeued_requests,
            "co_host": self.co_host,
            "colocated_steps": self.colocated_steps,
            "windows_seen": self.windows_seen,
            "deferred_windows": self.deferred_windows,
            "kv_budget_bytes": self.kv_budget_bytes,
            "window_headroom_bytes": self.window_headroom_bytes,
        }
