"""FleetScheduler — many sessions, one cluster, one planner (port of
``repro/fleet/scheduler.py``).

The multi-tenant tier above :class:`repro_torch.session.SpindleSession` /
:class:`repro_torch.serving.session.ServingSession` (DESIGN.md §14): N jobs —
plan-only wavefront training jobs over named workloads plus real serving
sessions over arches from ``repro_torch.config`` — are admitted onto ONE
:class:`repro_torch.core.placement.ClusterSpec`.  A :class:`repro_torch.fleet.lease.
LeaseArbiter` carves the host→device map into disjoint per-job leases
(priority-weighted, re-carved on every arrival/completion/eviction), each
job plans against its lease's *canonical view*, and every job plans
through ONE shared :class:`repro_torch.core.plancache.PlanCache` — identical
arch + lease shape admitted twice plans once (``cross_job_hits``).

Time is **virtual**: the fleet advances an event-driven clock where one
training step costs its current plan's makespan (the estimator's own
seconds — the same quantity the wavefront benchmarks compare) and one
serving step costs the planner's current mix makespan.  Serving jobs
still *execute* real decode steps (admission, paged KV, eviction); train
jobs are plan-only, exactly like the dynamicity benchmark.  Virtual time
is what makes the three policies comparable and the bench deterministic:

  * ``fleet``   — priority-weighted space sharing, re-carved on every
                  membership/topology change (this subsystem),
  * ``static``  — equal partition fixed up front; shares idle while
                  their job is absent and are never reclaimed,
  * ``fifo``    — time slicing: each job gets the WHOLE cluster for
                  ``slice_steps`` steps, round-robin; per-job step
                  latency absorbs every other job's slices.

Straggler events route to the FLEET, not to any one job: the cluster
shrinks, the arbiter strips evicted blocks from every lease immediately
and re-carves the survivors under the grant/apply deferral rule, and
each surviving job adopts its shrunken lease at its next step boundary
(``LeaseChanged`` → one replan through the shared cache).

Serve jobs execute on ``FleetConfig.device`` (``"cuda"`` by default: every
decode step goes through the paged-decode kernel, every prefill past 256
positions through flash).  The clock is the planner's, so ``metrics()``
depends on ``FleetConfig.hw`` and the cluster alone, never on the device:
with the reference's spec and cluster values it equals the JAX fleet's.
"""

from __future__ import annotations

import contextlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import default_sharding, get_arch, reduced, resolve_device
from ..core.costmodel import ICI_BW, H100, HardwareSpec
from ..core.placement import ClusterSpec
from ..core.plancache import PlanCache
from ..launch.events import (
    Event,
    HostFailed,
    JobArrived,
    JobFinished,
    StragglerDetected,
)
from ..session import SessionCallbacks, SessionConfig, SpindleSession
from .jobs import JobHandle, JobSpec
from .lease import Lease, LeaseArbiter, lease_view

__all__ = ["FleetConfig", "FleetCallbacks", "FleetScheduler"]

POLICIES = ("fleet", "static", "fifo", "colocate")


@dataclass(frozen=True)
class FleetConfig:
    """Typed, immutable inputs of one fleet run."""

    #: 8 hosts of 4 H100s (80 GB, NVLink)
    cluster: ClusterSpec = ClusterSpec(
        n_devices=32, island_size=8, mem_bytes=80e9, devices_per_host=4,
        intra_island_bw=ICI_BW,
    )
    #: "fleet" (lease arbiter) | "static" (fixed equal partition) |
    #: "fifo" (whole-cluster time slicing) | "colocate" (fleet leases for
    #: train jobs; serve jobs ride a train lease's idle windows as
    #: co-resident tenants — decode steps slot into the plan timeline's
    #: bubbles whose memory headroom fits the tenant's KV page budget)
    policy: str = "fleet"
    planner: str = "spindle"
    placement_strategy: str = "spindle"
    #: fifo quantum: steps a job runs before yielding the cluster
    slice_steps: int = 4
    #: shared-PlanCache capacity (one cache for the whole fleet)
    cache_maxsize: int = 64
    #: serving replan policy forwarded to ServingSession ("mix"/"initial")
    serve_replan: str = "mix"
    #: preemptive-lease revoke deadline in scheduler TICKS: a holder whose
    #: grant shrank while a waiter wants the blocks must apply (yield)
    #: within this many ticks or the arbiter force-evicts the contested
    #: hosts from its applied lease (DESIGN.md §17); None = purely
    #: cooperative (deferrals wait for the holder's next boundary forever)
    revoke_deadline: Optional[int] = None
    #: virtual cost of a serving step before the first mix plan exists
    #: (a colocate fleet on the H100 clock needs the planner's price of
    #: that step instead: ``launch.fleet.first_serve_step_dt``)
    serve_fallback_dt: float = 1e-3
    #: safety valve on the cooperative loop (total steps across all jobs)
    max_ticks: int = 100_000
    #: where serve jobs' models, caches and steps live: "cuda" (the
    #: hand-written kernels) | "cpu" (their plain PyTorch versions);
    #: "cuda" without a GPU raises
    device: str = "cuda"
    #: the planner's hardware spec, forwarded to every session
    hw: HardwareSpec = H100

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown fleet policy {self.policy!r}; "
                f"choose from {POLICIES}"
            )
        if self.slice_steps < 1:
            raise ValueError("slice_steps must be >= 1")


class FleetCallbacks(SessionCallbacks):
    """Fleet observer protocol — the per-session hooks (``on_plan`` /
    ``on_replan`` / ...) still fire from each job's inner session (the
    fleet threads its callback list through every session it builds);
    these add the fleet-level lifecycle."""

    def on_job_admitted(self, fleet: "FleetScheduler",
                        handle: JobHandle) -> None:
        pass

    def on_job_step(self, fleet: "FleetScheduler", handle: JobHandle,
                    step: int, dt: float) -> None:
        pass

    def on_job_finished(self, fleet: "FleetScheduler",
                        handle: JobHandle) -> None:
        pass

    def on_rebalance(self, fleet: "FleetScheduler", event: Event,
                     leases: Dict[str, Lease]) -> None:
        pass


class FleetScheduler:
    """Admit N jobs onto one cluster; plan them all through one cache."""

    def __init__(
        self,
        config: Optional[FleetConfig] = None,
        jobs: Sequence[JobSpec] = (),
        *,
        callbacks: Sequence[SessionCallbacks] = (),
        event_sources: Sequence[Any] = (),
        cache: Optional[PlanCache] = None,
        model_cache: Optional[Dict[str, Any]] = None,
    ):
        self.config = config or FleetConfig()
        self.device = resolve_device(self.config.device)
        # NOT `cache or ...`: an empty shared cache is falsy but still the
        # caller's cache (same aliasing rule as SpindleSession)
        self.cache = cache if cache is not None else PlanCache(
            maxsize=self.config.cache_maxsize
        )
        self.callbacks: List[SessionCallbacks] = list(callbacks)
        self.event_sources: List[Any] = list(event_sources)
        #: live fleet topology (config.cluster minus evicted hosts)
        self.cluster = self.config.cluster
        self.arbiter = LeaseArbiter(
            self.cluster, revoke_deadline=self.config.revoke_deadline
        )
        self.jobs: Dict[str, JobHandle] = {}
        #: one initialised Model per arch (reduced unless the caller passed
        #: one), shared by same-arch serve jobs
        self._model_cache = model_cache if model_cache is not None else {}
        #: fleet virtual clock (seconds)
        self.t = 0.0
        self.busy_device_seconds = 0.0
        self.rebalances = 0
        #: live co-tenant bindings (colocate policy): tenant name -> host
        #: job name (mirrors arbiter.co_tenants; the scheduler side also
        #: tracks unbound tenants waiting for a plannable host)
        self._tenants: Dict[str, str] = {}
        self._flagged: frozenset = frozenset()
        #: hard-failed hosts (HostFailed routing; full-set convention)
        self._dead: frozenset = frozenset()
        self.host_failures = 0
        self.events: List[Event] = []
        self.ticks = 0
        for spec in jobs:
            self.submit(spec)

    # ------------------------------------------------------------- plumbing
    def _fire(self, name: str, *args) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is not None:
                fn(self, *args)

    @contextlib.contextmanager
    def _owner(self, name: str):
        """Scope the shared cache's owner to ``name`` for one planning
        turn — hits on entries planned by a DIFFERENT job count as
        ``cross_job_hits`` (the dedup the shared cache exists for)."""
        prev = self.cache.owner
        self.cache.owner = name
        try:
            yield
        finally:
            self.cache.owner = prev

    # ------------------------------------------------------------- registry
    def submit(self, spec: JobSpec) -> JobHandle:
        """Register a job (admission happens when its arrival time comes)."""
        if spec.name in self.jobs:
            raise ValueError(f"duplicate job name {spec.name!r}")
        handle = JobHandle(spec=spec)
        self.jobs[spec.name] = handle
        return handle

    def _model(self, arch: str) -> Any:
        if arch not in self._model_cache:
            from ..models import build_model

            cfg = reduced(get_arch(arch))
            self._model_cache[arch] = build_model(
                cfg, default_sharding(cfg, use_kernels=True),
                device=str(self.device),
            ).init(0)
        model = self._model_cache[arch]
        if model.device.type != self.device.type:
            raise ValueError(f"cached {arch} model lives on {model.device}, "
                             f"the fleet runs on {self.config.device}")
        return model

    def _make_requests(self, spec: JobSpec) -> List[Any]:
        from ..serving.queue import Request

        toks = (np.arange(spec.prompt_len, dtype=np.int32) % 13) + 1
        return [
            Request(
                rid=i,
                tokens=toks,
                max_new_tokens=spec.gen_len,
                family=spec.name,
                arrival=float(i),  # serving-step units: one per step
            )
            for i in range(spec.requests)
        ]

    def _build_session(self, handle: JobHandle) -> None:
        spec = handle.spec
        if spec.kind == "train":
            # plan-only: the cluster here is a placeholder — the first
            # lease apply adopts the canonical view before any planning
            handle.session = SpindleSession(
                SessionConfig(
                    cluster=self.config.cluster,
                    planner=self.config.planner,
                    placement_strategy=self.config.placement_strategy,
                    workload=spec.workload,
                    cache_maxsize=self.config.cache_maxsize,
                    hw=self.config.hw,
                ),
                callbacks=self.callbacks,
                cache=self.cache,
            )
        else:
            from ..serving.session import ServingConfig, ServingSession

            handle.session = ServingSession(
                ServingConfig(
                    arch=spec.arch,
                    device=self.config.device,
                    max_slots=spec.slots,
                    cache_len=spec.cache_len,
                    cluster=self.config.cluster,
                    planner=self.config.planner,
                    placement_strategy=self.config.placement_strategy,
                    hw=self.config.hw,
                    replan=self.config.serve_replan,
                    cache_maxsize=self.config.cache_maxsize,
                ),
                model=self._model(spec.arch),
                callbacks=self.callbacks,
                plan_cache=self.cache,
            )
            handle.pending_requests = self._make_requests(spec)

    # ------------------------------------------------------------ lifecycle
    def _admit_due(self) -> None:
        """Admit every registered job whose arrival time has come; grants
        settle over the WHOLE admission burst before anyone plans."""
        due = [
            h for h in self.jobs.values()
            if h.state == "pending" and h.spec.arrival <= self.t
        ]
        for h in due:
            tenant = (
                self.config.policy == "colocate" and h.spec.kind == "serve"
            )
            if tenant:
                # co-tenants never hold a lease: the session is built at
                # bind time (its KV budget comes from the host plan's
                # headroom), and the arbiter only learns the window binding
                h.pending_requests = self._make_requests(h.spec)
            else:
                self._build_session(h)
                self.arbiter.admit(h.name, priority=h.spec.priority)
            h.state = "queued"
            h.admitted_at = max(self.t, h.spec.arrival)
            h.clock = h.admitted_at
            h.last_end = h.admitted_at
            self.events.append(
                JobArrived(name=h.name, job_kind=h.spec.kind)
            )
            self._fire("on_job_admitted", h)

    def _apply_lease(self, handle: JobHandle) -> bool:
        """Adopt the job's granted lease (step boundary).  Returns False
        when the grant is empty — the job parks as ``queued`` until a
        promotion re-grants it devices."""
        name = handle.name
        grant = self.arbiter.granted[name]
        if not grant.hosts:
            self.arbiter.apply(name)  # releases survivors it still held
            handle.lease = None
            handle.state = "queued"
            return False
        if handle.lease is not None:
            handle.renewals += 1
        applied = self.arbiter.apply(name)
        handle.lease = applied
        handle.state = "running"
        sess = handle.session
        view = applied.view
        with self._owner(name):
            # one protocol method for both job kinds: first lease plans,
            # later leases signal LeaseChanged (an equal-shaped re-grant —
            # same view, new physical blocks — is a signal-level no-op)
            sess.apply_lease(view)
        return True

    def _sync_queued(self) -> None:
        for h in self.jobs.values():
            # unbound co-tenants are queued without an arbiter grant
            grant = self.arbiter.granted.get(h.name)
            if h.state == "queued" and grant is not None and grant.hosts:
                self._apply_lease(h)

    def _job_done(self, handle: JobHandle) -> bool:
        if handle.spec.kind == "train":
            return handle.steps_done >= handle.spec.steps
        return not handle.pending_requests and not handle.session.busy

    def _execute_step(self, handle: JobHandle) -> float:
        """Run one job step; returns its virtual cost in seconds."""
        sess = handle.session
        if handle.spec.kind == "serve":
            while (
                handle.pending_requests
                and handle.pending_requests[0].arrival <= sess.steps
            ):
                sess.submit(handle.pending_requests.pop(0))
            with self._owner(handle.name):
                sess.step()
            ps = sess.planner_session
            plan = ps.current_plan if ps is not None else None
            return (
                plan.makespan if plan is not None
                else self.config.serve_fallback_dt
            )
        return sess.current_plan.makespan

    # ------------------------------------------------------- co-location
    def _build_cotenant_session(self, handle: JobHandle,
                                host: JobHandle) -> bool:
        """Stand up the tenant's ServingSession against the host's lease
        view, with ``kv_pages`` budgeted from the host plan's memory
        headroom (the placement high-water the timeline exposes).  Returns
        False when even one request's KV reach cannot fit the headroom —
        the caller promotes the tenant to a real lease instead."""
        from ..models.paging import kv_page_bytes
        from ..serving.pages import pages_needed
        from ..serving.session import ServingConfig, ServingSession

        spec = handle.spec
        model = self._model(spec.arch)
        view = host.lease.view
        tl = host.session.current_plan.timeline()
        head = min(tl.headroom.values()) if tl.headroom else 0.0
        page_size = ServingConfig.page_size
        probe, lay = model.init_paged_cache(
            1, spec.cache_len, n_pages=2, page_size=page_size,
            cache_dtype=torch.bfloat16,
        )
        pb = kv_page_bytes(probe, lay)
        pps = pages_needed(spec.cache_len, page_size)
        full_need = spec.slots * pps + 1
        if pb <= 0:
            budget = full_need  # stateless-KV arch: nothing pooled to cap
        else:
            fit = 1 + int(head // pb)
            reach = pages_needed(
                spec.prompt_len + spec.gen_len - 1, page_size
            )
            if fit < reach + 1:
                return False  # headroom can't hold even one request
            budget = min(full_need, fit)
        handle.session = ServingSession(
            ServingConfig(
                arch=spec.arch,
                device=self.config.device,
                max_slots=spec.slots,
                cache_len=spec.cache_len,
                kv_pages=budget,
                cluster=view,
                planner=self.config.planner,
                placement_strategy=self.config.placement_strategy,
                hw=self.config.hw,
                replan=self.config.serve_replan,
                cache_maxsize=self.config.cache_maxsize,
            ),
            model=model,
            callbacks=self.callbacks,
            plan_cache=self.cache,
        )
        handle.kv_budget_bytes = float((budget - 1) * pb)
        handle.window_headroom_bytes = float(head)
        return True

    def _bind_or_promote_tenants(self) -> None:
        """Give every waiting colocate serve job a home.

        Preference order: bind as co-tenant of a running train job that
        already has a plan (windows exist); else keep waiting while any
        train job could still run; else *promote* to an ordinary
        arbiter-leased job so the fleet always drains."""
        waiting = [
            h for h in self.jobs.values()
            if h.spec.kind == "serve" and h.state == "queued"
            and h.name not in self._tenants
            and h.name not in self.arbiter.granted
        ]
        if not waiting:
            return
        hosts = [
            h for h in self.jobs.values()
            if h.spec.kind == "train" and h.state == "running"
            and h.lease is not None
            and h.session.current_plan is not None
        ]
        train_alive = any(
            h.spec.kind == "train" and h.state != "done"
            for h in self.jobs.values()
        )
        for h in waiting:
            if hosts:
                host = min(hosts, key=lambda x: (x.clock, x.spec.name))
                if h.session is None:
                    if not self._build_cotenant_session(h, host):
                        self._promote_tenant(h)
                        continue
                else:
                    # re-homed tenant: adopt the new host's lease view and
                    # re-baseline the headroom contract against its plan
                    with self._owner(h.name):
                        h.session.apply_lease(host.lease.view)
                    tl = host.session.current_plan.timeline()
                    if tl.headroom:
                        h.window_headroom_bytes = float(
                            min(tl.headroom.values())
                        )
                self.arbiter.colocate(h.name, host.name)
                self._tenants[h.name] = host.name
                h.co_host = host.name
                h.state = "running"
                h.clock = max(h.clock, host.clock)
                h.last_end = h.clock
            elif not train_alive:
                self._promote_tenant(h)

    def _promote_tenant(self, handle: JobHandle) -> None:
        """Fall back to a real lease (no windows to ride): the tenant
        becomes an ordinary arbiter-arbitrated serve job."""
        handle.co_host = None
        self.arbiter.admit(handle.name, priority=handle.spec.priority)
        if handle.session is None:
            reqs = handle.pending_requests
            self._build_session(handle)
            handle.pending_requests = reqs  # keep trace progress

    def _serve_dt(self, tenant: JobHandle) -> float:
        """Virtual cost of ONE co-located serve step: the decode wave of
        the tenant's mix plan (a window hosts decode steps and prefill
        chunks, not the whole mix), or the configured floor pre-plan."""
        ps = getattr(tenant.session, "planner_session", None)
        plan = ps.current_plan if ps is not None else None
        if plan is None:
            return self.config.serve_fallback_dt
        dec = [s.duration for s in plan.steps if "decode" in s.meta_name]
        return max(dec) if dec else plan.makespan

    def _tenant_step(self, tenant: JobHandle) -> None:
        sess = tenant.session
        while (
            tenant.pending_requests
            and tenant.pending_requests[0].arrival <= sess.steps
        ):
            sess.submit(tenant.pending_requests.pop(0))
        with self._owner(tenant.name):
            sess.step()

    def _colocate_tenant_steps(self, host: JobHandle, start: float) -> None:
        """Slot tenant serve steps into the idle windows of the host step
        that just ran over ``[start, start + makespan]``.  Each gang window
        fits ``floor(duration / serve_dt)`` steps; a window too short for
        even one step counts as a deferral (the tenant waits for the next
        host step instead of stretching the training critical path)."""
        tenants = [t for t, hn in self._tenants.items() if hn == host.name]
        if not tenants:
            return
        plan = host.session.current_plan
        if plan is None:
            return
        tl = plan.timeline()
        for tname in tenants:
            tenant = self.jobs[tname]
            if tenant.state != "running":
                continue
            gangs = tl.gang_windows(
                k=1, min_headroom=tenant.kv_budget_bytes
            )
            tenant.windows_seen += len(gangs)
            for win in gangs:
                if self._job_done(tenant):
                    break
                used = 0.0
                stepped = False
                while not self._job_done(tenant):
                    serve_dt = self._serve_dt(tenant)
                    if used + serve_dt > win.duration:
                        break
                    self._tenant_step(tenant)
                    tenant.colocated_steps += 1
                    self._account_step(
                        tenant, start + win.start + used, serve_dt,
                        len(win.devices),
                    )
                    used += serve_dt
                    stepped = True
                if not stepped and not self._job_done(tenant):
                    tenant.deferred_windows += 1
            if self._job_done(tenant):
                self._finish(tenant, tenant.clock)

    def _account_step(self, handle: JobHandle, start: float,
                      dt: float, n_devices: int) -> None:
        end = start + dt
        handle.step_times.append(end - handle.last_end)
        handle.last_end = end
        handle.clock = end
        handle.steps_done += 1
        if self.rebalances > 0:
            handle.post_rebalance_steps += 1
        self.busy_device_seconds += dt * n_devices
        self.ticks += 1
        self._fire("on_job_step", handle, handle.steps_done - 1, dt)

    def _finish(self, handle: JobHandle, end: float) -> None:
        handle.state = "done"
        handle.done_at = end
        handle.lease = None
        self.arbiter.release(handle.name)  # also drops co-tenant bindings
        # orphaned tenants re-enter the bind-or-promote pipeline: the next
        # loop iteration rebinds them to another running train job, or
        # promotes them to a real lease if no train job remains
        for tname, hname in list(self._tenants.items()):
            if hname == handle.name:
                del self._tenants[tname]
                tenant = self.jobs[tname]
                tenant.co_host = None
                if tenant.state == "running":
                    tenant.state = "queued"
        self._tenants.pop(handle.name, None)
        self.events.append(JobFinished(name=handle.name))
        self._fire("on_job_finished", handle)

    def _step_job(self, handle: JobHandle) -> None:
        if self.arbiter.needs_renewal(handle.name):
            if not self._apply_lease(handle):
                return  # parked: no devices until a promotion
        start = max(self.t, handle.clock)
        dt = self._execute_step(handle)
        self.t = start + dt if self.config.policy == "fifo" else self.t
        self._account_step(handle, start, dt, handle.lease.n_devices)
        if (
            self.config.policy == "colocate"
            and handle.spec.kind == "train"
            and self._tenants
        ):
            # the step that just ran over [start, start+dt] carried this
            # plan's idle windows — fill them with tenant decode steps
            self._colocate_tenant_steps(handle, start)
        if self._job_done(handle):
            self._finish(handle, start + dt)

    def _enforce_revocations(self) -> None:
        """Advance the arbiter clock to the tick counter and force-evict
        every holder whose revoke deadline expired before it reached a
        step boundary.  The holder keeps what its grant still allows (it
        adopts the shrunken lease at its next boundary — in a real
        deployment that adoption is a rollback-restore from its last
        snapshot, DESIGN.md §17); the deferred waiter's grant promotes
        immediately."""
        self.arbiter.clock = self.ticks
        if self.config.revoke_deadline is None:
            return
        for rev in self.arbiter.expired_revocations():
            handle = self.jobs[rev.job]
            applied = self.arbiter.force_revoke(rev.job)
            handle.forced_revokes += 1
            if applied.hosts:
                handle.lease = applied
            else:
                handle.lease = None
                handle.state = "queued"
            if handle.spec.kind == "serve" and handle.session is not None:
                # the revoked blocks held live KV: requeue the in-flight
                # requests; they regenerate token-exactly on the survivors
                handle.requeued_requests += handle.session.host_failed()

    # --------------------------------------------------------------- events
    def poll(self) -> List[Event]:
        """Drain the fleet's event sources (one poll per cooperative tick)."""
        fired: List[Event] = []
        for src in self.event_sources:
            fired.extend(src.poll())
        for ev in fired:
            self.signal(ev)
        return fired

    def signal(self, event: Event) -> None:
        """Route one fleet-level event.

        ``StragglerDetected`` / ``HostFailed`` (host-indexed against the
        FLEET cluster) shrink the live topology and re-carve every lease —
        the downed host leaves the *lease map*; each surviving job adopts
        its shrunken view at its next step boundary.  Recovery (an empty
        set) restores the full cluster the same way.  A hard host loss
        additionally requeues every in-flight request of serving jobs
        whose applied lease touched the lost block (their KV pages died
        with the host) — the requests regenerate token-exactly on the
        survivors.
        """
        self.events.append(event)
        if isinstance(event, StragglerDetected):
            flagged = frozenset(
                h for h in event.hosts
                if 0 <= h < self.config.cluster.n_hosts
            )
            if flagged == self._flagged:
                return
            if len(flagged | self._dead) >= self.config.cluster.n_hosts:
                return  # never evict the whole fleet
            self._flagged = flagged
            lost: frozenset = frozenset()
        elif isinstance(event, HostFailed):
            dead = frozenset(
                h for h in event.hosts
                if 0 <= h < self.config.cluster.n_hosts
            )
            if dead == self._dead:
                return
            if len(dead | self._flagged) >= self.config.cluster.n_hosts:
                return  # never evict the whole fleet
            lost = dead - self._dead
            self._dead = dead
            if lost:
                self.host_failures += 1
        else:
            return
        # serve jobs whose APPLIED hosts died lose their resident KV —
        # snapshot holders before the arbiter strips the blocks
        hit = [
            h for h in self.jobs.values()
            if lost and h.spec.kind == "serve" and h.state == "running"
            and h.lease is not None and set(h.lease.hosts) & lost
        ]
        down = tuple(sorted(self._flagged | self._dead))
        self.cluster = self.config.cluster.shrink(down)
        self.arbiter.evict_hosts(self.cluster)
        self.rebalances += 1
        for h in self.jobs.values():
            h.post_rebalance_steps = 0
            if h.state == "running":
                applied = self.arbiter.applied.get(h.name)
                if applied is None or not applied.hosts:
                    h.lease = None
                    h.state = "queued"
                else:
                    h.lease = applied
        for h in hit:
            h.requeued_requests += h.session.host_failed()
        self._fire("on_rebalance", event, dict(self.arbiter.granted))

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, Any]:
        """Drive every job to completion; returns the fleet metrics."""
        if self.config.policy == "fifo":
            return self._run_fifo()
        if self.config.policy == "static" and self.arbiter.fixed is None:
            self._carve_static()
        while self.ticks < self.config.max_ticks:
            self._admit_due()
            self._sync_queued()
            if self.config.policy == "colocate":
                self._bind_or_promote_tenants()
                self._sync_queued()  # a promoted tenant may now hold a grant
            # bound co-tenants never step standalone: their steps ride
            # their host's windows inside _step_job
            runnable = [
                h for h in self.jobs.values()
                if h.state == "running" and h.name not in self._tenants
            ]
            if not runnable:
                pending = [
                    h.spec.arrival for h in self.jobs.values()
                    if h.state == "pending"
                ]
                if pending:
                    self.t = max(self.t, min(pending))
                    continue
                queued = [
                    h for h in self.jobs.values() if h.state == "queued"
                ]
                if queued:
                    # nothing running holds devices, so a re-carve must be
                    # able to grant the queued jobs — if not, the carve
                    # itself is infeasible (e.g. a static share of zero)
                    self.arbiter.recarve()
                    self._sync_queued()
                    if not any(
                        h.state == "running" for h in self.jobs.values()
                    ):
                        raise RuntimeError(
                            "fleet stalled: queued jobs "
                            f"{[h.name for h in queued]} hold no grantable "
                            "devices (static share empty, or more jobs "
                            "than hosts)"
                        )
                    continue
                break  # everything done
            h = min(runnable, key=lambda h: (h.clock, h.spec.name))
            self.t = max(self.t, h.clock)
            self._step_job(h)
            self.poll()
            self._enforce_revocations()
        return self.metrics()

    def _carve_static(self) -> None:
        """Equal fixed partition over ALL registered jobs, carved up front
        (the static baseline: shares are reserved from t=0 and never move,
        idling while their job is pending or finished)."""
        names = list(self.jobs)
        hosts = list(range(self.config.cluster.n_hosts))
        if not names:
            return
        base, rem = divmod(len(hosts), len(names))
        fixed: Dict[str, Tuple[int, ...]] = {}
        i = 0
        for k, name in enumerate(names):
            n = base + (1 if k < rem else 0)
            fixed[name] = tuple(hosts[i:i + n])
            i += n
        self.arbiter.fixed = fixed

    def _run_fifo(self) -> Dict[str, Any]:
        """Whole-cluster time slicing, round-robin in arrival order."""
        order = sorted(
            self.jobs.values(),
            key=lambda h: (h.spec.arrival, list(self.jobs).index(h.name)),
        )
        pending = deque(order)
        ready: deque = deque()
        fifo_view: Optional[ClusterSpec] = None
        while (pending or ready) and self.ticks < self.config.max_ticks:
            if not ready and pending:
                self.t = max(self.t, pending[0].spec.arrival)
            while pending and pending[0].spec.arrival <= self.t:
                h = pending.popleft()
                self._build_session(h)
                h.state = "queued"
                h.admitted_at = max(self.t, h.spec.arrival)
                h.clock = h.admitted_at
                h.last_end = h.admitted_at
                self.events.append(
                    JobArrived(name=h.name, job_kind=h.spec.kind)
                )
                self._fire("on_job_admitted", h)
                ready.append(h)
            h = ready.popleft()
            # swap in: the whole (healthy) cluster as one canonical view
            healthy = [
                hh for hh in range(self.cluster.n_hosts)
                if hh not in self.cluster.flagged_hosts
            ]
            view = lease_view(self.cluster, healthy)
            if view != fifo_view:
                fifo_view = view
            h.state = "running"
            sess = h.session
            with self._owner(h.name):
                sess.apply_lease(view)
            for _ in range(self.config.slice_steps):
                if self._job_done(h):
                    break
                start = self.t
                dt = self._execute_step(h)
                self.t = start + dt
                self._account_step(h, start, dt, view.n_devices)
                self.poll()
            if self._job_done(h):
                self._finish(h, self.t)
            else:
                h.state = "queued"
                ready.append(h)
        return self.metrics()

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, Any]:
        rows = [h.summary() for h in self.jobs.values()]
        done_at = [
            h.done_at for h in self.jobs.values() if h.done_at is not None
        ]
        makespan = max(done_at) if done_at else self.t
        total_device_seconds = self.config.cluster.n_devices * makespan
        p99s = [r["p99_step_s"] for r in rows if r["steps_done"] > 0]
        cache = self.cache.stats.as_dict()
        return {
            "policy": self.config.policy,
            "jobs": rows,
            "n_jobs": len(rows),
            "ticks": self.ticks,
            "makespan_s": makespan,
            "worst_p99_step_s": max(p99s) if p99s else 0.0,
            "mean_p99_step_s": float(np.mean(p99s)) if p99s else 0.0,
            "busy_device_seconds": self.busy_device_seconds,
            "device_idle_frac": (
                max(0.0, 1.0 - self.busy_device_seconds
                    / total_device_seconds)
                if total_device_seconds > 0 else 0.0
            ),
            "rebalances": self.rebalances,
            "host_failures": self.host_failures,
            "forced_revokes": sum(r["forced_revokes"] for r in rows),
            "requeued_requests": sum(r["requeued_requests"] for r in rows),
            "colocated_steps": sum(r["colocated_steps"] for r in rows),
            "windows_seen": sum(r["windows_seen"] for r in rows),
            "deferred_windows": sum(r["deferred_windows"] for r in rows),
            "lease": self.arbiter.stats(),
            "cross_job_hits": cache["cross_job_hits"],
            "cache": cache,
        }
