"""SpindleSession — one lifecycle API: plan → replan (port of the plan-only
path of ``repro/session.py``, §5.5).

    session = SpindleSession(SessionConfig(workload="multitask_clip"))
    session.plan()                                  # through the PlanCache
    session.signal(StragglerDetected((1,)))         # replan around the host

A session plans a workload — a named :data:`repro_torch.core.workloads.
WORKLOADS` entry or a ``graph_factory`` building a graph per task set —
through the :class:`repro_torch.core.plancache.PlanCache` (exact hit /
incremental replan / full plan) and replans on lifecycle events
(:mod:`repro_torch.launch.events`): task arrivals and completions change
the task set, straggler and host-failure events shrink the live cluster,
lease changes replace its base.  Observers subscribe through
:class:`SessionCallbacks` (``on_plan`` / ``on_replan``), and event
*sources* are drained by :meth:`SpindleSession.poll`.

This is the **plan-only** flavour.  The JAX session's bound flavour — a
model, the wave engine, training steps, checkpoints and elastic restores —
comes with the wavefront training path: :meth:`SpindleSession.bind`,
:meth:`~SpindleSession.step` and :meth:`~SpindleSession.run` raise
``NotImplementedError`` naming that ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .core.costmodel import ICI_BW, H100, HardwareSpec
from .core.estimator import TimeFn
from .core.graph import TaskGraph
from .core.placement import ClusterSpec
from .core.plan import ExecutionPlan
from .core.plancache import PlanCache
from .launch.events import (
    Event,
    HostFailed,
    LeaseChanged,
    StragglerDetected,
    TaskArrived,
    TaskCompleted,
)

__all__ = [
    "SessionConfig",
    "SessionCallbacks",
    "ReplanRecord",
    "SpindleSession",
]

_TRAINING = "ROADMAP queue 1, item 3 (the wavefront training path)"


@dataclass(frozen=True)
class SessionConfig:
    """Typed, immutable inputs of one plan-only session: the workload (a
    named planner workload, or a ``graph_factory`` on the session), the
    planner strategy + options, the cluster spec, the cache policy and the
    replan triggers."""

    # cluster + planner strategy: two 8-card H100 NVLink islands
    cluster: ClusterSpec = ClusterSpec(
        n_devices=16, island_size=8, mem_bytes=80e9, intra_island_bw=ICI_BW
    )
    planner: str = "spindle"
    placement_strategy: str = "spindle"
    profile_powers_of_two: bool = True
    hw: HardwareSpec = H100
    time_fn: Optional[TimeFn] = None
    #: named repro_torch.core.workloads entry for plan-only sessions
    workload: Optional[str] = None
    # cache policy
    cache_maxsize: int = 32
    curve_memo_max: int = 8192
    #: event kinds that trigger a replan (subset of launch.events.EVENT_KINDS)
    replan_on: Tuple[str, ...] = (
        "task_arrived", "task_completed", "straggler", "host_failed",
        "lease_changed",
    )
    #: evict flagged hosts before a straggler replan: the flagged hosts'
    #: OWN device blocks (``ClusterSpec.devices_of``) leave the schedulable
    #: pool — placement routes around the hole — always relative to the
    #: configured cluster, restored when the flagged set empties.
    straggler_shrink: bool = False


class SessionCallbacks:
    """Observer protocol — subclass and override what you need.

    ``on_plan`` fires whenever a *new* plan becomes current (initial plan
    and every replan); ``on_replan`` after a signal's replan completed (so
    it sees the session already on the new plan).
    """

    def on_plan(self, session: "SpindleSession",
                plan: ExecutionPlan) -> None:
        pass

    def on_replan(self, session: "SpindleSession", event: Event,
                  old_plan: Optional[ExecutionPlan],
                  new_plan: ExecutionPlan, info: "ReplanRecord") -> None:
        pass


@dataclass
class ReplanRecord:
    """What one signal-triggered replan did (handed to ``on_replan``)."""

    #: headline event (the last effective one of a coalesced burst)
    event: Event
    #: every effective event folded into this single replan
    events: Tuple[Event, ...] = ()
    #: "hit" (exact cache hit) | "incremental" | "full" | "fallback"
    mode: str = "full"
    #: how the underlying plan itself was obtained (== ``mode`` on the
    #: plan-only path)
    plan_mode: str = ""
    #: wall time THIS replan spent in the cache/planner (≈0 on exact hits)
    planning_seconds: float = 0.0


GraphFactory = Callable[[Tuple[str, ...]], TaskGraph]


class SpindleSession:
    """The lifecycle facade: plan → replan, re-entrant (plan-only)."""

    def __init__(
        self,
        config: Optional[SessionConfig] = None,
        *,
        graph_factory: Optional[GraphFactory] = None,
        tasks: Optional[Sequence[str]] = None,
        callbacks: Sequence[SessionCallbacks] = (),
        event_sources: Sequence[Any] = (),
        cache: Optional[PlanCache] = None,
    ):
        self.config = config or SessionConfig()
        # NOT `cache or ...`: an empty PlanCache is falsy (len 0) but still
        # the caller's cache — sharing one across sessions must work
        self.cache = cache if cache is not None else PlanCache(
            maxsize=self.config.cache_maxsize,
            curve_memo_max=self.config.curve_memo_max,
        )
        self.callbacks: List[SessionCallbacks] = list(callbacks)
        self.event_sources: List[Any] = list(event_sources)
        self.graph_factory = graph_factory
        self.tasks: Optional[Tuple[str, ...]] = (
            tuple(tasks) if tasks is not None else None
        )
        #: live cluster — flagged hosts' device blocks leave the pool on
        #: straggler events (straggler_shrink), restored on recovery
        self.cluster = self.config.cluster
        #: externally-arbitrated lease view (fleet scheduler): when set, it
        #: replaces ``config.cluster`` as the base the live cluster derives
        #: from — straggler shrinks then apply to the lease's own host
        #: indices (view-local), and the arbiter owns the physical mapping
        self._lease: Optional[ClusterSpec] = None
        self._straggler_hosts: frozenset = frozenset()
        #: hosts confirmed dead by HostFailed events (hard failures), kept
        #: apart from the straggler flags: eviction is unconditional (not
        #: gated on ``straggler_shrink``)
        self._dead_hosts: frozenset = frozenset()
        self.current_plan: Optional[ExecutionPlan] = None
        #: set False (e.g. by a serving session around a structural shift —
        #: a new request family) to force the next plan to be full, not
        #: incremental, when its signature misses the cache
        self.incremental = True
        self.replans: List[ReplanRecord] = []

    # ------------------------------------------------------------- plumbing
    def _fire(self, name: str, *args) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is not None:
                fn(self, *args)

    def _graph(self) -> TaskGraph:
        if self.graph_factory is not None:
            return self.graph_factory(self.tasks or ())
        if self.config.workload is not None:
            from .core.workloads import WORKLOADS

            if self.config.workload not in WORKLOADS:
                raise ValueError(
                    f"unknown workload {self.config.workload!r}; "
                    f"choose from {sorted(WORKLOADS)}"
                )
            return WORKLOADS[self.config.workload]()
        raise ValueError(
            "session has no workload: pass graph_factory or set "
            "SessionConfig.workload"
        )

    def _get_or_plan(self) -> ExecutionPlan:
        """Plan through the cache WITHOUT committing/notifying (signal_all
        commits only after the whole replan turn succeeded)."""
        return self.cache.get_or_plan(
            self._graph(),
            self.cluster,
            planner=self.config.planner,
            time_fn=self.config.time_fn,
            hw=self.config.hw,
            placement_strategy=self.config.placement_strategy,
            profile_powers_of_two=self.config.profile_powers_of_two,
            incremental=self.incremental,
        )

    # ------------------------------------------------------------ lifecycle
    def plan(self) -> ExecutionPlan:
        """Build (or fetch) the ExecutionPlan for the current workload.

        Always goes through the PlanCache: exact workload-signature hits
        return the stored plan, shifted workloads replan incrementally,
        everything else plans from scratch via the registered pipeline.
        Fires ``on_plan`` when the current plan actually changed.
        """
        p = self._get_or_plan()
        if p is not self.current_plan:
            self.current_plan = p
            self._fire("on_plan", p)
        return p

    def bind(self, model: Any = None, *,
             tasks: Optional[Sequence[str]] = None) -> "SpindleSession":
        """Not ported: binding a model to the wave engine."""
        raise NotImplementedError(
            f"SpindleSession.bind is not ported to repro_torch yet: "
            f"{_TRAINING}")

    def step(self, batches: Optional[Dict[str, Dict]] = None) -> float:
        """Not ported: one training step on the bound engine."""
        raise NotImplementedError(
            f"SpindleSession.step is not ported to repro_torch yet: "
            f"{_TRAINING}")

    def run(self, steps: int,
            batches: Optional[Dict[str, Dict]] = None) -> Dict[str, Any]:
        """Not ported: training steps on the bound engine."""
        raise NotImplementedError(
            f"SpindleSession.run is not ported to repro_torch yet: "
            f"{_TRAINING}")

    def poll(self) -> List[Event]:
        """Drain every event source; everything that fired in this cycle is
        coalesced into ONE replan (see :meth:`signal_all`)."""
        fired: List[Event] = []
        for src in self.event_sources:
            fired.extend(src.poll())
        if fired:
            self.signal_all(fired)
        return fired

    # --------------------------------------------------------------- events
    def signal(self, event: Event) -> Optional[ExecutionPlan]:
        """Handle one lifecycle event — the §5.5 re-plan hook.

        Task arrivals/completions update the active task set; straggler
        events optionally shrink the live cluster (by the currently flagged
        host set, always relative to the configured cluster — re-fires
        never compound).  If the event kind is in ``config.replan_on``, the
        workload replans through the cache.  Events the policy ignores —
        duplicate arrivals, completions of absent tasks, and any task event
        on a session that does not track membership (``tasks=None``) —
        leave ALL session state untouched and return ``None``.
        """
        return self.signal_all((event,))

    def adopt_cluster(self, cluster: ClusterSpec) -> None:
        """Adopt an externally-arbitrated cluster view WITHOUT replanning.

        The silent counterpart of signalling :class:`LeaseChanged`: the
        lease becomes the session's base topology immediately, but no
        planner turn runs — the next ``plan()``/``signal`` plans over it.
        For sessions with nothing plannable right now (a drained serving
        mix, a job queued behind admission).
        """
        self._lease = cluster
        base = cluster if cluster is not None else self.config.cluster
        self.cluster = base.shrink(self._straggler_hosts)

    def apply_lease(self, cluster: ClusterSpec) -> Optional[ReplanRecord]:
        """Adopt an arbitrated lease view — the uniform protocol method every
        schedulable session exposes (``ServingSession`` implements the same
        signature).

        First lease (no current plan yet): adopt silently and plan over it.
        Subsequent leases: signal :class:`LeaseChanged` and return the
        resulting :class:`ReplanRecord` (``None`` when the view was equal
        and no replan fired).
        """
        if self.current_plan is None:
            self.adopt_cluster(cluster)
            self.plan()
            return None
        n = len(self.replans)
        self.signal(LeaseChanged(cluster=cluster))
        return self.replans[n] if len(self.replans) > n else None

    def signal_all(self, events: Sequence[Event]) -> Optional[ExecutionPlan]:
        """Handle a burst of events with ONE coalesced replan.

        All membership/cluster updates are applied first, then the workload
        replans once — a phase shift arriving as N task events costs one
        planner invocation, not N (intermediate task sets are never
        planned).  Returns the new plan, or ``None`` when no event was
        effective.
        """
        # Simulate the whole burst against local copies first: no session
        # state is touched until we know the burst is effective (so a raise
        # below leaves the session exactly as it was).
        effective: List[Event] = []
        tasks = self.tasks
        flagged = self._straggler_hosts
        dead = self._dead_hosts
        lease = self._lease
        for event in events:
            if event.kind not in self.config.replan_on:
                continue
            if isinstance(event, TaskArrived):
                if tasks is None or event.task in tasks:
                    continue  # untracked membership / duplicate: no-op
                tasks = tasks + (event.task,)
            elif isinstance(event, TaskCompleted):
                if tasks is None or event.task not in tasks:
                    continue  # untracked membership / absent task: no-op
                tasks = tuple(t for t in tasks if t != event.task)
            elif isinstance(event, LeaseChanged):
                base = lease if lease is not None else self.config.cluster
                if event.cluster == base:
                    continue  # re-granted the same view: no-op
                lease = event.cluster
            elif isinstance(event, HostFailed):
                # hard failures evict unconditionally (no straggler_shrink
                # gate); the event carries the FULL currently-dead set, so
                # a shrinking set is a flapped host returning
                cluster0 = (
                    lease if lease is not None else self.config.cluster
                )
                new_dead = frozenset(
                    h for h in event.hosts if 0 <= h < cluster0.n_hosts
                )
                if len(new_dead | flagged) >= cluster0.n_hosts:
                    new_dead = dead  # never evict the whole cluster
                if new_dead == dead:
                    continue  # duplicate / recovery no-op / capped flood
                dead = new_dead
            elif isinstance(event, StragglerDetected):
                # the event carries the FULL currently-flagged set,
                # host-indexed against the session's base topology (the
                # lease view when one is injected)
                cluster0 = (
                    lease if lease is not None else self.config.cluster
                )
                new_flagged = frozenset(
                    h for h in event.hosts if 0 <= h < cluster0.n_hosts
                )
                if self.config.straggler_shrink:
                    # never evict the whole cluster: a flood flagging every
                    # host degrades to a replan without eviction
                    evictable = (
                        new_flagged
                        if len(new_flagged | dead) < cluster0.n_hosts
                        else flagged
                    )
                    if evictable != flagged:
                        flagged = evictable
                    elif frozenset(event.hosts) == flagged or not event.hosts:
                        continue  # true duplicate / recovery no-op
                    # else: the event carries hosts the topology cannot map
                    # (detector/cluster n_hosts mismatch, or the flood
                    # above) — still replan rather than silently dropping
                    # the fault signal
                elif not event.hosts:
                    continue  # recovery is a no-op when nothing was shrunk
            effective.append(event)
        if not effective:
            return None
        # Commit the simulated membership/cluster state — and roll it ALL
        # back if the planner raises, so a failed burst leaves the session
        # exactly on its previous (tasks, cluster, plan); observers are
        # notified (on_plan/on_replan) only after the whole turn succeeded.
        rollback = (
            self.tasks, self.cluster, self._straggler_hosts,
            self._dead_hosts, self._lease,
        )
        self.tasks = tasks
        if (flagged != self._straggler_hosts or dead != self._dead_hosts
                or lease is not self._lease):
            self._straggler_hosts = flagged
            self._dead_hosts = dead
            self._lease = lease
            # topology-aware eviction over the session's base topology (an
            # injected lease view, else the configured cluster): the
            # flagged + dead hosts' OWN device blocks leave the pool
            # (shrink(()) ≡ full recovery — the spec then compares equal
            # to the base)
            base = lease if lease is not None else self.config.cluster
            self.cluster = base.shrink(flagged | dead)
        event = effective[-1]  # the record's headline event
        old_plan = self.current_plan
        try:
            s = self.cache.stats
            before = (s.hits, s.incremental, s.fallbacks)
            t0 = time.perf_counter()
            p = self._get_or_plan()
            plan_seconds = time.perf_counter() - t0
        except BaseException:
            (self.tasks, self.cluster, self._straggler_hosts,
             self._dead_hosts, self._lease) = rollback
            raise
        if p is not self.current_plan:
            self.current_plan = p
            self._fire("on_plan", p)
        if s.fallbacks > before[2]:
            plan_mode = "fallback"
        elif s.hits > before[0]:
            plan_mode = "hit"
        elif s.incremental > before[1]:
            plan_mode = "incremental"
        else:
            plan_mode = "full"
        info = ReplanRecord(
            event=event,
            events=tuple(effective),
            mode=plan_mode,
            plan_mode=plan_mode,
            planning_seconds=plan_seconds,
        )
        self.replans.append(info)
        self._fire("on_replan", event, old_plan, p, info)
        return p
