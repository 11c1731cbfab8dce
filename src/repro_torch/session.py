"""SpindleSession — one lifecycle API: plan → bind → execute → replan (port
of ``repro/session.py``, §5.5).

    session = SpindleSession(SessionConfig(device="cuda"),
                             model_factory=lambda tasks: tiny_multitask_clip(
                                 n_tasks=len(tasks)),
                             tasks=("img_text", "audio_text"))
    session.bind()                  # plan (through the PlanCache) + engine
    session.run(steps=100)          # wave-by-wave training steps
    session.signal(TaskCompleted("audio_text"))   # replan + rebind mid-run
    session.run(steps=100)          # continues on the rebound plan

A session plans a workload through the
:class:`repro_torch.core.plancache.PlanCache` (exact hit / incremental
replan / full plan) and replans on lifecycle events
(:mod:`repro_torch.launch.events`): task arrivals and completions change
the task set, straggler and host-failure events shrink the live cluster,
lease changes replace its base.  Observers subscribe through
:class:`SessionCallbacks` (``on_plan`` / ``on_wave`` / ``on_replan`` /
``on_step_end``), and event *sources* are drained once per step.

Sessions come in two flavours:

  * **bound** — an :class:`repro_torch.runtime.mtmodel.MTModel` (or a
    ``model_factory`` building one per task set) is attached; ``step`` /
    ``run`` execute training iterations on ``SessionConfig.device`` (the
    GPU unless the caller asks for the CPU) through the
    :class:`repro_torch.runtime.engine.WaveEngine`, and replans rebind the
    live engine without rebuilding unchanged step closures.
  * **plan-only** — no executable model (a named
    :data:`repro_torch.core.workloads.WORKLOADS` entry or a
    ``graph_factory``); ``plan`` / ``signal`` still work.

Checkpoints, elastic restores and rollback after a host failure come with
multi-GPU runs (ROADMAP queue 1, item 5): :class:`CheckpointCallbacks`
raises, and so does a cluster-changing event on a bound session that
carries a checkpoint manager through its callbacks.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from .ckpt.straggler import ITEM_5
from .core.costmodel import ICI_BW, H100, HardwareSpec
from .core.estimator import TimeFn
from .core.graph import TaskGraph
from .core.placement import ClusterSpec
from .core.plan import ExecutionPlan, PlanStep
from .core.plancache import PlanCache
from .launch.events import (
    Event,
    HostFailed,
    LeaseChanged,
    StragglerDetected,
    TaskArrived,
    TaskCompleted,
    process_index,
)

__all__ = [
    "SessionConfig",
    "SessionCallbacks",
    "CheckpointCallbacks",
    "ReplanRecord",
    "SpindleSession",
]


@dataclass(frozen=True)
class SessionConfig:
    """Typed, immutable inputs of one session: the workload (a named
    planner workload for plan-only sessions — bound sessions get their
    graph from the model), the planner strategy + options, the cluster
    spec, the cache policy, the replan triggers, and the training
    hyperparameters and device of a bound session."""

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
    # train hyperparameters (bound sessions)
    lr: float = 5e-3
    weight_decay: float = 0.0
    seed: int = 0
    #: where a bound session's params, batches and steps live ("cpu" only
    #: when asked for; "cuda" without a GPU raises at bind)
    device: str = "cuda"


class SessionCallbacks:
    """Observer protocol — subclass and override what you need.

    Firing order per lifecycle turn: ``on_plan`` whenever a *new* plan
    becomes current (initial plan and every replan), ``on_wave`` after each
    forward wave of a step, ``on_step_end`` after the optimizer update,
    ``on_replan`` after a signal's replan+rebind completed (so it sees the
    session already on the new plan).
    """

    def on_plan(self, session: "SpindleSession",
                plan: ExecutionPlan) -> None:
        pass

    def on_wave(self, session: "SpindleSession", wave_index: int,
                steps: List[PlanStep], windows=None) -> None:
        """``windows`` is the wave's list of
        :class:`repro_torch.core.timeline.IdleWindow` records, or ``None``
        when the plan carries no timeline.  Overrides that omit the
        parameter keep working — the session passes it only to callbacks
        whose signature accepts it."""
        pass

    def on_replan(self, session: "SpindleSession", event: Event,
                  old_plan: Optional[ExecutionPlan],
                  new_plan: ExecutionPlan, info: "ReplanRecord") -> None:
        pass

    def on_step_end(self, session: "SpindleSession", step: int,
                    loss: float, dt: float) -> None:
        pass


class CheckpointCallbacks(SessionCallbacks):
    """The JAX package's checkpoint ↔ lifecycle seam (periodic saves,
    elastic restore, rollback after a host failure): not ported yet."""

    def __init__(self, manager: Any, *, save_extra: Optional[Dict] = None):
        raise NotImplementedError(
            f"CheckpointCallbacks is not ported to repro_torch yet: {ITEM_5}")


@dataclass
class ReplanRecord:
    """What one signal-triggered replan did (handed to ``on_replan``)."""

    #: headline event (the last effective one of a coalesced burst)
    event: Event
    #: every effective event folded into this single replan
    events: Tuple[Event, ...] = ()
    #: "hit" (exact cache hit) | "incremental" | "full" | "fallback"
    mode: str = "full"
    #: how the underlying plan itself was obtained (== ``mode``: the
    #: JAX session's "restore" mode comes with checkpoints, item 5)
    plan_mode: str = ""
    #: wall time THIS replan spent in the cache/planner (≈0 on exact hits)
    planning_seconds: float = 0.0
    #: engine closures retained across the rebind (bound sessions only)
    closures_cached: Optional[int] = None
    model_rebuilt: bool = False


#: a model factory returns an MTModel or an (MTModel, batches) pair
ModelFactory = Callable[[Tuple[str, ...]], Union[Any, Tuple[Any, Dict]]]
GraphFactory = Callable[[Tuple[str, ...]], TaskGraph]


class SpindleSession:
    """The lifecycle facade: plan → bind → execute → replan, re-entrant."""

    def __init__(
        self,
        config: Optional[SessionConfig] = None,
        *,
        model: Any = None,
        model_factory: Optional[ModelFactory] = None,
        graph_factory: Optional[GraphFactory] = None,
        tasks: Optional[Sequence[str]] = None,
        batches: Optional[Dict[str, Dict]] = None,
        batch_fn: Optional[Callable[[int], Dict[str, Dict]]] = None,
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
        self.model_factory = model_factory
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
        self.model = None
        #: task → batch dict (CPU or device tensors; each step moves them
        #: to the session's device)
        self.batches = batches
        #: step-indexed data cursor: when set, ``step()`` fetches
        #: ``batch_fn(step_count)``
        self.batch_fn = batch_fn
        self.engine = None
        #: the instance ``nn.ModuleDict`` of a bound session
        self.params = None
        self.opt_state: Any = None
        self.optimizer = None
        self.current_plan: Optional[ExecutionPlan] = None
        #: set False (e.g. by a serving session around a structural shift —
        #: a new request family) to force the next plan to be full, not
        #: incremental, when its signature misses the cache
        self.incremental = True
        self.step_count = 0
        self.history: List[float] = []
        self.replans: List[ReplanRecord] = []
        if model is not None:
            self.bind(model)

    # ------------------------------------------------------------- plumbing
    def _fire(self, name: str, *args) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is not None:
                fn(self, *args)

    @staticmethod
    def _accepts_windows(fn: Callable) -> bool:
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return False
        return any(p.kind is inspect.Parameter.VAR_KEYWORD
                   or p.name == "windows" for p in sig.parameters.values())

    def _fire_wave(self, wave_index: int, steps: List[PlanStep]) -> None:
        """Fire ``on_wave``, attaching the wave's idle windows for callbacks
        that opt in (a ``windows`` parameter or ``**kwargs``); two-argument
        overrides are called unchanged."""
        windows: Optional[List[Any]] = None
        computed = False
        for cb in self.callbacks:
            fn = getattr(cb, "on_wave", None)
            if fn is None:
                continue
            if self._accepts_windows(fn):
                if not computed:
                    computed = True
                    p = self.current_plan
                    if p is not None:
                        try:
                            windows = p.timeline().wave_windows(wave_index)
                        except ValueError:  # no recorded cluster
                            windows = None
                fn(self, wave_index, steps, windows=windows)
            else:
                fn(self, wave_index, steps)

    def _device(self):
        from .config import resolve_device

        return resolve_device(self.config.device)

    def _build_model(self) -> None:
        if self.model_factory is None:
            raise ValueError(
                "session has no model_factory; bind(model) explicitly"
            )
        out = self.model_factory(self.tasks or ())
        if isinstance(out, tuple):
            self.model, self.batches = out
        else:
            self.model = out

    def _refresh_params(self) -> None:
        """(Re-)derive params/optimizer for the current model.

        Instances whose name survives a task shift (shared towers, per-task
        components of continuing tasks) keep their trained values; new
        instances are freshly initialized.  Optimizer moments restart —
        the model's parameter set changed.  A new ``ModuleDict`` and state
        are built (the old ones are left as they were, for a rollback)."""
        from torch import nn

        from .optim import AdamW

        if self.optimizer is None:
            self.optimizer = AdamW(lr=self.config.lr,
                                   weight_decay=self.config.weight_decay)
        fresh = self.model.init(self.config.seed, device=self._device())
        old = self.params if self.params is not None else {}
        self.params = nn.ModuleDict({k: old[k] if k in old else v
                                     for k, v in fresh.items()})
        self.opt_state = self.optimizer.init(
            dict(self.params.named_parameters()))

    def _graph(self) -> TaskGraph:
        if self.model is not None:
            return self.model.graph
        if self.model_factory is not None:
            self._build_model()
            return self.model.graph
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
            "session has no workload: pass model/model_factory/"
            "graph_factory or set SessionConfig.workload"
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
        """Attach an executable MTModel (or build one via the factory) and
        stand up the WaveEngine on the current plan.

        Binding an explicit ``model`` also refreshes task membership —
        from ``tasks`` if given, else derived from the model's flows.  A
        failure anywhere (factory, planner, params init, engine) rolls the
        session back to its previous model, batches, params, optimizer
        state, plan and tasks — the engine rebind is the last mutating
        step, so session and engine never end up on different (model,
        plan) pairs.
        """
        from .runtime.engine import WaveEngine

        rollback = (
            self.model, self.batches, self.params, self.opt_state,
            self.current_plan, self.tasks,
        )
        try:
            model_changed = False
            if model is not None:
                model_changed = model is not self.model
                self.model = model
                if tasks is not None:
                    self.tasks = tuple(tasks)
                else:
                    flows = getattr(model, "flows", None)
                    if flows is not None:
                        self.tasks = tuple(f.task for f in flows)
            elif self.model is None:
                self._build_model()
                model_changed = True
            p = self._get_or_plan()
            if model_changed or self.params is None:
                self._refresh_params()
            if self.engine is None:
                self.engine = WaveEngine(self.model, p)
            else:
                self.engine.rebind(
                    p, model=self.model if model_changed else None)
        except BaseException:
            (self.model, self.batches, self.params, self.opt_state,
             self.current_plan, self.tasks) = rollback
            raise
        if p is not self.current_plan:
            self.current_plan = p
            self._fire("on_plan", p)
        return self

    def step(self, batches: Optional[Dict[str, Dict]] = None) -> float:
        """One training step on the bound engine.

        Fires ``on_wave`` per forward wave and ``on_step_end`` after the
        update, then drains every event source — a straggler or workload
        shift detected at step *t* replans before step *t+1* begins.  The
        step time includes waiting for the device.
        """
        if self.engine is None:
            raise RuntimeError("bind() a model before calling step()")
        import torch

        dev = self._device()
        b = batches if batches is not None else self._step_batches()
        b = {t: {k: v.to(dev) for k, v in tb.items()} for t, tb in b.items()}
        t0 = time.perf_counter()
        self.params, self.opt_state, loss = self.engine.train_step(
            self.params, self.opt_state, b, self.optimizer,
            on_wave=self._fire_wave,
        )
        loss = float(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.history.append(loss)
        step_idx = self.step_count
        self.step_count += 1
        for src in self.event_sources:
            # prefer the aggregated per-host feed (a TimingCollector behind
            # record_step); the raw (host, dt) feed cannot flag by itself
            rec_step = getattr(src, "record_step", None)
            if rec_step is not None:
                rec_step(dt)
                continue
            rec = getattr(src, "record", None)
            if rec is not None:
                rec(process_index(), dt)
        self._fire("on_step_end", step_idx, loss, dt)
        self.poll()
        return loss

    def _step_batches(self) -> Dict[str, Dict]:
        """The current step's batches: the ``batch_fn`` data cursor (keyed
        by ``step_count``) when one is set, else the static batches."""
        if self.batch_fn is not None:
            return self.batch_fn(self.step_count)
        if self.batches is None:
            raise ValueError(
                "no batches: pass step(batches=...), set batch_fn=, or use "
                "a model_factory returning (model, batches)"
            )
        return self.batches

    def run(self, steps: int,
            batches: Optional[Dict[str, Dict]] = None) -> Dict[str, Any]:
        """Run ``steps`` training steps (each one polls the event sources)."""
        for _ in range(steps):
            self.step(batches)
        return {
            "steps": self.step_count,
            "history": list(self.history),
            "final_loss": self.history[-1] if self.history else None,
            "replans": list(self.replans),
        }

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

        Task arrivals/completions update the active task set (and rebuild
        the model via the factory, when bound); straggler events optionally
        shrink the live cluster (by the currently flagged host set, always
        relative to the configured cluster — re-fires never compound).  If
        the event kind is in ``config.replan_on``, the workload replans
        through the cache and a bound engine rebinds to the new plan
        without rebuilding unchanged step closures.  Events the policy
        ignores —
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
        replans once and the engine rebinds once — a phase shift arriving as
        N task events costs one planner invocation, not N (intermediate
        task sets are never planned).  Returns the new plan, or ``None``
        when no event was effective.
        """
        # Simulate the whole burst against local copies first: no session
        # state is touched until we know the burst is effective AND legal
        # (so a raise below leaves the session exactly as it was).
        model_shift = False
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
                model_shift = True
            elif isinstance(event, TaskCompleted):
                if tasks is None or event.task not in tasks:
                    continue  # untracked membership / absent task: no-op
                tasks = tuple(t for t in tasks if t != event.task)
                model_shift = True
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
        if model_shift and self.model is not None and (
            self.model_factory is None
        ):
            raise RuntimeError(
                "session has a bound model but no model_factory: task "
                "membership shifts cannot be applied — construct the "
                "session with model_factory=, or rebuild the shifted "
                "model yourself and bind() it"
            )
        cluster_changed = (flagged != self._straggler_hosts
                           or dead != self._dead_hosts
                           or lease is not self._lease)
        if (cluster_changed and self.engine is not None
                and self.step_count > 0
                and self._checkpoint_manager() is not None):
            raise NotImplementedError(
                f"elastic restore and rollback through a checkpoint manager "
                f"are not ported to repro_torch yet: {ITEM_5}")
        # Commit the simulated membership/cluster state — and roll it ALL
        # back if the factory, planner, params refresh or rebind below
        # raises, so a failed burst leaves the session exactly on its
        # previous (tasks, cluster, model, params, plan).  The engine
        # rebind is the LAST mutating step and validates before mutating;
        # observers are notified (on_plan/on_replan) only after the whole
        # turn succeeded.
        rollback = (
            self.tasks, self.cluster, self._straggler_hosts,
            self._dead_hosts, self._lease, self.model, self.batches,
            self.params, self.opt_state,
        )
        self.tasks = tasks
        if cluster_changed:
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
        old_plan, old_model = self.current_plan, self.model
        try:
            if model_shift and self.model is not None:
                self._build_model()  # rebuild for the shifted task set
            s = self.cache.stats
            before = (s.hits, s.incremental, s.fallbacks)
            t0 = time.perf_counter()
            p = self._get_or_plan()
            plan_seconds = time.perf_counter() - t0
            if self.engine is not None:
                if self.model is not old_model:
                    self._refresh_params()
                rebind_stats = self.engine.rebind(
                    p, model=self.model if self.model is not old_model
                    else None)
        except BaseException:
            (self.tasks, self.cluster, self._straggler_hosts,
             self._dead_hosts, self._lease, self.model, self.batches,
             self.params, self.opt_state) = rollback
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
            model_rebuilt=self.model is not old_model,
        )
        if self.engine is not None:
            info.closures_cached = rebind_stats["closures_cached"]
        self.replans.append(info)
        self._fire("on_replan", event, old_plan, p, info)
        return p

    def _checkpoint_manager(self) -> Optional[Any]:
        """A checkpoint manager carried by a callback (``manager`` with
        ``save`` and ``restore_latest``), if any."""
        for cb in self.callbacks:
            mgr = getattr(cb, "manager", None)
            if mgr is not None and hasattr(mgr, "save") and (
                    hasattr(mgr, "restore_latest")):
                return mgr
        return None
