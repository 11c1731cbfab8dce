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

A :class:`CheckpointCallbacks` threads a checkpoint manager
(:mod:`repro_torch.ckpt`) through a bound session: periodic snapshots, a
snapshot-and-restore around a cooperative cluster change, and rollback to
the last durable snapshot plus a replay of the lost steps after a hard
host failure.

Without ``SessionConfig.mesh`` all of it runs in one process: the
planner's cluster is a spec, the engine runs on ``SessionConfig.device``.
With a mesh (a ``DeviceMesh`` over the ranks of a ``torch.distributed``
world, :func:`repro_torch.parallel.mesh_over_devices`) every rank runs the
same session and a bound one stands up the distributed
:class:`repro_torch.runtime.engine.WaveEngine`: plan device ``d`` is rank
``d``.  The live mesh follows the cluster: a straggler or a host failure
flattens it to 1-D over the healthy devices, full recovery restores the
configured mesh.  Rank 0's drained events are broadcast to every rank, so
every rank replans alike; checkpoints are written by the lowest rank of
the live mesh into a directory the ranks share and restored by every rank
of the new live mesh.
"""

from __future__ import annotations

import inspect
import time
import warnings
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

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
    #: a ``DeviceMesh`` over the ranks (``parallel.mesh_over_devices``):
    #: bound sessions then stand up ``WaveEngine(distributed=True)``, every
    #: rank running the same session, and a cluster change re-meshes over
    #: the healthy devices.  ``None`` = the one-process engine.
    mesh: Any = None


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
    """A :class:`repro_torch.ckpt.CheckpointManager` threaded through the
    session callbacks — the checkpoint ↔ lifecycle seam.

    ``on_step_end`` runs the manager's periodic ``maybe_save`` over the
    bound session's live ``(params, opt_state)``.  Attaching one of these
    ALSO arms the restore paths: a cluster-changing ``StragglerDetected``
    (or a flapped host's return) snapshots through this manager, replans
    around the hole and restores the snapshot onto the session's device
    (``ReplanRecord(mode="restore")``); a :class:`HostFailed` event with a
    newly dead host (no cooperative snapshot turn possible) rolls back to
    this manager's last *durable* snapshot and replays the lost steps
    (``ReplanRecord.rollback_steps``).  Pair it with an
    :class:`repro_torch.ckpt.AsyncCheckpointManager` to keep the periodic
    saves off the step turn.
    """

    def __init__(self, manager: Any, *, save_extra: Optional[Dict] = None):
        self.manager = manager
        self.save_extra = dict(save_extra or {})

    def on_step_end(self, session: "SpindleSession", step: int,
                    loss: float, dt: float) -> None:
        if session.params is None or not session.writes_checkpoints:
            return  # no state to snapshot, or another rank writes it
        self.manager.maybe_save(
            step,
            {"params": session.params, "opt": session.opt_state},
            extra={"loss": loss, **self.save_extra},
        )


@dataclass
class ReplanRecord:
    """What one signal-triggered replan did (handed to ``on_replan``)."""

    #: headline event (the last effective one of a coalesced burst)
    event: Event
    #: every effective event folded into this single replan
    events: Tuple[Event, ...] = ()
    #: "hit" (exact cache hit) | "incremental" | "full" | "fallback" |
    #: "restore" (checkpoint → replan → restore around a cluster change)
    mode: str = "full"
    #: how the underlying plan itself was obtained (== ``mode`` except on
    #: restore replans, where the planner mode is recorded here)
    plan_mode: str = ""
    #: wall time THIS replan spent in the cache/planner (≈0 on exact hits)
    planning_seconds: float = 0.0
    #: engine closures retained across the rebind (bound sessions only)
    closures_cached: Optional[int] = None
    model_rebuilt: bool = False
    #: checkpoint step the restore path restored (restore only)
    restored_step: Optional[int] = None
    #: hard-failure recovery only: completed steps rolled back to reach the
    #: last durable snapshot and replayed on the surviving topology (0 on
    #: cooperative restores, which snapshot the live state and lose nothing)
    rollback_steps: int = 0


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
        #: live mesh — flattened over the healthy devices on a cluster
        #: change, the configured one again on full recovery
        self.mesh = self.config.mesh
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
        self._warned_plan_only_ckpt = False
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

    @property
    def distributed(self) -> bool:
        """A bound session on the distributed engine (every rank runs it)."""
        return self.engine is not None and self.engine.distributed

    @property
    def writes_checkpoints(self) -> bool:
        """This process writes the session's snapshots: always on one
        process; the lowest rank of the live mesh when distributed."""
        return self.engine is None or self.engine.me == self.engine.live[0]

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
        if (self._checkpoint_manager() is not None and self.model is None
                and self.model_factory is None
                and not self._warned_plan_only_ckpt):
            self._warned_plan_only_ckpt = True
            warnings.warn(
                "session carries a CheckpointManager through its callbacks "
                "but is plan-only (no model or model_factory): periodic "
                "snapshots and failure recovery will silently not run "
                "until a model is bind()-ed explicitly",
                RuntimeWarning,
                stacklevel=2,
            )
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
                self.engine = WaveEngine(
                    self.model, p, distributed=self.config.mesh is not None,
                    mesh=self.mesh)
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
        loss, dt = self._train_step(
            batches if batches is not None else self._step_batches())
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

    def _train_step(self, batches: Dict[str, Dict]) -> Tuple[float, float]:
        """One engine step on the session's device; appends the loss to
        ``history``.  Returns (loss, seconds, including the device wait)."""
        import torch

        dev = self._device()
        b = {t: {k: v.to(dev) for k, v in tb.items()}
             for t, tb in batches.items()}
        t0 = time.perf_counter()
        self.params, self.opt_state, loss = self.engine.train_step(
            self.params, self.opt_state, b, self.optimizer,
            on_wave=self._fire_wave,
        )
        loss = float(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.history.append(loss)
        return loss, time.perf_counter() - t0

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
        coalesced into ONE replan (see :meth:`signal_all`).  When
        distributed, every rank drains its own sources and then applies
        rank 0's events, broadcast to the world (the straggler detector
        sees every host's times on rank 0 alone), so every rank replans
        alike."""
        fired: List[Event] = []
        for src in self.event_sources:
            fired.extend(src.poll())
        if self.distributed:
            import torch.distributed as dist

            box = [fired]
            dist.broadcast_object_list(box, src=0)
            fired = box[0]
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
        #: hosts newly LOST this burst (not a flap recovery): their device
        #: state is gone, so a bound session must roll back to the last
        #: durable snapshot instead of snapshotting live state
        hard_lost = dead - self._dead_hosts
        # Commit the simulated membership/cluster state — and roll it ALL
        # back if the factory, planner, params refresh or rebind below
        # raises, so a failed burst leaves the session exactly on its
        # previous (tasks, cluster, model, params, plan).  The engine
        # rebind is the LAST mutating step and validates before mutating;
        # observers are notified (on_plan/on_replan) only after the whole
        # turn succeeded.
        rollback = (
            self.tasks, self.cluster, self.mesh, self._straggler_hosts,
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

        # Restore path: a cluster change on a bound session with a
        # checkpoint manager threaded through the callbacks snapshots the
        # live state, replans around the hole and restores the snapshot.
        # A HARD failure (new dead hosts) cannot snapshot — it restores
        # the last durable snapshot and replays the lost steps instead.
        ckpt_mgr = (
            self._checkpoint_manager()
            if cluster_changed and self.engine is not None
            and self.step_count > 0 else None
        )  # nothing trained yet → plain shrink replan, nothing to restore
        hard = bool(hard_lost) and ckpt_mgr is not None
        restored_step: Optional[int] = None
        old_plan, old_model = self.current_plan, self.model
        old_live = self.engine.live if self.distributed else None
        try:
            if model_shift and self.model is not None:
                self._build_model()  # rebuild for the shifted task set
            if cluster_changed and self.config.mesh is not None:
                self.mesh = self._remesh()
            if ckpt_mgr is not None and not hard:
                # label = index of the last COMPLETED step — the convention
                # of the periodic path (on_step_end) and of the train
                # trainer's resume (start_step = manifest step + 1); the
                # old live mesh's lowest rank writes
                if self.writes_checkpoints:
                    ckpt_mgr.save(
                        self.step_count - 1,
                        {"params": self.params, "opt": self.opt_state},
                        extra={
                            "flagged_hosts": sorted(flagged),
                            "tasks": list(self.tasks or ()),
                        },
                    )
            if ckpt_mgr is not None and self.distributed:
                # what any rank restores must be durable before it reads:
                # the writer drains its saves, then every rank meets
                import torch.distributed as dist

                if self.writes_checkpoints:
                    ckpt_mgr.wait(raise_errors=False)
                dist.barrier()
            s = self.cache.stats
            before = (s.hits, s.incremental, s.fallbacks)
            t0 = time.perf_counter()
            p = self._get_or_plan()
            plan_seconds = time.perf_counter() - t0
            if ckpt_mgr is not None:
                restored_step = (
                    self._rollback_restore(ckpt_mgr) if hard
                    else self._remesh_restore(ckpt_mgr)
                )
            if self.engine is not None:
                if self.model is not old_model:
                    self._refresh_params()
                rebind_stats = self.engine.rebind(
                    p, model=self.model if self.model is not old_model
                    else None, mesh=self.mesh)
            if ckpt_mgr is None and old_live is not None and cluster_changed:
                self._share_state(old_live)
        except BaseException:
            (self.tasks, self.cluster, self.mesh, self._straggler_hosts,
             self._dead_hosts, self._lease, self.model, self.batches,
             self.params, self.opt_state) = rollback
            raise
        if p is not self.current_plan:
            self.current_plan = p
            self._fire("on_plan", p)
        rollback_steps = 0
        if hard and restored_step is not None:
            # the session is committed onto the surviving topology; now
            # replay the steps the rollback lost, so post-recovery state is
            # what an uninterrupted run on the survivors would have produced
            rollback_steps = self._replay_lost_steps(restored_step)
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
            mode="restore" if restored_step is not None else plan_mode,
            plan_mode=plan_mode,
            planning_seconds=plan_seconds,
            model_rebuilt=self.model is not old_model,
            restored_step=restored_step,
            rollback_steps=rollback_steps,
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

    # --------------------------------------------------------------- restore
    def _remesh(self) -> Any:
        """The live mesh for the just-committed cluster: 1-D over its
        healthy devices (the configured mesh's first axis) while hosts are
        evicted, the configured mesh itself on full recovery.  Every rank
        builds it (a ``DeviceMesh`` makes its groups collectively)."""
        if not (self._straggler_hosts or self._dead_hosts):
            return self.config.mesh
        from .parallel.mesh import mesh_over_devices

        return mesh_over_devices(
            self.cluster.healthy_devices(),
            axes=(self.config.mesh.mesh_dim_names[0],),
            device=self.config.mesh.device_type)

    def _share_state(self, old_live: Tuple[int, ...]) -> None:
        """A live mesh that grew without a checkpoint to restore: the
        params and moments are broadcast from the lowest rank that is in
        both the old and the new mesh (ranks that sat outside skipped the
        updates meanwhile)."""
        import torch
        import torch.distributed as dist

        new = self.engine.live  # already rebound to the new mesh
        if set(new) <= set(old_live):
            return  # shrunk: every survivor already holds the state
        both = sorted(set(new) & set(old_live))
        if not both:
            raise RuntimeError(f"re-mesh: no rank of {old_live} is in the "
                               f"new live mesh {new}")
        tensors = (list(self.params.parameters())
                   + list(self.opt_state.mu.values())
                   + list(self.opt_state.nu.values()))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, both[0])
        box = [self.opt_state.count]
        dist.broadcast_object_list(box, src=both[0])
        self.opt_state.count = box[0]

    def _restore(self, mgr: Any) -> Optional[int]:
        """Load ``mgr``'s latest durable snapshot onto the session's device
        into a NEW instance ``ModuleDict`` and ``OptState`` (the live ones,
        which the optimizer updates in place, stay as they are for the
        turn's rollback).  Returns the restored step, or ``None`` when the
        manager holds no snapshot.  When distributed, every rank of the
        live mesh loads its whole replica from the shared directory; a
        rank outside the live mesh keeps its state."""
        from .ckpt.remesh import fresh_module, restore_to_mesh

        tree, manifest = mgr.restore_latest(
            {"params": self.params, "opt": self.opt_state})
        if tree is None:
            return None
        if self.distributed and self.mesh.get_coordinate() is None:
            return int(manifest["step"])
        placed = restore_to_mesh(tree, self._device())
        self.params = fresh_module(self.params, placed["params"])
        self.opt_state = placed["opt"]
        return int(manifest["step"])

    def _remesh_restore(self, mgr: Any) -> int:
        """Restore the snapshot just taken (cooperative cluster change)."""
        step = self._restore(mgr)
        if step is None:
            raise RuntimeError(
                "elastic restore: checkpoint manager has no snapshot")
        return step

    def _rollback_restore(self, mgr: Any) -> Optional[int]:
        """Hard-failure restore: load the last DURABLE snapshot (no save —
        the dead host's state is gone).

        Returns the restored step, or ``None`` (with a warning) when the
        manager holds no snapshot yet — the in-process simulation then
        degrades to a plain shrink replan on the live state; a real cluster
        would have lost the run.
        """
        step = self._restore(mgr)
        if step is None:
            warnings.warn(
                "hard host failure with no durable snapshot to roll back "
                "to: recovering from live in-process state (a real "
                "deployment would have lost the run) — attach a "
                "CheckpointManager with every >= 1 before training",
                RuntimeWarning,
                stacklevel=3,
            )
        return step

    def _replay_lost_steps(self, restored_step: int) -> int:
        """Re-run the steps between the restored snapshot and the failure
        point on the already-rebound surviving engine.

        Rolling ``step_count`` back to ``restored_step + 1`` IS the
        data-cursor restore: params and moments come from the snapshot, and
        each replayed step refetches its batches through the step-indexed
        ``batch_fn`` (or reuses the static batches).  Observers see the
        replayed steps through ``on_step_end`` — so periodic snapshots keep
        their cadence — but event sources are NOT polled (recovery must not
        recursively replan mid-replay).
        """
        target = self.step_count
        resume = restored_step + 1
        if resume >= target:
            return 0
        del self.history[resume:]
        self.step_count = resume
        for _ in range(target - resume):
            loss, dt = self._train_step(self._step_batches())
            step_idx = self.step_count
            self.step_count += 1
            self._fire("on_step_end", step_idx, loss, dt)
        return target - resume
