"""Staged planner pipeline with swappable strategies (DESIGN.md §9).

The Spindle planner (contraction → scaling curves → allocation → wavefront
schedule → placement, Fig. 2) is decomposed into four protocol-style stages:

  * :class:`EstimatorStage` — builds the scalability estimator (§3.2),
  * :class:`AllocatorStage` — per-MetaLevel resource allocation (§3.3),
  * :class:`SchedulerStage` — turns allocations into a Schedule (§3.4),
  * :class:`PlacementStage` — maps wave entries to device ids (§3.5).

A :class:`PlannerPipeline` composes one implementation of each; pipelines are
registered by name so ``plan(..., planner="optimus")``, the simulator, and
the benchmarks all resolve the same strategies through one registry:

  * ``spindle``     — the paper's planner (wavefront scheduling).
  * ``sequential``  — Megatron/DeepSpeed-style temporal decoupling: every
                      MetaOp serially on its widest valid allocation.
  * ``distmm_mt``   — DistMM-MT: tasks sequential, concurrent towers inside
                      a task share devices via the balanced allocator.
  * ``optimus``     — task-level greedy marginal-gain allocation; tasks run
                      concurrently on fixed disjoint device blocks.

Baselines produce real :class:`ExecutionPlan` objects (schedule + placement
+ steps), so the simulator needs no planner-specific code paths.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from .allocator import (
    BracketMemo,
    LevelAllocation,
    allocate_balanced,
    allocate_level,
)
from .contraction import MetaGraph, MetaOp, contract
from .costmodel import HardwareSpec, H100, make_time_fn
from .estimator import (
    ScalabilityEstimator,
    ScalingCurve,
    TimeFn,
    best_config,
    valid_allocations,
)
from .graph import TaskGraph
from .placement import ClusterSpec, PlacedEntry, Placement, place
from .plan import ExecutionPlan, assemble_plan
from .scheduler import Schedule, Wave, WaveEntry, check_schedule, schedule


@dataclass(frozen=True)
class PlanContext:
    """Immutable per-plan inputs threaded through every stage."""

    graph: TaskGraph
    cluster: ClusterSpec
    hw: HardwareSpec = H100
    time_fn: Optional[TimeFn] = None

    def resolve_time_fn(self) -> TimeFn:
        return self.time_fn or make_time_fn(self.hw)

    @property
    def capacity(self) -> int:
        """Schedulable device count: the cluster minus flagged hosts'
        blocks (== n_devices on a fully healthy cluster)."""
        return self.cluster.n_healthy


# --------------------------------------------------------------------------
# Stage protocols
# --------------------------------------------------------------------------


class EstimatorStage(Protocol):
    def build(self, ctx: PlanContext, mg: MetaGraph) -> ScalabilityEstimator:
        """Return a profiled estimator over the contracted MetaGraph."""


class AllocatorStage(Protocol):
    def allocate(
        self,
        metas: Sequence[MetaOp],
        estimator: ScalabilityEstimator,
        n_devices: int,
    ) -> LevelAllocation:
        """Allocate one MetaLevel's devices among its MetaOps."""


class SchedulerStage(Protocol):
    #: whether the produced Schedule satisfies the §3.4 invariants that
    #: check_schedule() asserts (baselines with overlapping task timelines
    #: intentionally violate the global level-barrier formulation).
    validates: bool

    def run(
        self,
        ctx: PlanContext,
        mg: MetaGraph,
        estimator: ScalabilityEstimator,
        allocator: AllocatorStage,
    ) -> Schedule:
        """Produce the full Schedule for the MetaGraph."""


class PlacementStage(Protocol):
    def run(self, ctx: PlanContext, sched: Schedule, mg: MetaGraph) -> Placement:
        """Assign concrete device ids to every wave entry."""


# --------------------------------------------------------------------------
# Spindle stage implementations (thin adapters over the §3.x modules)
# --------------------------------------------------------------------------


@dataclass
class ProfiledEstimatorStage:
    """§3.2 scaling-curve profiling (analytic cost model or measured times)."""

    profile_powers_of_two: bool = True
    curve_memo: Optional[Dict[Tuple, ScalingCurve]] = None

    def build(self, ctx: PlanContext, mg: MetaGraph) -> ScalabilityEstimator:
        return ScalabilityEstimator(
            ctx.resolve_time_fn(),
            ctx.capacity,
            profile_powers_of_two=self.profile_powers_of_two,
            curve_memo=self.curve_memo,
        )


@dataclass
class SpindleAllocatorStage:
    """§3.3 MPSP relaxation + bi-point discretization.

    ``bracket_memo`` (wired by the PlanCache) reuses unchanged MetaOps'
    bi-point brackets across replans, so ``discretize`` skips its
    valid-allocation sweep inside changed levels."""

    bracket_memo: Optional[BracketMemo] = None

    def allocate(self, metas, estimator, n_devices) -> LevelAllocation:
        return allocate_level(
            metas, estimator, n_devices, bracket_memo=self.bracket_memo
        )

    def allocate_warm(self, metas, estimator, n_devices,
                      c_hint: float) -> LevelAllocation:
        """Changed-level replan path: warm-start the MPSP bisection bracket
        from a cached C̃* (the previous plan's optimum for this level)."""
        return allocate_level(
            metas, estimator, n_devices, c_hint=c_hint,
            bracket_memo=self.bracket_memo,
        )


class BalancedAllocatorStage:
    """Single-tuple balanced shares (DistMM-MT-style intra-task allocation)."""

    def allocate(self, metas, estimator, n_devices) -> LevelAllocation:
        return allocate_balanced(metas, estimator, n_devices)


class WavefrontSchedulerStage:
    """§3.4 Algorithm 1 over every MetaLevel, merged back-to-back."""

    validates = True

    def run(self, ctx, mg, estimator, allocator) -> Schedule:
        return schedule(
            mg,
            estimator,
            ctx.capacity,
            allocate_fn=allocator.allocate,
        )


@dataclass
class LocalityPlacementStage:
    """§3.5 guideline-based placement (or the Fig. 10 ablation baseline)."""

    strategy: str = "spindle"

    def run(self, ctx, sched, mg) -> Placement:
        return place(sched, mg, ctx.cluster, strategy=self.strategy)


# --------------------------------------------------------------------------
# Baseline scheduler stages (ported from the ad-hoc simulator planners)
# --------------------------------------------------------------------------


def _widest_valid(m: MetaOp, n_devices: int, limit: Optional[int] = None) -> int:
    cap = n_devices if limit is None else min(limit, n_devices)
    fits = [v for v in valid_allocations(m, n_devices) if v <= cap]
    return max(fits) if fits else 0


def _make_entry(
    m: MetaOp,
    n: int,
    l: int,
    estimator: ScalabilityEstimator,
    start: float,
    op_offset: int = 0,
) -> WaveEntry:
    curve = estimator.curve(m)
    cfg = best_config(m, n) or curve.config_for(n)
    return WaveEntry(
        meta_id=m.meta_id,
        n=n,
        l=l,
        t_per_op=curve.estimate(n),
        config=cfg,
        start=start,
        op_offset=op_offset,
    )


def _tasks_of(mg: MetaGraph) -> Dict[str, List[MetaOp]]:
    """Group MetaOps by owning task (merged MetaOps go to their first task)."""
    tasks: Dict[str, List[MetaOp]] = {}
    for m in mg.meta_ops.values():
        tasks.setdefault(m.task.split("+")[0], []).append(m)
    return tasks


class SerialSchedulerStage:
    """Megatron/DeepSpeed baseline: one MetaOp at a time on the widest valid
    allocation (workload-unaware temporal decoupling)."""

    validates = True

    def run(self, ctx, mg, estimator, allocator) -> Schedule:
        N = ctx.capacity
        sched = Schedule()
        t_now, widx = 0.0, 0
        for level, metas in enumerate(mg.levels()):
            for m in metas:
                n = _widest_valid(m, N)
                e = _make_entry(m, n, m.L, estimator, t_now)
                sched.waves.append(
                    Wave(index=widx, level=level, start=t_now,
                         duration=e.duration, entries=[e])
                )
                widx += 1
                t_now += e.duration
        sched.makespan = t_now
        return sched


class TaskSequentialSchedulerStage:
    """DistMM-MT: tasks run one after another; inside a task, the concurrent
    towers of each level share devices via the allocator stage (balanced
    shares).  Entries are packed into capacity-respecting waves."""

    validates = False  # cross-task level spans overlap the global barrier check

    def run(self, ctx, mg, estimator, allocator) -> Schedule:
        N = ctx.capacity
        tasks = _tasks_of(mg)
        sched = Schedule()
        t_now, widx = 0.0, 0
        for task in sorted(tasks):
            by_level: Dict[int, List[MetaOp]] = {}
            for m in tasks[task]:
                by_level.setdefault(m.level, []).append(m)
            for level in sorted(by_level):
                group = by_level[level]
                alloc = allocator.allocate(group, estimator, N)
                # Per-MetaOp tuple queue in execution order (wider slice
                # first, matching the Fig. 5 convention), op_offset threaded
                # through so multi-tuple allocators slice correctly.
                queues: Dict[int, List[WaveEntry]] = {}
                for m in group:
                    offset, lst = 0, []
                    for t in sorted(alloc.tuples[m.meta_id], key=lambda a: -a.n):
                        lst.append(
                            _make_entry(m, t.n, t.l, estimator, t_now, offset)
                        )
                        offset += t.l
                    queues[m.meta_id] = lst
                # First-fit over queue HEADS (desc width) keeps Σn ≤ N per
                # wave while preserving each MetaOp's intra-op order.
                while any(queues.values()):
                    wave_entries, used = [], 0
                    heads = sorted(
                        (lst[0] for lst in queues.values() if lst),
                        key=lambda e: (-e.n, e.meta_id),
                    )
                    for e in heads:
                        if used + e.n <= N:
                            e.start = t_now
                            wave_entries.append(e)
                            used += e.n
                            queues[e.meta_id].pop(0)
                    dur = max(e.duration for e in wave_entries)
                    sched.waves.append(
                        Wave(index=widx, level=level, start=t_now,
                             duration=dur, entries=wave_entries)
                    )
                    widx += 1
                    t_now += dur
        sched.makespan = t_now
        return sched


class TaskParallelSchedulerStage:
    """Spindle-Optimus: iterated marginal-gain *task-level* allocation; tasks
    run concurrently on fixed disjoint device blocks (recorded in
    ``Schedule.extras`` for the paired :class:`BlockPlacementStage`)."""

    validates = False  # tasks overlap in time: the level barrier does not hold

    def run(self, ctx, mg, estimator, allocator) -> Schedule:
        N = ctx.capacity
        tasks = _tasks_of(mg)
        names = sorted(tasks)

        def task_time(task: str, n: int) -> float:
            if n <= 0:
                return math.inf
            total = 0.0
            for m in sorted(tasks[task], key=lambda m: m.level):
                n_eff = _widest_valid(m, N, limit=n)
                if n_eff == 0:
                    return math.inf
                total += estimator.curve(m).estimate(n_eff) * m.L
            return total

        alloc = {t: 1 for t in names}
        free = N - len(names)
        if free < 0:
            # more tasks than devices: degenerate to the serial baseline
            return SerialSchedulerStage().run(ctx, mg, estimator, allocator)
        cur = {t: task_time(t, alloc[t]) for t in names}
        while free > 0:
            best_t, best_gain = None, 0.0
            for t in names:
                gain = cur[t] - task_time(t, alloc[t] + 1)
                if gain > best_gain:
                    best_t, best_gain = t, gain
            if best_t is None:
                break
            alloc[best_t] += 1
            free -= 1
            cur[best_t] = task_time(best_t, alloc[best_t])

        sched = Schedule()
        blocks: Dict[str, Tuple[int, int]] = {}  # task -> (first device, size)
        task_of_meta: Dict[int, str] = {}
        offset, widx = 0, 0
        for task in names:
            blocks[task] = (offset, alloc[task])
            offset += alloc[task]
            t_now = 0.0
            for m in sorted(tasks[task], key=lambda m: (m.level, m.meta_id)):
                task_of_meta[m.meta_id] = task
                n_eff = _widest_valid(m, N, limit=alloc[task]) or 1
                e = _make_entry(m, n_eff, m.L, estimator, t_now)
                sched.waves.append(
                    Wave(index=widx, level=m.level, start=t_now,
                         duration=e.duration, entries=[e])
                )
                widx += 1
                t_now += e.duration
        sched.makespan = max(cur.values()) if cur else 0.0
        sched.extras["task_blocks"] = blocks
        sched.extras["task_of_meta"] = task_of_meta
        return sched


class BlockPlacementStage:
    """Placement onto the fixed per-task device blocks chosen by the optimus
    scheduler; falls back to locality placement when no blocks were emitted
    (e.g. the more-tasks-than-devices serial degenerate case).

    Per-device memory high-water is tracked the same way the locality
    placer does (params + optimizer states + activations accumulated per
    entry), so the baseline's OOM behavior is directly comparable to the
    spindle placement path in Fig. 10-style ablations.
    """

    def run(self, ctx, sched, mg) -> Placement:
        from .placement import _entry_memory

        blocks = sched.extras.get("task_blocks")
        if blocks is None:
            return place(sched, mg, ctx.cluster, strategy="sequential")
        task_of_meta = sched.extras["task_of_meta"]
        pl = Placement()
        # Block offsets index the schedulable capacity; map them through the
        # healthy-device list so flagged hosts' blocks stay empty.
        healthy = ctx.cluster.healthy_devices()
        mem = {d: 0.0 for d in healthy}
        for w in sched.waves:
            for e in w.entries:
                start, _size = blocks[task_of_meta[e.meta_id]]
                devs = tuple(healthy[start : start + e.n])
                pl.entries[(w.index, e.meta_id)] = PlacedEntry(
                    w.index, e.meta_id, devs
                )
                per_dev = _entry_memory(mg.meta_ops[e.meta_id], e)
                for d in devs:
                    mem[d] += per_dev
        pl.mem_high_water = mem
        return pl


# --------------------------------------------------------------------------
# The pipeline and its registry
# --------------------------------------------------------------------------


@dataclass
class PlannerPipeline:
    """A named composition of the four planning stages."""

    name: str
    estimator: EstimatorStage
    allocator: AllocatorStage
    scheduler: SchedulerStage
    placement: PlacementStage

    def plan(
        self,
        graph: TaskGraph,
        cluster: ClusterSpec,
        *,
        hw: HardwareSpec = H100,
        time_fn: Optional[TimeFn] = None,
    ) -> ExecutionPlan:
        ctx = PlanContext(graph=graph, cluster=cluster, hw=hw, time_fn=time_fn)
        t0 = time.perf_counter()
        mg = contract(graph)
        est = self.estimator.build(ctx, mg)
        sched = self.scheduler.run(ctx, mg, est, self.allocator)
        if self.scheduler.validates:
            check_schedule(sched, mg, ctx.capacity)
        placement = self.placement.run(ctx, sched, mg)
        seconds = time.perf_counter() - t0
        return assemble_plan(
            mg, sched, placement, cluster, seconds, planner=self.name
        )


PipelineFactory = Callable[..., PlannerPipeline]
_REGISTRY: Dict[str, PipelineFactory] = {}


def register_planner(name: str, factory: PipelineFactory) -> None:
    """Register (or replace) a planner strategy under ``name``."""
    _REGISTRY[name] = factory


def available_planners() -> List[str]:
    return sorted(_REGISTRY)


def get_pipeline(
    name: str = "spindle",
    *,
    placement_strategy: str = "spindle",
    profile_powers_of_two: bool = True,
    curve_memo: Optional[Dict[Tuple, ScalingCurve]] = None,
    bracket_memo: Optional[BracketMemo] = None,
) -> PlannerPipeline:
    """Resolve a registered planner pipeline by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown planner {name!r}; choose from {available_planners()}"
        ) from None
    return factory(
        placement_strategy=placement_strategy,
        profile_powers_of_two=profile_powers_of_two,
        curve_memo=curve_memo,
        bracket_memo=bracket_memo,
    )


def _spindle_factory(*, placement_strategy="spindle",
                     profile_powers_of_two=True, curve_memo=None,
                     bracket_memo=None):
    return PlannerPipeline(
        name="spindle",
        estimator=ProfiledEstimatorStage(profile_powers_of_two, curve_memo),
        allocator=SpindleAllocatorStage(bracket_memo),
        scheduler=WavefrontSchedulerStage(),
        placement=LocalityPlacementStage(placement_strategy),
    )


def _sequential_factory(*, placement_strategy="spindle",
                        profile_powers_of_two=True, curve_memo=None,
                        bracket_memo=None):
    return PlannerPipeline(
        name="sequential",
        estimator=ProfiledEstimatorStage(profile_powers_of_two, curve_memo),
        allocator=SpindleAllocatorStage(),  # unused by the serial scheduler
        scheduler=SerialSchedulerStage(),
        placement=LocalityPlacementStage(placement_strategy),
    )


def _distmm_factory(*, placement_strategy="spindle",
                    profile_powers_of_two=True, curve_memo=None,
                    bracket_memo=None):
    return PlannerPipeline(
        name="distmm_mt",
        estimator=ProfiledEstimatorStage(profile_powers_of_two, curve_memo),
        allocator=BalancedAllocatorStage(),
        scheduler=TaskSequentialSchedulerStage(),
        placement=LocalityPlacementStage(placement_strategy),
    )


def _optimus_factory(*, placement_strategy="spindle",
                     profile_powers_of_two=True, curve_memo=None,
                     bracket_memo=None):
    if placement_strategy != "spindle":
        raise ValueError(
            "the optimus planner places onto fixed task blocks; "
            f"placement_strategy={placement_strategy!r} is not applicable"
        )
    return PlannerPipeline(
        name="optimus",
        estimator=ProfiledEstimatorStage(profile_powers_of_two, curve_memo),
        allocator=SpindleAllocatorStage(),  # unused: allocation is task-level
        scheduler=TaskParallelSchedulerStage(),
        placement=BlockPlacementStage(),
    )


register_planner("spindle", _spindle_factory)
register_planner("sequential", _sequential_factory)
register_planner("distmm_mt", _distmm_factory)
register_planner("optimus", _optimus_factory)
