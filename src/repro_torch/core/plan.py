"""Execution plan assembly — the planner driver (Spindle Fig. 2, §3).

``plan()`` is the front door of the planning subsystem: it resolves a
:class:`repro_torch.core.pipeline.PlannerPipeline` by name (``spindle`` plus the
``sequential`` / ``distmm_mt`` / ``optimus`` baselines) and runs its staged
contraction → scaling curves → per-level allocation → schedule → device
placement flow, producing an :class:`ExecutionPlan` the runtime engine (and
the simulator) consume.  :func:`assemble_plan` is the shared final stage that
flattens any (MetaGraph, Schedule, Placement) triple into concrete steps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from .contraction import MetaGraph
from .costmodel import HardwareSpec, H100
from .estimator import TimeFn
from .graph import TaskGraph
from .placement import ClusterSpec, Placement
from .scheduler import Schedule


@dataclass
class PlanStep:
    """One executable unit: a sliced MetaOp on a concrete device group."""

    wave_index: int
    level: int
    meta_id: int
    meta_name: str
    op_ids: List[int]  # operators of the MetaOp executed in this step
    devices: Tuple[int, ...]
    dp: int
    tp: int
    start: float
    duration: float
    param_group: Optional[str]


@dataclass
class ExecutionPlan:
    steps: List[PlanStep]
    makespan: float
    c_star_total: float
    n_devices: int
    planning_seconds: float
    schedule: Schedule
    placement: Placement
    meta_graph: MetaGraph
    planner: str = "spindle"  # registry name of the pipeline that built it
    signature: Optional[str] = None  # workload signature (plancache key)
    cluster: Optional[ClusterSpec] = None  # cluster the plan was built against
    # memoized PlanTimeline — excluded from equality so cached plans with
    # and without a computed timeline still compare equal
    _timeline: Optional[object] = dc_field(
        default=None, repr=False, compare=False
    )

    # ------------------------------------------------------------------
    def timeline(self, cluster: Optional[ClusterSpec] = None):
        """The plan's idle-window structure (see :mod:`repro_torch.core.timeline`).

        With no argument, uses the recorded assembly cluster and memoizes;
        an explicit ``cluster`` (e.g. a lease view) always recomputes.
        """
        from .timeline import compute_timeline

        if cluster is not None:
            return compute_timeline(self, cluster)
        if self._timeline is None:
            object.__setattr__(self, "_timeline", compute_timeline(self))
        return self._timeline

    def waves(self) -> Dict[int, List[PlanStep]]:
        out: Dict[int, List[PlanStep]] = {}
        for s in self.steps:
            out.setdefault(s.wave_index, []).append(s)
        return out

    def param_device_groups(self) -> Dict[str, Tuple[int, ...]]:
        """The global parameter device-group pool {D_i -> {W_j}} (§3.6 (3)).

        For each param_group, the synchronization group is the union of all
        devices that ever instantiate it.
        """
        groups: Dict[str, set] = {}
        for s in self.steps:
            if s.param_group:
                groups.setdefault(s.param_group, set()).update(s.devices)
        return {k: tuple(sorted(v)) for k, v in groups.items()}

    def to_json(self) -> str:
        return json.dumps(
            {
                "planner": self.planner,
                "signature": self.signature,
                "makespan": self.makespan,
                "c_star_total": self.c_star_total,
                "n_devices": self.n_devices,
                "planning_seconds": self.planning_seconds,
                "steps": [
                    {
                        "wave": s.wave_index,
                        "level": s.level,
                        "meta": s.meta_id,
                        "name": s.meta_name,
                        "ops": s.op_ids,
                        "devices": list(s.devices),
                        "dp": s.dp,
                        "tp": s.tp,
                        "start": s.start,
                        "duration": s.duration,
                        "param_group": s.param_group,
                    }
                    for s in self.steps
                ],
            },
            indent=2,
        )


def assemble_plan(
    mg: MetaGraph,
    sched: Schedule,
    placement: Placement,
    cluster: ClusterSpec,
    planning_seconds: float,
    *,
    planner: str = "spindle",
) -> ExecutionPlan:
    """Flatten (MetaGraph, Schedule, Placement) into executable PlanSteps."""
    steps: List[PlanStep] = []
    for w in sched.waves:
        for e in w.entries:
            m = mg.meta_ops[e.meta_id]
            steps.append(
                PlanStep(
                    wave_index=w.index,
                    level=w.level,
                    meta_id=e.meta_id,
                    meta_name=m.name,
                    op_ids=m.op_ids[e.op_offset : e.op_offset + e.l],
                    devices=placement.devices_for(w.index, e.meta_id),
                    dp=e.config.dp,
                    tp=e.config.tp,
                    start=e.start,
                    duration=e.duration,
                    param_group=m.param_group,
                )
            )
    return ExecutionPlan(
        steps=steps,
        makespan=sched.makespan,
        c_star_total=sched.c_star_total,
        n_devices=cluster.n_healthy,  # schedulable capacity (minus evictions)
        planning_seconds=planning_seconds,
        schedule=sched,
        placement=placement,
        meta_graph=mg,
        planner=planner,
        cluster=cluster,
    )


def plan(
    graph: TaskGraph,
    cluster: ClusterSpec,
    *,
    time_fn: Optional[TimeFn] = None,
    hw: HardwareSpec = H100,
    planner: str = "spindle",
    placement_strategy: str = "spindle",
    profile_powers_of_two: bool = True,
    cache: Optional["PlanCache"] = None,
) -> ExecutionPlan:
    """Build an ExecutionPlan via the named planner pipeline.

    ``planner`` selects a registered :class:`PlannerPipeline` strategy
    (``spindle`` | ``sequential`` | ``distmm_mt`` | ``optimus``).  When a
    :class:`repro_torch.core.plancache.PlanCache` is supplied, planning goes
    through the cache: exact workload-signature hits return the stored plan
    and near-misses replan incrementally (unchanged MetaLevels reuse their
    cached allocation/schedule).
    """
    from .pipeline import get_pipeline  # local import: avoids module cycle

    if cache is not None:
        from .plancache import plan_cached

        return plan_cached(
            graph,
            cluster,
            cache,
            planner=planner,
            time_fn=time_fn,
            hw=hw,
            placement_strategy=placement_strategy,
            profile_powers_of_two=profile_powers_of_two,
        )
    pipe = get_pipeline(
        planner,
        placement_strategy=placement_strategy,
        profile_powers_of_two=profile_powers_of_two,
    )
    return pipe.plan(graph, cluster, time_fn=time_fn, hw=hw)
