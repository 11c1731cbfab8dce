"""Plan simulator (Spindle §5 evaluation quantities).

Simulates any :class:`ExecutionPlan` on the analytic cluster model to report
makespan, FLOPs-based utilization (the paper measures "FLOPs per second",
Fig. 1/9), per-device occupancy, and inter-wave communication time — the
quantities behind the paper's Fig. 8/9/10 evaluation.

Planner strategies live in :mod:`repro_torch.core.pipeline`; the ``simulate_*``
helpers below are thin adapters that build a plan through the registered
pipeline of the same name and convert it to a :class:`SimResult`, so the
simulator and ``plan(..., planner=...)`` share one code path:

  * ``spindle``        — the real planner (wavefront scheduling).
  * ``sequential``     — Megatron-LM / DeepSpeed-style temporal decoupling.
  * ``distmm_mt``      — DistMM-MT per-task balanced tower allocation.
  * ``optimus``        — Spindle-Optimus task-level marginal-gain blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .costmodel import HardwareSpec, H100
from .graph import TaskGraph
from .pipeline import get_pipeline
from .placement import ClusterSpec
from .plan import ExecutionPlan, plan as spindle_plan


@dataclass
class SimStep:
    start: float
    end: float
    n_devices: int
    flops: float  # useful FLOPs performed in this step
    meta_id: int = -1

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SimResult:
    name: str
    makespan: float
    n_devices: int
    steps: List[SimStep]
    comm_seconds: float = 0.0
    c_star_total: float = 0.0
    #: per-device peak FLOP/s of the spec the plan was made for: the
    #: utilizations below are against it
    peak_flops: float = H100.peak_flops

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.steps)

    @property
    def avg_flops_utilization(self) -> float:
        """Achieved FLOP/s over cluster peak (the paper's utilization)."""
        if self.makespan <= 0:
            return 0.0
        peak = self.n_devices * self.peak_flops
        return self.total_flops / (peak * self.makespan)

    @property
    def avg_occupancy(self) -> float:
        """Fraction of device-seconds reserved by some step."""
        if self.makespan <= 0:
            return 0.0
        return sum(s.duration * s.n_devices for s in self.steps) / (
            self.n_devices * self.makespan
        )

    def utilization_curve(self, n_bins: int = 64) -> List[float]:
        """FLOPs/s per time bin over cluster peak (Fig. 9a analogue)."""
        if self.makespan <= 0:
            return [0.0] * n_bins
        peak = self.n_devices * self.peak_flops
        bins = [0.0] * n_bins
        dt = self.makespan / n_bins
        for s in self.steps:
            if s.duration <= 0:
                continue
            rate = s.flops / s.duration
            b0 = max(int(s.start / dt), 0)
            b1 = min(int(math.ceil(s.end / dt)), n_bins)
            for b in range(b0, b1):
                lo, hi = b * dt, (b + 1) * dt
                overlap = max(0.0, min(s.end, hi) - max(s.start, lo))
                bins[b] += rate * overlap / dt
        return [b / peak for b in bins]

    def per_meta_utilization(self) -> Dict[int, float]:
        """Achieved FLOP/s per MetaOp over ITS devices' peak (Fig. 9b)."""
        acc: Dict[int, Tuple[float, float]] = {}
        for s in self.steps:
            if s.meta_id < 0 or s.duration <= 0:
                continue
            f, d = acc.get(s.meta_id, (0.0, 0.0))
            acc[s.meta_id] = (f + s.flops, d + s.duration * s.n_devices)
        return {
            mid: f / (d * self.peak_flops) if d > 0 else 0.0
            for mid, (f, d) in acc.items()
        }


# --------------------------------------------------------------------------
# Simulating an ExecutionPlan (with placement-aware comm costs)
# --------------------------------------------------------------------------


def simulate_plan(
    p: ExecutionPlan,
    cluster: ClusterSpec,
    *,
    include_comm: bool = True,
    hw: HardwareSpec = H100,
) -> SimResult:
    """Convert a plan (from ANY registered pipeline) into a SimResult.

    ``include_comm`` adds the placement's inter-wave transmission time to
    the makespan; the baseline planners ignore data movement (they model
    idealized competitors, matching the paper's comparison).  ``hw`` is
    the spec the plan was made for: utilization is against its peak."""
    steps = []
    for s in p.steps:
        m = p.meta_graph.meta_ops[s.meta_id]
        steps.append(
            SimStep(
                start=s.start,
                end=s.start + s.duration,
                n_devices=len(s.devices),
                flops=m.workload.flops * len(s.op_ids),
                meta_id=s.meta_id,
            )
        )
    comm = 0.0
    if include_comm:
        comm = (
            p.placement.interwave_bytes_intra / cluster.intra_island_bw
            + p.placement.interwave_bytes_inter / cluster.inter_island_bw
        )
    return SimResult(
        name=p.planner,
        makespan=p.makespan + comm,
        n_devices=cluster.n_devices,
        steps=steps,
        comm_seconds=comm,
        c_star_total=p.c_star_total,
        peak_flops=hw.peak_flops,
    )


# --------------------------------------------------------------------------
# Named planner adapters (one code path: the pipeline registry)
# --------------------------------------------------------------------------


def simulate_planner(
    name: str,
    graph: TaskGraph,
    cluster: ClusterSpec,
    hw: HardwareSpec = H100,
    time_fn=None,
) -> SimResult:
    """Plan ``graph`` with the named registered pipeline and simulate it."""
    p = get_pipeline(name).plan(graph, cluster, hw=hw, time_fn=time_fn)
    # Baselines are idealized (no data-movement modelling); only the spindle
    # plan carries a meaningful placement comm estimate.
    return simulate_plan(p, cluster, include_comm=(name == "spindle"), hw=hw)


def simulate_sequential(
    graph: TaskGraph, cluster: ClusterSpec, hw: HardwareSpec = H100, time_fn=None
) -> SimResult:
    return simulate_planner("sequential", graph, cluster, hw, time_fn)


def simulate_distmm_mt(
    graph: TaskGraph, cluster: ClusterSpec, hw: HardwareSpec = H100, time_fn=None
) -> SimResult:
    return simulate_planner("distmm_mt", graph, cluster, hw, time_fn)


def simulate_optimus(
    graph: TaskGraph, cluster: ClusterSpec, hw: HardwareSpec = H100, time_fn=None
) -> SimResult:
    return simulate_planner("optimus", graph, cluster, hw, time_fn)


def simulate_spindle(
    graph: TaskGraph, cluster: ClusterSpec, hw: HardwareSpec = H100, time_fn=None
) -> Tuple[SimResult, ExecutionPlan]:
    p = spindle_plan(graph, cluster, hw=hw, time_fn=time_fn)
    return simulate_plan(p, cluster, hw=hw), p


ALL_SYSTEMS = {
    "sequential": simulate_sequential,
    "distmm_mt": simulate_distmm_mt,
    "optimus": simulate_optimus,
}
