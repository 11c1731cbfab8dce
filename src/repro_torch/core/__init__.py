"""Spindle core: the paper's contribution (execution planner + plan model).

Pipeline:  TaskGraph → contract() → MetaGraph → PlannerPipeline stages
(EstimatorStage → AllocatorStage → SchedulerStage → PlacementStage) →
ExecutionPlan (→ WaveEngine), with PlanCache-backed incremental replanning
for dynamic workloads (see repro_torch.core.pipeline / repro_torch.core.plancache).
"""

from .graph import ComponentSpec, FlowSpec, GraphBuilder, OpNode, OpWorkload, TaskGraph
from .contraction import MetaGraph, MetaOp, contract
from .estimator import (
    ParallelConfig,
    ScalabilityEstimator,
    ScalingCurve,
    best_config,
    enumerate_configs,
    valid_allocations,
)
from .costmodel import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, HardwareSpec, H100, make_time_fn, op_time
from .allocator import (
    ASLTuple,
    LevelAllocation,
    allocate_balanced,
    allocate_level,
    discretize,
    solve_continuous,
)
from .scheduler import Schedule, Wave, WaveEntry, check_schedule, schedule
from .placement import ClusterSpec, Placement, PlacedEntry, place
from .plan import ExecutionPlan, PlanStep, assemble_plan, plan
from .pipeline import (
    PlanContext,
    PlannerPipeline,
    available_planners,
    get_pipeline,
    register_planner,
)
from .plancache import (
    PlanCache,
    PlanCacheStats,
    level_signature,
    meta_signature,
    plan_cached,
    workload_signature,
)
from .simulator import (
    SimResult,
    simulate_distmm_mt,
    simulate_optimus,
    simulate_plan,
    simulate_planner,
    simulate_sequential,
    simulate_spindle,
)

__all__ = [
    "ComponentSpec",
    "FlowSpec",
    "GraphBuilder",
    "OpNode",
    "OpWorkload",
    "TaskGraph",
    "MetaGraph",
    "MetaOp",
    "contract",
    "ParallelConfig",
    "ScalabilityEstimator",
    "ScalingCurve",
    "best_config",
    "enumerate_configs",
    "valid_allocations",
    "HardwareSpec",
    "H100",
    "make_time_fn",
    "op_time",
    "PEAK_FLOPS_BF16",
    "HBM_BW",
    "ICI_BW",
    "ASLTuple",
    "LevelAllocation",
    "allocate_balanced",
    "allocate_level",
    "discretize",
    "solve_continuous",
    "Schedule",
    "Wave",
    "WaveEntry",
    "check_schedule",
    "schedule",
    "ClusterSpec",
    "Placement",
    "PlacedEntry",
    "place",
    "ExecutionPlan",
    "PlanStep",
    "assemble_plan",
    "plan",
    "PlanContext",
    "PlannerPipeline",
    "available_planners",
    "get_pipeline",
    "register_planner",
    "PlanCache",
    "PlanCacheStats",
    "plan_cached",
    "workload_signature",
    "level_signature",
    "meta_signature",
    "SimResult",
    "simulate_plan",
    "simulate_planner",
    "simulate_sequential",
    "simulate_distmm_mt",
    "simulate_optimus",
    "simulate_spindle",
]
