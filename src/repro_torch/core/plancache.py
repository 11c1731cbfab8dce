"""Plan cache + incremental replanning for dynamic workloads (DESIGN.md §9).

The paper's §5 dynamicity evaluation requires replanning to be cheap enough
to run on every workload shift (planner wall time < 0.2 s per shift,
Fig. 12).  This module makes that cheap in two tiers:

  * **Exact reuse** — plans are keyed by a deterministic *workload
    signature* (task set + shapes + cluster spec + planner + hardware);
    an identical signature returns the stored plan without replanning.
  * **Incremental replanning** — on a workload shift, the new MetaGraph's
    levels are compared against the most recent cached plan by *MetaLevel
    signature*: unchanged levels reuse their cached allocation and waves
    (time-shifted, meta-ids remapped), and only affected levels re-run the
    allocator + wavefront scheduler.  Scaling curves are memoized across
    replans by MetaOp identity, so unchanged MetaOps are never re-profiled.
    The merged schedule is re-validated with ``check_schedule``; any
    violation falls back to a full replan (correctness first).

Placement always re-runs over the merged schedule: it is cheap relative to
profiling + allocation and depends on cross-level flow history.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .allocator import ASLTuple, BracketMemo, LevelAllocation
from .contraction import MetaOp, contract
from .costmodel import HardwareSpec, H100
from .estimator import ScalingCurve, TimeFn
from .graph import TaskGraph
from .pipeline import PlanContext, PlannerPipeline, get_pipeline
from .placement import ClusterSpec
from .plan import ExecutionPlan, assemble_plan
from .scheduler import Schedule, Wave, WaveEntry, check_schedule, schedule_level


# --------------------------------------------------------------------------
# Deterministic signatures
# --------------------------------------------------------------------------


def _digest(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def meta_signature(m: MetaOp) -> str:
    """Identity of one MetaOp, independent of its meta_id/op_ids numbering."""
    w = m.workload
    return _digest(
        f"{m.op_type}|{m.task}|{m.component}|L{m.L}|b{m.batch_size}"
        f"|s{m.seq_len}|tp{m.max_tp}|pg{m.param_group}"
        f"|{w.flops:.6e}|{w.bytes_hbm:.6e}|{w.param_bytes:.6e}"
        f"|{w.act_bytes:.6e}|{w.tp_comm_bytes:.6e}"
    )


def level_signature(metas: Sequence[MetaOp]) -> str:
    """Identity of one MetaLevel: the multiset of its MetaOp signatures."""
    return _digest("|".join(sorted(meta_signature(m) for m in metas)))


def _cluster_key(cluster: ClusterSpec) -> str:
    # explicit host maps (ragged/non-contiguous topologies, fleet lease
    # views) key on the full per-host device lists; two leases with
    # identical canonical maps alias — that is the cross-job dedup
    hm = (
        "/map" + ";".join(",".join(map(str, h)) for h in cluster.host_map)
        if cluster.host_map
        else f"/host{cluster.host_size}"
    )
    return (
        f"N{cluster.n_devices}/isl{cluster.island_size}/mem{cluster.mem_bytes:.3e}"
        f"/bw{cluster.intra_island_bw:.3e}:{cluster.inter_island_bw:.3e}"
        f"{hm}/flag{','.join(map(str, cluster.flagged_hosts))}"
    )


def workload_signature(
    graph: TaskGraph,
    cluster: ClusterSpec,
    *,
    planner: str = "spindle",
    hw: HardwareSpec = H100,
    placement_strategy: str = "spindle",
    profile_powers_of_two: bool = True,
    time_fn: Optional[TimeFn] = None,
) -> str:
    """Deterministic key for the full planner input: task graph, cluster,
    planner strategy + options, and timing source.

    A caller-supplied ``time_fn`` is keyed by object identity (cache entries
    hold a reference, so the id stays unique among live entries) and is
    re-checked with ``is`` on lookup — two different timing sources never
    alias a signature."""
    parts: List[str] = [
        planner,
        _cluster_key(cluster),
        repr(hw),
        f"pl:{placement_strategy}",
        f"p2:{profile_powers_of_two}",
        f"tf:{id(time_fn) if time_fn is not None else 'analytic'}",
    ]
    for oid in sorted(graph.nodes):
        n = graph.nodes[oid]
        w = n.workload
        parts.append(
            f"{oid}:{n.op_type}|{n.task}|{n.component}|b{n.batch_size}"
            f"|s{n.seq_len}|pg{n.param_group}|tp{n.max_tp}"
            f"|{w.flops:.6e}|{w.bytes_hbm:.6e}|{w.param_bytes:.6e}"
            f"|{w.act_bytes:.6e}|{w.tp_comm_bytes:.6e}"
        )
    for src in sorted(graph.edges):
        for dst in sorted(graph.edges[src]):
            parts.append(f"e{src}>{dst}")
    return _digest("\n".join(parts))


# --------------------------------------------------------------------------
# The cache
# --------------------------------------------------------------------------


@dataclass
class PlanCacheStats:
    hits: int = 0  # exact signature matches
    misses: int = 0  # full plans built from scratch
    incremental: int = 0  # plans assembled incrementally
    levels_reused: int = 0
    levels_replanned: int = 0
    warm_start_hits: int = 0  # changed levels whose MPSP bisection was
    # warm-started from the cached C̃* bracket
    bracket_hits: int = 0  # MetaOps whose bi-point bracket (valid-width
    # sweep) was served from the cross-plan BracketMemo
    cross_job_hits: int = 0  # exact hits on a plan another job/owner built
    # (fleet-shared caches set PlanCache.owner around each job's turn)
    fallbacks: int = 0  # incremental merge failed validation → full replan

    @property
    def lookups(self) -> int:
        return self.hits + self.misses + self.incremental

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return (self.hits + self.incremental) / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "incremental": self.incremental,
            "levels_reused": self.levels_reused,
            "levels_replanned": self.levels_replanned,
            "warm_start_hits": self.warm_start_hits,
            "bracket_hits": self.bracket_hits,
            "cross_job_hits": self.cross_job_hits,
            "fallbacks": self.fallbacks,
            "hit_rate": self.hit_rate,
        }


@dataclass
class _CacheEntry:
    signature: str
    plan: ExecutionPlan
    planner: str
    n_devices: int
    hw: HardwareSpec
    # Planner options the plan was built under; lookups must match them all
    # (the signature encodes them too — these fields make the invariants
    # checkable and keep a strong ref to time_fn so its id stays unique).
    placement_strategy: str = "spindle"
    profile_powers_of_two: bool = True
    time_fn: Optional[TimeFn] = None
    # Per-MetaLevel reuse payload (spindle plans only; empty for baselines):
    level_sigs: List[str] = field(default_factory=list)
    level_metas: List[List[Tuple[str, int]]] = field(default_factory=list)
    level_allocs: List[LevelAllocation] = field(default_factory=list)
    level_waves: List[List[Wave]] = field(default_factory=list)
    #: job/owner scope that built the plan (fleet-shared caches only)
    owner: Optional[str] = None


class PlanCache:
    """LRU plan cache + cross-plan scaling-curve memo (both bounded)."""

    def __init__(self, maxsize: int = 32, curve_memo_max: int = 8192):
        self.maxsize = maxsize
        self.curve_memo_max = curve_memo_max
        self.stats = PlanCacheStats()
        self._entries: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self._curve_memos: Dict[HardwareSpec, Dict[Tuple, ScalingCurve]] = {}
        # Cross-plan bi-point bracket memo (timing-independent, so one memo
        # serves every hw/time_fn combination; see BracketMemo).
        self.bracket_memo = BracketMemo(maxsize=curve_memo_max)
        #: active job scope for a fleet-shared cache: the FleetScheduler
        #: sets this to the job name around each job's planning turn, so an
        #: exact hit on a plan some OTHER job built counts as a
        #: ``cross_job_hits`` (identical archs admitted twice plan once).
        #: ``None`` (the default) disables the accounting entirely.
        self.owner: Optional[str] = None

    def __len__(self) -> int:
        return len(self._entries)

    def curve_memo(self, hw: HardwareSpec) -> Dict[Tuple, ScalingCurve]:
        memo = self._curve_memos.setdefault(hw, {})
        # Long-running replan loops accumulate one curve per distinct MetaOp
        # shape; drop the oldest half when the bound is hit (dicts preserve
        # insertion order) so the process-lifetime footprint stays flat.
        if len(memo) > self.curve_memo_max:
            for key in list(memo)[: len(memo) // 2]:
                del memo[key]
        return memo

    def get(self, signature: str,
            time_fn: Optional[TimeFn] = None) -> Optional[ExecutionPlan]:
        entry = self._entries.get(signature)
        if entry is None:
            return None
        if entry.time_fn is not time_fn:  # id-collision guard
            return None
        if self.owner is not None and entry.owner not in (None, self.owner):
            self.stats.cross_job_hits += 1
        self._entries.move_to_end(signature)
        return entry.plan

    def latest(
        self,
        planner: str,
        n_devices: int,
        hw: HardwareSpec,
        *,
        placement_strategy: str = "spindle",
        profile_powers_of_two: bool = True,
        time_fn: Optional[TimeFn] = None,
    ) -> Optional[_CacheEntry]:
        """Most recently used reusable entry built under the SAME planner
        inputs (strategy, cluster size, hardware, options, timing source)."""
        for entry in reversed(self._entries.values()):
            if (
                entry.planner == planner
                and entry.n_devices == n_devices
                and entry.hw == hw
                and entry.placement_strategy == placement_strategy
                and entry.profile_powers_of_two == profile_powers_of_two
                and entry.time_fn is time_fn
                and entry.level_sigs
            ):
                return entry
        return None

    def put(
        self,
        plan: ExecutionPlan,
        *,
        hw: HardwareSpec = H100,
        placement_strategy: str = "spindle",
        profile_powers_of_two: bool = True,
        time_fn: Optional[TimeFn] = None,
    ) -> None:
        assert plan.signature, "plan must carry its workload signature"
        entry = _CacheEntry(
            signature=plan.signature,
            plan=plan,
            planner=plan.planner,
            n_devices=plan.n_devices,
            hw=hw,
            placement_strategy=placement_strategy,
            profile_powers_of_two=profile_powers_of_two,
            time_fn=time_fn,
            owner=self.owner,
        )
        mg = plan.meta_graph
        levels = mg.levels()
        # Only schedules with per-level allocations (the wavefront path)
        # carry enough structure for incremental reuse.
        if len(plan.schedule.level_allocs) == len(levels) and levels:
            by_level: Dict[int, List[Wave]] = {}
            for w in plan.schedule.waves:
                by_level.setdefault(w.level, []).append(w)
            if sorted(by_level) == list(range(len(levels))):
                entry.level_sigs = [level_signature(ms) for ms in levels]
                entry.level_metas = [
                    sorted((meta_signature(m), m.meta_id) for m in ms)
                    for ms in levels
                ]
                entry.level_allocs = list(plan.schedule.level_allocs)
                entry.level_waves = [by_level[i] for i in range(len(levels))]
        self._entries[plan.signature] = entry
        self._entries.move_to_end(plan.signature)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def get_or_plan(
        self,
        graph: TaskGraph,
        cluster: ClusterSpec,
        *,
        planner: str = "spindle",
        time_fn: Optional[TimeFn] = None,
        hw: HardwareSpec = H100,
        placement_strategy: str = "spindle",
        profile_powers_of_two: bool = True,
        incremental: bool = True,
    ) -> ExecutionPlan:
        """Plan ``graph`` through this cache: exact signature hit → stored
        plan; near miss → incremental replan; otherwise a full plan is built
        and stored.  The method form of :func:`plan_cached` — the session
        layer's single planning entry point.  ``incremental=False`` forces
        a full replan on a signature miss (structural workload shifts — a
        new serving family, say — where nothing is worth reusing)."""
        return plan_cached(
            graph,
            cluster,
            self,
            planner=planner,
            time_fn=time_fn,
            hw=hw,
            placement_strategy=placement_strategy,
            profile_powers_of_two=profile_powers_of_two,
            incremental=incremental,
        )


# --------------------------------------------------------------------------
# Cached / incremental planning
# --------------------------------------------------------------------------


def _remap_alloc(alloc: LevelAllocation, mapping: Dict[int, int]) -> LevelAllocation:
    return LevelAllocation(
        c_star=alloc.c_star,
        n_star={mapping[k]: v for k, v in alloc.n_star.items()},
        tuples={
            mapping[k]: [
                ASLTuple(mapping[k], t.n, t.l, t.t_per_op, t.config, t.s)
                for t in ts
            ]
            for k, ts in alloc.tuples.items()
        },
    )


def _remap_waves(
    waves: List[Wave],
    mapping: Dict[int, int],
    t_start: float,
    level: int,
    wave_index0: int,
) -> Tuple[List[Wave], float]:
    shift = t_start - min(w.start for w in waves)
    out: List[Wave] = []
    t_end = t_start
    for k, w in enumerate(sorted(waves, key=lambda w: w.start)):
        entries = [
            WaveEntry(
                meta_id=mapping[e.meta_id],
                n=e.n,
                l=e.l,
                t_per_op=e.t_per_op,
                config=e.config,
                start=e.start + shift,
                op_offset=e.op_offset,
            )
            for e in w.entries
        ]
        nw = Wave(
            index=wave_index0 + k,
            level=level,
            start=w.start + shift,
            duration=w.duration,
            entries=entries,
        )
        out.append(nw)
        t_end = max(t_end, nw.end)
    return out, t_end


def plan_cached(
    graph: TaskGraph,
    cluster: ClusterSpec,
    cache: PlanCache,
    *,
    planner: str = "spindle",
    time_fn: Optional[TimeFn] = None,
    hw: HardwareSpec = H100,
    placement_strategy: str = "spindle",
    profile_powers_of_two: bool = True,
    incremental: bool = True,
) -> ExecutionPlan:
    """Plan through the cache: exact hit → stored plan; otherwise replan
    incrementally against the nearest cached plan (spindle pipeline only),
    falling back to a full replan whenever validation fails.
    ``incremental=False`` skips the base lookup entirely (full plan)."""
    sig = workload_signature(
        graph, cluster, planner=planner, hw=hw,
        placement_strategy=placement_strategy,
        profile_powers_of_two=profile_powers_of_two,
        time_fn=time_fn,
    )
    hit = cache.get(sig, time_fn)
    if hit is not None:
        cache.stats.hits += 1
        return hit

    # Curve memoization is only sound for the deterministic analytic model;
    # a user-supplied time_fn may close over anything.  The bracket memo
    # caches only timing-independent combinatorics, so it always applies.
    memo = cache.curve_memo(hw) if time_fn is None else None
    bracket_hits0 = cache.bracket_memo.hits
    pipe = get_pipeline(
        planner,
        placement_strategy=placement_strategy,
        profile_powers_of_two=profile_powers_of_two,
        curve_memo=memo,
        bracket_memo=cache.bracket_memo,
    )
    opts = dict(
        hw=hw,
        placement_strategy=placement_strategy,
        profile_powers_of_two=profile_powers_of_two,
        time_fn=time_fn,
    )

    base = (
        cache.latest(planner, cluster.n_healthy, hw,
                     placement_strategy=placement_strategy,
                     profile_powers_of_two=profile_powers_of_two,
                     time_fn=time_fn)
        if incremental else None
    )
    if planner != "spindle" or base is None:
        p = pipe.plan(graph, cluster, hw=hw, time_fn=time_fn)
        p.signature = sig
        cache.put(p, **opts)
        cache.stats.misses += 1
        cache.stats.bracket_hits += cache.bracket_memo.hits - bracket_hits0
        return p

    p = _incremental_plan(graph, cluster, cache, pipe, base, sig,
                          hw=hw, time_fn=time_fn)
    cache.put(p, **opts)
    cache.stats.bracket_hits += cache.bracket_memo.hits - bracket_hits0
    return p


def _incremental_plan(
    graph: TaskGraph,
    cluster: ClusterSpec,
    cache: PlanCache,
    pipe: PlannerPipeline,
    base: _CacheEntry,
    sig: str,
    *,
    hw: HardwareSpec,
    time_fn: Optional[TimeFn],
) -> ExecutionPlan:
    t0 = time.perf_counter()
    ctx = PlanContext(graph=graph, cluster=cluster, hw=hw, time_fn=time_fn)
    mg = contract(graph)
    est = pipe.estimator.build(ctx, mg)
    N = cluster.n_healthy

    sched = Schedule()
    t_now, widx = 0.0, 0
    reused = replanned = warm_hits = 0
    for i, metas in enumerate(mg.levels()):
        lsig = level_signature(metas)
        if i < len(base.level_sigs) and lsig == base.level_sigs[i]:
            new_sorted = sorted((meta_signature(m), m.meta_id) for m in metas)
            mapping = {
                old_mid: new_mid
                for (_, old_mid), (_, new_mid) in zip(base.level_metas[i],
                                                      new_sorted)
            }
            sched.level_allocs.append(
                _remap_alloc(base.level_allocs[i], mapping)
            )
            sched.c_star_total += base.level_allocs[i].c_star
            waves, t_now = _remap_waves(
                base.level_waves[i], mapping, t_now, i, widx
            )
            sched.waves.extend(waves)
            widx += len(waves)
            reused += 1
        else:
            # Changed level: warm-start the MPSP bisection from the cached
            # level's C̃* when the allocator supports it (sub-level reuse —
            # task-count shifts change every level's membership, but the
            # optimum moves little, so the cached bracket converges fast).
            warm = getattr(pipe.allocator, "allocate_warm", None)
            c_hint = (
                base.level_allocs[i].c_star
                if i < len(base.level_allocs) else None
            )
            if warm is not None and c_hint is not None and c_hint > 0:
                alloc = warm(metas, est, N, c_hint)
                warm_hits += 1
            else:
                alloc = pipe.allocator.allocate(metas, est, N)
            sched.level_allocs.append(alloc)
            sched.c_star_total += alloc.c_star
            waves, t_now = schedule_level(metas, alloc, est, N, t_now, i, widx)
            sched.waves.extend(waves)
            widx += len(waves)
            replanned += 1
    sched.makespan = t_now

    try:
        check_schedule(sched, mg, N)
        placement = pipe.placement.run(ctx, sched, mg)
        p = assemble_plan(
            mg, sched, placement, cluster,
            time.perf_counter() - t0, planner=pipe.name,
        )
        cache.stats.incremental += 1
        cache.stats.levels_reused += reused
        cache.stats.levels_replanned += replanned
        cache.stats.warm_start_hits += warm_hits
    except (AssertionError, RuntimeError, KeyError):
        # Correctness fallback: any merge inconsistency voids the reuse.
        cache.stats.fallbacks += 1
        cache.stats.misses += 1
        p = pipe.plan(graph, cluster, hw=hw, time_fn=time_fn)
    p.signature = sig
    return p
