"""Wavefront scheduler (Spindle §3.4, Algorithm 1).

A *wave* is the smallest scheduling unit: one concurrent execution of sliced
MetaOps on disjoint, fixed device groups.  Waves are crafted greedily:

  ① Propose_Candidate_Set — pick ASL-tuples from the remaining allocation
    plan to occupy as many devices as possible (at most one tuple per MetaOp
    per wave — constraint (6): intervals of one MetaOp are pairwise disjoint).
  ② Extend_Resources_If_Needed — if the candidate set leaves devices idle,
    extend allocations of proposed tuples to the next valid size, prioritized
    by larger remaining execution time (balances remaining workload).
  ③ Align_Time_Span — the wave ends when its *shortest complete tuple* ends;
    longer tuples are dissected (only ⌊T_wave / T_m(n)⌋ of their operators run
    in this wave; the rest return to the remaining set).  Hence every wave
    consumes all layers of ≥1 tuple, bounding #waves ≤ 2·#MetaOps (§5.5).
  ④ Conclude — set start times, subtract scheduled work, advance the clock.

MetaLevels are scheduled independently and merged back-to-back (§3.4
"Merging MetaLevels").
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .allocator import LevelAllocation, allocate_level
from .contraction import MetaGraph, MetaOp
from .estimator import ScalabilityEstimator, best_config, valid_allocations


@dataclass
class WaveEntry:
    """One sliced MetaOp execution inside a wave."""

    meta_id: int
    n: int
    l: int  # number of operators scheduled in this wave
    t_per_op: float
    config: "ParallelConfig"
    start: float
    op_offset: int  # index of the first operator (within the MetaOp) run here

    @property
    def duration(self) -> float:
        return self.t_per_op * self.l

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass
class Wave:
    index: int
    level: int
    start: float
    duration: float
    entries: List[WaveEntry] = field(default_factory=list)

    @property
    def end(self) -> float:
        return self.start + self.duration

    @property
    def devices_used(self) -> int:
        return sum(e.n for e in self.entries)


@dataclass
class Schedule:
    """The full wavefront schedule (all MetaLevels merged)."""

    waves: List[Wave] = field(default_factory=list)
    makespan: float = 0.0
    c_star_total: float = 0.0  # Σ per-level C̃* — the Fig.11 reference bound
    level_allocs: List[LevelAllocation] = field(default_factory=list)
    # Strategy-specific side channel (e.g. the optimus task-block map) read
    # by the paired placement stage; see repro_torch.core.pipeline.
    extras: Dict[str, Any] = field(default_factory=dict)


# Signature shared by allocate_level and its strategy alternatives
# (repro_torch.core.allocator.allocate_balanced); the scheduler below and the
# PlannerPipeline wire the selected allocator through this hook.
AllocateFn = Callable[[Sequence[MetaOp], ScalabilityEstimator, int], LevelAllocation]


# --------------------------------------------------------------------------


# Wavefront proposal ordering; see step ① below. Measured on the Fig. 11
# grid (EXPERIMENTS.md §Perf planner iterations): "wide" (the paper's
# fill-devices-first) beat "long" (longest-remaining first): mean deviation
# 10.2% vs 11.2% — hypothesis refuted, kept "wide".
PROPOSE_ORDER = "wide"

# Iterated re-allocation: re-solve the MPSP continuous optimum on the
# REMAINING work after each wave (instead of keeping the initial bi-point
# tuples), so discretization bias doesn't compound into ragged tails.
# Beyond-paper extension, measured in EXPERIMENTS.md §Perf.
REALLOCATE_EVERY_WAVE = False


@dataclass
class _Pending:
    """Remaining work of one ASL-tuple during scheduling."""

    meta: MetaOp
    n: int
    l_remaining: int
    t_per_op: float
    config: "ParallelConfig"
    op_offset: int  # next operator index of the MetaOp to execute

    @property
    def remaining_time(self) -> float:
        return self.t_per_op * self.l_remaining


def _pick_span(cand: Sequence["_Pending"]) -> float:
    """Align_Time_Span (③) with waste-minimizing span search.

    The paper aligns to the SHORTEST complete tuple; we search all candidate
    remaining-times and pick the span minimizing device·time waste under
    nearest-rounding, subject to ≥1 tuple finishing (termination invariant).
    Measured: mean deviation vs C̃* 8.0% → 7.7% (EXPERIMENTS.md §Perf).
    """
    spans = sorted({p.remaining_time for p in cand})

    def waste(t: float) -> float:
        ks = [
            min(max(int(t / p.t_per_op + 0.5), 0), p.l_remaining)
            for p in cand
        ]
        if not any(k == p.l_remaining for k, p in zip(ks, cand)):
            return math.inf  # must finish ≥1 tuple per wave
        dur = max((k * p.t_per_op for k, p in zip(ks, cand)), default=t)
        if dur <= 0:
            return math.inf
        return sum(p.n * (dur - k * p.t_per_op) for k, p in zip(ks, cand))

    return min(spans, key=waste)


def schedule_level(
    metas: Sequence[MetaOp],
    alloc: LevelAllocation,
    estimator: ScalabilityEstimator,
    n_devices: int,
    t_start: float,
    level: int,
    wave_index0: int,
) -> Tuple[List[Wave], float]:
    """Algorithm 1 for one MetaLevel; returns (waves, t_end)."""
    meta_by_id = {m.meta_id: m for m in metas}

    # Remaining set: per MetaOp, its (≤2) ASL-tuples in execution order —
    # the tuple covering earlier operators first (larger-n tuple first is the
    # paper's Fig. 5 convention: run the wide slice first).
    remaining: Dict[int, List[_Pending]] = {}
    for mid, tuples in alloc.tuples.items():
        m = meta_by_id[mid]
        offset = 0
        lst = []
        for t in sorted(tuples, key=lambda a: -a.n):
            lst.append(
                _Pending(
                    meta=m,
                    n=t.n,
                    l_remaining=t.l,
                    t_per_op=t.t_per_op,
                    config=t.config,
                    op_offset=offset,
                )
            )
            offset += t.l
        remaining[mid] = lst

    waves: List[Wave] = []
    t_now = t_start
    widx = wave_index0
    guard = 0
    while any(remaining.values()):
        guard += 1
        if guard > 4 * len(metas) + 16:
            raise RuntimeError("wavefront scheduler failed to converge")

        if REALLOCATE_EVERY_WAVE and waves:
            # Re-solve the MPSP optimum on the remaining work so tuple
            # discretization bias doesn't compound into ragged tails.
            rem_metas, offsets = [], {}
            for mid, lst in remaining.items():
                if not lst:
                    continue
                off = lst[0].op_offset
                m = meta_by_id[mid]
                rem_metas.append(replace(m, op_ids=list(m.op_ids[off:])))
                offsets[mid] = off
            re_alloc = allocate_level(rem_metas, estimator, n_devices)
            remaining = {mid: [] for mid in remaining}
            for m2 in rem_metas:
                off = offsets[m2.meta_id]
                lst = []
                for t in sorted(re_alloc.tuples[m2.meta_id], key=lambda a: -a.n):
                    lst.append(
                        _Pending(
                            meta=meta_by_id[m2.meta_id],
                            n=t.n,
                            l_remaining=t.l,
                            t_per_op=t.t_per_op,
                            config=t.config,
                            op_offset=off,
                        )
                    )
                    off += t.l
                remaining[m2.meta_id] = lst

        # ① Propose candidate set: heads of each MetaOp's pending list,
        # greedily packed to fill N devices.  Ordering policy is a measured
        # choice (EXPERIMENTS.md §Perf planner cell): "wide" = widest
        # allocation first (fills fastest), "long" = largest remaining
        # execution time first (balances tails).
        heads = [lst[0] for lst in remaining.values() if lst]
        if PROPOSE_ORDER == "long":
            heads.sort(key=lambda p: (-p.remaining_time, -p.n, p.meta.meta_id))
        else:
            heads.sort(key=lambda p: (-p.n, -p.remaining_time, p.meta.meta_id))
        cand: List[_Pending] = []
        free = n_devices
        for p in heads:
            if p.n <= free:
                cand.append(p)
                free -= p.n
        if free > 0:
            # Shrink-to-fit post-pass: rather than leaving residual devices
            # idle, run the widest unpacked tuple narrower (largest valid ≤
            # free).  Only after normal packing so small heads pack first.
            for p in heads:
                if free <= 0:
                    break
                if p in cand:
                    continue
                fits = [v for v in valid_allocations(p.meta, n_devices) if v <= free]
                if fits:
                    n_new = fits[-1]
                    curve = estimator.curve(p.meta)
                    p.n = n_new
                    p.t_per_op = curve.estimate(n_new)
                    cfg = best_config(p.meta, n_new)
                    p.config = cfg if cfg is not None else curve.config_for(n_new)
                    cand.append(p)
                    free -= n_new
        if not cand:
            # The smallest pending tuple is wider than the cluster — clamp it.
            p = min(heads, key=lambda q: q.n)
            valids = [v for v in valid_allocations(p.meta, n_devices)]
            n_new = max(v for v in valids if v <= n_devices)
            curve = estimator.curve(p.meta)
            p.n = n_new
            p.t_per_op = curve.estimate(n_new)
            p.config = curve.config_for(n_new)
            cand = [p]
            free = n_devices - p.n

        # ② + ③ fixed point: extend allocations onto idle devices, align the
        # time span to the shortest complete tuple, and defer any candidate
        # whose single-op time exceeds the wave (it could schedule 0 ops and
        # would only reserve idle devices); deferred devices are re-extended.
        def extend(cand: List[_Pending], free: int) -> int:
            progressed = True
            while free > 0 and progressed:
                progressed = False
                for p in sorted(cand, key=lambda q: -q.remaining_time):
                    valids = valid_allocations(p.meta, n_devices)
                    bigger = [v for v in valids if p.n < v <= p.n + free]
                    if not bigger:
                        continue
                    n_new = bigger[0]
                    curve = estimator.curve(p.meta)
                    free -= n_new - p.n
                    p.n = n_new
                    p.t_per_op = curve.estimate(n_new)
                    cfg = best_config(p.meta, n_new)
                    p.config = cfg if cfg is not None else curve.config_for(n_new)
                    progressed = True
                    if free == 0:
                        break
            return free

        for _ in range(len(cand) + 1):
            free = extend(cand, free)
            t_wave = _pick_span(cand)
            drop = [p for p in cand if p.t_per_op > t_wave * (1 + 1e-9)]
            if not drop:
                break
            for p in drop:
                cand.remove(p)
                free += p.n
        t_wave = _pick_span(cand)

        entries: List[WaveEntry] = []
        for p in cand:
            if p.t_per_op <= 0:
                k = p.l_remaining
            else:
                # nearest-rounding (not floor): balances entry durations
                # around the aligned span — measured mean deviation vs C̃*
                # 10.2% → 8.0% on the Fig. 11 grid (EXPERIMENTS.md §Perf).
                k = int(math.floor(t_wave / p.t_per_op + 0.5))
            k = min(max(k, 0), p.l_remaining)
            if k == 0:
                continue  # numerical guard; cannot normally happen post-defer
            entries.append(
                WaveEntry(
                    meta_id=p.meta.meta_id,
                    n=p.n,
                    l=k,
                    t_per_op=p.t_per_op,
                    config=p.config,
                    start=t_now,
                    op_offset=p.op_offset,
                )
            )
            p.l_remaining -= k
            p.op_offset += k
            if p.l_remaining == 0:
                remaining[p.meta.meta_id].pop(0)

        # ④ Conclude the wave.
        dur = max((e.duration for e in entries), default=t_wave)
        waves.append(
            Wave(index=widx, level=level, start=t_now, duration=dur, entries=entries)
        )
        widx += 1
        t_now += dur

    return waves, t_now


def schedule(
    mg: MetaGraph,
    estimator: ScalabilityEstimator,
    n_devices: int,
    *,
    allocate_fn: AllocateFn = allocate_level,
) -> Schedule:
    """Allocate + schedule every MetaLevel, merged sequentially (§3.4)."""
    sched = Schedule()
    t_now = 0.0
    widx = 0
    for level, metas in enumerate(mg.levels()):
        alloc = allocate_fn(metas, estimator, n_devices)
        sched.level_allocs.append(alloc)
        sched.c_star_total += alloc.c_star
        waves, t_now = schedule_level(
            metas, alloc, estimator, n_devices, t_now, level, widx
        )
        sched.waves.extend(waves)
        widx += len(waves)
    sched.makespan = t_now
    return sched


# --------------------------------------------------------------------------
# Schedule invariants (used by tests and by the runtime engine's validation)
# --------------------------------------------------------------------------


def check_schedule(sched: Schedule, mg: MetaGraph, n_devices: int) -> None:
    """Assert capacity (2)/(5), disjointness (6), completeness (7), deps (3)."""
    # capacity & per-wave structure
    for w in sched.waves:
        used = sum(e.n for e in w.entries)
        if used > n_devices:
            raise AssertionError(f"wave {w.index} over capacity: {used}>{n_devices}")
        seen = set()
        for e in w.entries:
            if e.meta_id in seen:
                raise AssertionError(f"wave {w.index}: duplicate MetaOp {e.meta_id}")
            seen.add(e.meta_id)
            if e.end > w.end + 1e-9:
                raise AssertionError(f"wave {w.index}: entry exceeds wave end")

    # completeness + intra-MetaOp op ordering
    done: Dict[int, int] = {mid: 0 for mid in mg.meta_ops}
    for w in sched.waves:
        for e in w.entries:
            if e.op_offset != done[e.meta_id]:
                raise AssertionError(
                    f"MetaOp {e.meta_id}: op_offset {e.op_offset} != {done[e.meta_id]}"
                )
            done[e.meta_id] += e.l
    for mid, m in mg.meta_ops.items():
        if done[mid] != m.L:
            raise AssertionError(f"MetaOp {mid}: scheduled {done[mid]} of {m.L} ops")

    # dependency: all ops of a lower level finish before a higher level starts
    level_span: Dict[int, Tuple[float, float]] = {}
    for w in sched.waves:
        s, e = level_span.get(w.level, (math.inf, 0.0))
        level_span[w.level] = (min(s, w.start), max(e, w.end))
    levels = sorted(level_span)
    for a, b in zip(levels, levels[1:]):
        if level_span[a][1] > level_span[b][0] + 1e-9:
            raise AssertionError(f"levels {a} and {b} overlap in time")
