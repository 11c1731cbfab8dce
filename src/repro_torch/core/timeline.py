"""Plan timeline introspection: idle windows + memory headroom (DESIGN.md §15).

Spindle's wavefront decomposition already *computes* everything a
co-located tenant needs — per-device busy intervals (the schedule's wave
entries) and per-device memory high-water (the placement stage) — but
until this module neither was exposed as a queryable surface: every
consumer read raw simulator fields.  :func:`compute_timeline` (reachable
as ``plan.timeline()``) turns one :class:`repro_torch.core.plan.ExecutionPlan`
into a :class:`PlanTimeline` of typed :class:`IdleWindow` records:

  * a window is a maximal interval in ``[0, makespan]`` (simulated
    seconds) during which one device runs no plan step — exactly the
    complement of the simulator's per-device step occupancy, so windows
    and ``SimResult`` gaps agree by construction;
  * each window carries the device's **memory headroom**:
    ``cluster.mem_bytes − placement.mem_high_water[device]`` — the bytes
    a co-resident workload (e.g. a serving tenant's KV pages) can map
    beside the training footprint without evicting it.

Invariants (asserted by ``tests/test_timeline.py``):

  * per device, busy intervals and idle windows partition ``[0, makespan]``
    (no overlap, no gap);
  * ``0 <= headroom_bytes <= mem_bytes − mem_high_water`` for every window;
  * windows are reported sorted by ``(start, device)``.

:meth:`PlanTimeline.gang_windows` is the co-location query: maximal
intervals with a *constant* set of simultaneously-idle devices (filtered
by a headroom floor), which is what a gang-scheduled decode step needs —
``k`` devices idle together, each with room for the tenant's KV budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .placement import ClusterSpec

__all__ = ["IdleWindow", "GangWindow", "PlanTimeline", "compute_timeline"]

#: windows (and busy gaps) shorter than this are scheduling noise, not
#: exploitable bubbles — float fuzz from wave arithmetic collapses to zero
_EPS = 1e-12


@dataclass(frozen=True)
class IdleWindow:
    """One device's maximal idle interval inside a plan's makespan."""

    device: int
    start: float
    end: float
    #: bytes a co-resident tenant can map on this device during the window
    #: (device memory minus the placement's high-water mark, floored at 0)
    headroom_bytes: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    def fits(self, seconds: float, bytes_needed: float = 0.0) -> bool:
        """Can a unit of ``seconds`` work needing ``bytes_needed`` run here?"""
        return (
            self.duration + _EPS >= seconds
            and self.headroom_bytes + _EPS >= bytes_needed
        )


@dataclass(frozen=True)
class GangWindow:
    """A maximal interval where a fixed device set is simultaneously idle."""

    start: float
    end: float
    devices: Tuple[int, ...]
    #: min headroom over :attr:`devices` — the gang's co-tenant budget
    headroom_bytes: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def n_devices(self) -> int:
        return len(self.devices)


@dataclass
class PlanTimeline:
    """The queryable idle structure of one ExecutionPlan."""

    makespan: float
    #: per-device merged busy intervals, device -> [(start, end), ...]
    busy: Dict[int, List[Tuple[float, float]]]
    #: per-device headroom (mem_bytes − placement high-water, floored at 0)
    headroom: Dict[int, float]
    #: all idle windows, sorted by (start, device)
    windows: List[IdleWindow] = field(default_factory=list)
    #: wave spans (wave_index -> (start, end)) for wave-boundary queries
    wave_spans: Dict[int, Tuple[float, float]] = field(default_factory=dict)

    # ------------------------------------------------------------- queries
    @property
    def n_devices(self) -> int:
        return len(self.busy)

    def windows_for(self, device: int) -> List[IdleWindow]:
        return [w for w in self.windows if w.device == device]

    def total_idle_seconds(self) -> float:
        return sum(w.duration for w in self.windows)

    def idle_fraction(self) -> float:
        """Idle device-seconds over total device-seconds of the plan."""
        total = self.makespan * max(self.n_devices, 1)
        if total <= 0:
            return 0.0
        return self.total_idle_seconds() / total

    def wave_windows(self, wave_index: int) -> List[IdleWindow]:
        """Idle windows overlapping the given wave's ``[start, end)`` span
        (the bubbles a wave-boundary callback could fill)."""
        span = self.wave_spans.get(wave_index)
        if span is None:
            return []
        s, e = span
        return [w for w in self.windows if w.start < e and w.end > s + _EPS]

    def gang_windows(
        self, k: int = 1, min_headroom: float = 0.0
    ) -> List[GangWindow]:
        """Maximal intervals where ≥ ``k`` devices (each with headroom ≥
        ``min_headroom``) are simultaneously idle, with a constant idle set.

        Sweep over the window boundary points: within one elementary
        interval the idle-device set is constant; adjacent intervals with
        identical sets coalesce.  Deterministic and exact — no merging of
        unequal sets, so a reported gang really is idle end to end.
        """
        if k < 1:
            raise ValueError(f"gang size must be >= 1, got {k}")
        eligible = [
            w for w in self.windows
            if w.headroom_bytes + _EPS >= min_headroom and w.duration > _EPS
        ]
        if not eligible:
            return []
        points = sorted({w.start for w in eligible}
                        | {w.end for w in eligible})
        out: List[GangWindow] = []
        for lo, hi in zip(points[:-1], points[1:]):
            if hi - lo <= _EPS:
                continue
            idle = tuple(sorted(
                w.device for w in eligible
                if w.start <= lo + _EPS and w.end >= hi - _EPS
            ))
            if len(idle) < k:
                continue
            head = min(self.headroom[d] for d in idle)
            prev = out[-1] if out else None
            if (
                prev is not None
                and prev.devices == idle
                and abs(prev.end - lo) <= _EPS
            ):
                out[-1] = GangWindow(
                    start=prev.start, end=hi, devices=idle,
                    headroom_bytes=head,
                )
            else:
                out.append(GangWindow(
                    start=lo, end=hi, devices=idle, headroom_bytes=head
                ))
        return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping/adjacent intervals (sorted output)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1] + _EPS:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def compute_timeline(
    plan, cluster: Optional[ClusterSpec] = None,
    devices: Optional[Sequence[int]] = None,
) -> PlanTimeline:
    """Build the :class:`PlanTimeline` of ``plan``.

    ``cluster`` supplies per-device memory (``mem_bytes``) and the device
    universe; it defaults to the cluster the plan was assembled against
    (every planner pipeline records it).  ``devices`` overrides the device
    universe — e.g. to ask about a sub-lease only.
    """
    cluster = cluster if cluster is not None else getattr(
        plan, "cluster", None
    )
    if cluster is None:
        raise ValueError(
            "plan has no recorded cluster; pass timeline(cluster=...)"
        )
    if devices is None:
        devices = cluster.healthy_devices()
    makespan = plan.makespan
    raw: Dict[int, List[Tuple[float, float]]] = {int(d): [] for d in devices}
    wave_spans: Dict[int, Tuple[float, float]] = {}
    for s in plan.steps:
        end = s.start + s.duration
        for d in s.devices:
            if d in raw:
                raw[d].append((s.start, end))
        ws, we = wave_spans.get(s.wave_index, (s.start, end))
        wave_spans[s.wave_index] = (min(ws, s.start), max(we, end))
    busy = {d: _merge(iv) for d, iv in raw.items()}
    mhw = plan.placement.mem_high_water if plan.placement is not None else {}
    headroom = {
        d: max(0.0, cluster.mem_bytes - float(mhw.get(d, 0.0)))
        for d in busy
    }
    windows: List[IdleWindow] = []
    for d, iv in busy.items():
        cursor = 0.0
        for s, e in iv:
            if s - cursor > _EPS:
                windows.append(IdleWindow(
                    device=d, start=cursor, end=s,
                    headroom_bytes=headroom[d],
                ))
            cursor = max(cursor, e)
        if makespan - cursor > _EPS:
            windows.append(IdleWindow(
                device=d, start=cursor, end=makespan,
                headroom_bytes=headroom[d],
            ))
    windows.sort(key=lambda w: (w.start, w.device))
    return PlanTimeline(
        makespan=makespan, busy=busy, headroom=headroom,
        windows=windows, wave_spans=wave_spans,
    )
