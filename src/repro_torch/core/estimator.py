"""Scalability estimator: per-MetaOp scaling curves (Spindle §3.2).

The estimator captures ``T_m(n)`` — the execution time of one operator of
MetaOp ``m`` when the MetaOp is allocated ``n`` devices — via **piecewise
α–β modelling**: profile discrete points ``(n_i, T_m(n_i))`` under the best
parallel configuration per ``n_i``, then fit each segment
``[n_i, n_{i+1}]`` with ``T(n) = α_k + β_k / n`` (exactly through the two
endpoints; two unknowns, two points).  Estimation locates the segment ``n``
falls into and evaluates the corresponding piece; the inverse
``T⁻¹(t) = min{n : T(n) ≤ t}`` (needed by the allocator's eq. 9 bisection)
is solved per-piece in closed form.

Profiled points come from either
  * real measurements (tests feed CPU wall times; on a real cluster this is
    the paper's <5-min profiling pass), or
  * the analytic H100 cost model in :mod:`repro_torch.core.costmodel`
    (its four fitted constants come from a sweep on the card).
Either way the fitting/estimation machinery below is identical — that is
the paper-faithful part.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .contraction import MetaGraph, MetaOp


@dataclass(frozen=True)
class ParallelConfig:
    """Intra-MetaOp parallel configuration for a given allocation ``n``."""

    dp: int = 1
    tp: int = 1

    @property
    def n(self) -> int:
        return self.dp * self.tp

    def __repr__(self) -> str:
        return f"dp{self.dp}tp{self.tp}"


@dataclass
class ScalingCurve:
    """Piecewise α–β model of ``T_m(n)`` for one MetaOp.

    ``points`` must be sorted by n, with strictly positive times, and is
    coerced to be non-increasing (Theorem 1's precondition).  Each segment
    ``[n_i, n_{i+1}]`` stores ``(alpha, beta)`` with ``T(n) = alpha + beta/n``.
    """

    ns: List[int]
    ts: List[float]
    configs: List[ParallelConfig]
    pieces: List[Tuple[float, float]] = field(default_factory=list)

    def __post_init__(self) -> None:
        if len(self.ns) != len(self.ts) or len(self.ns) < 1:
            raise ValueError("need ≥1 profiled point with matching times")
        if any(t <= 0 for t in self.ts):
            raise ValueError("times must be positive")
        if sorted(self.ns) != list(self.ns) or len(set(self.ns)) != len(self.ns):
            raise ValueError("ns must be strictly increasing")
        # Enforce monotone non-increasing T(n): a larger allocation can always
        # emulate a smaller one, so clip upward bumps (measurement noise).
        best = math.inf
        ts = []
        for t in self.ts:
            best = min(best, t)
            ts.append(best)
        self.ts = ts
        self.pieces = []
        for k in range(len(self.ns) - 1):
            n0, n1 = self.ns[k], self.ns[k + 1]
            t0, t1 = self.ts[k], self.ts[k + 1]
            # Solve t0 = a + b/n0 ; t1 = a + b/n1
            b = (t0 - t1) / (1.0 / n0 - 1.0 / n1) if n0 != n1 else 0.0
            a = t0 - b / n0
            self.pieces.append((a, b))

    # ------------------------------------------------------------------
    @property
    def n_min(self) -> int:
        return self.ns[0]

    @property
    def n_max(self) -> int:
        return self.ns[-1]

    def estimate(self, n: float) -> float:
        """``T(n)`` for real-valued ``n`` (continuous relaxation, §3.3)."""
        if n <= 0:
            return math.inf
        if n <= self.ns[0]:
            # Below the smallest profiled allocation: work/device grows
            # inversely — extrapolate with the first piece if available,
            # else perfect inverse scaling from the first point.
            if len(self.ns) == 1:
                return self.ts[0] * self.ns[0] / n
            a, b = self.pieces[0]
            return a + b / n
        if n >= self.ns[-1]:
            return self.ts[-1]  # no gain past the largest profiled allocation
        k = bisect.bisect_right(self.ns, n) - 1
        a, b = self.pieces[k]
        return a + b / n

    def inverse(self, t: float) -> float:
        """Smallest real ``n`` with ``T(n) ≤ t``; ``inf`` if unattainable."""
        if t <= 0:
            return math.inf
        if t >= self.estimate(self.ns[0]):
            # attainable below the first profiled point
            if len(self.ns) == 1:
                return self.ts[0] * self.ns[0] / t
            a, b = self.pieces[0]
            if b <= 0:
                return float(self.ns[0]) if t >= a else math.inf
            n = b / (t - a) if t > a else math.inf
            return max(min(n, float(self.ns[0])), 1e-9)
        if t < self.ts[-1]:
            return math.inf
        # find segment with ts[k] >= t >= ts[k+1]
        for k in range(len(self.pieces)):
            t0, t1 = self.ts[k], self.ts[k + 1]
            if t1 <= t <= t0:
                a, b = self.pieces[k]
                if b <= 0:  # flat segment
                    return float(self.ns[k + 1]) if t >= t1 else math.inf
                if t <= a:
                    return math.inf
                return min(max(b / (t - a), float(self.ns[k])), float(self.ns[k + 1]))
        return math.inf

    def config_for(self, n: int) -> ParallelConfig:
        """Best profiled parallel config at the largest profiled n ≤ n."""
        k = bisect.bisect_right(self.ns, n) - 1
        k = max(0, min(k, len(self.configs) - 1))
        return self.configs[k]

    def speedup(self, n: int) -> float:
        """ς_m(n) = T_m(1)/T_m(n) (resource scalability, Fig. 4 right)."""
        return self.estimate(1) / self.estimate(n)


# --------------------------------------------------------------------------
# Valid allocations (§3.3 "valid" constraint)
# --------------------------------------------------------------------------


def valid_allocations(m: MetaOp, n_devices: int, *, powers_of_two: bool = False) -> List[int]:
    """Allocations ``n`` that admit a practical parallel config for ``m``.

    ``n = dp·tp`` is valid iff some factorization exists with ``dp`` dividing
    the MetaOp's global batch (no uneven sample partition) and ``tp`` both a
    divisor of ``n`` and ≤ ``max_tp`` (e.g. bounded by #kv-heads).  ``n=0`` is
    the dummy allocation and always "valid" (§3.3).
    """
    out = []
    candidates = (
        [1 << k for k in range(n_devices.bit_length()) if (1 << k) <= n_devices]
        if powers_of_two
        else range(1, n_devices + 1)
    )
    for n in candidates:
        if best_config(m, n) is not None:
            out.append(n)
    return out


def best_config(m: MetaOp, n: int) -> Optional[ParallelConfig]:
    """Pick the least-TP factorization ``dp·tp = n`` that is valid for ``m``.

    Lower TP is preferred (less collective traffic) whenever DP divisibility
    allows; the cost model refines this choice when profiling.  TP degrees
    are restricted to powers of two (hardware-aligned head/FFN splits) —
    odd TP factorizations are never practical and would make the scaling
    curves jagged.
    """
    if n <= 0:
        return None
    for tp in _divisors(n):
        dp = n // tp
        if tp & (tp - 1) == 0 and tp <= m.max_tp and m.batch_size % dp == 0:
            return ParallelConfig(dp=dp, tp=tp)
    return None


def enumerate_configs(m: MetaOp, n: int) -> List[ParallelConfig]:
    out = []
    for tp in _divisors(n):
        dp = n // tp
        if tp & (tp - 1) == 0 and tp <= m.max_tp and m.batch_size % dp == 0:
            out.append(ParallelConfig(dp=dp, tp=tp))
    return out


def _divisors(n: int) -> List[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


# --------------------------------------------------------------------------
# The estimator itself
# --------------------------------------------------------------------------

TimeFn = Callable[[MetaOp, ParallelConfig], float]


class ScalabilityEstimator:
    """Builds a :class:`ScalingCurve` per MetaOp from a timing source.

    ``time_fn(meta_op, config)`` returns the per-operator execution time under
    ``config``; it is either the analytic model
    (:func:`repro_torch.core.costmodel.h100_time_fn`) or real measurements.
    Profiling grid: the valid allocations up to ``n_devices`` (optionally
    thinned to powers of two for large clusters — mirroring the paper's
    "several discrete data points").
    """

    def __init__(
        self,
        time_fn: TimeFn,
        n_devices: int,
        *,
        profile_powers_of_two: bool = True,
        curve_memo: Optional[Dict[Tuple, ScalingCurve]] = None,
    ):
        self.time_fn = time_fn
        self.n_devices = n_devices
        self.profile_powers_of_two = profile_powers_of_two
        self._cache: Dict[int, ScalingCurve] = {}
        # Optional cross-plan memo keyed by MetaOp *identity* (not meta_id),
        # shared between estimator instances so incremental replans skip
        # re-profiling unchanged MetaOps (repro_torch.core.plancache wires this).
        self._memo = curve_memo

    def _memo_key(self, m: MetaOp) -> Tuple:
        w = m.workload
        return (
            m.op_type, m.batch_size, m.seq_len, m.max_tp,
            w.flops, w.bytes_hbm, w.param_bytes, w.act_bytes, w.tp_comm_bytes,
            self.n_devices, self.profile_powers_of_two,
        )

    def curve(self, m: MetaOp) -> ScalingCurve:
        if m.meta_id in self._cache:
            return self._cache[m.meta_id]
        if self._memo is not None:
            key = self._memo_key(m)
            hit = self._memo.get(key)
            if hit is not None:
                self._cache[m.meta_id] = hit
                return hit
        grid = valid_allocations(
            m, self.n_devices, powers_of_two=self.profile_powers_of_two
        )
        if not grid:
            grid = valid_allocations(m, self.n_devices, powers_of_two=False)[:1]
        if not grid:
            raise ValueError(f"no valid allocation for {m!r}")
        ns, ts, cfgs = [], [], []
        for n in grid:
            best_t, best_c = math.inf, None
            for cfg in enumerate_configs(m, n):
                t = self.time_fn(m, cfg)
                if t < best_t:
                    best_t, best_c = t, cfg
            if best_c is None:
                continue
            ns.append(n)
            ts.append(best_t)
            cfgs.append(best_c)
        curve = ScalingCurve(ns=ns, ts=ts, configs=cfgs)
        self._cache[m.meta_id] = curve
        if self._memo is not None:
            self._memo[self._memo_key(m)] = curve
        return curve

    def curves(self, mg: MetaGraph) -> Dict[int, ScalingCurve]:
        return {mid: self.curve(m) for mid, m in mg.meta_ops.items()}
