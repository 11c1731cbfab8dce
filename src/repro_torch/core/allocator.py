"""Resource allocator: MPSP relaxation + bi-point discretization (Spindle §3.3).

Per MetaLevel (MetaOps ``Ṽ_M``, cluster of ``N`` devices):

1. **Continuous optimum** (Theorem 1, Weglarz).  With positive non-increasing
   ``T_m(n)`` the malleable-project-scheduling optimum has every MetaOp start
   at 0, run all ``L_m`` operators on a constant real allocation ``n*_m``,
   and finish together at ``C̃*`` determined by

        T_m(n*_m) · L_m = C̃*   ∀m        Σ_m n*_m = N            (eq. 8)

   found by **bisection** on  g(C) := Σ_m T_m⁻¹(C / L_m) = N      (eq. 9),
   g being continuous and non-increasing in C.

2. **Bi-point discretization.**  Each real ``n*_m`` is represented by two
   ASL-tuples ⟨n̄_m, ·, l̄_m⟩, ⟨n̲_m, ·, l̲_m⟩ with n̄/n̲ the closest *valid*
   integers bracketing n*_m, and l̄/l̲ solving

        l̄ + l̲ = L_m                                             (10a)
        T_m(n̄)·l̄ + T_m(n̲)·l̲ = C̃*                               (10b)

   l's are then rounded to integers (zero-length tuples dropped; ``n̲ = 0``
   is the dummy allocation and is dropped after serving (10b)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .contraction import MetaOp
from .estimator import (
    ParallelConfig,
    ScalabilityEstimator,
    ScalingCurve,
    best_config,
    valid_allocations,
)


@dataclass
class ASLTuple:
    """⟨n, s, l⟩: ``l`` consecutive operators on ``n`` devices from time ``s``.

    ``s`` is filled in by the wavefront scheduler; the allocator leaves it at
    ``None``.  ``t_per_op`` caches ``T_m(n)`` so downstream stages never
    re-query the estimator.
    """

    meta_id: int
    n: int
    l: int
    t_per_op: float
    config: ParallelConfig
    s: Optional[float] = None

    @property
    def duration(self) -> float:
        return self.t_per_op * self.l

    def __repr__(self) -> str:
        return (
            f"ASL(m{self.meta_id} n={self.n} l={self.l}"
            f" t/op={self.t_per_op:.2e} s={self.s})"
        )


@dataclass
class LevelAllocation:
    """Allocator output for one MetaLevel."""

    c_star: float  # theoretical optimum C̃* of the continuous relaxation
    n_star: Dict[int, float]  # meta_id -> real-valued optimal allocation
    tuples: Dict[int, List[ASLTuple]]  # meta_id -> up to two ASL-tuples


def solve_continuous(
    metas: Sequence[MetaOp],
    curves: Dict[int, ScalingCurve],
    n_devices: int,
    *,
    tol: float = 1e-6,
    max_iter: int = 200,
    c_hint: Optional[float] = None,
) -> Tuple[float, Dict[int, float]]:
    """Bisection on eq. (9): find C̃* with Σ_m T_m⁻¹(C̃*/L_m) = N.

    ``c_hint`` warm-starts the bracket from a previously solved C̃* (the
    incremental-replan changed-level path hands in the cached level's
    optimum): the initial bracket is a tight window around the hint instead
    of the serial/maximally-parallel bounds, and the validity-expansion
    loops below still guarantee g(c_hi) ≤ N ≤ g(c_lo), so a stale hint
    costs a few extra doublings rather than correctness.
    """
    if not metas:
        return 0.0, {}

    def g(c: float) -> float:
        total = 0.0
        for m in metas:
            n = curves[m.meta_id].inverse(c / m.L)
            if math.isinf(n):
                return math.inf
            total += n
        return total

    if c_hint is not None and c_hint > 0 and math.isfinite(c_hint):
        c_lo, c_hi = 0.5 * c_hint, 2.0 * c_hint
    else:
        # Bracket: serial lower bound on speed (everything on 1 device, g
        # small) vs. everything maximally parallel (g large).
        c_hi = sum(curves[m.meta_id].estimate(1) * m.L for m in metas)
        c_lo = max(
            curves[m.meta_id].estimate(n_devices) * m.L for m in metas
        ) / max(len(metas), 1)
    c_lo = max(c_lo, 1e-12)
    # Ensure bracket validity: g(c_hi) <= N <= g(c_lo).
    for _ in range(80):
        if g(c_hi) <= n_devices:
            break
        c_hi *= 2.0
    for _ in range(80):
        if g(c_lo) >= n_devices:
            break
        c_lo /= 2.0
    if g(c_lo) < n_devices:
        # Even at the fastest feasible point the cluster is bigger than the
        # total parallelizable work: allocate saturation points.
        n_star = {
            m.meta_id: float(
                min(curves[m.meta_id].n_max, n_devices)
            )
            for m in metas
        }
        c = max(
            curves[m.meta_id].estimate(n_star[m.meta_id]) * m.L for m in metas
        )
        return c, n_star

    for _ in range(max_iter):
        c_mid = 0.5 * (c_lo + c_hi)
        val = g(c_mid)
        if val > n_devices:
            c_lo = c_mid
        else:
            c_hi = c_mid
        if (c_hi - c_lo) <= tol * max(c_hi, 1e-12):
            break
    c_star = c_hi
    n_star = {
        m.meta_id: min(
            float(n_devices), curves[m.meta_id].inverse(c_star / m.L)
        )
        for m in metas
    }
    # Numerical cleanup: rescale so the total equals N (preserves ratios).
    total = sum(n_star.values())
    if total > 0 and abs(total - n_devices) / n_devices > 1e-3:
        scale = n_devices / total
        n_star = {k: v * scale for k, v in n_star.items()}
    return c_star, n_star


class BracketMemo:
    """Cross-plan memo of each MetaOp's bi-point bracket ingredients.

    ``discretize`` spends its time enumerating **valid allocations** (an
    O(N · divisors) sweep of ``best_config``) to bracket the continuous
    optimum — work that depends only on the MetaOp's shape identity and the
    cluster width, not on the timing source or the level it sits in.  The
    PlanCache owns one of these so incremental replans of *changed* levels
    skip that sweep (and the per-width ``best_config`` query) for every
    MetaOp whose identity is unchanged — the sub-level analogue of the
    scaling-curve memo.  Hits surface as the ``bracket_hits`` cache stat.

    Only timing-independent facts are cached (valid widths + best configs);
    curve estimates still go through the live estimator, so a custom
    ``time_fn`` can never read stale times through this memo.
    """

    def __init__(self, maxsize: int = 8192):
        self.maxsize = maxsize
        self.hits = 0
        self._valids: Dict[Tuple, List[int]] = {}
        self._configs: Dict[Tuple, Optional[ParallelConfig]] = {}

    @staticmethod
    def _key(m: MetaOp, n_devices: int) -> Tuple:
        return (m.op_type, m.batch_size, m.seq_len, m.max_tp, n_devices)

    def _bound(self, d: Dict) -> None:
        if len(d) > self.maxsize:  # drop the oldest half (insertion order)
            for key in list(d)[: len(d) // 2]:
                del d[key]

    def valids(self, m: MetaOp, n_devices: int) -> List[int]:
        key = self._key(m, n_devices)
        v = self._valids.get(key)
        if v is None:
            v = valid_allocations(m, n_devices)
            self._bound(self._valids)
            self._valids[key] = v
        else:
            self.hits += 1
        return v

    def config(self, m: MetaOp, n: int) -> Optional[ParallelConfig]:
        # no hit counting here: every discretize() call goes through
        # valids() first, so bracket_hits counts each memo-served MetaOp
        # exactly once — config reuse rides along uncounted by design
        key = self._key(m, n) + ("cfg",)
        if key not in self._configs:
            self._bound(self._configs)
            self._configs[key] = best_config(m, n)
        return self._configs[key]


def bracket_valid(
    m: MetaOp, n_star: float, n_devices: int,
    memo: Optional[BracketMemo] = None,
) -> Tuple[int, int]:
    """Closest valid integers n̲ ≤ n* ≤ n̄ (n̲ may be the 0 dummy)."""
    valids = (
        memo.valids(m, n_devices) if memo is not None
        else valid_allocations(m, n_devices)
    )
    lo = 0
    hi = valids[-1] if valids else 0
    for v in valids:
        if v <= n_star:
            lo = v
        if v >= n_star:
            hi = v
            break
    if hi < max(lo, 1):
        hi = max(lo, valids[0] if valids else 1)
    return lo, hi


def discretize(
    m: MetaOp,
    curve: ScalingCurve,
    n_star: float,
    c_star: float,
    n_devices: int,
    memo: Optional[BracketMemo] = None,
) -> List[ASLTuple]:
    """Bi-point discretization of ⟨n*_m, 0, L_m⟩ per conds. (10a)/(10b)."""

    def _config(n: int) -> Optional[ParallelConfig]:
        return memo.config(m, n) if memo is not None else best_config(m, n)

    lo, hi = bracket_valid(m, n_star, n_devices, memo)
    if lo == hi:
        cfg = _config(hi)
        assert cfg is not None
        return [ASLTuple(m.meta_id, hi, m.L, curve.estimate(hi), cfg)]

    t_hi = curve.estimate(hi)  # faster (more devices)
    t_lo = curve.estimate(lo) if lo > 0 else math.inf  # slower / dummy

    if lo == 0 or math.isinf(t_lo):
        # Dummy lower allocation: all L ops run at n̄; (10b) is preserved by
        # the zero-device tuple which is then ignored (§3.3).
        cfg = _config(hi)
        assert cfg is not None
        return [ASLTuple(m.meta_id, hi, m.L, t_hi, cfg)]

    # Solve l̄·t_hi + l̲·t_lo = C̃*, l̄ + l̲ = L.
    denom = t_hi - t_lo
    if abs(denom) < 1e-18:
        l_hi_f = float(m.L)
    else:
        l_hi_f = (c_star - t_lo * m.L) / denom
    l_hi_f = min(max(l_hi_f, 0.0), float(m.L))

    l_hi = int(round(l_hi_f))
    l_lo = m.L - l_hi  # keep (10a) exact under rounding

    out: List[ASLTuple] = []
    if l_hi > 0:
        cfg = _config(hi)
        assert cfg is not None
        out.append(ASLTuple(m.meta_id, hi, l_hi, t_hi, cfg))
    if l_lo > 0:
        cfg = _config(lo)
        assert cfg is not None
        out.append(ASLTuple(m.meta_id, lo, l_lo, t_lo, cfg))
    if not out:  # L rounded away entirely — never valid, restore full run
        cfg = _config(hi)
        assert cfg is not None
        out.append(ASLTuple(m.meta_id, hi, m.L, t_hi, cfg))
    return out


def allocate_level(
    metas: Sequence[MetaOp],
    estimator: ScalabilityEstimator,
    n_devices: int,
    *,
    c_hint: Optional[float] = None,
    bracket_memo: Optional[BracketMemo] = None,
) -> LevelAllocation:
    """Full §3.3 pipeline for one MetaLevel (``c_hint`` warm-starts eq. 9;
    ``bracket_memo`` reuses unchanged MetaOps' bi-point brackets)."""
    curves = {m.meta_id: estimator.curve(m) for m in metas}
    c_star, n_star = solve_continuous(metas, curves, n_devices, c_hint=c_hint)
    tuples: Dict[int, List[ASLTuple]] = {}
    for m in metas:
        tuples[m.meta_id] = discretize(
            m, curves[m.meta_id], n_star[m.meta_id], c_star, n_devices,
            memo=bracket_memo,
        )
    return LevelAllocation(c_star=c_star, n_star=n_star, tuples=tuples)


def allocate_balanced(
    metas: Sequence[MetaOp],
    estimator: ScalabilityEstimator,
    n_devices: int,
) -> LevelAllocation:
    """Balanced-share allocation (DistMM-MT-style, one tuple per MetaOp).

    Solves the same continuous optimum as :func:`allocate_level` but skips
    bi-point dissection: each MetaOp gets the single largest valid allocation
    ≤ its real-valued share (rounded UP to the smallest valid width when the
    share is below it), and runs all ``L_m`` operators at that constant
    width.  Σ n_m ≤ N is therefore NOT guaranteed — levels with more MetaOps
    than their shares can fit still round up to ≥1 device each — so
    consumers must pack entries into capacity-respecting waves (as
    ``TaskSequentialSchedulerStage`` does); the tuples are not directly a
    one-wave schedule.  This is the intra-task heterogeneity-aware (but
    wave-unaware) allocator the DistMM-MT baseline pipeline plugs into the
    scheduler hook.
    """
    curves = {m.meta_id: estimator.curve(m) for m in metas}
    c_star, n_star = solve_continuous(metas, curves, n_devices)
    tuples: Dict[int, List[ASLTuple]] = {}
    for m in metas:
        lo, hi = bracket_valid(m, n_star[m.meta_id], n_devices)
        n = lo if lo > 0 else hi  # floor to the valid share; ≥ smallest valid
        cfg = best_config(m, n)
        assert cfg is not None
        tuples[m.meta_id] = [
            ASLTuple(m.meta_id, n, m.L, curves[m.meta_id].estimate(n), cfg)
        ]
    return LevelAllocation(c_star=c_star, n_star=n_star, tuples=tuples)
