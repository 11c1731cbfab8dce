"""Active-request-mix tracking → planner workload signatures (port of
``repro/serving/mix.py``).

The live mix of a serving session — which request families are active, at
which prompt-length buckets, in which counts — IS the workload the paper's
§5.5 dynamicity hook should replan for.  This module reduces that mix to a
small deterministic snapshot:

  * prompt lengths quantize to power-of-two-ish **buckets** (two requests
    of 30 and 31 tokens are the same work to the planner), and
  * per-bucket counts optionally quantize to powers of two as well
    (**hysteresis**: a 5th identical request joining a 4-slot bucket shifts
    the signature; a 4th does not), so single join/evict churn inside a
    steady mix does not thrash the planner.

``MixSnapshot.key`` is the replan trigger (the serving session signals only
when it changes); the full planner-side identity is the workload signature
of :func:`repro_torch.core.workloads.serving_mix_workload` over
``MixSnapshot.counts``, which is what the PlanCache keys plans by.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..core.workloads import TowerSpec

#: default prompt-length buckets (smallest bucket ≥ prompt_len wins)
DEFAULT_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def prompt_bucket(n: int, buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def tower_from_arch(cfg, seq: int = 128) -> TowerSpec:
    """Size the serving workload tower from a served ArchConfig."""
    return TowerSpec(
        name=cfg.name,
        n_layers=cfg.n_layers,
        d_model=cfg.d_model,
        d_ff=cfg.d_ff or 4 * cfg.d_model,
        n_heads=cfg.n_heads,
        seq=seq,
    )


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class MixSnapshot:
    """One bucketized view of the live request mix."""

    #: sorted ((family, prompt_bucket), count) for ACTIVE (decoding) slots
    counts: Tuple[Tuple[str, int, int], ...]
    #: requests admitted but not yet prefilled into a slot
    pending: int
    #: total active decode slots (the union decode batch)
    decoding: int

    @property
    def families(self) -> Tuple[str, ...]:
        return tuple(sorted({f for f, _, _ in self.counts}))

    @property
    def prefill_decode_ratio(self) -> float:
        return self.pending / max(self.decoding, 1)

    @property
    def key(self) -> str:
        """Deterministic digest — the serving session's replan trigger."""
        payload = ";".join(f"{f}/p{b}={c}" for f, b, c in self.counts)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


class MixTracker:
    """Counts requests through their lifecycle: pending → active → done."""

    def __init__(
        self,
        buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
        quantize_counts: bool = True,
    ):
        self.buckets = tuple(buckets)
        self.quantize_counts = quantize_counts
        self._pending: Dict[int, Tuple[str, int]] = {}  # rid → (family, bkt)
        self._active: Dict[int, Tuple[str, int]] = {}

    def submitted(self, rid: int, family: str, prompt_len: int) -> None:
        self._pending[rid] = (family, prompt_bucket(prompt_len, self.buckets))

    def joined(self, rid: int) -> None:
        self._active[rid] = self._pending.pop(rid)

    def is_active(self, rid: int) -> bool:
        return rid in self._active

    def completed(self, rid: int) -> None:
        self._active.pop(rid, None)

    def snapshot(self, quantize: Optional[bool] = None) -> MixSnapshot:
        q = self.quantize_counts if quantize is None else quantize
        raw: Dict[Tuple[str, int], int] = {}
        for fam, bkt in self._active.values():
            raw[(fam, bkt)] = raw.get((fam, bkt), 0) + 1
        counts = tuple(
            sorted((fam, bkt, _pow2(c) if q else c) for (fam, bkt), c in raw.items())
        )
        return MixSnapshot(
            counts=counts,
            pending=len(self._pending),
            decoding=len(self._active),
        )
