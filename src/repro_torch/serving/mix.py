"""Active-request-mix tracking (port of ``repro/serving/mix.py``).

The live mix — which request families are active, at which prompt-length
buckets, in which counts — reduced to a small deterministic snapshot:
prompt lengths quantize to power-of-two-ish buckets and per-bucket counts
optionally to powers of two (hysteresis), so join/evict churn inside a
steady mix does not move ``MixSnapshot.key``.  The JAX package feeds the
snapshot to its planner (``tower_from_arch``, ``serving_mix_workload``),
which is ported with ``replan="mix"``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: default prompt-length buckets (smallest bucket ≥ prompt_len wins)
DEFAULT_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def prompt_bucket(n: int, buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


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
        """Deterministic digest — the replan trigger."""
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
