"""ServingSession — continuous batching over a request queue (port of
``repro/serving/session.py`` with ``replan="off"``).

    session = ServingSession(ServingConfig(arch="qwen3-0.6b"))
    session.submit(Request(rid=0, tokens=prompt, max_new_tokens=16))
    while session.busy:
        session.step()       # admit → decode one token → evict
    results = session.results

Each ``step`` admits queued requests into free batch slots (stacked prefill
+ page map-in), decodes one token for the whole active batch and evicts
finished requests, returning their KV pages to the pool.  Admission is
``"continuous"`` (join whenever a slot is free) or ``"static"`` (wait until
the batch drains, then refill).

This slice ports the paged KV layout with reserve admission and no
planner.  The JAX session's other settings are accepted by name and raise
``NotImplementedError`` naming the ROADMAP item that brings them, rather
than serving quietly in another mode: ``replan="mix"``/``"initial"`` (the
planner), ``kv_layout="slab"``, ``prefill_chunk > 0``,
``prefix_sharing`` and ``kv_admission="grow"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import default_sharding, get_arch, reduced, resolve_device
from ..launch.events import RequestQueueSource
from ..models import build_model
from ..models.layers import dtype_of
from .batcher import ContinuousBatcher, SlotState
from .mix import DEFAULT_PROMPT_BUCKETS, MixTracker
from .queue import Request, RequestQueue

__all__ = ["RequestResult", "ServingConfig", "ServingSession"]

_PLANNER = "ROADMAP queue 1, item 1 (planner + replan='mix')"
_KV_PATHS = ("ROADMAP queue 1, item 2 (chunked prefill, prefix sharing and "
             "grow admission)")
_SLAB = "ROADMAP queue 1, item 4 (slab layout and the other families)"


@dataclass(frozen=True)
class ServingConfig:
    """Typed, immutable inputs of one serving session."""

    arch: str = "qwen3-0.6b"
    reduced_cfg: bool = True
    seed: int = 0
    #: "cuda" (the default: the hand-written kernels on the card) | "cpu"
    #: (the plain PyTorch versions).  "cuda" without a GPU raises.
    device: str = "cuda"
    # batching
    max_slots: int = 8
    cache_len: int = 128
    cache_dtype: str = "bfloat16"
    #: "continuous" (join as slots free) | "static" (drain-then-refill)
    admission: str = "continuous"
    max_pending: int = 1024
    kv_layout: str = "paged"
    page_size: int = 16
    kv_pages: int = 0  # physical pages incl. trash page; 0 → full coverage
    prefix_sharing: bool = False
    kv_admission: str = "reserve"
    batched_prefill: bool = True
    prefill_chunk: int = 0
    max_prompt_len: int = 0  # 0 → cache_len - max_new_tokens
    max_new_tokens: int = 0  # 0 → no per-request generation cap
    #: "off" is the one policy ported; "mix" | "initial" need the planner
    replan: str = "off"
    prompt_buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS
    quantize_counts: bool = True

    def __post_init__(self):
        if self.admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if self.replan not in ("mix", "initial", "off"):
            raise ValueError(f"unknown replan policy {self.replan!r}")
        if self.kv_layout not in ("paged", "slab"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.kv_admission not in ("reserve", "grow"):
            raise ValueError(f"unknown kv_admission {self.kv_admission!r}")
        if self.cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown cache_dtype {self.cache_dtype!r}")
        if self.max_prompt_len < 0 or self.max_new_tokens < 0:
            raise ValueError("max_prompt_len/max_new_tokens must be >= 0")
        if self.max_prompt_len and self.max_new_tokens:
            need = self.max_prompt_len + self.max_new_tokens - 1
            if need > self.cache_len:
                raise ValueError(
                    f"max_prompt_len ({self.max_prompt_len}) + "
                    f"max_new_tokens ({self.max_new_tokens}) needs {need} "
                    f"cache positions > cache_len={self.cache_len}; raise "
                    f"cache_len or lower the admissibility caps"
                )
        unported = [
            (self.replan != "off", f"replan={self.replan!r}", _PLANNER),
            (self.kv_layout == "slab", "kv_layout='slab'", _SLAB),
            (self.prefill_chunk > 0, "prefill_chunk > 0", _KV_PATHS),
            (self.prefix_sharing, "prefix_sharing=True", _KV_PATHS),
            (self.kv_admission == "grow", "kv_admission='grow'", _KV_PATHS),
        ]
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported to repro_torch yet: {item}")

    @property
    def effective_max_prompt_len(self) -> int:
        if self.max_prompt_len:
            return self.max_prompt_len
        if self.max_new_tokens:
            return self.cache_len - self.max_new_tokens + 1
        return self.cache_len


@dataclass
class RequestResult:
    """What one finished request produced."""

    rid: int
    family: str
    tokens: List[int]
    prompt_len: int
    latency_seconds: float
    queue_seconds: float  # submit → slot join (admission + queueing)


class ServingSession:
    """Continuous batching over a request queue."""

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 model: Any = None):
        self.config = config or ServingConfig()
        cfg = self.config
        self.device = resolve_device(cfg.device)
        if model is None:
            arch = get_arch(cfg.arch)
            if cfg.reduced_cfg:
                arch = reduced(arch)
            model = build_model(
                arch, default_sharding(arch, use_kernels=True),
                device=str(self.device),
            ).init(cfg.seed)
        elif model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, config asks for "
                             f"{cfg.device}")
        self.model = model
        self.queue = RequestQueue(max_pending=cfg.max_pending)
        self.source = RequestQueueSource(self.queue)
        self.mix = MixTracker(
            buckets=cfg.prompt_buckets, quantize_counts=cfg.quantize_counts
        )
        self.batcher = ContinuousBatcher(
            model,
            max_slots=cfg.max_slots,
            cache_len=cfg.cache_len,
            cache_dtype=dtype_of(cfg.cache_dtype),
            page_size=cfg.page_size,
            kv_pages=cfg.kv_pages,
            batched_prefill=cfg.batched_prefill,
        )
        self._t_submit: Dict[int, float] = {}
        self.results: Dict[int, RequestResult] = {}
        self.steps = 0

    # ------------------------------------------------------------- lifecycle
    @property
    def busy(self) -> bool:
        return self.batcher.n_active > 0 or len(self.queue) > 0

    def submit(self, req: Request) -> bool:
        """Admit a request (False = rejected by admission control).

        Raises ``ValueError`` up front for a request that could never fit a
        slot or that violates the config's admissibility caps."""
        cfg = self.config
        if req.prompt_len > cfg.effective_max_prompt_len:
            raise ValueError(
                f"request {req.rid}: prompt_len {req.prompt_len} > "
                f"admissible max {cfg.effective_max_prompt_len}"
            )
        if cfg.max_new_tokens and req.max_new_tokens > cfg.max_new_tokens:
            raise ValueError(
                f"request {req.rid}: max_new_tokens {req.max_new_tokens} > "
                f"config cap {cfg.max_new_tokens}"
            )
        self.batcher.validate(req)
        ok = self.queue.submit(req)
        if ok:
            self.mix.submitted(req.rid, req.family, req.prompt_len)
            self._t_submit[req.rid] = time.perf_counter()
        return ok

    def _admit(self) -> int:
        if self.config.admission == "static" and self.batcher.n_active > 0:
            return 0  # classic batch serving: drain before refilling
        free = len(self.batcher.free_slots())
        if free == 0 or len(self.queue) == 0:
            return 0
        cand = [self.queue.pop() for _ in range(min(free, len(self.queue)))]
        try:
            slots = self.batcher.admit_many(cand)
            joined = cand[: len(slots)]
            # page-pool pressure can defer the tail; it stays queued, in order
            self.queue.requeue_front(cand[len(slots):])
        except Exception:
            # a group prefill failed mid-admission: earlier groups ARE
            # resident — keep the mix in sync for them before propagating
            resident = {s.req.rid for s in self.batcher.slots if s is not None}
            for req in cand:
                if req.rid in resident:
                    self.mix.joined(req.rid)
            raise
        for req in joined:
            self.mix.joined(req.rid)
        return len(slots)

    def step(self) -> List[SlotState]:
        """One serving step: admit → decode one token → evict."""
        self._admit()
        finished = self.batcher.step()
        for s in finished:
            self.mix.completed(s.req.rid)
            self.queue.note_completion(s.req, len(s.generated))
            t0 = self._t_submit.pop(s.req.rid, s.t_join)
            self.results[s.req.rid] = RequestResult(
                rid=s.req.rid,
                family=s.req.family,
                tokens=list(s.generated),
                prompt_len=s.req.prompt_len,
                latency_seconds=s.t_done - t0,
                queue_seconds=s.t_join - t0,
            )
        self.steps += 1
        self.source.poll()  # no planner consumes the lifecycle events yet
        return finished

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: int = 100_000) -> Dict[str, Any]:
        """Serve a scripted trace: ``Request.arrival`` is the step index at
        which each request becomes visible.  Returns aggregate metrics."""
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        t0 = time.perf_counter()
        while i < len(pending) or self.busy:
            while i < len(pending) and pending[i].arrival <= self.steps:
                self.submit(pending[i])
                i += 1
            self.step()
            if self.steps >= max_steps:
                break
        return self.metrics(time.perf_counter() - t0)

    def metrics(self, wall_seconds: Optional[float] = None) -> Dict[str, Any]:
        lats = sorted(r.latency_seconds for r in self.results.values())
        out_tokens = sum(len(r.tokens) for r in self.results.values())
        b = self.batcher
        m: Dict[str, Any] = {
            "requests": len(self.results),
            "rejected": self.queue.rejected,
            "output_tokens": out_tokens,
            "decode_steps": b.decode_steps,
            "prefill_calls": b.prefill_calls,
            "prefill_seconds": b.prefill_seconds,
            "decode_seconds": b.decode_seconds,
            **b.kv_stats(),
            "p50_latency_s": float(np.percentile(lats, 50)) if lats else 0.0,
            "p99_latency_s": float(np.percentile(lats, 99)) if lats else 0.0,
        }
        # busy time = prefill + decode; wall additionally counts idle steps
        # between scripted arrivals, which is trace shape, not serving cost
        m["busy_seconds"] = m["prefill_seconds"] + m["decode_seconds"]
        m["throughput_tok_s"] = out_tokens / max(m["busy_seconds"], 1e-9)
        if wall_seconds is not None:
            m["wall_seconds"] = wall_seconds
        return m
