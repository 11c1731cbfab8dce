"""ServingSession — continuous batching planned through the Spindle lifecycle
(port of ``repro/serving/session.py``).

    session = ServingSession(ServingConfig(arch="qwen3-0.6b"))
    session.submit(Request(rid=0, tokens=prompt, max_new_tokens=16))
    while session.busy:
        session.step()       # admit → decode one token → evict → replan?
    results = session.results

Each ``step`` admits queued requests into free batch slots (stacked prefill
+ page map-in, or a chunked-prefill job), advances pending prefill chunks
at the ``prefill_duty`` cycle (chunks run *between* decode steps), decodes
one token for the whole decoding batch, evicts finished requests
(returning their KV pages to the pool), and then drains the request
lifecycle events (:class:`repro_torch.launch.events.
RequestQueueSource`).  When the bucketized **mix signature**
(:class:`repro_torch.serving.mix.MixTracker`) actually changed, the event
burst is driven through the inner plan-only :class:`repro_torch.session.
SpindleSession` via ``signal_all`` — one coalesced replan per mix shift,
planned through the :class:`repro_torch.core.plancache.PlanCache`:

  * an unchanged mix signature never reaches the planner at all,
  * a recurring mix is an exact-signature cache **hit** (zero planning),
  * a count/bucket drift inside known families replans **incrementally**,
  * a NEW family is a structural shift: the session forces a **full**
    replan (``SpindleSession.incremental = False`` for that turn).

The plan runs on the host and changes no device work: tokens are the same
under every replan policy.  Replan policies: ``"mix"`` (the above),
``"initial"`` (plan the first non-empty mix, then serve on the stale plan —
the ablation baseline), and ``"off"`` (no planner); ``replan_cooldown``
coalesces bursty mix churn into one planner turn per window.  Admission is
``"continuous"`` (join whenever a slot is free) or ``"static"`` (wait until
the batch drains, then refill).

The KV layout is paged (the default), with chunked prefill
(``prefill_chunk``, ``prefill_duty``), prefix sharing and ``"reserve"`` or
``"grow"`` admission, or ``"slab"``: per-slot caches of ``cache_len``
positions, which none of those three apply to (the config raises JAX's
``ValueError`` for each).  :meth:`ServingSession.host_failed` requeues
every resident request after a host loss.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import default_sharding, get_arch, reduced, resolve_device
from ..core.costmodel import ICI_BW
from ..core.placement import ClusterSpec
from ..core.workloads import serving_mix_workload
from ..launch.events import (
    Event,
    LeaseChanged,
    RequestArrived,
    RequestQueueSource,
)
from ..models import build_model
from ..models.layers import dtype_of
from ..session import ReplanRecord, SessionConfig, SpindleSession
from .batcher import ContinuousBatcher, SlotState
from .mix import DEFAULT_PROMPT_BUCKETS, MixTracker, tower_from_arch
from .queue import Request, RequestQueue

__all__ = ["RequestResult", "ServingConfig", "ServingSession"]


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
    enc_len: int = 0  # 0 → cache_len // 4 (enc-dec archs only)
    cache_dtype: str = "bfloat16"
    #: "continuous" (join as slots free) | "static" (drain-then-refill)
    admission: str = "continuous"
    max_pending: int = 1024
    kv_layout: str = "paged"
    page_size: int = 16
    kv_pages: int = 0  # physical pages incl. trash page; 0 → full coverage
    #: prefix sharing: map a hot prompt prefix's pages read-shared through
    #: the radix index instead of re-prefilling them (all-attention models)
    prefix_sharing: bool = False
    #: "reserve" (map the full reach at admission) | "grow" (map the
    #: prompt's pages; decode grows one page as each is first written)
    kv_admission: str = "reserve"
    # prefill: stacked same-length admission (one prefill call for k
    # requests), and — all-attention models — chunked prefill interleaved
    # with decode steps
    batched_prefill: bool = True
    prefill_chunk: int = 0  # 0 = one-shot; else chunk width in tokens
    #: prefill:decode duty cycle — chunk calls allowed per decode step
    #: (fractional: 0.5 = one chunk every other decode step)
    prefill_duty: float = 1.0
    max_prompt_len: int = 0  # 0 → cache_len - max_new_tokens
    max_new_tokens: int = 0  # 0 → no per-request generation cap
    # planning
    #: "mix" (replan on mix shifts) | "initial" (plan once, stale after)
    #: | "off" (no planner at all)
    replan: str = "mix"
    #: minimum serving steps between replan turns (0 = replan on every mix
    #: shift).  Bursty admission churns the quantized mix many times within
    #: a few steps; a cooldown coalesces those shifts into ONE planner turn
    #: over the settled mix.
    replan_cooldown: int = 0
    planner: str = "spindle"
    placement_strategy: str = "spindle"
    #: two 8-card H100 NVLink islands
    cluster: ClusterSpec = ClusterSpec(
        n_devices=16, island_size=8, mem_bytes=80e9, intra_island_bw=ICI_BW
    )
    prompt_buckets: Tuple[int, ...] = DEFAULT_PROMPT_BUCKETS
    quantize_counts: bool = True
    cache_maxsize: int = 64

    def __post_init__(self):
        if self.admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if self.replan_cooldown < 0:
            raise ValueError("replan_cooldown must be >= 0")
        if self.replan not in ("mix", "initial", "off"):
            raise ValueError(f"unknown replan policy {self.replan!r}")
        if self.kv_layout not in ("paged", "slab"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 0 or self.prefill_duty <= 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 and prefill_duty > 0, got "
                f"{self.prefill_chunk}/{self.prefill_duty}"
            )
        if self.prefill_chunk and self.kv_layout != "paged":
            raise ValueError(
                "prefill_chunk requires kv_layout='paged' (chunks stream "
                "into the page pool)"
            )
        if self.kv_admission not in ("reserve", "grow"):
            raise ValueError(f"unknown kv_admission {self.kv_admission!r}")
        if self.kv_admission == "grow" and self.kv_layout != "paged":
            raise ValueError(
                "kv_admission='grow' requires kv_layout='paged' (growth "
                "maps pool pages)"
            )
        if self.prefix_sharing and self.kv_layout != "paged":
            raise ValueError(
                "prefix_sharing requires kv_layout='paged' (shared prefixes "
                "are page mappings)"
            )
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
    """Continuous batching over a request queue, replanned per mix shift."""

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 model: Any = None, callbacks: Sequence[Any] = (),
                 plan_cache: Any = None):
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
            enc_len=cfg.enc_len,
            cache_dtype=dtype_of(cfg.cache_dtype),
            kv_layout=cfg.kv_layout,
            page_size=cfg.page_size,
            kv_pages=cfg.kv_pages,
            prefill_chunk=cfg.prefill_chunk,
            batched_prefill=cfg.batched_prefill,
            prefix_sharing=cfg.prefix_sharing,
            kv_admission=cfg.kv_admission,
        )
        self._duty_credit = 0.0
        self._tower = tower_from_arch(model.cfg, seq=cfg.cache_len)
        self.planner_session: Optional[SpindleSession] = None
        if cfg.replan != "off":
            # the graph factory holds the mix, the tower and the batcher,
            # not the session: no reference cycle keeps a served model alive
            mix, tower, batcher = self.mix, self._tower, self.batcher
            self.planner_session = SpindleSession(
                SessionConfig(
                    cluster=cfg.cluster,
                    planner=cfg.planner,
                    placement_strategy=cfg.placement_strategy,
                    cache_maxsize=cfg.cache_maxsize,
                    replan_on=(
                        "request_arrived", "request_completed",
                        "lease_changed",
                    ),
                ),
                graph_factory=lambda tasks: serving_mix_workload(
                    mix.snapshot().counts,
                    tower=tower,
                    # the batcher's EFFECTIVE chunk: zero on models that
                    # cannot chunk, so the planner never models chunked
                    # towers that won't execute
                    prefill_chunk=batcher.prefill_chunk,
                    # observed prefix-sharing rate: shared positions arrive
                    # by page mapping, so the planner sizes prefill towers
                    # for the suffix compute that actually runs
                    prefix_hit_rate=batcher.observed_hit_rate(),
                ),
                callbacks=callbacks,
                cache=plan_cache,
            )
        self._last_key: Optional[str] = None
        self._last_families: Optional[Tuple[str, ...]] = None
        self._event_buf: List[Event] = []
        self._planned_once = False
        self._last_replan_step = -(10**9)
        self._t_submit: Dict[int, float] = {}
        self.results: Dict[int, RequestResult] = {}
        self.steps = 0
        self.host_loss_events = 0
        self.host_loss_requeued = 0

    # ------------------------------------------------------------- lifecycle
    @property
    def busy(self) -> bool:
        return self.batcher.n_active > 0 or len(self.queue) > 0

    @property
    def replans(self) -> List[ReplanRecord]:
        return self.planner_session.replans if self.planner_session else []

    @property
    def current_plan(self):
        return self.planner_session.current_plan if self.planner_session else None

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
        # preempted requests rejoin at the FRONT of the queue: their full
        # re-prefill (greedy decoding regenerates the exact tokens) should
        # not wait behind the backlog that evicted them
        self.queue.requeue_front(self.batcher.take_preempted())
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
            # resident — sync the mix/event bookkeeping for them before
            # propagating, or every later snapshot would plan an
            # undercounted mix
            resident = {s.req.rid for s in self.batcher.slots if s is not None}
            self._note_joined([r for r in cand if r.rid in resident])
            raise
        self._note_joined(joined)
        return len(slots)

    def _note_joined(self, reqs: Sequence[Request]) -> None:
        for req in reqs:
            if self.mix.is_active(req.rid):
                # re-admission after a preemption: the mix already counts
                # this request; a second arrival event would double-plan it
                continue
            self.mix.joined(req.rid)
            # joining is the mix-changing moment (a queued request's
            # submit-time arrival event may have drained steps ago without
            # shifting anything) — feed the replan buffer so a backlog
            # refilling freed slots still reaches the planner
            self._event_buf.append(
                RequestArrived(
                    rid=req.rid, family=req.family, prompt_len=req.prompt_len
                )
            )

    def _run_prefill_chunks(self) -> None:
        """Interleave: advance queued prefill chunks between decode steps,
        throttled by the prefill:decode duty cycle.  With nothing decoding
        there is nothing to interleave with — stream chunks until a request
        becomes decodable."""
        b = self.batcher
        if not b.prefill_pending():
            return
        if b.n_decoding == 0:
            while b.prefill_pending() and b.n_decoding == 0:
                b.prefill_chunk_step()
            self._duty_credit = 0.0
            return
        self._duty_credit += self.config.prefill_duty
        while b.prefill_pending() and self._duty_credit >= 1.0:
            b.prefill_chunk_step()
            self._duty_credit -= 1.0

    def step(self) -> List[SlotState]:
        """One serving step: admit → prefill chunks → decode one token →
        evict → replan."""
        self._admit()
        self._run_prefill_chunks()
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
        self._maybe_replan()
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
            "chunk_steps": b.chunk_steps,
            "interleaved_chunks": b.interleaved_chunks,
            "prefill_seconds": b.prefill_seconds,
            "decode_seconds": b.decode_seconds,
            **b.kv_stats(),
            "p50_latency_s": float(np.percentile(lats, 50)) if lats else 0.0,
            "p99_latency_s": float(np.percentile(lats, 99)) if lats else 0.0,
            "host_loss_events": self.host_loss_events,
            "host_loss_requeued": self.host_loss_requeued,
            "replans": len(self.replans),
            "replan_modes": [r.mode for r in self.replans],
            "planning_seconds": sum(r.planning_seconds for r in self.replans),
        }
        # busy time = the resources the trace actually consumed (prefill +
        # decode + planning); wall additionally counts idle steps between
        # scripted arrivals, which is trace shape, not serving cost
        m["busy_seconds"] = (
            m["prefill_seconds"] + m["decode_seconds"] + m["planning_seconds"]
        )
        m["throughput_tok_s"] = out_tokens / max(m["busy_seconds"], 1e-9)
        if wall_seconds is not None:
            m["wall_seconds"] = wall_seconds
        if self.planner_session is not None:
            m["cache"] = self.planner_session.cache.stats.as_dict()
            if self.current_plan is not None:
                m["planned_makespan_ms"] = self.current_plan.makespan * 1e3
        return m

    def apply_lease(self, cluster: ClusterSpec) -> Optional[ReplanRecord]:
        """Inject an externally-arbitrated sub-cluster (a fleet lease).

        With live traffic the inner planner session replans the current
        mix over the new view immediately (one ``LeaseChanged`` turn
        through the shared PlanCache); with nothing to plan — no mix yet,
        or a drained queue — the lease is adopted silently and the next
        mix shift plans over it.  No-op under ``replan="off"``.
        """
        ps = self.planner_session
        if ps is None:
            return None
        if not self.mix.snapshot().counts:
            ps.adopt_cluster(cluster)
            self._last_key = None  # replan as soon as traffic returns
            return None
        ps.signal(LeaseChanged(cluster=cluster))
        return ps.replans[-1] if ps.replans else None

    def host_failed(self, cluster: Optional[ClusterSpec] = None) -> int:
        """Degrade gracefully under a hard host loss.

        Every in-flight request's KV lived (at least partly) on the dead
        host, so the whole resident set — decoding slots AND streaming
        prefill jobs — is bumped through the preemption machinery and
        requeued at the FRONT of the admission queue; the prefix index is
        dropped with the lost pages.  Greedy decode makes the regeneration
        token-exact.  Pass the surviving sub-cluster as ``cluster`` to
        re-lease in the same turn.  Returns how many requests were
        requeued."""
        n = self.batcher.preempt_resident()
        self.queue.requeue_front(self.batcher.take_preempted())
        self.host_loss_events += 1
        self.host_loss_requeued += n
        if cluster is not None:
            self.apply_lease(cluster)
        return n

    # ---------------------------------------------------------------- replan
    def _maybe_replan(self) -> Optional[ReplanRecord]:
        """Drain request events (queue arrivals/completions + slot joins);
        drive the burst through ``session.signal_all`` when the bucketized
        mix signature actually moved."""
        self._event_buf.extend(self.source.poll())
        ps = self.planner_session
        if ps is None or not self._event_buf:
            self._event_buf = []
            return None
        cd = self.config.replan_cooldown
        if cd and self.steps - self._last_replan_step < cd:
            # cooldown: keep buffering — the burst's shifts coalesce into
            # one planner turn over the settled mix when the window expires
            return None
        snap = self.mix.snapshot()
        if not snap.counts:  # drained: nothing to plan until traffic returns
            self._last_key = None
            self._event_buf = []
            return None
        if self.config.replan == "initial" and self._planned_once:
            self._event_buf = []
            return None
        if snap.key == self._last_key:
            self._event_buf = []  # churn inside an unchanged mix: no shift
            return None
        new_family = self._last_families is not None and bool(
            set(snap.families) - set(self._last_families)
        )
        self._last_key = snap.key
        self._last_families = snap.families
        self._planned_once = True
        self._last_replan_step = self.steps
        events, self._event_buf = self._event_buf, []
        ps.incremental = not new_family  # structural shift → full replan
        try:
            ps.signal_all(events)
        finally:
            ps.incremental = True
        return ps.replans[-1] if ps.replans else None
