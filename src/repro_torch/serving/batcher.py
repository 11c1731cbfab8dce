"""Continuous batcher: slot map + paged or slab KV over one decode batch
(port of ``repro/serving/batcher.py``).

The decode batch is a fixed array of ``max_slots`` rows; each row is a
**slot** holding one request's decode state.  Under the paged layout
(``kv_layout="paged"``, the port's default) full-attention KV lives in a
shared page pool (:mod:`repro_torch.serving.pages`): joining *maps*
physical pages through a per-slot page table and evicting *unmaps* them.
A model with no full-attention layer (recurrentgemma, xlstm) has no KV to
page: it gets no pool and no page table, and admission waits on free
slots only, as in JAX.  Under the slab layout (``kv_layout="slab"``; the
JAX batcher's default) every leaf of :meth:`init_cache`'s cache, the
full-attention K/V (max_slots, K, cache_len, hd) included, is slot-major.
Window and recurrent state (local-attention buffers, RG-LRU and xLSTM
state) is slot-major under both: joining overwrites the slot's rows.
Every prefill map-in goes through :class:`CacheIO`, the one place that
tells the layouts apart.
Admission is **stacked**: :meth:`ContinuousBatcher.admit_many` prefills all
same-length queued requests in ONE call.  Long prompts of an all-attention
model are **chunked**: admission only maps pages and queues a
:class:`PrefillJob`, and :meth:`prefill_chunk_step` advances it one chunk
at a time, so the serving session can interleave chunks *between* decode
steps.  With **prefix sharing** admission maps the pages of a prompt
prefix that the :class:`~repro_torch.serving.pages.PrefixIndex` already
holds, read-shared, copy-on-write forks the divergence page and prefills
only the suffix (as a chunk job).  Under **grow** admission a request maps
only its prompt's pages and decode maps each page the step it is first
written; a slot that cannot get one pauses, or a victim is preempted and
requeued.

Requests of the encoder-decoder and VLM archs carry their stub modality
inputs in ``Request.extras`` (``frames`` (S_enc, d), ``embeds`` (P, d)):
admission stacks them into the prefill batch of a group whose extras have
one shape, a VLM request's ``P`` stub positions count toward its cache
reach and its first decode position, and the prefill's cross memory lands
in the slot's ``"state0"`` leaves.  Since a prompt's tokens no longer
define its KV once frames or patches precede them, such a request never
takes a chunk job, never looks up the prefix index and is never inserted
into it, as in JAX.

Correctness contract (``tests/test_torch_serving.py``): for a dense
model every per-row operation of the decode path is batch-independent, so
a request decoded in a shared batch produces the tokens it produces
decoded alone.  Inactive rows ride along in the fixed-shape decode and
write through zeroed page-table rows into the pool's trash page, and into
their own slot-major rows, which the next admission overwrites.  An MoE
model breaks the contract as the JAX one does: the rows of one decode
step share each expert's capacity in row order, so a neighbour — a freed
slot's stale row included — can drop a live row's assignment once the
batch has more rows than an expert's capacity (ROADMAP queue 3).

Against the JAX batcher: the pools are updated in place (the JAX decode
and chunk calls donate them, and the copy-on-write fork is an in-place
copy of one page in every pool); the prefill map-in writes only mapped
pages (the JAX one also scatters the padded tail of unmapped logical pages
into the trash page, which nothing reads); admission holds the pages its
prefix lookup matched while it allocates (the JAX batcher does not, so
under pool pressure its index reclaim can free a matched page and hand
it back as the same request's private page, ROADMAP queue 3 — on every
trace where that does not happen the two give the same pages and
counters); and every timed window ends on
the device's work: the host read of each step's tokens sits inside the
window in one-shot prefill and decode, and a chunk step that reads nothing
back (all but a job's last) ends in a stream synchronize, so on an
asynchronous CUDA stream ``prefill_seconds`` and ``decode_seconds`` each
hold their own device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .pages import PagePool, PrefixHit, PrefixIndex, pages_needed
from .queue import Request

KV_LAYOUTS = ("paged", "slab")


@torch.no_grad()
def write_slot(cache, page, slot: int) -> None:
    """Write a batch-1 prefill cache into slab row ``slot`` of every leaf,
    in place, each cast to the destination's dtype (JAX
    ``_write_slot_impl``)."""
    for dst_layer, src_layer in zip(cache, page):
        for key, dst in dst_layer.items():
            dst[slot] = src_layer[key][0].to(dst.dtype)


@torch.no_grad()
def write_slots(cache, page, slots) -> None:
    """Scatter a batch-k prefill cache into slab rows ``slots`` (k,) of
    every leaf, in place — the stacked form of :func:`write_slot` (JAX
    ``_write_slots_impl``)."""
    device = next(iter(cache[0].values())).device
    idx = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=device)
    for dst_layer, src_layer in zip(cache, page):
        for key, dst in dst_layer.items():
            dst[idx] = src_layer[key].to(dst.dtype)


def read_slot(cache, slot: int):
    """The batch-1 cache held at slab row ``slot`` (views, one dict per
    layer; JAX ``_read_slot_impl``)."""
    return [{key: leaf[slot:slot + 1] for key, leaf in layer.items()}
            for layer in cache]


@torch.no_grad()
def write_pages(cache, page, slots, rows: Optional[np.ndarray],
                layout) -> None:
    """Map a packed batch-k prefill cache into the paged cache, in place,
    following the per-leaf layout codes (JAX ``_write_pages_impl``).

    ``page`` is what ``prefill`` returned, per layer; ``slots`` (k,) are the
    admitted slot rows and ``rows`` (k, pages_per_slot) each request's
    physical page ids.  A ``"state0"`` leaf — recurrent state, conv
    buffer, local-attention window — takes the prefill's rows at
    ``slots``, whole, so a reused slot keeps nothing of its last request.
    A ``"kv0"`` pool takes the (k, K, cache_len, hd) K or V through the
    page table; only mapped logical pages (nonzero ids) are written (the
    JAX map-in also scatters the zero-padded tail of unmapped pages into
    the trash page, which nothing reads).  ``rows`` may be None for a
    layout without ``"kv0"`` leaves."""
    device = next(iter(cache[0].values())).device
    slot_ids = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                               device=device)
    if rows is not None:
        ii, lp = np.nonzero(rows)
        phys = torch.as_tensor(rows[ii, lp], dtype=torch.long, device=device)
        ii = torch.as_tensor(ii, device=device)
        lp = torch.as_tensor(lp, device=device)
        n_pp = rows.shape[1]
    for src_layer, dst_layer, codes in zip(page, cache, layout):
        for key, code in codes.items():
            dst, src = dst_layer[key], src_layer[key]
            if code == "state0":
                dst[slot_ids] = src.to(dst.dtype)
                continue
            if code != "kv0":
                raise ValueError(f"write_pages: unknown layout code {code!r}")
            if rows is None:
                raise ValueError("write_pages: a KV pool needs rows (page "
                                 "ids)")
            if phys.numel() == 0:
                continue
            ps = dst.shape[2]
            k, K, S, hd = src.shape
            src = torch.nn.functional.pad(src, (0, 0, 0, n_pp * ps - S))
            src = src.reshape(k, K, n_pp, ps, hd).permute(0, 2, 1, 3, 4)
            dst[phys] = src[ii, lp].to(dst.dtype)


@torch.no_grad()
def copy_page(cache, layout, src: int, dst: int) -> None:
    """Copy physical page ``src`` over ``dst`` in every ``"kv0"`` pool, in
    place — the device half of a copy-on-write fork (JAX ``_copy_page``):
    the divergence page's matched head stays readable through the new
    private page while the donor's page is untouched.  State leaves are
    left alone."""
    for layer, codes in zip(cache, layout):
        for key, code in codes.items():
            if code == "kv0":
                layer[key][dst] = layer[key][src]


class CacheIO:
    """The one dispatch point between the slab and paged layouts (JAX
    ``CacheIO``): built with the per-leaf layout codes of
    ``model.init_paged_cache``, or ``None`` for a slab cache."""

    def __init__(self, layout: Any = None):
        self.layout = layout

    @property
    def paged(self) -> bool:
        return self.layout is not None

    def write_prefill(self, cache, page, slots, rows=None) -> None:
        """Map a batch-k prefill cache into ``cache`` in place: through
        the page table ``rows`` (k, pages_per_slot) when paged, else into
        slab rows ``slots`` — batch-1 :func:`write_slot` for one request,
        the stacked :func:`write_slots` for more."""
        if self.layout is not None:
            write_pages(cache, page, slots, rows, self.layout)
        elif len(slots) == 1:
            write_slot(cache, page, int(slots[0]))
        else:
            write_slots(cache, page, slots)

    def read_slot(self, cache, slot: int):
        """The batch-1 cache at slab row ``slot`` (slab only: paged KV is
        read through page tables)."""
        if self.layout is not None:
            raise ValueError("read_slot is slab-only; paged KV is pooled")
        return read_slot(cache, slot)


@dataclass
class SlotState:
    """One occupied slot: the request plus its decode progress."""

    req: Request
    slot: int
    prompt_total: int
    generated: List[int] = field(default_factory=list)
    prefilling: bool = False  # mapped but chunks still streaming in
    prefix_hit: int = 0  # prompt positions mapped from the prefix index
    paused: bool = False  # grow admission: stalled on a free page
    t_join: float = 0.0
    t_done: float = 0.0

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_id
        if not self.generated or eos is None:
            return False
        return self.generated[-1] == eos


@dataclass
class PrefillJob:
    """One admitted group whose prompt streams in chunk by chunk.

    ``base`` is the prefix-shared offset: positions ``[0, base)`` arrived
    by page mapping (no compute), so ``tokens`` holds only the suffix and
    each chunk scores at absolute position ``base + progress``."""

    states: List[SlotState]
    tokens: torch.Tensor  # (k, prompt_total - base) int64, stacked suffix
    chunk: int
    base: int = 0  # positions provided by shared prefix pages
    progress: int = 0  # suffix positions already prefilled

    @property
    def prompt_total(self) -> int:
        return self.base + int(self.tokens.shape[1])

    @property
    def remaining(self) -> int:
        return int(self.tokens.shape[1]) - self.progress


class ContinuousBatcher:
    """Fixed-slot continuous batching over one served model.  The layout
    defaults to ``"paged"`` (the serving session passes its own
    explicitly); JAX's ``ContinuousBatcher`` defaults to ``"slab"``.
    Chunked prefill, grow admission and prefix sharing need the paged
    layout, as in JAX."""

    def __init__(
        self,
        model,
        *,
        max_slots: int = 8,
        cache_len: int = 128,
        enc_len: int = 0,
        cache_dtype=torch.bfloat16,
        kv_layout: str = "paged",
        page_size: int = 16,
        kv_pages: int = 0,
        prefill_chunk: int = 0,
        batched_prefill: bool = True,
        prefix_sharing: bool = False,
        kv_admission: str = "reserve",
    ):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if prefill_chunk and kv_layout != "paged":
            raise ValueError("chunked prefill requires kv_layout='paged'")
        if kv_admission not in ("reserve", "grow"):
            raise ValueError(f"unknown kv_admission {kv_admission!r}")
        if kv_admission == "grow" and kv_layout != "paged":
            raise ValueError("kv_admission='grow' requires kv_layout='paged'")
        if prefix_sharing and kv_layout != "paged":
            raise ValueError("prefix_sharing requires kv_layout='paged'")
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.cache_len = cache_len
        # encoder memory length of an enc-dec arch (frames per request)
        self.enc_len = enc_len or max(cache_len // 4, 1)
        self.cache_dtype = cache_dtype
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.batched_prefill = batched_prefill
        chunkable = model.supports_chunked_prefill
        self.prefill_chunk = prefill_chunk if chunkable else 0
        self.pool: Optional[PagePool] = None
        self._layout = None
        self._tables = self._visible_dev = None
        if kv_layout == "paged":
            self.pages_per_slot = pages_needed(cache_len, page_size)
            n_pages = kv_pages or max_slots * self.pages_per_slot + 1
            self.cache, self._layout = model.init_paged_cache(
                max_slots, cache_len, n_pages=n_pages, page_size=page_size,
                enc_len=self.enc_len, cache_dtype=cache_dtype,
            )
            # a model without full-attention layers has no KV to page: no
            # pool, no page table, and admission waits on slots only, as
            # in JAX (grow admission and sharing apply to KV pools only)
            if any(code == "kv0" for codes in self._layout
                   for code in codes.values()):
                self.pool = PagePool(n_pages, page_size)
                # physical page ids per (slot, logical page); 0 = trash
                self._tables = np.zeros(
                    (max_slots, max(self.pages_per_slot, 1)), np.int32)
                # the table the decode step sees: prefilling and paused
                # slots stay zeroed (their decode-lane writes must hit the
                # trash page)
                self._visible_dev = torch.as_tensor(self._tables,
                                                    device=self.device)
        else:
            self.pages_per_slot = 0
            self.cache = model.init_cache(
                max_slots, cache_len, enc_len=self.enc_len,
                cache_dtype=cache_dtype)
        self.io = CacheIO(self._layout)
        self.grow = kv_admission == "grow" and self.pool is not None
        self.kv_admission = "grow" if self.grow else "reserve"
        # sharing rides the chunked-prefill path (the suffix prefill is one
        # chunk at base offset), so it needs a KV pool and an all-attention
        # model
        self.prefix_sharing = (prefix_sharing and self.pool is not None
                               and chunkable)
        self.index: Optional[PrefixIndex] = (
            PrefixIndex(self.pool) if self.prefix_sharing else None)
        self._preempted: List[Request] = []
        self._pending_forks: Dict[int, Tuple[int, int]] = {}  # slot→(src,dst)
        self.preemptions = 0
        self.host_loss_preemptions = 0  # subset of preemptions: dead host
        self.prefix_requests = 0  # sharing-eligible admissions
        self.prefix_hits = 0  # admissions that mapped >= 1 shared position
        self.prefix_hit_tokens = 0  # prompt positions mapped, not prefilled
        self.prompt_tokens = 0  # prompt positions admitted (denominator)
        self.logical_hw = 0  # max logical pages mapped (shared counted per
        #                      reader — what an unshared run would allocate)

        self.tokens = torch.zeros((max_slots,), dtype=torch.long,
                                  device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int32,
                               device=self.device)
        self.slots: List[Optional[SlotState]] = [None] * max_slots
        self._slot_pages: Dict[int, List[int]] = {}
        self._last_defer_rid: Optional[int] = None
        self._jobs: List[PrefillJob] = []
        self._finished: List[SlotState] = []
        self.decode_steps = 0
        self.prefill_calls = 0  # prefill dispatches (stacked counts once)
        self.chunk_steps = 0
        self.interleaved_chunks = 0  # chunk steps run with decode work live
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------- occupancy
    @property
    def n_active(self) -> int:
        """Occupied slots (decoding or still prefilling)."""
        return sum(s is not None for s in self.slots)

    @property
    def n_decoding(self) -> int:
        return sum(s is not None and not s.prefilling and not s.paused
                   for s in self.slots)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def prefill_pending(self) -> bool:
        return bool(self._jobs)

    @property
    def kv_page_bytes(self) -> int:
        """Device bytes one KV page costs across all pool leaves (0 without
        a pool: a slab layout, or a model with no full-attention KV)."""
        if self.pool is None:
            return 0
        from ..models.paging import kv_page_bytes

        return kv_page_bytes(self.cache, self._layout)

    def kv_stats(self) -> Dict[str, Any]:
        """Page-pool occupancy vs. the slab footprint (token positions);
        without a pool only the layout, the slab footprint and the host
        loss preemptions, as JAX's."""
        slab_tokens = self.max_slots * self.cache_len
        out: Dict[str, Any] = {
            "kv_layout": self.kv_layout,
            "kv_slab_tokens": slab_tokens,
            "kv_host_loss_preemptions": self.host_loss_preemptions,
        }
        if self.pool is not None:
            hw = self.pool.high_water_tokens()
            out.update(
                kv_admission=self.kv_admission,
                kv_page_size=self.page_size,
                kv_pages=self.pool.n_pages,
                kv_pages_in_use=self.pool.in_use,
                kv_page_hw=self.pool.high_water,
                kv_page_hw_tokens=hw,
                kv_mem_saving=1.0 - hw / max(slab_tokens, 1),
                kv_defers=self.pool.defers,
                kv_grow_allocs=self.pool.grow_allocs,
                kv_grow_defers=self.pool.grow_defers,
                kv_preemptions=self.preemptions,
            )
        if self.index is not None:
            out.update(
                prefix_sharing=True,
                prefix_requests=self.prefix_requests,
                prefix_hits=self.prefix_hits,
                prefix_hit_tokens=self.prefix_hit_tokens,
                prefix_hit_rate=self.observed_hit_rate(),
                kv_shared_maps=self.pool.shared_maps,
                kv_cow_forks=self.pool.cow_forks,
                # logical/physical: how many pages an unshared run would
                # have needed at this run's logical high-water vs. the
                # physical pages sharing actually touched
                kv_compression=self.logical_hw / max(self.pool.high_water, 1),
                prefix_index_nodes=len(self.index),
                prefix_index_reclaimed=self.index.reclaimed,
            )
        return out

    def observed_hit_rate(self) -> float:
        """Fraction of admitted prompt positions served from the prefix
        index instead of prefill compute (0.0 with sharing off)."""
        return self.prefix_hit_tokens / max(self.prompt_tokens, 1)

    # ------------------------------------------------------------------ join
    def validate(self, req: Request) -> None:
        """Raise if ``req`` cannot fit a slot."""
        need = self._need_tokens(req)
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt_len}+"
                f"{self._stub(req)}) + {req.max_new_tokens} new tokens needs "
                f"{need} cache positions > cache_len={self.cache_len}"
            )
        if "frames" in req.extras:
            got = int(req.extras["frames"].shape[0])
            if got != self.enc_len:
                raise ValueError(
                    f"request {req.rid}: frames length {got} != batcher "
                    f"enc_len {self.enc_len}"
                )
        if self.pool is None:
            return
        pages = min(pages_needed(need, self.page_size), self.pages_per_slot)
        if pages > self.pool.capacity:
            # a reservation no pool state can ever satisfy must fail loudly
            raise ValueError(
                f"request {req.rid}: needs {pages} KV pages > pool "
                f"capacity {self.pool.capacity}; raise kv_pages or "
                f"page_size"
            )

    @staticmethod
    def _stub(req: Request) -> int:
        """Stub positions a VLM request's patch embeddings take before its
        prompt."""
        if "embeds" in req.extras:
            return int(req.extras["embeds"].shape[0])
        return 0

    def _need_tokens(self, req: Request) -> int:
        return req.prompt_len + self._stub(req) + req.max_new_tokens - 1

    def _admit_pages(self, req: Request) -> int:
        """Pages admission must map up front: the full reach under reserve,
        only the prompt's (and stub's) pages under grow (decode grows the
        rest)."""
        if self.grow:
            return min(pages_needed(req.prompt_len + self._stub(req),
                                    self.page_size), self.pages_per_slot)
        return min(pages_needed(self._need_tokens(req), self.page_size),
                   self.pages_per_slot)

    def can_admit(self, req: Request) -> bool:
        """A free slot AND (with a pool) enough pool pages — free or
        reclaimable from the prefix index — for the admission mapping.
        Conservative: ignores the prefix credit an actual lookup might
        grant."""
        if not self.free_slots():
            return False
        if self.pool is None:
            return True
        need = self._admit_pages(req)
        avail = self.pool.capacity - self.pool.in_use
        if self.index is not None:
            avail += self.index.reclaimable()
        ok = need <= avail
        if not ok and req.rid != self._last_defer_rid:
            # count deferral EVENTS, not per-step admission polls
            self.pool.defers += 1
            self._last_defer_rid = req.rid
        return ok

    def _lookup(self, req: Request) -> Optional[PrefixHit]:
        """Consult the prefix index for a sharing-eligible request (token
        prompts only — extras change what a position's KV means)."""
        if self.index is None or req.extras:
            return None
        hit = self.index.lookup(np.asarray(req.tokens).tolist())
        return hit if (hit.pages or hit.fork is not None) else None

    def _admit_alloc(self, n: int, req: Request) -> Optional[List[int]]:
        """Allocate ``n`` private pages, reclaiming index-only pages to
        cover a shortfall; ``None`` (defer) when even reclaim cannot."""
        if n == 0:
            return []
        if not self.pool.can_alloc(n) and self.index is not None:
            free = self.pool.capacity - self.pool.in_use
            self.index.reclaim(n - free)
        if not self.pool.can_alloc(n):
            return None
        return self.pool.alloc(n, rid=req.rid)

    def _note_logical(self) -> None:
        """Track the logical-page high water: every slot's mapping counted
        per reader — what an unshared, reserve-free run would hold."""
        if self.pool is None:
            return
        live = sum(len(p) for p in self._slot_pages.values())
        if live > self.logical_hw:
            self.logical_hw = live

    def join(self, req: Request) -> int:
        """Admit one request on its own (a batch-1 prefill)."""
        slots = self.admit_many([req])
        if not slots:
            raise RuntimeError("no free slot/pages: admission outran eviction")
        return slots[0]

    def admit_many(self, reqs: List[Request]) -> List[int]:
        """Admit queued requests: map slots and pages, then prefill in
        stacked same-shape groups — ONE prefill call for k requests.  Long
        prompts of a chunkable model and prefix hits become
        :class:`PrefillJob`s instead of prefilling inline.  Stops at the
        first request that does not fit (FIFO preserved).  Returns the
        admitted slots, in request order."""
        admitted: List[Tuple[Request, int]] = []
        for req in reqs:
            self.validate(req)
            if not self.free_slots():
                break
            hit = self._lookup(req)
            slot = self.free_slots()[0]
            if self.pool is not None and not self._map_pages(req, slot, hit):
                break
            state = SlotState(
                req=req, slot=slot,
                prompt_total=req.prompt_len + self._stub(req),
                prefix_hit=(hit.tokens if hit else 0),
                t_join=time.perf_counter(),
            )
            self.slots[slot] = state
            self._last_defer_rid = None
            if self.index is not None and not req.extras:
                self.prefix_requests += 1
                self.prompt_tokens += state.prompt_total
                if state.prefix_hit:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += state.prefix_hit
            self._index_insert(state)
            self._note_logical()
            admitted.append((req, slot))
        if not admitted:
            return []

        # group by stacked-prefill compatibility: identical prompt length,
        # prefix-hit offset (the suffix shapes must agree) and extras
        # shapes; in a dense model rows are batch-independent, so one
        # stacked prefill equals k solo prefills (an MoE prefill shares
        # expert capacity, as in JAX)
        groups: Dict[Any, List[SlotState]] = {}
        for i, (req, slot) in enumerate(admitted):
            state = self.slots[slot]
            extras = tuple(sorted((k, tuple(v.shape))
                                  for k, v in req.extras.items()))
            key = ((state.prompt_total, state.prefix_hit, extras)
                   if self.batched_prefill else (i,))
            groups.setdefault(key, []).append(state)
        for states in groups.values():
            base = states[0].prefix_hit
            suffix_len = states[0].prompt_total - base
            chunkable = (0 < self.prefill_chunk < suffix_len
                         and not states[0].req.extras)
            if base or chunkable:
                # prefix hits always take the chunk path: the suffix
                # prefill is a chunk (or a few) scored at offset ``base``
                # over the shared pages already mapped in
                for s in states:
                    s.prefilling = True
                toks = torch.as_tensor(
                    np.stack([np.asarray(s.req.tokens)[base:]
                              for s in states]),
                    dtype=torch.long, device=self.device)
                self._jobs.append(PrefillJob(
                    states=states, tokens=toks,
                    chunk=(self.prefill_chunk or suffix_len), base=base))
                continue
            try:
                self._prefill_group(states)
            except Exception:
                # roll the group's capacity back: a failing prefill must not
                # leak slots or pool pages (its requests are lost)
                self._index_evict_states(states)
                for st in states:
                    self._release(st)
                self._refresh_tables()
                raise
        self._refresh_tables()
        return [slot for _, slot in admitted]

    def _map_pages(self, req: Request, slot: int,
                   hit: Optional[PrefixHit]) -> bool:
        """Map ``req``'s pages into ``slot``'s table: the prefix hit's
        pages read-shared, then private ones.  False (pool pressure: the
        caller defers) when they cannot be allocated."""
        shared = list(hit.pages) if hit else []
        fork = hit.fork if hit else None
        # hold the matched pages (and the fork source) while the private
        # pages are allocated: the index reclaim that covers a shortfall
        # must not free them and hand them back as this request's own
        # pages (the JAX batcher takes no hold here, ROADMAP queue 3)
        held = shared + ([fork] if fork is not None else [])
        for p in held:
            self.pool.pin(p)
        n_new = self._admit_pages(req) - len(shared)
        pages = self._admit_alloc(n_new, req)
        if pages is None:
            self.pool.release(held)
            # pool pressure defers the tail, FIFO preserved; count
            # deferral EVENTS, not per-step admission polls
            if req.rid != self._last_defer_rid:
                self.pool.defers += 1
                self._last_defer_rid = req.rid
            return False
        for p in shared:
            self.pool.ref(p)  # read-shared map-in: refcount only
        self.pool.release(shared)  # the holds became the map-ins
        if fork is not None:
            # CoW fork: the divergence page's matched head is valid prefix
            # KV, but this request's own writes land in the same logical
            # page — it is copied into the first private page at this
            # request's first chunk (the donor may not have written it
            # yet; FIFO prefill order guarantees it has by then).  The
            # hold on the source stays until the copy, so eviction/reclaim
            # cannot free it in between.
            self.pool.cow_forks += 1
            self._pending_forks[slot] = (fork, pages[0])
        row = shared + pages  # logical order: prefix, then private
        self._slot_pages[slot] = row
        self._tables[slot] = 0
        self._tables[slot, : len(row)] = row
        return True

    def _release(self, state: SlotState) -> None:
        """Return a slot's capacity without completion bookkeeping (error
        rollback, preemption)."""
        if self.slots[state.slot] is state:
            self.slots[state.slot] = None
        self._unmap(state.slot)

    def _unmap(self, slot: int) -> None:
        """Return ``slot``'s pages (and an uncopied CoW source's hold) to
        the pool."""
        pf = self._pending_forks.pop(slot, None)
        if pf is not None:
            self.pool.release([pf[0]])  # unpin the never-copied CoW source
        pages = self._slot_pages.pop(slot, None)
        if pages is not None:
            self.pool.free(pages)
            self._tables[slot] = 0

    def _refresh_tables(self) -> None:
        """Rebuild the decode-visible page table: occupied decoding slots
        expose their mapping; everything else — free, still prefilling, or
        paused on grow pressure — points at trash, so its fixed-shape
        decode write cannot corrupt a mapped (possibly shared) page.  No
        table without a pool."""
        if self._tables is None:
            return
        visible = self._tables.copy()
        for i, s in enumerate(self.slots):
            if s is None or s.prefilling or s.paused:
                visible[i] = 0
        self._visible_dev = torch.as_tensor(visible, device=self.device)

    @torch.no_grad()
    def _prefill_group(self, states: List[SlotState]) -> None:
        """One stacked (or solo) one-shot prefill + cache map-in."""
        batch = {"tokens": torch.as_tensor(
            np.stack([np.asarray(s.req.tokens) for s in states]),
            dtype=torch.long, device=self.device,
        )}
        for key in states[0].req.extras:
            batch[key] = torch.stack([
                torch.as_tensor(s.req.extras[key], device=self.device)
                for s in states])
        slot_list = [s.slot for s in states]
        t0 = time.perf_counter()
        logits, page = self.model.prefill(
            batch, cache_len=self.cache_len, cache_dtype=self.cache_dtype,
        )
        firsts = logits.argmax(dim=-1)
        rows = (self._tables[np.asarray(slot_list)]
                if self._tables is not None else None)
        self.io.write_prefill(self.cache, page, slot_list, rows=rows)
        slot_ids = torch.as_tensor(slot_list, device=self.device)
        self.tokens[slot_ids] = firsts
        self.pos[slot_ids] = torch.as_tensor(
            [s.prompt_total for s in states], dtype=torch.int32,
            device=self.device)
        first_host = firsts.tolist()
        self.prefill_calls += 1
        self.prefill_seconds += time.perf_counter() - t0
        for s, tok in zip(states, first_host):
            s.generated = [int(tok)]
            s.t_join = time.perf_counter()
            if s.done:  # max_new_tokens == 1 (or instant EOS)
                self._evict(s)
                self._finished.append(s)

    # --------------------------------------------------------------- chunks
    @torch.no_grad()
    def prefill_chunk_step(self) -> bool:
        """Advance the front prefill job by one chunk (the serving session
        calls this *between* decode steps).  Returns True if a chunk ran.

        The window timed into ``prefill_seconds`` ends on the chunk's device
        work: the last chunk reads its first tokens back to the host, any
        other chunk synchronizes the stream (it reads nothing back, and its
        work would otherwise land in the next decode step's time)."""
        if not self._jobs:
            return False
        job = self._jobs[0]
        t0 = time.perf_counter()
        if job.progress == 0:
            # the donor prefills ahead of this job (FIFO), so its
            # divergence pages hold valid KV now — run the pending CoW
            # copies before the first suffix chunk reads or writes them
            self._run_forks(job.states)
        width = min(job.chunk, job.remaining)
        toks = job.tokens[:, job.progress: job.progress + width]
        rows = torch.as_tensor(
            self._tables[np.asarray([s.slot for s in job.states])],
            device=self.device)
        try:
            logits, self.cache = self.model.prefill_chunk(
                toks, self.cache, job.base + job.progress, pages=rows)
        except Exception:
            self._jobs.pop(0)
            self._index_evict_states(job.states)
            for st in job.states:
                self._release(st)
            self._refresh_tables()
            raise
        job.progress += width
        self.chunk_steps += 1
        if self.n_decoding > 0:
            self.interleaved_chunks += 1
        firsts = first_host = None
        if job.remaining == 0:
            firsts = logits.argmax(dim=-1)
            first_host = firsts.tolist()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_seconds += time.perf_counter() - t0
        if firsts is not None:
            self._finish_job(job, firsts, first_host)
        return True

    def _run_forks(self, states: List[SlotState]) -> None:
        """Execute the deferred CoW copies for ``states`` and unpin the
        donor pages."""
        for s in states:
            pf = self._pending_forks.pop(s.slot, None)
            if pf is None:
                continue
            src, dst = pf
            copy_page(self.cache, self._layout, src, dst)
            self.pool.release([src])

    def _finish_job(self, job: PrefillJob, firsts: torch.Tensor,
                    first_host: List[int]) -> None:
        self._jobs.pop(0)
        slot_ids = torch.as_tensor([s.slot for s in job.states],
                                   device=self.device)
        self.tokens[slot_ids] = firsts
        self.pos[slot_ids] = torch.as_tensor(
            [s.prompt_total for s in job.states], dtype=torch.int32,
            device=self.device)
        self.prefill_calls += 1
        for s, tok in zip(job.states, first_host):
            s.prefilling = False
            s.generated = [int(tok)]
            if s.done:
                self._evict(s)
                self._finished.append(s)
        self._refresh_tables()

    def _index_insert(self, s: SlotState) -> None:
        """Index a request's full prompt pages at ADMISSION time, before its
        prefill has written them — so siblings of the same burst share
        intra-batch.  Safe because prefill order is FIFO: inline groups run
        during the same ``admit_many`` call, chunk jobs drain in admission
        order, and a sharer's first read of a prefix page (its suffix
        prefill's gather) therefore happens after the donor's write.  The
        failure paths drop these optimistic entries via
        :meth:`_index_evict_states` before releasing the pages."""
        if self.index is None or s.req.extras:
            return
        n_full = s.prompt_total // self.page_size
        if n_full == 0:
            return
        self.index.insert(
            np.asarray(s.req.tokens).tolist()[: n_full * self.page_size],
            [int(p) for p in self._tables[s.slot, :n_full]],
        )

    def _index_evict_states(self, states: List[SlotState]) -> None:
        """Un-index the pages a failing prefill group OWNED (never the
        read-shared prefix pages of an earlier donor — those are valid):
        they were indexed optimistically at admission and will never be
        written now."""
        if self.index is None:
            return
        bad = set()
        for st in states:
            for p in self._slot_pages.get(st.slot, []):
                if self.pool.owner(p) == st.req.rid:
                    bad.add(p)
        if bad:
            self.index.evict_pages(bad)

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> List[SlotState]:
        """Decode ONE token for every decoding slot; return evictions.

        Free, prefilling and paused slots ride along as masked garbage rows
        (in a dense model every per-row op of the decode path is
        batch-independent, so they cannot perturb live rows; in an MoE
        model they share expert capacity with them); their KV writes land
        in the trash page, or go there when a stale position lies past the
        page table, and in a slab cache at their own row's position
        (clamped to its last one), which the next join overwrites.
        """
        finished, self._finished = self._finished, []
        if self._grow_pages():
            self._refresh_tables()
        if self.n_decoding == 0:
            return finished
        active = [s is not None and not s.prefilling and not s.paused
                  for s in self.slots]
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.tokens, self.cache, self.pos, pages=self._visible_dev)
        next_tok = logits.argmax(dim=-1)
        act = torch.as_tensor(active, device=self.device)
        self.tokens = torch.where(act, next_tok, self.tokens)
        self.pos = self.pos + act.to(torch.int32)
        toks = next_tok.tolist()
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        evicted = False
        for s in list(self.slots):
            if s is None or s.prefilling or s.paused:
                continue
            s.generated.append(int(toks[s.slot]))
            if s.done:
                self._evict(s)
                finished.append(s)
                evicted = True
        if evicted:
            self._refresh_tables()
        return finished

    # ------------------------------------------------------------------ grow
    def _grow_pages(self) -> bool:
        """Grow admission: map the page each decoding slot's NEXT decode
        write lands in, called before every decode dispatch.  A slot whose
        growth cannot be satisfied — even after index reclaim and
        preemption — pauses: its table row goes dark (writes hit trash, its
        position does not advance) until a page frees up.  Returns True if
        any table changed."""
        if not self.grow:
            return False
        changed = False
        for s in list(self.slots):
            if s is None or s.prefilling:
                continue
            if self.slots[s.slot] is not s:
                continue  # preempted by an earlier slot's growth this pass
            # the next decode step writes KV at this absolute position
            need_pos = s.prompt_total + len(s.generated) - 1
            lp = need_pos // self.page_size
            row = self._slot_pages.get(s.slot, [])
            if lp < len(row) or lp >= self.pages_per_slot:
                if s.paused:
                    s.paused = False
                    changed = True
                continue
            page = self._grow_alloc(s)
            if self.slots[s.slot] is not s:
                # the slot went away under the allocation (lone decoder
                # preempted itself) — a page handed out anyway must not leak
                if page is not None:
                    self.pool.release([page])
                changed = True
                continue
            if page is None:
                if not s.paused:
                    changed = True
                s.paused = True
                self.pool.grow_defers += 1
                continue
            row.append(page)
            self._slot_pages[s.slot] = row
            self._tables[s.slot, lp] = page
            self.pool.grow_allocs += 1
            if s.paused:
                s.paused = False
            changed = True
            self._note_logical()
        return changed

    def _grow_alloc(self, s: SlotState) -> Optional[int]:
        """One page for slot ``s``'s growth, through the recovery ladder:
        free list → index reclaim → preempt the cheapest-to-redo decoding
        victim (fewest generated tokens; greedy decoding regenerates its
        exact tokens on re-admission) → None (pause)."""
        pool = self.pool
        if not pool.can_alloc(1) and self.index is not None:
            self.index.reclaim(1)
        if not pool.can_alloc(1):
            victims = sorted(
                (v for v in self.slots
                 if v is not None and not v.prefilling and v is not s),
                key=lambda v: len(v.generated),
            )
            if not victims and self.n_decoding <= 1:
                # the lone decoder cannot wait on anyone: requeue ITSELF
                # for a full re-prefill rather than livelock
                victims = [s]
            for v in victims:
                self._preempt(v)
                if v is s:
                    return None
                if pool.can_alloc(1):
                    break
                if self.index is not None:
                    self.index.reclaim(1)
                    if pool.can_alloc(1):
                        break
        if not pool.can_alloc(1):
            return None
        pages = pool.alloc(1, rid=s.req.rid)
        return pages[0] if pages else None

    def _preempt(self, state: SlotState) -> None:
        """Release a slot under grow pressure and requeue its request (the
        session re-admits it for a full re-prefill)."""
        self._release(state)
        self._preempted.append(state.req)
        self.preemptions += 1

    def take_preempted(self) -> List[Request]:
        """Drain requests bumped by preemption; the caller requeues them at
        the front of the admission queue."""
        out, self._preempted = self._preempted, []
        return out

    def preempt_resident(self) -> int:
        """Hard host loss: bump EVERY resident request through the
        preemption machinery (the device KV is gone) and return how many
        were bumped.  Also cancels in-progress chunk jobs (their
        optimistically indexed pages will never be written) and drops the
        whole prefix index.  Greedy decode makes the re-admissions
        token-exact."""
        n = 0
        for job in list(self._jobs):  # streaming prefills first
            self._jobs.remove(job)
            self._index_evict_states(job.states)
            for st in job.states:
                self._preempt(st)
                n += 1
        for s in list(self.slots):
            if s is None:
                continue
            self._preempt(s)
            n += 1
        if self.index is not None:
            self.index.evict_pages(self.index.pages)
        self.host_loss_preemptions += n
        self._refresh_tables()
        return n

    # ----------------------------------------------------------------- evict
    def _evict(self, state: SlotState) -> None:
        """Free the slot the step its request finishes (eos-aware: an early
        EOS returns its pages immediately): its pages unmap back to the
        pool (a shared page only when its last reader is gone)."""
        state.t_done = time.perf_counter()
        if self.slots[state.slot] is state:
            self.slots[state.slot] = None
            self._unmap(state.slot)
