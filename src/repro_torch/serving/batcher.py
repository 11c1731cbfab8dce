"""Continuous batcher: slot map + paged KV pool over one decode batch (port of
``repro/serving/batcher.py`` for the paged layout with reserve admission).

The decode batch is a fixed array of ``max_slots`` rows; each row is a
**slot** holding one request's decode state.  Full-attention KV lives in a
shared page pool (:mod:`repro_torch.serving.pages`): joining *maps*
physical pages through a per-slot page table and evicting *unmaps* them.
Window and recurrent state (a hybrid model's local-attention buffers and
RG-LRU state) is slot-major: joining overwrites the slot's rows.
Admission is **stacked**: :meth:`ContinuousBatcher.admit_many` prefills all
same-length queued requests in ONE call.

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
donates them); the prefill map-in writes only mapped pages (the JAX one
also scatters the padded tail of unmapped logical pages into the trash
page, which nothing reads); and the host read of each step's tokens sits
inside the timed window in both prefill and decode, so on an asynchronous
CUDA stream the times include the device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .pages import PagePool, pages_needed
from .queue import Request


@torch.no_grad()
def write_pages(cache, page, slots, rows: np.ndarray, layout) -> None:
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
    the trash page, which nothing reads)."""
    device = next(iter(cache[0].values())).device
    slot_ids = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                               device=device)
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
            if phys.numel() == 0:
                continue
            ps = dst.shape[2]
            k, K, S, hd = src.shape
            src = torch.nn.functional.pad(src, (0, 0, 0, n_pp * ps - S))
            src = src.reshape(k, K, n_pp, ps, hd).permute(0, 2, 1, 3, 4)
            dst[phys] = src[ii, lp].to(dst.dtype)


@dataclass
class SlotState:
    """One occupied slot: the request plus its decode progress."""

    req: Request
    slot: int
    prompt_total: int
    generated: List[int] = field(default_factory=list)
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


class ContinuousBatcher:
    """Fixed-slot continuous batching over one served model."""

    def __init__(
        self,
        model,
        *,
        max_slots: int = 8,
        cache_len: int = 128,
        cache_dtype=torch.bfloat16,
        page_size: int = 16,
        kv_pages: int = 0,
        batched_prefill: bool = True,
    ):
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.cache_dtype = cache_dtype
        self.page_size = page_size
        self.batched_prefill = batched_prefill
        self.pages_per_slot = pages_needed(cache_len, page_size)
        n_pages = kv_pages or max_slots * self.pages_per_slot + 1
        self.cache, self._layout = model.init_paged_cache(
            max_slots, cache_len, n_pages=n_pages, page_size=page_size,
            cache_dtype=cache_dtype,
        )
        self.pool = PagePool(n_pages, page_size)
        # physical page ids per (slot, logical page); 0 = trash
        self._tables = np.zeros((max_slots, max(self.pages_per_slot, 1)),
                                np.int32)
        self._visible_dev = torch.as_tensor(self._tables, device=self.device)

        self.tokens = torch.zeros((max_slots,), dtype=torch.long,
                                  device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int32,
                               device=self.device)
        self.slots: List[Optional[SlotState]] = [None] * max_slots
        self._slot_pages: Dict[int, List[int]] = {}
        self._last_defer_rid: Optional[int] = None
        self._finished: List[SlotState] = []
        self.decode_steps = 0
        self.prefill_calls = 0  # prefill dispatches (stacked counts once)
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------- occupancy
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_decoding(self) -> int:
        return self.n_active

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def kv_page_bytes(self) -> int:
        """Device bytes one KV page costs across all pool leaves."""
        from ..models.paging import kv_page_bytes

        return kv_page_bytes(self.cache, self._layout)

    def kv_stats(self) -> Dict[str, Any]:
        """Page-pool occupancy vs. the slab footprint (token positions)."""
        slab_tokens = self.max_slots * self.cache_len
        hw = self.pool.high_water_tokens()
        return {
            "kv_layout": "paged",
            "kv_slab_tokens": slab_tokens,
            "kv_admission": "reserve",
            "kv_page_size": self.page_size,
            "kv_pages": self.pool.n_pages,
            "kv_pages_in_use": self.pool.in_use,
            "kv_page_hw": self.pool.high_water,
            "kv_page_hw_tokens": hw,
            "kv_mem_saving": 1.0 - hw / max(slab_tokens, 1),
            "kv_defers": self.pool.defers,
        }

    # ------------------------------------------------------------------ join
    def validate(self, req: Request) -> None:
        """Raise if ``req`` cannot fit a slot."""
        need = self._need_tokens(req)
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt_len}+0) + "
                f"{req.max_new_tokens} new tokens needs {need} cache "
                f"positions > cache_len={self.cache_len}"
            )
        pages = min(pages_needed(need, self.page_size), self.pages_per_slot)
        if pages > self.pool.capacity:
            # a reservation no pool state can ever satisfy must fail loudly
            raise ValueError(
                f"request {req.rid}: needs {pages} KV pages > pool "
                f"capacity {self.pool.capacity}; raise kv_pages or "
                f"page_size"
            )

    @staticmethod
    def _need_tokens(req: Request) -> int:
        return req.prompt_len + req.max_new_tokens - 1

    def _admit_pages(self, req: Request) -> int:
        """Reserve admission: every page the request can ever write."""
        return min(pages_needed(self._need_tokens(req), self.page_size),
                   self.pages_per_slot)

    def admit_many(self, reqs: List[Request]) -> List[int]:
        """Admit queued requests: map slots and pages, then prefill in
        stacked same-length groups — ONE prefill call for k requests.
        Stops at the first request that does not fit (FIFO preserved).
        Returns the admitted slots, in request order."""
        admitted: List[Tuple[Request, int]] = []
        for req in reqs:
            self.validate(req)
            if not self.free_slots():
                break
            slot = self.free_slots()[0]
            n = self._admit_pages(req)
            pages: Optional[List[int]] = []
            if n:
                pages = (self.pool.alloc(n, rid=req.rid)
                         if self.pool.can_alloc(n) else None)
            if pages is None:
                # pool pressure defers the tail, FIFO preserved; count
                # deferral EVENTS, not per-step admission polls
                if req.rid != self._last_defer_rid:
                    self.pool.defers += 1
                    self._last_defer_rid = req.rid
                break
            self._slot_pages[slot] = pages
            self._tables[slot] = 0
            self._tables[slot, : len(pages)] = pages
            self.slots[slot] = SlotState(
                req=req, slot=slot, prompt_total=req.prompt_len,
                t_join=time.perf_counter(),
            )
            self._last_defer_rid = None
            admitted.append((req, slot))
        if not admitted:
            return []

        # stack requests of identical prompt length: in a dense model rows
        # are batch-independent, so one stacked prefill equals k solo
        # prefills (an MoE prefill shares expert capacity, as in JAX)
        groups: Dict[Any, List[SlotState]] = {}
        for i, (req, slot) in enumerate(admitted):
            key = req.prompt_len if self.batched_prefill else i
            groups.setdefault(key, []).append(self.slots[slot])
        for states in groups.values():
            try:
                self._prefill_group(states)
            except Exception:
                # roll the group's capacity back: a failing prefill must not
                # leak slots or pool pages (its requests are lost)
                for st in states:
                    self._release(st)
                self._refresh_tables()
                raise
        self._refresh_tables()
        return [slot for _, slot in admitted]

    def _release(self, state: SlotState) -> None:
        """Return a slot's capacity without completion bookkeeping."""
        if self.slots[state.slot] is state:
            self.slots[state.slot] = None
        pages = self._slot_pages.pop(state.slot, None)
        if pages is not None:
            self.pool.free(pages)
            self._tables[state.slot] = 0

    def _refresh_tables(self) -> None:
        """Rebuild the decode-visible page table: occupied slots expose
        their mapping, free ones point at the trash page."""
        visible = self._tables.copy()
        for i, s in enumerate(self.slots):
            if s is None:
                visible[i] = 0
        self._visible_dev = torch.as_tensor(visible, device=self.device)

    @torch.no_grad()
    def _prefill_group(self, states: List[SlotState]) -> None:
        """One stacked (or solo) one-shot prefill + cache map-in."""
        tokens = torch.as_tensor(
            np.stack([np.asarray(s.req.tokens) for s in states]),
            dtype=torch.long, device=self.device,
        )
        slot_list = [s.slot for s in states]
        t0 = time.perf_counter()
        logits, page = self.model.prefill(
            {"tokens": tokens}, cache_len=self.cache_len,
            cache_dtype=self.cache_dtype,
        )
        firsts = logits.argmax(dim=-1)
        write_pages(self.cache, page, slot_list,
                    self._tables[np.asarray(slot_list)], self._layout)
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

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> List[SlotState]:
        """Decode ONE token for every occupied slot; return evictions.

        Free slots ride along as masked garbage rows (in a dense model
        every per-row op of the decode path is batch-independent, so they
        cannot perturb live rows; in an MoE model they share expert
        capacity with them); their KV writes land in the trash page, or go
        there when a stale position lies past the page table.
        """
        finished, self._finished = self._finished, []
        if self.n_decoding == 0:
            return finished
        active = [s is not None for s in self.slots]
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.tokens, self.cache, self.pos, pages=self._visible_dev,
        )
        next_tok = logits.argmax(dim=-1)
        act = torch.as_tensor(active, device=self.device)
        self.tokens = torch.where(act, next_tok, self.tokens)
        self.pos = self.pos + act.to(torch.int32)
        toks = next_tok.tolist()
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        evicted = False
        for s in list(self.slots):
            if s is None:
                continue
            s.generated.append(int(toks[s.slot]))
            if s.done:
                self._evict(s)
                finished.append(s)
                evicted = True
        if evicted:
            self._refresh_tables()
        return finished

    # ----------------------------------------------------------------- evict
    def _evict(self, state: SlotState) -> None:
        """Free the slot the step its request finishes (eos-aware: an early
        EOS returns its pages immediately): its pages unmap back to the
        pool."""
        state.t_done = time.perf_counter()
        if self.slots[state.slot] is state:
            self.slots[state.slot] = None
            pages = self._slot_pages.pop(state.slot, None)
            if pages is not None:
                self.pool.free(pages)
                self._tables[state.slot] = 0
