"""Paged KV allocation: refcounted physical pages (port of
``repro/serving/pages.py``).

Cache memory is a pool of fixed-size physical pages (``page_size`` token
positions each); each slot owns a page table mapping its logical pages
(position ``p`` lives in logical page ``p // page_size``) to physical ones.
Joining a request maps pages in, evicting unmaps them.

Physical page 0 is reserved as the **trash page**: page-table rows init to
0, so unmapped logical pages of inactive (or short) slots direct the decode
step's fixed-shape writes into a sacrificial page instead of a neighbour's
memory.  Reads through unmapped entries return garbage that the attention
validity mask (``kpos <= pos``) zeroes exactly.

Two admission policies share the pool: **reserve** maps every page a
request could ever touch at admission; **grow** maps only the prompt's
pages and decode maps each page the step its first position is written
(a slot whose growth fails pauses until a page frees up).

**Prefix sharing**: pages are refcounted, and a :class:`PrefixIndex` — a
radix tree over admitted token sequences at page granularity — maps two
requests with a common prefix onto the *same* physical pages.  Admission
maps fully-matched pages read-shared (refcount++), copy-on-write forks the
divergence page, and prefills only the suffix.  Eviction releases instead
of freeing; the index holds one reference per indexed page, and under pool
pressure :meth:`PrefixIndex.reclaim` drops least-recently-matched leaves
whose only holder is the index.  Every line and iteration order is the JAX
package's: LRU ticks and reclaim order decide which pages come back, and
the counters must be equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PagePool", "PrefixIndex", "PrefixHit", "pages_needed"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Physical pages covering ``tokens`` positions (0 tokens → 0 pages)."""
    if tokens <= 0:
        return 0
    return -(-tokens // page_size)


class PagePool:
    """Host-side refcounted allocator for one cache layout's physical pages.

    Purely bookkeeping — the storage lives in the cache's pool tensors; this
    class decides which physical rows are free, owns the trash-page
    convention, counts readers per page, and tracks the high-water
    occupancy the serving metrics report against the slab footprint.
    """

    TRASH = 0  # physical page 0: the write sink for unmapped entries

    def __init__(self, n_pages: int, page_size: int, *, name: str = "kv"):
        if n_pages < 2:
            raise ValueError(
                f"{name} pool needs >= 2 pages (1 trash + 1 usable), "
                f"got {n_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.name = name
        self.n_pages = n_pages
        self.page_size = page_size
        #: free physical pages, smallest-first (page 0 never enters)
        self._free: List[int] = list(range(1, n_pages))
        self._refs: Dict[int, int] = {}  # physical page -> reader count
        self._owner: Dict[int, int] = {}  # physical page -> allocating rid
        self.high_water = 0  # max pages simultaneously mapped
        self.alloc_calls = 0
        #: deferral EVENTS — incremented by the admission layer once per
        #: request that had to wait on pool pressure (and by a failed
        #: alloc), NOT once per polling attempt
        self.defers = 0
        self.shared_maps = 0  # ref() calls: logical map-ins with no alloc
        self.cow_forks = 0  # divergence-page copies (batcher increments)
        self.grow_allocs = 0  # pages allocated lazily by decode writes
        self.grow_defers = 0  # decode steps a slot paused on pool pressure

    # ------------------------------------------------------------- occupancy
    @property
    def in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def capacity(self) -> int:
        """Usable pages (the trash page is not allocatable)."""
        return self.n_pages - 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def high_water_tokens(self) -> int:
        return self.high_water * self.page_size

    @property
    def logical_refs(self) -> int:
        """Total readers across mapped pages (= logical page mappings)."""
        return sum(self._refs.values())

    # ------------------------------------------------------------ alloc/free
    def alloc(self, n: int, *, rid: int = -1) -> Optional[List[int]]:
        """Map ``n`` fresh pages (refcount 1) to ``rid``; None on pressure."""
        if n > len(self._free):
            self.defers += 1
            return None
        pages = [self._free.pop(0) for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
            self._owner[p] = rid
        self.alloc_calls += 1
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def ref(self, page: int) -> int:
        """Add a reader to a mapped page (a shared map-in)."""
        if page == self.TRASH:
            raise ValueError(f"{self.name} pool: cannot ref trash page")
        if page not in self._refs:
            raise ValueError(f"{self.name} pool: ref of unmapped page {page}")
        self._refs[page] += 1
        self.shared_maps += 1
        return self._refs[page]

    def pin(self, page: int) -> int:
        """:meth:`ref` without the shared-map accounting — an internal hold,
        not a logical mapping."""
        if page == self.TRASH:
            raise ValueError(f"{self.name} pool: cannot pin trash page")
        if page not in self._refs:
            raise ValueError(f"{self.name} pool: pin of unmapped page {page}")
        self._refs[page] += 1
        return self._refs[page]

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reader from each page; a page returns to the free list
        only when its LAST reader is gone.  Releasing the trash page or an
        unmapped page is an error — a page table row leaked or aliased."""
        for p in pages:
            if p == self.TRASH:
                raise ValueError(f"{self.name} pool: cannot free trash page")
            if p not in self._refs:
                raise ValueError(f"{self.name} pool: double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._owner.pop(p, None)
                self._free.append(p)
        self._free.sort()

    def free(self, pages: Sequence[int]) -> None:
        """Alias of :meth:`release`."""
        self.release(pages)

    def owner(self, page: int) -> Optional[int]:
        return self._owner.get(page)

    def stats(self) -> Dict[str, int]:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "in_use": self.in_use,
            "high_water": self.high_water,
            "high_water_tokens": self.high_water_tokens(),
            "alloc_calls": self.alloc_calls,
            "defers": self.defers,
            "shared_maps": self.shared_maps,
            "cow_forks": self.cow_forks,
            "grow_allocs": self.grow_allocs,
            "grow_defers": self.grow_defers,
            "logical_refs": self.logical_refs,
        }


class PrefixHit:
    """One admission's prefix-index match.

    ``pages`` are the fully-matched physical pages (map read-shared, one
    refcount each, in logical order).  ``tokens`` is the matched prefix
    length in token positions — always ``< prompt_len``, so at least one
    position remains for the suffix prefill to produce first-token
    logits.  ``fork`` is the physical page holding the **divergence
    page**'s KV when the match ends mid-page: its matched head must be
    copied into a private page (copy-on-write) because the request's own
    prefill/decode writes land in the same page.
    """

    __slots__ = ("pages", "tokens", "fork")

    def __init__(self, pages: List[int], tokens: int, fork: Optional[int]):
        self.pages = pages
        self.tokens = tokens
        self.fork = fork

    @property
    def full(self) -> int:
        return len(self.pages)


class _Node:
    __slots__ = ("page", "children", "tick")

    def __init__(self, page: int):
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tick = 0


class PrefixIndex:
    """Radix tree over admitted token sequences, at page granularity.

    Each edge is one *full page* of prompt tokens (a ``page_size``-tuple);
    the child node records the physical page whose KV covers exactly those
    positions.  Only pages every position of which was written by a
    finished prefill are inserted — partial tail pages are private by
    construction.  The index holds ONE pool reference per node so an
    indexed page outlives the request that prefilled it; :meth:`reclaim`
    prunes least-recently-matched leaves whose only remaining reader is
    the index itself when the pool runs dry.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes: List[Tuple[Tuple[Tuple[int, ...], ...], _Node]] = []
        self._tick = 0
        self.inserts = 0
        self.lookups = 0
        self.hits = 0  # lookups that matched at least one full page
        self.hit_tokens = 0
        self.reclaimed = 0

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def pages(self) -> List[int]:
        return [n.page for _, n in self._nodes]

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index a prefilled prompt: ``pages[i]`` holds the KV of tokens
        ``[i*ps, (i+1)*ps)``.  Only full pages are indexed.  Returns the
        number of NEW nodes (pages the index took a reference on); blocks
        already present keep their existing (canonical) page — the
        caller's duplicate physical copy stays private to its slot."""
        ps = self.page_size
        n_full = min(len(tokens) // ps, len(pages))
        level = self._root
        path: List[Tuple[int, ...]] = []
        created = 0
        self._tick += 1
        for i in range(n_full):
            block = tuple(int(t) for t in tokens[i * ps : (i + 1) * ps])
            path.append(block)
            node = level.get(block)
            if node is None:
                page = int(pages[i])
                if page == self.pool.TRASH:
                    break  # unmapped logical page: nothing to index
                self.pool.ref(page)  # the index's own hold
                node = _Node(page)
                level[block] = node
                self._nodes.append((tuple(path), node))
                created += 1
            node.tick = self._tick
            level = node.children
        if created:
            self.inserts += 1
        return created

    # ---------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest indexed prefix of ``tokens``, capped at ``len-1`` so the
        suffix prefill always has at least one position to score (the
        request's first output token comes from its logits).

        Fully-matched pages are returned for read-shared mapping.  When
        the match ends mid-page — the stored block and the prompt agree on
        a head shorter than ``page_size``, including the cap demoting a
        full match — the page is returned as ``fork``: its KV for the
        matched head is valid, but the request's own writes land in the
        same page, so the caller must copy it (CoW) before mapping."""
        ps = self.page_size
        self.lookups += 1
        cap = len(tokens) - 1
        if cap <= 0:
            return PrefixHit([], 0, None)
        toks = [int(t) for t in tokens]
        matched: List[int] = []
        level = self._root
        node: Optional[_Node] = None
        self._tick += 1
        i = 0
        while (i + 1) * ps <= len(toks):
            block = tuple(toks[i * ps : (i + 1) * ps])
            nxt = level.get(block)
            if nxt is None:
                break
            node = nxt
            node.tick = self._tick
            matched.append(node.page)
            level = node.children
            i += 1
        hit = i * ps
        fork: Optional[int] = None
        # the divergence page: a stored block whose head matches the
        # remaining prompt tokens (partial tail, or mid-block divergence)
        rest = toks[i * ps :]
        if rest:
            best = 0
            for block, child in level.items():
                lcp = 0
                for a, b in zip(rest, block):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best:
                    best, fork = lcp, child.page
                    child.tick = self._tick
            hit += best
            if best == 0:
                fork = None
        if hit > cap:
            hit = cap
        full = hit // ps
        if full < len(matched):
            # the cap (or a shortened tail) demoted the last fully-matched
            # page to the divergence page: positions >= hit in it will be
            # written by this request — it must be forked, not shared
            fork = matched[full]
            matched = matched[:full]
        if hit % ps == 0:
            fork = None
        if matched or fork is not None:
            self.hits += 1
            self.hit_tokens += hit
        return PrefixHit(matched, hit, fork)

    # ----------------------------------------------------------------- evict
    def evict_pages(self, pages: Sequence[int]) -> int:
        """Drop every entry resolving through any of ``pages`` (subtrees
        included — a child's KV is meaningless without its prefix) and
        release the index's holds.  The failure-path complement of
        admission-time indexing: a prefill that dies before writing its
        pages must not leave them discoverable."""
        bad = {int(p) for p in pages}
        doomed = [path for path, n in self._nodes if n.page in bad]
        if not doomed:
            return 0
        removed = 0
        keep = []
        for path, node in self._nodes:
            if any(path[: len(d)] == d for d in doomed):
                self.pool.release([node.page])
                removed += 1
            else:
                keep.append((path, node))
        self._nodes = keep
        for d in sorted(doomed, key=len):
            level = self._root
            ok = True
            for block in d[:-1]:
                nxt = level.get(block)
                if nxt is None:
                    ok = False  # an ancestor was already detached
                    break
                level = nxt.children
            if ok:
                level.pop(d[-1], None)
        return removed

    # --------------------------------------------------------------- reclaim
    def reclaimable(self) -> int:
        """Indexed pages whose ONLY reader is the index (refcount 1) and
        that index no deeper entries — droppable without touching a live
        slot."""
        return sum(
            1
            for _, n in self._nodes
            if not n.children and self.pool.refcount(n.page) == 1
        )

    def reclaim(self, n_pages: int) -> int:
        """Release up to ``n_pages`` pages back to the pool by pruning
        least-recently-matched leaves held only by the index.  Pruning a
        leaf can expose its parent; passes repeat until the budget is met
        or nothing reclaimable remains.  Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = [
                (node.tick, path, node)
                for path, node in self._nodes
                if not node.children and self.pool.refcount(node.page) == 1
            ]
            if not leaves:
                break
            leaves.sort(key=lambda t: t[0])
            progress = False
            for _, path, node in leaves:
                if freed >= n_pages:
                    break
                level = self._root
                for block in path[:-1]:
                    level = level[block].children
                if level.get(path[-1]) is not node:
                    continue
                del level[path[-1]]
                self._nodes.remove((path, node))
                self.pool.release([node.page])
                self.reclaimed += 1
                freed += 1
                progress = True
            if not progress:
                break
        return freed

    def stats(self) -> Dict[str, int]:
        return {
            "nodes": len(self._nodes),
            "inserts": self.inserts,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "reclaimed": self.reclaimed,
        }
