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

Pages are refcounted (``ref``/``pin``/``release``) exactly as in the JAX
package, where prefix sharing maps one page into several slots; the radix
``PrefixIndex`` that drives sharing is ported with prefix sharing itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

__all__ = ["PagePool", "pages_needed"]


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
            "logical_refs": self.logical_refs,
        }
