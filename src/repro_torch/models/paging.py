"""Shared paged-KV cache construction (port of ``repro/models/paging.py``).

A slab decode cache's full-attention KV leaves — ``(..., batch @ ax, K,
cache_len @ ax+2, hd)`` — become shared page pools ``(..., n_pages @ ax,
K, page_size @ ax+2, hd)`` indexed through per-row page tables.  Layout
codes mirror the cache tree: ``"kv<ax>"`` for a pool (``ax`` is its page
axis) and ``"state<ax>"`` for slot-major state (``ax`` its batch axis),
which keeps its shape.  The port's caches are lists of per-layer dicts (no
scan-stacked group axis), so its codes are ``"kv0"`` and ``"state0"``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

__all__ = ["paginate_cache", "kv_page_bytes"]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def paginate_cache(slab: Any, layout: Any, *, n_pages: int, page_size: int,
                   device: torch.device) -> Tuple[Any, Any]:
    """Turn a slab decode cache (``init_cache``'s, possibly on the ``meta``
    device — only shapes and dtypes are read) into its paged counterpart:
    zeros on ``device``, each pool with ``n_pages`` pages of ``page_size``
    positions, each state leaf in its slab shape.  Returns ``(cache,
    layout)``."""

    def one(leaf, code):
        shape = list(leaf.shape)
        if code.startswith("kv"):
            ax = int(code[len("kv"):])
            shape[ax] = n_pages
            shape[ax + 2] = page_size
        return torch.zeros(shape, dtype=leaf.dtype, device=device)

    return _tree_map(one, slab, layout), layout


def kv_page_bytes(cache: Any, layout: Any) -> int:
    """Bytes one KV page occupies summed across every pool leaf."""
    total = 0

    def one(leaf, code):
        nonlocal total
        if code.startswith("kv"):
            ax = int(code[len("kv"):])
            total += (leaf.numel() * leaf.element_size()) // leaf.shape[ax]
        return leaf

    _tree_map(one, cache, layout)
    return int(total)
