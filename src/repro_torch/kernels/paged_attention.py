"""CUDA paged-decode attention: the wrapper of ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/paged_attention.py:paged_attention`` (the Pallas TPU
kernel).  The wrapper checks what the kernel takes, picks the number of
splits of each row's pages from shapes alone (:func:`num_splits`), allocates
the output and the splits' fp32 workspace with ``torch.empty`` and launches
on the current CUDA stream; the kernel is built at first use
(:mod:`repro_torch.kernels.build`).  Callers go through
:func:`repro_torch.kernels.ops.paged_attention`, which sends CPU tensors to
the plain version instead.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "paged_attention",
    "paged_attention.cu",
    "repro_paged_attention",
    [_P, _P, _P, _P, _P, _P,  # q, k_pool, v_pool, table, lengths, out
     _I, _I, _I, _I, _I, _I, _I,  # B, H, K, hd, ps, n_pp, P
     ctypes.c_float, _I, _I,  # scale, q dtype, kv dtype
     _I, _P, _P, _P],  # n_split, workspace, counters, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # 32 lanes of 8 head dims score one token
HEADS_PER_BLOCK = 8  # query heads of a KV group per block: csrc kMaxHeads
BLOCKS_PER_SM = 4  # what the split count aims at
MAX_SPLITS = 32  # csrc/paged_attention.cu:kMaxSplits
MAX_SMEM = 227 * 1024

_SM_COUNT: Dict[int, int] = {}
#: split counters per (device index, raw CUDA stream), and whether their
#: zeros were written outside a graph capture; a tensor here is never
#: replaced or freed while the process lives
_COUNTERS: Dict[Tuple[int, int], Tuple[torch.Tensor, bool]] = {}


def work(B: int, H: int, K: int, hd: int, itemsize: int, live: int,
         table_entries: int):
    """(FLOPs, bytes) of one call: the ``live`` cached positions of all
    rows (the sum of each row's ``length + 1``, capped at its pages) read
    once from the K and V pools, q read and the output written (B,H,hd),
    the int32 page table and lengths read; two products of ``hd`` for
    each (query head, live position)."""
    return (4.0 * live * H * hd,
            float(2 * live * K * hd * itemsize + 2 * B * H * hd * itemsize
                  + 4 * table_entries + 4 * B))


def head_groups(H: int, K: int) -> int:
    """Blocks per (row, KV head) along the query heads: ``rep = H/K`` heads
    share one block up to ``HEADS_PER_BLOCK``."""
    return -(-(H // K) // HEADS_PER_BLOCK)


def num_splits(B: int, K: int, n_pp: int, sm_count: int,
               n_hg: int = 1) -> int:
    """Splits of each row's ``n_pp`` logical pages, from shapes only: enough
    (row, KV head, head group, split) blocks for ``BLOCKS_PER_SM`` per SM,
    at most ``MAX_SPLITS`` and one page per split, and no split that would
    own no page at all."""
    want = -(-BLOCKS_PER_SM * sm_count // max(B * K * n_hg, 1))
    s = max(1, min(want, n_pp, MAX_SPLITS))
    pps = -(-n_pp // s)
    return -(-n_pp // pps)


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, K: int, hd: int, ps: int, n_pp: int, P: int,
          itemsize: int, sm_count: int) -> Tuple[int, int]:
    """(splits, head groups) of a call, or ValueError for a shape the
    kernel cannot take; cached per shape (decode repeats a few)."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if n_pp == 0 or P == 0:
        raise ValueError("paged_attention: empty page table or pool")
    # two stages of K and V slabs (rows padded to 8 dims) must fit
    if 4 * ps * (-(-hd // 8) * 8) * itemsize > MAX_SMEM - 40 * 1024:
        raise ValueError(f"paged_attention: pages of {ps} x {hd} do not fit "
                         f"two shared-memory stages")
    n_hg = head_groups(H, K)
    n_split = num_splits(B, K, n_pp, sm_count, n_hg)
    # a call splits only below BLOCKS_PER_SM * sm_count (row, KV head,
    # head group) triples, so the counters of _counters always suffice
    assert n_split == 1 or B * K * n_hg <= BLOCKS_PER_SM * sm_count
    return n_split, n_hg


def _sm_count(device: torch.device) -> int:
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device.index]


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's per-(row, KV head, head group) split counters, one for
    each block a split call can have (``BLOCKS_PER_SM`` per SM, see
    :func:`_plan`): zeros, left at zero by every launch, kept per (device,
    stream) so that launches on two streams never share one, and never
    freed, so a CUDA graph captured with them writes into live memory.
    Until a launch outside a capture has zeroed them, every capture
    records its own zero fill, so a graph replayed before any eager launch
    finds zeros.  A graph keeps the counters of the stream it was captured
    on: replay it where no launch on that stream runs at the same time."""
    key = (device.index, stream)
    entry = _COUNTERS.get(key)
    if entry is not None and entry[1]:
        return entry[0]
    capturing = torch.cuda.is_current_stream_capturing()
    c = entry[0] if entry is not None else torch.empty(
        BLOCKS_PER_SM * _sm_count(device), dtype=torch.int32, device=device)
    c.zero_()  # inside a capture: recorded into the graph, not run
    _COUNTERS[key] = (c, not capturing)
    return c


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,hd); pools (P,K,ps,hd); page_table (B,n_pp) int32; lengths
    (B,) int32 decode positions.  Returns (B,H,hd) in q's dtype."""
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table,
                   lengths=lengths)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"paged_attention: q (B,H,hd) and pools (P,K,ps,hd) "
                         f"expected, got {tuple(q.shape)} / "
                         f"{tuple(k_pool.shape)}")
    B, H, hd = q.shape
    P, K, ps, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % K:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pool.shape)} v {tuple(v_pool.shape)} "
                         f"do not agree (H % K == 0, same hd)")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_attention: page_table must be (B={B}, n_pp), "
                         f"got {tuple(page_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"paged_attention: lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and lengths must be "
                         "int32")
    if q.dtype not in DTYPE_CODE or k_pool.dtype not in DTYPE_CODE:
        raise ValueError(f"paged_attention: dtypes {q.dtype}/{k_pool.dtype} "
                         f"unsupported (float32, bfloat16)")
    if v_pool.dtype != k_pool.dtype:
        raise ValueError("paged_attention: k_pool and v_pool dtypes differ")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_pp = page_table.shape[1]
    n_split, n_hg = _plan(B, H, K, hd, ps, n_pp, P, k_pool.element_size(),
                          _sm_count(q.device))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = cnt = None
        if n_split > 1:
            ws = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                             device=q.device)
            cnt = _counters(q.device, stream)
        KERNEL.launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, K, hd, ps, n_pp, P, scale,
            DTYPE_CODE[q.dtype], DTYPE_CODE[k_pool.dtype], n_split,
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(), stream,
        )
    return out
