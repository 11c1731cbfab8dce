"""Rows of a plan step on its ranks, and the moves between rank groups (the
paper's transmission ops, §3.6 (2)) of the distributed
:class:`repro_torch.runtime.engine.WaveEngine`.

A step's activation is a stack of per-task row blocks (a merged step
concatenates its tasks' batches in flow order).  Its **layout** says which
rows each rank of the step's group holds: a list of segments ``(task, lo,
hi)`` per rank, the rank's local tensor being those rows in that order.
A **piece** is a run of rows that one rank holds and another needs; the
consumer's input is its pieces concatenated.  Every rank computes the same
layouts and pieces from the plan and the batch sizes alone, so every rank
walks one global order of moves and posts its sends and receives in it:
the lowest unfinished move always has both ends at it, so nothing
deadlocks.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import TRAFFIC

#: (task, first row, end row) of one task's batch
Seg = Tuple[str, int, int]
Layout = Dict[int, List[Seg]]


class Piece(NamedTuple):
    """Rows ``src_lo:src_hi`` of rank ``src``'s local activation become
    rows ``dst_lo:dst_hi`` of rank ``dst``'s local input."""

    src: int
    dst: int
    src_lo: int
    src_hi: int
    dst_lo: int
    dst_hi: int


def row_layout(group: Sequence[int], sizes: Dict[str, int],
               whole: bool) -> Layout:
    """Each task's rows split contiguously over ``group`` (``sizes``: task →
    rows, in flow order) when its size divides every task's and ``whole``
    is False; otherwise the group's lowest rank holds every row."""
    g = len(group)
    if whole or any(n % g for n in sizes.values()):
        return {min(group): [(t, 0, n) for t, n in sizes.items()]}
    return {r: [(t, i * n // g, (i + 1) * n // g) for t, n in sizes.items()]
            for i, r in enumerate(group)}


def pieces(held: Layout, dst: int, need: Sequence[Seg]) -> List[Piece]:
    """The pieces that give rank ``dst`` the rows ``need`` (in that order)
    of an activation laid out as ``held``."""
    out: List[Piece] = []
    at = 0
    for task, lo, hi in need:
        runs = []
        for src, segs in held.items():
            off = 0
            for t, plo, phi in segs:
                a, b = max(lo, plo), min(hi, phi)
                if t == task and a < b:
                    runs.append((a, src, off + a - plo, off + b - plo))
                off += phi - plo
        covered = 0
        for a, src, s0, s1 in sorted(runs):
            out.append(Piece(src, dst, s0, s1, at, at + s1 - s0))
            at += s1 - s0
            covered += s1 - s0
        if covered != hi - lo:
            raise ValueError(f"rows {task}[{lo}:{hi}] are not held whole "
                             f"by {held}")
    return out


class Wire:
    """Point-to-point moves over the default group.  Under gloo a CUDA
    tensor goes through a host copy (gloo's send and receive take host
    memory); under NCCL it moves from device to device.  The choice
    follows from the backend alone.  Every byte of payload this rank
    sends is added to ``TRAFFIC["moves"]``."""

    HEADER = 8  # ndim and up to 7 dims of a forward move's shape

    def __init__(self):
        nccl = dist.get_backend() == "nccl"
        self.host = not nccl
        self.ctrl = (torch.device("cuda", torch.cuda.current_device())
                     if nccl else torch.device("cpu"))

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return (t.detach().cpu() if self.host else t.detach()).contiguous()

    def send(self, t: torch.Tensor, dst: int, *, header: bool) -> None:
        if header:
            if t.dim() >= self.HEADER:
                raise ValueError(f"a move of {t.dim()} dims")
            h = torch.zeros(self.HEADER, dtype=torch.int64)
            h[0] = t.dim()
            h[1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
            dist.send(h.to(self.ctrl), dst)
        out = self._out(t)
        TRAFFIC["moves"] += out.numel() * out.element_size()
        dist.send(out, dst)

    def recv(self, src: int, like: torch.Tensor,
             shape=None) -> torch.Tensor:
        """A tensor from ``src`` of ``like``'s dtype and device: of
        ``shape`` (a backward move, whose shape both ends know), or of the
        shape its header gives (a forward move)."""
        if shape is None:
            h = torch.empty(self.HEADER, dtype=torch.int64, device=self.ctrl)
            dist.recv(h, src)
            h = h.tolist()
            shape = h[1:1 + h[0]]
        buf = torch.empty(shape, dtype=like.dtype,
                          device="cpu" if self.host else like.device)
        dist.recv(buf, src)
        return buf.to(like.device)
