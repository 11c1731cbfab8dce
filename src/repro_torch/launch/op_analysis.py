"""Shape-only analysis of one step: FLOPs, HBM traffic, collective bytes,
kernel launches and peak live bytes, per rank (the counterpart of
``repro/launch/hlo_analysis.py``).

JAX compiles a step and parses the optimized HLO text.  The port has no
compiler and no HLO to parse: the step runs once, eagerly, on ``"meta"``
tensors (shapes and dtypes, no data, nothing allocated), and a
``TorchDispatchMode`` counts every aten op as it runs.  Every number is
this rank's, as JAX's partitioned module is the per-device program:

* ``flops``: 2 · |result| · K of every ``mm`` / ``bmm`` / ``addmm`` /
  ``baddbmm`` (``matmul``, ``linear`` and ``einsum`` reach the
  dispatcher as these), K the contracted size —
  ``hlo_analysis._dot_flops`` —, plus each kernel's formula FLOPs
  (``kernels/*.py:work``);
* ``hbm_bytes``: operand plus result bytes of every aten op that is not
  a view and not an allocation without a write (``empty``), plus each
  kernel's formula bytes.  Eager torch runs no fusion, so every op's
  operands cross HBM: the proxy is an upper bound where XLA's counts
  fusion boundaries;
* ``collective_bytes``: the bytes this rank sent into each collective
  (:data:`repro_torch.parallel.collectives.TRAFFIC`'s delta over the
  step, the counter the card's runs log), under JAX's five kinds; the
  wavefront engine's point-to-point moves count as
  ``collective-permute``, and nothing in the port makes an all-to-all;
* ``launches``: the shape-only calls of each kernel
  (:data:`repro_torch.kernels.ops.SHAPE_ONLY`'s delta), each one launch
  on the card;
* ``peak_bytes``: the most bytes live at once — the storages the step's
  inputs hold, plus each storage an op creates from its creation until
  it is freed (``weakref.finalize``: the pattern of torch's
  ``torch.distributed._tools.mem_tracker``, kept here in the one mode
  that also counts the ops);
* ``peak_live``: what holds those bytes, the live storages grouped by the
  op that made them, its result's shape and dtype (``"input"`` for the
  step's inputs), largest first, taken when the live bytes last rose 1 %
  above the previous such snapshot (so within 1 % of the peak).

``hlo_analysis`` multiplies each while-loop body by its trip count,
since ``cost_analysis()`` counts a loop body once.  Eager dispatch runs
every layer, microbatch (``grad_accum``), logits chunk and remat
recompute as ops of their own, so each op is counted as often as it runs
and no trip count is needed.

A DTensor op reaches the mode with the DTensors' logical shapes; it is
counted on their local tensors, what this rank computes.  The mode is
itself seen: while any dispatch mode is active, some of autograd's
backward formulas take out-of-place forms (``_INTO_COPY``) of what they
otherwise do in place on a fresh zero buffer; the peak gives such a
buffer's bytes to the result, as the in-place form would.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: ``collectives.TRAFFIC`` key → JAX's collective kind
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "moves": "collective-permute"}

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided}
#: factories of a zero (or constant) buffer
_FILLS = {_aten.zeros, _aten.zeros_like, _aten.new_zeros, _aten.full,
          _aten.full_like, _aten.new_full}
#: out-of-place ops that write into a copy of their first argument.
#: Autograd's formulas fill a fresh zero buffer in place
#: (``gather_backward``: ``new_zeros(...).scatter_add_(...)``), but take
#: these out-of-place forms whenever a dispatch mode is active (the
#: ``areAnyTensorSubclassLike`` branches of torch's ``FunctionsManual``),
#: which would hold the zeros and the result at once only because the
#: counter watches
_INTO_COPY = {_aten.scatter_add, _aten.scatter, _aten.index_add,
              _aten.index_put, _aten.index_copy, _aten.masked_scatter,
              _aten.slice_scatter, _aten.select_scatter,
              _aten.diagonal_scatter, _aten.as_strided_scatter}


@dataclass
class OpStats:
    """``HloStats``'s fields, plus ``launches``, ``peak_bytes`` and
    ``peak_live``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    launches: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0
    peak_live: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree, out=None) -> list:
    """The tensors in an op's arguments or results, or in a step's inputs
    (nested tuples, lists, dicts and dataclasses such as an
    ``OptState``), a DTensor as its local tensor."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(getattr(tree, "_local_tensor", tree))  # a DTensor's
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(packet, args, out: torch.Tensor) -> float:
    """2 · |result| · K, K the last dim of the left matrix operand."""
    lhs = args[1] if packet in (_aten.addmm, _aten.baddbmm) else args[0]
    return 2.0 * out.numel() * _tensors(lhs)[0].shape[-1]


@functools.lru_cache(maxsize=None)
def _role(func) -> Tuple[Any, bool, bool]:
    """(overload packet, whether the op moves bytes, whether it is a
    fill) of an op: what the counter asks of every call."""
    packet = func._overloadpacket
    moves = (func.namespace == "aten" and not func.is_view
             and packet not in _NO_TRAFFIC)
    return packet, moves, packet in _FILLS


#: the live bytes must rise this much above the last ``peak_live``
#: snapshot before the next is taken
_SNAPSHOT_STEP = 1.01
#: groups kept in a snapshot
_SNAPSHOT_TOP = 8


class _Counter(TorchDispatchMode):
    def __init__(self, inputs):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        # id of a live storage → [its counted bytes, the weakref that
        # uncounts them when it is freed, what made it]
        self._seen: Dict[int, list] = {}
        self._fresh: set = set()  # ids of filled buffers no op has read
        for t in _tensors(inputs):
            self._see(t.untyped_storage(), True, "input")
        self.peak = self.live
        self.peak_live: Dict[str, int] = {}
        self._snapped = 0

    def _see(self, st, counted: bool, label: str = "") -> bool:
        """Know ``st`` until it is freed; ``counted``: its bytes are live
        bytes of the step (an input's, or an op's new storage, made by
        ``label``).  Returns whether it was new."""
        key = id(st)
        if key in self._seen:
            return False
        n = st.nbytes() if counted else 0
        self._seen[key] = [n, weakref.ref(st, lambda _, k=key: self._gone(k)),
                           label]
        self.live += n
        return True

    def _snapshot(self) -> None:
        """``peak_live``: the live bytes by what made them, largest first."""
        groups: Dict[str, int] = {}
        for n, _, label in self._seen.values():
            if n:
                groups[label] = groups.get(label, 0) + n
        top = sorted(groups.items(), key=lambda kv: -kv[1])[:_SNAPSHOT_TOP]
        self.peak_live = dict(top)
        self._snapped = self.live

    def _gone(self, key: int) -> None:
        self.live -= self._seen.pop(key, (0,))[0]
        self._fresh.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet, moves, fill = _role(func)
        ins = _tensors(kwargs, _tensors(args)) if kwargs else _tensors(args)
        outs = _tensors(out)
        into = None
        if packet in _INTO_COPY and id(ins[0].untyped_storage()) in (
                self._fresh):
            into = id(ins[0].untyped_storage())
        for t in ins:  # a storage first met as an input is not the op's
            st = t.untyped_storage()
            self._see(st, False)
            if self._fresh:
                self._fresh.discard(id(st))
        for t in outs:
            st = t.untyped_storage()
            label = f"{packet} {tuple(t.shape)} {str(t.dtype)[6:]}"
            if self._see(st, True, label) and fill:
                self._fresh.add(id(st))
        if into is not None:  # the in-place form's: the buffer is the result
            self.live -= self._seen[into][0]
            self._seen[into][0] = 0
        if self.live > self.peak:
            self.peak = self.live
            if self.live > _SNAPSHOT_STEP * self._snapped:
                self._snapshot()
        if packet in _DOTS:
            self.flops += _dot_flops(packet, args, outs[0])
        if moves:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        return out


def analyze(fn: Callable, *args, **kwargs) -> Tuple[Any, OpStats]:
    """Run ``fn(*args, **kwargs)`` once under the counter (on ``"meta"``
    inputs: a shape-only trace) and return its result and the step's
    :class:`OpStats`."""
    from ..kernels import ops
    from ..parallel import collectives

    traffic = dict(collectives.TRAFFIC)
    calls = {n: dict(r) for n, r in ops.SHAPE_ONLY.items()}
    counter = _Counter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    stats = OpStats(flops=counter.flops, hbm_bytes=counter.bytes,
                    peak_bytes=counter.peak, peak_live=counter.peak_live)
    for key, kind in KINDS.items():
        stats.collective_bytes[kind] += (collectives.TRAFFIC[key]
                                         - traffic[key])
    for name, rec in ops.SHAPE_ONLY.items():
        before = calls[name]
        stats.launches[name] = int(rec["calls"] - before["calls"])
        stats.flops += rec["flops"] - before["flops"]
        stats.hbm_bytes += rec["bytes"] - before["bytes"]
    return out, stats
