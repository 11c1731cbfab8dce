"""WaveEngine — executes a Spindle ExecutionPlan on an MTModel (§3.6; port
of ``repro/runtime/engine.py``).

The paper's four runtime steps:

  (1) **Localization** — every PlanStep (a sliced MetaOp on a device
      group) becomes a segment function over the owning component
      instance's parameters, built once and cached (see below).
  (2) **Intra-task data dependency** — a step's inputs are its
      predecessors' output activations, each detached into a leaf of its
      own that requires grad: the graph is cut at every step boundary, as
      the JAX engine's per-step ``jax.vjp`` closures cut it.
  (3) **Inter-task model dependency** — gradients of a shared instance
      are summed over all its per-task uses (the parameter device-group
      pool's all-reduce on hardware).
  (4) **Training step** — forward wave by wave, backward in *reverse wave
      order* (one ``torch.autograd.grad`` per recorded step, its output's
      cotangent in, its parameters' and inputs' gradients out), then the
      optimizer update.  The plan's order is the point: the backward is not
      one ``loss.backward()`` over a joined graph.

On one process the steps of a wave run one after another on the one
device: the code below with one rank, which holds every row, so nothing
moves and nothing is summed. With ``distributed=True`` in a
``torch.distributed`` world of more than one rank the engine is SPMD —
every rank runs the same plan, as the paper's runtime does with
per-group NCCL: plan device ``d`` is rank ``d``, and a step runs on its
**group**, its devices that are ranks of the live ``mesh`` (the lowest
live rank when none is). Its rows are split over the group
(:mod:`repro_torch.runtime.moves`: each task's batch contiguously when
the group size divides it, else all on the group's lowest rank; a
contrastive join, whose logits span the batch, always whole there).
Activations move between groups point to point before the step that
reads them, and their cotangents take the reverse route in the backward,
summed where several consumers read one activation. A decoder loss split
over ranks scales each rank's mean by its share of the rows. Every rank
of the live mesh keeps a whole replica of every instance: after the
backward each gradient is summed over the live mesh (ranks that did not
use an instance add zeros), so every replica takes the same update. The
loss is the sum of the ranks' parts, the same on every rank of the
world. A rank outside the live mesh (a flagged or dead host's) runs no
step, sums no gradient and skips the update.

Numerical contract (tested): ``loss_and_grads`` ≡ autograd of
``MTModel.reference_loss`` for ANY planner-produced plan, on one process
and on every rank.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt.straggler import world_size
from ..core.plan import ExecutionPlan, PlanStep
from ..parallel.collectives import all_reduce_, sum_grads
from .moves import Layout, Piece, Wire, pieces, row_layout
from .mtmodel import ExecComponent, MTModel


@dataclass
class _StepRecord:
    """One plan step as this rank saw it: the MetaOps it reads (by input
    position) and the pieces of each input, the local activations this
    rank sent rows of (their shapes size the cotangents coming back), and,
    when this rank ran a part of the step, its detached input leaves and
    its output (``out`` None otherwise)."""

    meta_id: int
    inst: str
    is_loss: bool
    srcs: List[int]
    moves: List[List[Piece]]
    sent_from: Dict[int, torch.Tensor]  # input position → local activation
    ins: List[torch.Tensor]
    out: Optional[torch.Tensor]


class WaveEngine:
    def __init__(self, model: MTModel, plan: ExecutionPlan, *,
                 distributed: bool = False, mesh: Any = None):
        self.model = model
        self.distributed = distributed and world_size() > 1
        #: the live mesh (a ``DeviceMesh`` over ranks; None: every rank)
        self.mesh = mesh
        # Step-closure cache, keyed by plan-id-independent step identity
        # (instance, component, layer range, predecessor roles) — survives
        # rebind() so replanned plans reuse closures for unchanged steps.
        self._fn_cache: Dict[Tuple, Callable] = {}
        # process groups by rank tuple, made once by every rank in the
        # same order (``dist.new_group`` is collective over the world)
        self._groups: Dict[Tuple[int, ...], Any] = {}
        #: plan steps and waves this rank ran a part of, since construction
        #: or the caller's last reset
        self.ran = {"steps": 0, "waves": 0}
        if self.distributed:
            self._check_plan(plan)
        self._bind(plan)

    # ------------------------------------------------------------------
    def _bind(self, plan: ExecutionPlan) -> None:
        """Derive all plan-dependent lookup structures."""
        if self.distributed:
            world = world_size()
            ranks = (range(world) if self.mesh is None
                     else self.mesh.mesh.flatten().tolist())
            self.me = dist.get_rank()
            self.live = tuple(sorted(r for r in ranks if r < world))
            self._world = dist.group.WORLD
            self._wire = Wire()
        else:  # one rank: every layout is {0: all rows}, nothing moves
            self.me, self.live, self._world, self._wire = 0, (0,), None, None
        self._sum_group = self._group(self.live)
        self.plan = plan
        self.mg = plan.meta_graph
        self._preds = self.mg.predecessors()
        self._succs = {m: set() for m in self.mg.meta_ops}
        for src, dsts in self.mg.edges.items():
            for d in dsts:
                self._succs[src].add(d)
        # meta → (instance, component, task string)
        self.meta_info: Dict[int, Tuple[str, str, str]] = {}
        for mid, m in self.mg.meta_ops.items():
            inst, comp, _, _ = self.model.op_info[m.op_ids[0]]
            self.meta_info[mid] = (inst, comp, m.task)
        # flow-order task list (merged-batch concat order)
        self.flow_order = [f.task for f in self.model.flows]

    def rebind(self, plan: ExecutionPlan, model: Optional[MTModel] = None,
               *, mesh: Any = None) -> Dict[str, int]:
        """Swap in a replanned/cached plan — and optionally a shifted model.

        Only the plan-derived lookups are rebuilt; the per-step closures in
        ``_fn_cache`` are keyed independently of MetaOp numbering, so steps
        whose (instance, layer range, inputs) identity is unchanged keep
        their closures.  Returns ``closures_cached`` — the number of
        closures retained for reuse.  With ``model`` (a task arrived or
        completed and the MTModel was rebuilt for the new task set) the
        engine rebinds to it and keeps the cache: closures resolve the
        model and the component spec at call time.  The plan is validated
        against the model BEFORE anything changes, so a raise leaves the
        engine on its previous (model, plan) pairing.  With ``mesh`` the
        engine also moves to that live mesh (every rank calls this).
        """
        ref_model = model if model is not None else self.model
        if plan.meta_graph is not self.mg or model is not None:
            for m in plan.meta_graph.meta_ops.values():
                if m.op_ids[0] not in ref_model.op_info:
                    raise ValueError(
                        "rebind: plan references operators unknown to this "
                        "model — replan against the same task graph first"
                    )
        if self.distributed:
            self._check_plan(plan)
        if model is not None:
            self.model = model
        if mesh is not None:
            self.mesh = mesh
        cached = len(self._fn_cache)
        self._bind(plan)
        return {"closures_cached": cached}

    # ------------------------------------------------------------------
    def param_device_groups(self) -> Dict[str, Tuple[int, ...]]:
        return self.plan.param_device_groups()

    def _layer_range(self, step: PlanStep) -> Tuple[int, int]:
        m = self.mg.meta_ops[step.meta_id]
        first = m.op_ids.index(step.op_ids[0])
        return first, first + len(step.op_ids)

    def _entry_preds(self, mid: int
                     ) -> Tuple[List[int], Tuple[Tuple[str, str], ...]]:
        """Ordered predecessor ids + their (task, component) roles, ordered
        by role with an id tiebreak, so the positional layout — and the
        cached closure — is stable across replans that renumber MetaOps."""
        preds = sorted(
            self._preds[mid],
            key=lambda p: (self.meta_info[p][2], self.meta_info[p][1], p),
        )
        pred_info = tuple(
            (self.meta_info[p][2], self.meta_info[p][1]) for p in preds)
        return preds, pred_info

    # ------------------------------------------------------------------
    def loss_and_grads(self, params, batches, *,
                       on_wave: Optional[Callable[[int, List[PlanStep]],
                                                  None]] = None):
        """Wave-by-wave forward + reverse-wave backward.  ``params`` is the
        instance ``ModuleDict``; returns (loss, grads), the loss a detached
        0-d tensor and ``grads`` a dict keyed like
        ``params.named_parameters()``.  On one process every step is this
        rank's whole and no move or sum runs.

        ``on_wave(wave_index, steps)`` fires after each forward wave — the
        session's observer hook for per-wave metrics."""
        dev = next(params.parameters()).device
        acts: Dict[int, torch.Tensor] = {}
        held: Dict[int, Layout] = {}
        records: List[_StepRecord] = []
        waves = self.plan.waves()
        with torch.enable_grad():
            for widx in sorted(waves):
                ran = 0
                for step in waves[widx]:
                    rec = self._forward_step(step, params, batches, acts, held)
                    records.append(rec)
                    ran += rec.out is not None
                self.ran["steps"] += ran
                self.ran["waves"] += ran > 0
                if on_wave is not None:
                    on_wave(widx, waves[widx])

            n_losses = sum(r.is_loss for r in records)
            parts = [r.out.detach() for r in records
                     if r.is_loss and r.out is not None]
            local = (torch.stack(parts).sum() if parts
                     else torch.zeros((), device=dev))

            # ------------- backward: reverse wave order -------------
            grads = {name: torch.zeros_like(p)
                     for name, p in params.named_parameters()}
            cot: Dict[int, torch.Tensor] = {}
            for rec in reversed(records):
                d_ins = self._backward_step(rec, params, grads, cot, n_losses)
                self._return_cotangents(rec, d_ins, cot)
        total = all_reduce_((local / n_losses).reshape(1), self._world)[0]
        if self.active:
            grads = sum_grads(grads, self._sum_group)
        return total, grads

    def _forward_step(self, step: PlanStep, params, batches,
                      acts: Dict[int, torch.Tensor],
                      held: Dict[int, Layout]) -> _StepRecord:
        """Moves the step's input rows to the ranks of its group and runs
        this rank's part of it."""
        me = self.me
        mid = step.meta_id
        inst, comp, task = self.meta_info[mid]
        c = self.model.components[comp]
        lo, hi = self._layer_range(step)
        m = self.mg.meta_ops[mid]
        is_loss = (not self._succs[mid] and hi == m.L
                   and c.kind in ("contrastive", "decoder"))
        layout = self._step_layout(step, batches)
        if lo == 0:
            srcs, pred_info = self._entry_preds(mid)
        else:
            srcs, pred_info = [mid], ()
        # the pieces of each input, for every consumer rank in rank order
        moves: List[List[Piece]] = []
        for p in srcs:
            ptasks = set(self.meta_info[p][2].split("+"))
            moves.append([
                pc for r in sorted(layout)
                for pc in pieces(held[p], r, [sg for sg in layout[r]
                                              if sg[0] in ptasks])])
        like = next(params[inst].parameters())
        sent_from: Dict[int, torch.Tensor] = {}
        ins: List[torch.Tensor] = []
        for i, p in enumerate(srcs):
            parts = []
            for pc in moves[i]:
                if pc.src == me:
                    sent_from[i] = acts[p]
                    rows = acts[p][pc.src_lo:pc.src_hi]
                    if pc.dst == me:
                        parts.append(rows)
                    else:
                        self._wire.send(rows, pc.dst, header=True)
                elif pc.dst == me:
                    parts.append(self._wire.recv(pc.src, like))
            if me in layout:
                x = parts[0] if len(parts) == 1 else torch.cat(parts)
                ins.append(x.detach().requires_grad_())
        held[mid] = layout
        out = None
        if me in layout:
            segs = layout[me]
            local = {t: {k: v[a:b] for k, v in batches[t].items()}
                     for t, a, b in segs}
            if lo == 0:
                fn = self._make_entry_fn(c, inst, pred_info, lo, hi, is_loss,
                                         task)
            else:
                fn = self._make_mid_fn(c, inst, lo, hi, is_loss, task)
            out = fn(local, params[inst], *ins)
            if is_loss and len(layout) > 1:
                # this rank's mean over its rows, weighted by their share
                total = sum(len(next(iter(batches[t].values())))
                            for t, _, _ in segs)
                out = out * (sum(b - a for _, a, b in segs) / total)
            if not is_loss:
                acts[mid] = out
        else:
            acts.pop(mid, None)
        return _StepRecord(mid, inst, is_loss, srcs, moves, sent_from, ins,
                           out)

    def _backward_step(self, rec: _StepRecord, params, grads,
                       cot: Dict[int, torch.Tensor],
                       n_losses: int) -> List[torch.Tensor]:
        """This rank's part of one step's backward (one
        ``torch.autograd.grad``): its parameters' gradients added to
        ``grads``; returns its inputs' cotangents."""
        mid = rec.meta_id
        if rec.out is None:
            return []
        if rec.is_loss:
            g_out = torch.full_like(rec.out, 1.0 / n_losses)
        elif mid in cot:
            g_out = cot.pop(mid)
        else:  # activation never used (defensive)
            return [torch.zeros_like(x) for x in rec.ins]
        named = list(params[rec.inst].named_parameters())
        pulls = torch.autograd.grad(rec.out, [p for _, p in named] + rec.ins,
                                    g_out, allow_unused=True)
        for (name, _), d in zip(named, pulls):
            if d is not None:
                grads[f"{rec.inst}.{name}"] += d
        return [torch.zeros_like(x) if d is None else d
                for x, d in zip(rec.ins, pulls[len(named):])]

    def _return_cotangents(self, rec: _StepRecord, d_ins: List[torch.Tensor],
                           cot: Dict[int, torch.Tensor]) -> None:
        """Each input piece's cotangent back to the rank that sent the
        rows, summed into its cotangent of that activation."""
        me = self.me
        for i, p in enumerate(rec.srcs):
            for pc in rec.moves[i]:
                if pc.dst == me:
                    g = d_ins[i][pc.dst_lo:pc.dst_hi]
                    if pc.src != me:
                        self._wire.send(g, pc.src, header=False)
                        continue
                elif pc.src == me:
                    act = rec.sent_from[i]
                    g = self._wire.recv(
                        pc.dst, act, (pc.src_hi - pc.src_lo, *act.shape[1:]))
                else:
                    continue
                if p not in cot:
                    cot[p] = torch.zeros_like(rec.sent_from[i])
                cot[p][pc.src_lo:pc.src_hi] += g

    # ------------------------------------------------- plan and rank groups
    @property
    def active(self) -> bool:
        """This rank is in the live mesh (always, on one process)."""
        return self.me in self.live

    def _check_plan(self, plan: ExecutionPlan) -> None:
        """Every rank must run the same plan: a digest of each step's
        (wave, MetaOp, operators, devices) is all-gathered and compared;
        a mismatch raises on every rank (rather than hanging in a move)."""
        items = [(w, s.meta_id, tuple(s.op_ids), tuple(s.devices))
                 for w, steps in sorted(plan.waves().items()) for s in steps]
        digest = hashlib.sha256(repr(items).encode()).digest()[:8]
        mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                            device=Wire().ctrl)
        parts = [torch.empty_like(mine) for _ in range(world_size())]
        dist.all_gather(parts, mine)
        if len({int(p) for p in parts}) > 1:
            raise RuntimeError("WaveEngine: the ranks hold different plans "
                               f"(digests {[int(p) for p in parts]})")

    def _group(self, ranks: Tuple[int, ...]):
        """The process group of ``ranks`` (None for one rank), made once."""
        if len(ranks) == 1:
            return None
        if ranks == tuple(range(world_size())):
            return dist.group.WORLD
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks))
        return self._groups[ranks]

    def _step_group(self, step: PlanStep) -> Tuple[int, ...]:
        """The ranks a step runs on: its devices in the live mesh, or the
        lowest live rank when none is."""
        live = set(self.live)
        return tuple(d for d in step.devices if d in live) or self.live[:1]

    def _step_layout(self, step: PlanStep, batches) -> Layout:
        """Which rows of the step's activation each rank of its group
        holds (:func:`repro_torch.runtime.moves.row_layout`)."""
        inst, comp, task = self.meta_info[step.meta_id]
        sizes = {t: len(next(iter(batches[t].values())))
                 for t in self._tasks_of(task)}
        whole = self.model.components[comp].kind == "contrastive"
        return row_layout(self._step_group(step), sizes, whole)

    # ------------------------------------------------------------------
    def _tasks_of(self, task_str: str) -> List[str]:
        return sorted(task_str.split("+"), key=self.flow_order.index)

    def _labels(self, batches, tasks: List[str]):
        if len(tasks) == 1:
            return batches[tasks[0]]["labels"]
        return torch.cat([batches[t]["labels"] for t in tasks], dim=0)

    def _make_entry_fn(self, c: ExecComponent, inst, pred_info, lo, hi,
                       is_loss, task_str):
        """Cached entry-step closure.  The key carries no MetaOp ids — only
        roles (instance, component, task set, predecessor (task, component)
        layout, layer range) — and ``batches`` is supplied at call time, so
        the closure survives rebind() across replans."""
        key = ("entry", inst, c.name, task_str, pred_info, lo, hi, is_loss)
        cached = self._fn_cache.get(key)
        if cached is not None:
            return cached
        # the model and the component spec are resolved at CALL time, so
        # rebind(model=...) never pins a retired model in the cache
        engine = self
        cname = c.name
        tasks = self._tasks_of(task_str)
        pos_by_task = {
            t: [i for i, (pt, _) in enumerate(pred_info) if pt == t]
            for t in tasks
        }

        def fn(batches, inst_params, *pred_acts):
            model = engine.model
            c = model.components[cname]
            if c.kind == "contrastive":
                inputs = {pc: a for (_, pc), a in zip(pred_info, pred_acts)}
                return model.loss_op(inst_params, c, inputs, batches[tasks[0]])
            # entry per task (merged components concat the union batch)
            hs = []
            for t in tasks:
                inputs = {pred_info[i][1]: pred_acts[i] for i in pos_by_task[t]}
                hs.append(model.entry(inst_params, c, inputs, batches[t]))
            h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=0)
            for lp in inst_params["layers"][lo:hi]:
                h = model.apply_layer(c, lp, h)
            if is_loss:
                return model.loss_op(inst_params, c, {},
                                     {"labels": engine._labels(batches, tasks)},
                                     h=h)
            return h

        self._fn_cache[key] = fn
        return fn

    def _make_mid_fn(self, c: ExecComponent, inst, lo, hi, is_loss, task_str):
        key = ("mid", inst, c.name, task_str, lo, hi, is_loss)
        cached = self._fn_cache.get(key)
        if cached is not None:
            return cached
        engine = self  # call-time model/spec lookup — see _make_entry_fn
        cname = c.name
        tasks = self._tasks_of(task_str)

        def fn(batches, inst_params, h):
            model = engine.model
            c = model.components[cname]
            for lp in inst_params["layers"][lo:hi]:
                h = model.apply_layer(c, lp, h)
            if is_loss:
                return model.loss_op(inst_params, c, {},
                                     {"labels": engine._labels(batches, tasks)},
                                     h=h)
            return h

        self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state, batches, optimizer, *,
                   on_wave=None):
        """One full §3.6 iteration: forward + backward wave by wave, then the
        optimizer update (in place on ``params``).  Returns (params, new
        optimizer state, loss).  A rank outside the live mesh takes no
        update."""
        loss, grads = self.loss_and_grads(params, batches, on_wave=on_wave)
        if not self.active:
            return params, opt_state, loss
        new_state = optimizer.update(grads, opt_state,
                                     dict(params.named_parameters()))
        return params, new_state, loss
