"""WaveEngine — executes a Spindle ExecutionPlan on an MTModel (§3.6; port
of the single-process ``repro/runtime/engine.py``).

The paper's four runtime steps, on one process:

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

Steps of one wave run one after another on the one device; dispatching
them onto disjoint device groups (and the parameter broadcast and
activation transfers between groups) comes with the distributed
WaveEngine (ROADMAP queue 1, item 5d).

Numerical contract (tested): ``loss_and_grads`` ≡ autograd of
``MTModel.reference_loss`` for ANY planner-produced plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..core.plan import ExecutionPlan, PlanStep
from .mtmodel import ExecComponent, MTModel


@dataclass
class _StepRecord:
    meta_id: int
    inst: str
    kind: str  # entry | mid
    pred_order: List[int]  # meta_ids whose activations were inputs
    ins: List[torch.Tensor]  # the detached input leaves
    out: torch.Tensor
    is_loss: bool


class WaveEngine:
    def __init__(self, model: MTModel, plan: ExecutionPlan):
        self.model = model
        # Step-closure cache, keyed by plan-id-independent step identity
        # (instance, component, layer range, predecessor roles) — survives
        # rebind() so replanned plans reuse closures for unchanged steps.
        self._fn_cache: Dict[Tuple, Callable] = {}
        self._bind(plan)

    # ------------------------------------------------------------------
    def _bind(self, plan: ExecutionPlan) -> None:
        """Derive all plan-dependent lookup structures."""
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

    def rebind(self, plan: ExecutionPlan,
               model: Optional[MTModel] = None) -> Dict[str, int]:
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
        engine on its previous (model, plan) pairing.
        """
        ref_model = model if model is not None else self.model
        if plan.meta_graph is not self.mg or model is not None:
            for m in plan.meta_graph.meta_ops.values():
                if m.op_ids[0] not in ref_model.op_info:
                    raise ValueError(
                        "rebind: plan references operators unknown to this "
                        "model — replan against the same task graph first"
                    )
        if model is not None:
            self.model = model
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
        ``params.named_parameters()``.

        ``on_wave(wave_index, steps)`` fires after each forward wave — the
        session's observer hook for per-wave metrics."""
        model = self.model
        acts: Dict[int, torch.Tensor] = {}
        records: List[_StepRecord] = []
        waves = self.plan.waves()
        with torch.enable_grad():
            for widx in sorted(waves):
                for step in waves[widx]:
                    records.append(self._forward_step(step, params, batches,
                                                      acts))
                if on_wave is not None:
                    on_wave(widx, waves[widx])

            losses = [r.out for r in records if r.is_loss]
            n_losses = len(losses)
            total = torch.stack([l.detach() for l in losses]).sum() / n_losses

            # ------------- backward: reverse wave order -------------
            leaves = {inst: list(params[inst].named_parameters())
                      for inst in {r.inst for r in records}}
            grads = {name: torch.zeros_like(p)
                     for name, p in params.named_parameters()}
            cot: Dict[int, torch.Tensor] = {}
            for rec in reversed(records):
                mid = rec.meta_id
                if rec.is_loss:
                    g_out = torch.full_like(rec.out, 1.0 / n_losses)
                elif mid in cot:
                    g_out = cot.pop(mid)
                else:
                    continue  # activation never used (defensive)
                named = leaves[rec.inst]
                pulls = torch.autograd.grad(
                    rec.out, [p for _, p in named] + rec.ins, g_out,
                    allow_unused=True)
                for (name, _), d in zip(named, pulls):
                    if d is not None:
                        grads[f"{rec.inst}.{name}"] += d
                d_ins = pulls[len(named):]
                srcs = [mid] if rec.kind == "mid" else rec.pred_order
                for p, d in zip(srcs, d_ins):
                    if d is not None:
                        cot[p] = cot[p] + d if p in cot else d
        return total, grads

    def _forward_step(self, step: PlanStep, params, batches,
                      acts: Dict[int, torch.Tensor]) -> _StepRecord:
        mid = step.meta_id
        inst, comp, task = self.meta_info[mid]
        c = self.model.components[comp]
        lo, hi = self._layer_range(step)
        m = self.mg.meta_ops[mid]
        is_loss = (not self._succs[mid] and hi == m.L
                   and c.kind in ("contrastive", "decoder"))
        if lo == 0:
            preds, pred_info = self._entry_preds(mid)
            ins = [acts[p].detach().requires_grad_() for p in preds]
            fn = self._make_entry_fn(c, inst, pred_info, lo, hi, is_loss,
                                     task)
            kind = "entry"
        else:
            preds = []
            ins = [acts[mid].detach().requires_grad_()]
            fn = self._make_mid_fn(c, inst, lo, hi, is_loss, task)
            kind = "mid"
        out = fn(batches, params[inst], *ins)
        if not is_loss:
            acts[mid] = out
        return _StepRecord(mid, inst, kind, preds, ins, out, is_loss)

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
        optimizer state, loss)."""
        loss, grads = self.loss_and_grads(params, batches, on_wave=on_wave)
        new_state = optimizer.update(grads, opt_state,
                                     dict(params.named_parameters()))
        return params, new_state, loss
