"""Executable MT MM models — the PyTorch counterpart of a TaskGraph (port
of ``repro/runtime/mtmodel.py``).

The planner (:mod:`repro_torch.core`) works on *workload* graphs; the
wave engine executes *this*: components with parameters and layer
functions, wired per task exactly like
:class:`repro_torch.core.graph.GraphBuilder` flows.  The same spec builds
both, so ``PlanStep.op_ids`` map 1:1 onto layer indices here.

Component kinds:
  * ``tower``       — modality encoder: (B, S, d_in) stub embeddings →
                      pre-norm (attn + SwiGLU) layers at width d.
  * ``decoder``     — causal LM join: tokens (B, S) + prefix conditioning
                      (sum of pooled, projected branch outputs added to every
                      position); final op computes the LM loss.
  * ``contrastive`` — CLIP-style join: two pooled branch embeddings →
                      symmetric InfoNCE loss (single op).

Sharing semantics mirror the paper (§2.1/§3.6): ``shared=True`` components
use ONE parameter instance across all activating tasks; ``merge_shared``
additionally merges the data flows into one chain over the union batch
(the execution-barrier case).

Parameters: one ``nn.Module`` per component *instance* (``"vision"`` for
a shared component, ``"img_text:contrastive"`` for a per-task one) in an
``nn.ModuleDict`` keyed by instance name; inside it the leaves nest as
the JAX pytree does (``layers.0.attn.wq``, ``proj.text``,
``logit_scale``), so :mod:`repro_torch.bridge` maps one onto the other by
name.  Attention is plain (``impl="naive"``), as the JAX model's is: the
wavefront path runs no kernel.

``reference_loss`` executes the whole model as one program — the numerical
contract the WaveEngine must match.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.graph import ComponentSpec, FlowSpec, GraphBuilder, TaskGraph
from ..core.workloads import loss_module_workload, transformer_layer_workload
from ..models.attention import attn_apply, attn_init
from ..models.layers import (cross_entropy, dense_init, embed_init,
                             embed_lookup, mlp_apply, mlp_init, rmsnorm,
                             rmsnorm_init)
from ..models.transformer import Leaves


@dataclass(frozen=True)
class ExecComponent:
    name: str
    kind: str  # tower | decoder | contrastive
    n_layers: int
    d_model: int
    n_heads: int = 4
    d_ff: int = 0  # 0 → 4·d
    d_in: int = 0  # 0 → d_model (input/stub width)
    vocab: int = 0  # decoders only
    shared: bool = False
    merge_shared: bool = False
    max_tp: int = 4

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.d_model


@dataclass(frozen=True)
class ExecFlow:
    task: str
    branches: Tuple[Tuple[str, ...], ...]
    join: Tuple[str, ...]
    batch_size: int
    seq_lens: Mapping[str, int] = field(default_factory=dict)

    def seq_for(self, comp: str, default: int = 16) -> int:
        return int(self.seq_lens.get(comp, default))


def _params(tree) -> nn.Module:
    """A pytree of tensors (nested dicts and lists) → modules of
    parameters: a list is an ``nn.ModuleList``, a dict of tensors an
    ``nn.ParameterDict``, any other dict a :class:`Leaves`."""
    if isinstance(tree, list):
        return nn.ModuleList(_params(v) for v in tree)
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return Leaves({k: nn.Parameter(v) if isinstance(v, torch.Tensor)
                   else _params(v) for k, v in tree.items()})


class MTModel:
    """Executable multi-task multi-modal model + its planner TaskGraph."""

    def __init__(self, components: Sequence[ExecComponent],
                 flows: Sequence[ExecFlow]):
        self.components = {c.name: c for c in components}
        self.flows = list(flows)
        self._validate()
        self._build_graph()

    def _validate(self) -> None:
        # merged components serve the union batch: every activating task
        # must agree on the sequence length (pad upstream, like OFASys)
        for c in self.components.values():
            if not c.merge_shared:
                continue
            seqs = {
                f.seq_for(c.name)
                for f in self.flows
                if c.name in (n for br in f.branches for n in br)
                or c.name in f.join
            }
            if len(seqs) > 1:
                raise ValueError(
                    f"merged component {c.name!r} sees unequal sequence "
                    f"lengths {sorted(seqs)}; pad tasks to a common length"
                )

    # ------------------------------------------------------------ graph link
    def _build_graph(self) -> None:
        """Build the planner TaskGraph and the op → (instance, layer) map."""
        specs = []
        for c in self.components.values():
            def wl(batch, seq, c=c):
                if c.kind == "contrastive":
                    return loss_module_workload(c.d_model, batch)
                return transformer_layer_workload(
                    c.d_model, c.ff, c.n_heads, batch, max(seq, 1)
                )

            specs.append(ComponentSpec(
                name=c.name, n_layers=c.n_layers,
                op_type=f"{c.kind}[{c.d_model}x{c.ff}]", workload_fn=wl,
                shared=c.shared, merge_shared=c.merge_shared,
                max_tp=c.max_tp,
            ))
        gb = GraphBuilder(specs)
        for f in self.flows:
            gb.add_flow(FlowSpec(
                task=f.task, branches=[list(b) for b in f.branches],
                join=list(f.join), batch_size=f.batch_size,
                seq_lens=dict(f.seq_lens),
            ))
        self.graph: TaskGraph = gb.build()

        # op_id → (instance, component, layer_idx, task); chains were built
        # in ascending op_id order per (task, component)
        chains: Dict[Tuple[str, str], List[int]] = {}
        for op_id in sorted(self.graph.nodes):
            n = self.graph.nodes[op_id]
            chains.setdefault((n.task, n.component), []).append(op_id)
        self.op_info: Dict[int, Tuple[str, str, int, str]] = {}
        for (task, comp), ops in chains.items():
            c = self.components[comp]
            inst = comp if (c.shared or c.merge_shared) else f"{task}:{comp}"
            for layer, op_id in enumerate(ops):
                self.op_info[op_id] = (inst, comp, layer, task)

    # ------------------------------------------------------------------ init
    def instances(self) -> List[str]:
        return sorted({info[0] for info in self.op_info.values()})

    def init(self, seed: int = 0, *, device) -> nn.ModuleDict:
        """One parameter module per component *instance*, drawn on the CPU
        from a generator seeded with ``(seed, instance index)`` and moved to
        ``device`` (the caller names it: ``"cuda"`` or ``"cpu"``)."""
        params = {}
        for i, inst in enumerate(self.instances()):
            c = self.components[inst.split(":")[-1]]
            gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
            params[inst] = _params(self._component_init(gen, c))
        return nn.ModuleDict(params).to(device)

    def _in_dims(self, comp: str) -> Dict[str, int]:
        """Predecessor-component → its output width (for in-projections)."""
        dims = {}
        for f in self.flows:
            seqs = [list(b) for b in f.branches] + [list(f.join)]
            for chain in seqs:
                for a, b in zip(chain, chain[1:]):
                    if b == comp:
                        dims[a] = self.components[a].d_model
            if comp in f.join and f.join and f.join[0] == comp:
                for b in f.branches:
                    if b:
                        dims[b[-1]] = self.components[b[-1]].d_model
        return dims

    def _component_init(self, gen: torch.Generator, c: ExecComponent):
        p: Dict[str, Any] = {}
        if c.kind == "contrastive":
            p["proj"] = {src: dense_init(gen, d, c.d_model)
                         for src, d in sorted(self._in_dims(c.name).items())}
            p["logit_scale"] = torch.tensor(math.log(10.0))
            return p
        if c.kind == "decoder":
            p["tok_embed"] = embed_init(gen, c.vocab or 256, c.d_model)
            p["lm_head"] = dense_init(gen, c.d_model, c.vocab or 256)
            p["prefix_proj"] = {
                src: dense_init(gen, d, c.d_model)
                for src, d in sorted(self._in_dims(c.name).items())}
        if c.kind == "tower" and c.d_in and c.d_in != c.d_model:
            p["in_proj"] = dense_init(gen, c.d_in, c.d_model)
        p["layers"] = [self._layer_init(gen, c) for _ in range(c.n_layers)]
        p["final_norm"] = rmsnorm_init(c.d_model)
        return p

    def _layer_init(self, gen: torch.Generator, c: ExecComponent):
        hd = c.d_model // c.n_heads
        return {
            "norm1": rmsnorm_init(c.d_model),
            "attn": attn_init(gen, c.d_model, c.n_heads, c.n_heads, hd),
            "norm2": rmsnorm_init(c.d_model),
            "mlp": mlp_init(gen, c.d_model, c.ff),
        }

    # --------------------------------------------------------------- layers
    def apply_layer(self, c: ExecComponent, lp, h):
        hd = c.d_model // c.n_heads
        y = attn_apply(
            lp["attn"], rmsnorm(lp["norm1"], h),
            n_heads=c.n_heads, n_kv=c.n_heads, head_dim=hd,
            rope_theta=1e4, causal=(c.kind == "decoder"), impl="naive",
        )
        h = h + y
        return h + mlp_apply(lp["mlp"], rmsnorm(lp["norm2"], h))

    def entry(self, inst_params, c: ExecComponent, inputs: Dict[str, Any],
              task_inputs: Dict[str, Any]):
        """Input activation for layer 0 of a component instance.

        ``inputs``: predecessor-component → (B, S, d) activation.
        ``task_inputs``: this task's raw batch dict."""
        if c.kind == "tower":
            if inputs:  # chained tower: previous component's output
                (src, h), = list(inputs.items())
                if "in_proj" in inst_params:
                    h = h @ inst_params["in_proj"]
                return h
            x = task_inputs[c.name]  # (B, S, d_in) stub embeddings
            if "in_proj" in inst_params:
                x = x @ inst_params["in_proj"]
            return x
        if c.kind == "decoder":
            h = embed_lookup(inst_params["tok_embed"], task_inputs["tokens"])
            prefix = torch.zeros((h.shape[0], c.d_model), dtype=torch.float32,
                                 device=h.device)
            for src, act in sorted(inputs.items()):
                pooled = act.mean(dim=1)  # (B, d_src)
                prefix = prefix + pooled @ inst_params["prefix_proj"][src]
            return h + prefix[:, None, :]
        raise ValueError(c.kind)

    def loss_op(self, inst_params, c: ExecComponent, inputs: Dict[str, Any],
                task_inputs: Dict[str, Any], h=None):
        """Terminal op: compute this task's scalar loss."""
        if c.kind == "contrastive":
            items = sorted(inputs.items())
            if len(items) != 2:
                raise ValueError("contrastive join needs exactly 2 branches")
            (sa, ha), (sb, hb) = items
            za = ha.mean(dim=1) @ inst_params["proj"][sa]
            zb = hb.mean(dim=1) @ inst_params["proj"][sb]
            za = za / (torch.linalg.vector_norm(za, dim=-1, keepdim=True)
                       + 1e-6)
            zb = zb / (torch.linalg.vector_norm(zb, dim=-1, keepdim=True)
                       + 1e-6)
            logits = za @ zb.T * torch.exp(inst_params["logit_scale"])
            labels = torch.arange(za.shape[0], device=za.device)
            return 0.5 * (cross_entropy(logits, labels)
                          + cross_entropy(logits.T, labels))
        if c.kind == "decoder":
            h = rmsnorm(inst_params["final_norm"], h)
            logits = h @ inst_params["lm_head"]
            return cross_entropy(logits, task_inputs["labels"])
        raise ValueError(c.kind)

    # ------------------------------------------------------------- reference
    def reference_loss(self, params, batches: Dict[str, Dict[str, Any]]):
        """Single-program execution of the full MT MM model.

        ``batches``: task → batch dict.  Returns the mean task loss (a 0-d
        tensor with its autograd graph) — the numerical contract for the
        WaveEngine.  Merged components process the union batch exactly
        like the engine does (concat in task order)."""
        losses = []
        merged_inputs: Dict[str, List[Tuple[str, str, Any, Any]]] = {}
        for f in self.flows:
            ti = batches[f.task]
            branch_out: Dict[str, Any] = {}
            for branch in f.branches:
                h, prev = None, None
                for comp in branch:
                    c = self.components[comp]
                    inst = comp if (c.shared or c.merge_shared) else f"{f.task}:{comp}"
                    ip = params[inst]
                    h = self.entry(ip, c, {} if prev is None else {prev: h}, ti)
                    for lp in ip["layers"]:
                        h = self.apply_layer(c, lp, h)
                    prev = comp
                if branch:
                    branch_out[branch[-1]] = h
            if not f.join:
                continue
            jname = f.join[0]
            jc = self.components[jname]
            if jc.merge_shared:
                merged_inputs.setdefault(jname, []).append(
                    (f.task, jname, branch_out, ti))
                continue
            inst = jname if jc.shared else f"{f.task}:{jname}"
            ip = params[inst]
            if jc.kind == "contrastive":
                losses.append(self.loss_op(ip, jc, branch_out, ti))
            else:
                h = self.entry(ip, jc, branch_out, ti)
                for lp in ip["layers"]:
                    h = self.apply_layer(jc, lp, h)
                losses.append(self.loss_op(ip, jc, branch_out, ti, h=h))

        # merged joins: union batch in flow order (the execution barrier)
        for jname, uses in merged_inputs.items():
            jc = self.components[jname]
            ip = params[jname]
            hs, tis = [], []
            for task, _, branch_out, ti in uses:
                hs.append(self.entry(ip, jc, branch_out, ti))
                tis.append(ti)
            h = torch.cat(hs, dim=0)
            for lp in ip["layers"]:
                h = self.apply_layer(jc, lp, h)
            labels = torch.cat([t["labels"] for t in tis], dim=0)
            losses.append(self.loss_op(ip, jc, {}, {"labels": labels}, h=h))
        return torch.stack(losses).mean()

    def reference_loss_and_grads(self, params, batches):
        """``reference_loss`` and its gradient with respect to every leaf
        of ``params`` (zeros for a leaf it does not reach), keyed like
        ``params.named_parameters()`` — what
        :meth:`repro_torch.runtime.engine.WaveEngine.loss_and_grads` must
        equal."""
        named = list(params.named_parameters())
        with torch.enable_grad():
            loss = self.reference_loss(params, batches)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(named, grads)}


# ---------------------------------------------------------------------------
# Canned demo models (small versions of the paper's three workloads)
# ---------------------------------------------------------------------------


def tiny_multitask_clip(n_tasks: int = 3, batch: int = 4, d: int = 32,
                        layers: Tuple[int, int] = (3, 2)
                        ) -> Tuple[MTModel, Dict]:
    """Small Multitask-CLIP: per-modality towers + shared contrastive joins."""
    towers = {
        "vision": ExecComponent("vision", "tower", layers[0], d * 2, 4, shared=True),
        "text": ExecComponent("text", "tower", layers[1], d, 4, shared=True),
        "audio": ExecComponent("audio", "tower", layers[1], d, 4, shared=True),
    }
    pairs = [("img_text", "vision", "text"), ("audio_text", "audio", "text"),
             ("audio_vision", "audio", "vision")][:n_tasks]
    loss_c = ExecComponent("contrastive", "contrastive", 1, d, shared=False)
    flows, seqs = [], {"vision": 9, "text": 5, "audio": 7}
    for task, ma, mb in pairs:
        flows.append(ExecFlow(task, ((ma,), (mb,)), ("contrastive",), batch,
                              {ma: seqs[ma], mb: seqs[mb]}))
    model = MTModel(list(towers.values()) + [loss_c], flows)
    return model, _demo_batches(model)


def tiny_ofasys(n_tasks: int = 3, batch: int = 4, d: int = 32
                ) -> Tuple[MTModel, Dict]:
    """Small OFASys: modality adaptors → ONE merged decoder (barrier case)."""
    comps = [
        ExecComponent("vis_ad", "tower", 2, d, 4, shared=True),
        ExecComponent("aud_ad", "tower", 3, d + 16, 4, shared=True),
        ExecComponent("txt_ad", "tower", 1, d, 4, shared=True),
        ExecComponent("lm", "decoder", 3, d, 4, vocab=97, shared=True,
                      merge_shared=True),
    ]
    tasks = [("caption", "vis_ad"), ("asr", "aud_ad"), ("summ", "txt_ad")][:n_tasks]
    flows = [ExecFlow(t, ((ad,),), ("lm",), batch, {ad: 6, "lm": 8})
             for t, ad in tasks]
    model = MTModel(comps, flows)
    return model, _demo_batches(model)


def _demo_batches(model: MTModel, seed: int = 0) -> Dict[str, Dict[str, Any]]:
    """Per-task batches on the CPU: tower stub embeddings from a numpy
    generator seeded with (seed, flow index, CRC of the component name),
    decoder tokens from (seed, flow index, 1) — the same values in every
    process (the JAX version seeds with the salted ``hash(comp)``)."""
    out = {}
    for i, f in enumerate(model.flows):
        b: Dict[str, Any] = {}
        for branch in f.branches:
            comp = branch[0]
            c = model.components[comp]
            if c.kind == "tower":
                rng = np.random.default_rng(
                    [seed, i, zlib.crc32(comp.encode())])
                x = rng.standard_normal(
                    (f.batch_size, f.seq_for(comp), c.d_in or c.d_model),
                    np.float32)
                b[comp] = torch.from_numpy(x)
        for jn in f.join:
            c = model.components[jn]
            if c.kind == "decoder":
                rng = np.random.default_rng([seed, i, 1])
                toks = torch.from_numpy(rng.integers(
                    0, c.vocab or 256, size=(f.batch_size, f.seq_for(jn) + 1)))
                b["tokens"], b["labels"] = toks[:, :-1], toks[:, 1:]
        out[f.task] = b
    return out
