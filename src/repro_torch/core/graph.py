"""Unified multi-task computation graph (Spindle §3, "Problem Formulation").

Spindle interprets the input tasks as a unified DAG ``G = (V, E)`` where each
node is a computational operator and each edge is a data flow.  Tasks activate
specific operators with unique data flows; components shared across tasks
either appear as a single merged operator chain (batch = union of activating
tasks, creating the execution barrier described in §1) or as per-task replicas
linked through a shared ``param_group`` (synchronized by the runtime engine,
§3.6 step 3).

The graph here is a *workload* graph: each operator carries enough
information (flops / bytes / params / comm volumes) for the scalability
estimator to derive scaling curves, and enough structure (op_type +
input_size) for graph contraction to fuse identical chains into MetaOps.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set


@dataclass(frozen=True)
class OpWorkload:
    """Per-operator workload characterization (one layer's worth).

    All quantities are for a *single* execution of the operator over its full
    input batch (not per device).
    """

    flops: float  # forward+backward FLOPs for training; fwd-only for serving
    bytes_hbm: float  # HBM traffic (weights + activations), fwd+bwd
    param_bytes: float  # parameter footprint (for memory balancing)
    act_bytes: float  # boundary activation size (inter-op data-flow volume)
    tp_comm_bytes: float = 0.0  # per-layer TP collective payload at tp=1 basis

    def scaled(self, factor: float) -> "OpWorkload":
        return OpWorkload(
            flops=self.flops * factor,
            bytes_hbm=self.bytes_hbm * factor,
            param_bytes=self.param_bytes,
            act_bytes=self.act_bytes * factor,
            tp_comm_bytes=self.tp_comm_bytes * factor,
        )


@dataclass(frozen=True)
class OpNode:
    """One operator in the unified computation graph ``G``."""

    op_id: int
    op_type: str  # e.g. "transformer_layer[d=1024,h=16]" — equality ⇒ identical workload
    task: str  # owning task (or "+"-joined set for merged shared components)
    component: str  # model component this op belongs to (e.g. "text_encoder")
    workload: OpWorkload
    # Batch/sequence of the data flow through this op; used for valid-alloc
    # divisibility constraints (§3.3 "valid" allocations).
    batch_size: int = 1
    seq_len: int = 1
    # Ops sharing parameters across tasks carry the same param_group; the
    # runtime engine's parameter device-group pool is keyed off this.
    param_group: Optional[str] = None
    # Maximum tensor-parallel degree this op supports (e.g. #kv heads).
    max_tp: int = 1


@dataclass
class TaskGraph:
    """The unified DAG ``G = (V, E)`` plus task metadata."""

    nodes: Dict[int, OpNode] = field(default_factory=dict)
    # adjacency: edges[i] = set of successor op_ids
    edges: Dict[int, Set[int]] = field(default_factory=dict)
    tasks: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------ build
    def add_node(self, node: OpNode) -> int:
        if node.op_id in self.nodes:
            raise ValueError(f"duplicate op_id {node.op_id}")
        self.nodes[node.op_id] = node
        self.edges.setdefault(node.op_id, set())
        return node.op_id

    def add_edge(self, src: int, dst: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge ({src},{dst}) references unknown node")
        if src == dst:
            raise ValueError("self-loop")
        self.edges[src].add(dst)

    # ---------------------------------------------------------------- queries
    def in_degree(self) -> Dict[int, int]:
        deg = {i: 0 for i in self.nodes}
        for src, dsts in self.edges.items():
            for d in dsts:
                deg[d] += 1
        return deg

    def predecessors(self) -> Dict[int, Set[int]]:
        preds: Dict[int, Set[int]] = {i: set() for i in self.nodes}
        for src, dsts in self.edges.items():
            for d in dsts:
                preds[d].add(src)
        return preds

    def topological_order(self) -> List[int]:
        deg = self.in_degree()
        # Deterministic order: stable by op_id among ready nodes.
        ready = sorted([i for i, d in deg.items() if d == 0])
        order: List[int] = []
        while ready:
            i = ready.pop(0)
            order.append(i)
            for j in sorted(self.edges[i]):
                deg[j] -= 1
                if deg[j] == 0:
                    # insert keeping `ready` sorted for determinism
                    import bisect

                    bisect.insort(ready, j)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def validate(self) -> None:
        self.topological_order()  # raises on cycles
        for src, dsts in self.edges.items():
            for d in dsts:
                if d not in self.nodes:
                    raise KeyError(f"dangling edge ({src},{d})")


# --------------------------------------------------------------------------
# Builder API — the analogue of the paper's SpindleTask + add_flow.
# --------------------------------------------------------------------------


@dataclass
class ComponentSpec:
    """A model component (e.g. a modality encoder): ``n_layers`` identical ops.

    ``workload_fn(batch, seq)`` returns the per-layer OpWorkload for a given
    data flow size, letting the same component express different workloads for
    different tasks (inter-task heterogeneity).
    """

    name: str
    n_layers: int
    op_type: str
    workload_fn: "WorkloadFn"
    shared: bool = False  # shared across tasks (parameter sharing)
    merge_shared: bool = False  # merge data flows into one chain (barrier)
    max_tp: int = 8


WorkloadFn = "Callable[[int, int], OpWorkload]"


@dataclass
class FlowSpec:
    """One task's data flow: an ordered chain of component names.

    ``branches`` allows multi-tower tasks (e.g. CLIP image+text towers that
    join at a cross-modal module): each branch is a chain, and all branches
    feed the ``join`` chain.
    """

    task: str
    branches: List[List[str]]
    join: List[str] = field(default_factory=list)
    batch_size: int = 1
    seq_lens: Mapping[str, int] = field(default_factory=dict)  # per component

    def seq_for(self, component: str, default: int = 1) -> int:
        return int(self.seq_lens.get(component, default))


class GraphBuilder:
    """Builds the unified DAG from components + per-task flows.

    This mirrors Spindle's user-facing API (SpindleTask / add_flow): users
    declare components once and wire them per task; shared components are
    either merged (one chain serving the union batch — the execution barrier
    case) or replicated per task with a common param_group (the runtime
    engine synchronizes gradients across the group).
    """

    def __init__(self, components: Sequence[ComponentSpec]):
        self.components = {c.name: c for c in components}
        self.flows: List[FlowSpec] = []
        self._ids = itertools.count()

    def add_flow(self, flow: FlowSpec) -> None:
        for chain in list(flow.branches) + [flow.join]:
            for name in chain:
                if name not in self.components:
                    raise KeyError(f"unknown component {name!r} in task {flow.task!r}")
        self.flows.append(flow)

    # ------------------------------------------------------------------
    def build(self) -> TaskGraph:
        g = TaskGraph(tasks=[f.task for f in self.flows])
        # For merged shared components we instantiate the chain once with the
        # union batch; map component -> (chain op_ids) lazily.
        merged_chains: Dict[str, List[int]] = {}

        def make_chain(
            comp: ComponentSpec, task: str, batch: int, seq: int
        ) -> List[int]:
            pg = comp.name if comp.shared else None
            ids = []
            for layer in range(comp.n_layers):
                oid = next(self._ids)
                g.add_node(
                    OpNode(
                        op_id=oid,
                        op_type=comp.op_type,
                        task=task,
                        component=comp.name,
                        workload=comp.workload_fn(batch, seq),
                        batch_size=batch,
                        seq_len=seq,
                        param_group=pg,
                        max_tp=comp.max_tp,
                    )
                )
                if ids:
                    g.add_edge(ids[-1], oid)
                ids.append(oid)
            return ids

        def chain_for(comp_name: str, flow: FlowSpec) -> List[int]:
            comp = self.components[comp_name]
            seq = flow.seq_for(comp_name)
            if comp.merge_shared:
                if comp_name not in merged_chains:
                    # union batch over all tasks that activate this component
                    total_batch = 0
                    seqs = []
                    for f in self.flows:
                        names = set(itertools.chain(*f.branches)) | set(f.join)
                        if comp_name in names:
                            total_batch += f.batch_size
                            seqs.append(f.seq_for(comp_name))
                    tasks = "+".join(
                        f.task
                        for f in self.flows
                        if comp_name
                        in (set(itertools.chain(*f.branches)) | set(f.join))
                    )
                    merged_chains[comp_name] = make_chain(
                        comp, tasks, total_batch, max(seqs) if seqs else 1
                    )
                return merged_chains[comp_name]
            return make_chain(comp, flow.task, flow.batch_size, seq)

        for flow in self.flows:
            branch_tails: List[int] = []
            for branch in flow.branches:
                prev_tail: Optional[int] = None
                for comp_name in branch:
                    ids = chain_for(comp_name, flow)
                    if prev_tail is not None and ids:
                        # merged chains may already have this edge; set dedups
                        g.add_edge(prev_tail, ids[0])
                    if ids:
                        prev_tail = ids[-1]
                if prev_tail is not None:
                    branch_tails.append(prev_tail)
            prev_tail = None
            for comp_name in flow.join:
                ids = chain_for(comp_name, flow)
                if ids:
                    if prev_tail is None:
                        for t in branch_tails:
                            g.add_edge(t, ids[0])
                    else:
                        g.add_edge(prev_tail, ids[0])
                    prev_tail = ids[-1]
        g.validate()
        return g
