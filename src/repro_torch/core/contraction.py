"""Graph contraction: ``G`` → MetaGraph of MetaOps + MetaLevels (Spindle §3.1).

Two operators ``i → j`` contract into one MetaOp iff
  (1) ``⟨i,j⟩ ∈ E`` with out-degree(i) == 1 and in-degree(j) == 1
      (direct predecessor/successor), and
  (2) they share the same operator type and input data size
      (identical workloads).

We traverse ``G`` in topological order, contracting until no pair matches;
the result is the MetaGraph ``G_M`` whose nodes are MetaOps of ``L_m``
consecutive identical operators.  MetaOps are then assigned *MetaLevels* by
BFS depth over ``G_M`` so that MetaOps within one level are mutually
independent (§3.1 "Disentangling MetaOp Dependency with MetaLevels").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .graph import OpWorkload, TaskGraph


@dataclass
class MetaOp:
    """``L_m`` consecutive identical operators contracted from ``G``."""

    meta_id: int
    op_type: str
    task: str
    component: str
    op_ids: List[int]  # the constituent operator ids, in execution order
    workload: OpWorkload  # per-operator workload (all ops identical)
    batch_size: int
    seq_len: int
    param_group: Optional[str]
    max_tp: int
    level: int = -1  # MetaLevel, assigned by assign_levels()

    @property
    def L(self) -> int:
        return len(self.op_ids)

    @property
    def name(self) -> str:
        return f"{self.task}/{self.component}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"MetaOp({self.meta_id}:{self.name} L={self.L} lvl={self.level})"


@dataclass
class MetaGraph:
    """Contracted MetaGraph ``G_M = (V_M, E_M)`` with level structure."""

    meta_ops: Dict[int, MetaOp] = field(default_factory=dict)
    edges: Dict[int, Set[int]] = field(default_factory=dict)

    def predecessors(self) -> Dict[int, Set[int]]:
        preds: Dict[int, Set[int]] = {i: set() for i in self.meta_ops}
        for src, dsts in self.edges.items():
            for d in dsts:
                preds[d].add(src)
        return preds

    def levels(self) -> List[List[MetaOp]]:
        """MetaOps grouped by MetaLevel, ascending."""
        if not self.meta_ops:
            return []
        n_levels = max(m.level for m in self.meta_ops.values()) + 1
        out: List[List[MetaOp]] = [[] for _ in range(n_levels)]
        for m in self.meta_ops.values():
            out[m.level].append(m)
        for lvl in out:
            lvl.sort(key=lambda m: m.meta_id)
        return out

    def validate(self) -> None:
        preds = self.predecessors()
        for mid, m in self.meta_ops.items():
            for p in preds[mid]:
                if self.meta_ops[p].level >= m.level:
                    raise AssertionError(
                        f"level order violated: {p}(lvl {self.meta_ops[p].level})"
                        f" -> {mid}(lvl {m.level})"
                    )


def contract(graph: TaskGraph) -> MetaGraph:
    """Contract ``graph`` into a MetaGraph per the §3.1 criteria."""
    graph.validate()
    preds = graph.predecessors()
    out_deg = {i: len(d) for i, d in graph.edges.items()}
    in_deg = {i: len(p) for i, p in preds.items()}

    # Union-find-ish chain assembly: walk topological order; a node j joins
    # its predecessor i's chain iff the contraction criteria hold.
    chain_of: Dict[int, int] = {}  # op_id -> chain head op_id
    chains: Dict[int, List[int]] = {}  # head -> member op list (ordered)

    for op_id in graph.topological_order():
        node = graph.nodes[op_id]
        joined = False
        if in_deg[op_id] == 1:
            (p,) = preds[op_id]
            pnode = graph.nodes[p]
            if (
                out_deg[p] == 1
                and pnode.op_type == node.op_type
                and pnode.batch_size == node.batch_size
                and pnode.seq_len == node.seq_len
                and pnode.component == node.component
                and pnode.task == node.task
            ):
                head = chain_of[p]
                chain_of[op_id] = head
                chains[head].append(op_id)
                joined = True
        if not joined:
            chain_of[op_id] = op_id
            chains[op_id] = [op_id]

    mg = MetaGraph()
    head_to_meta: Dict[int, int] = {}
    for meta_id, (head, members) in enumerate(sorted(chains.items())):
        node = graph.nodes[head]
        mg.meta_ops[meta_id] = MetaOp(
            meta_id=meta_id,
            op_type=node.op_type,
            task=node.task,
            component=node.component,
            op_ids=list(members),
            workload=node.workload,
            batch_size=node.batch_size,
            seq_len=node.seq_len,
            param_group=node.param_group,
            max_tp=node.max_tp,
        )
        head_to_meta[head] = meta_id
        mg.edges[meta_id] = set()

    # Meta edges: any G-edge crossing chain boundaries.
    for src, dsts in graph.edges.items():
        ms = head_to_meta[chain_of[src]]
        for d in dsts:
            md = head_to_meta[chain_of[d]]
            if ms != md:
                mg.edges[ms].add(md)

    assign_levels(mg)
    mg.validate()
    return mg


def assign_levels(mg: MetaGraph) -> None:
    """BFS-depth MetaLevel assignment (§3.1).

    level(m) = 1 + max(level(pred)); sources get level 0.  This is the
    longest-path depth, which (unlike plain BFS hop count) guarantees no
    dependencies within a level even for skip edges.
    """
    preds = mg.predecessors()
    order = _topo_order(mg)
    for mid in order:
        ps = preds[mid]
        mg.meta_ops[mid].level = 0 if not ps else 1 + max(
            mg.meta_ops[p].level for p in ps
        )


def _topo_order(mg: MetaGraph) -> List[int]:
    in_deg = {i: 0 for i in mg.meta_ops}
    for src, dsts in mg.edges.items():
        for d in dsts:
            in_deg[d] += 1
    ready = sorted(i for i, d in in_deg.items() if d == 0)
    order: List[int] = []
    while ready:
        i = ready.pop(0)
        order.append(i)
        for j in sorted(mg.edges[i]):
            in_deg[j] -= 1
            if in_deg[j] == 0:
                import bisect

                bisect.insort(ready, j)
    if len(order) != len(mg.meta_ops):
        raise ValueError("MetaGraph has a cycle")
    return order
