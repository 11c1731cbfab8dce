"""The collectives of the port's SPMD regions, as autograd functions.

JAX gets these from ``shard_map`` and GSPMD; here every rank holds local
tensors and calls ``torch.distributed`` on explicit groups
(:func:`repro_torch.parallel.mesh.axis_group`).  ``shard_map``'s
transpose rules decide the gradients, so each function states its own:

* :func:`replicated_in` — a value replicated over a group entering a
  region whose ranks compute different parts (the MoE layer's tokens and
  router weight over ``"model"``): identity forward; backward sums the
  cotangent over the group, as the transpose of a replicated input does.
* :func:`sum_out` — partial results leaving such a region (``psum``): SUM
  all-reduce forward; identity backward (every rank already holds the
  whole cotangent of the replicated sum).
* :func:`mean_over_replicas` — ``pmean`` over ranks that hold copies of
  one computation (the aux loss over ``"model"``): mean forward; backward
  divides the cotangent by the group size, so that a
  :func:`replicated_in` sum of it counts the value once.
* :func:`mean_over_shards` — ``pmean`` over ranks that hold different
  batch shards (the aux loss over the batch axes): mean forward; identity
  backward.  The data-parallel sync (:func:`mean_grads`) divides every
  gradient by the group size already: dividing here too would average
  the aux loss's gradient twice.
* :func:`gather_shards` — the FSDP pair: a tensor split along ``dim``
  over a group, all-gathered whole just before its use; backward
  reduce-scatters (SUMs) the cotangent back onto each rank's slice.  A
  placed parameter enters its layer through it over its data axes (the
  caller divides the summed gradient by the batch axes' size), and a
  projection whose ``"model"`` shard splits a head through it over
  ``"model"``.  Under gloo, which has no reduce-scatter of CUDA tensors
  to rely on, the scatter is a SUM all-reduce and a slice (twice the
  bytes of a ring reduce-scatter); under NCCL it is
  ``reduce_scatter_tensor``.  The choice follows from the group's
  backend, never from an error.
* :func:`sum_scatter` — the transpose of :func:`gather_shards`: partial
  sums of a row-parallel product (each rank's block of the contracted
  dim) reduce-scattered onto this rank's slice of the output dim;
  backward all-gathers the cotangent (every rank's partial product
  feeds every slice).  The Griffin block's input and gate projections
  leave through it onto each rank's own features.
* :func:`take_shard` and :func:`gather_alike` — a value every rank of the
  group holds alike (and computes alike from) cut to this rank's slice
  along ``dim`` (backward all-gathers the cotangent), and its inverse
  (all-gather forward; backward this rank's slice of the cotangent,
  which every rank holds whole and alike).  Megatron-SP enters and
  leaves its split of the residual stream through them.
* :func:`sum_over_shards` — a per-rank sum that every batch shard's loss
  then holds whole (the global-batch MoE's per-expert sums): SUM
  all-reduce forward; backward the cotangent times the group size, so
  that :func:`mean_grads`' division leaves the global value's gradient
  whole.
* :func:`tp_in` and :func:`tp_out` — the entry and exit of a
  tensor-parallel region of one :class:`~repro_torch.parallel.mesh.
  ModelShard`: :func:`replicated_in` and :func:`sum_out`, or under
  Megatron-SP (``tp.seq``) nothing and :func:`sum_scatter` along the
  sequence (dim 1): the layer has gathered the region's input with
  :func:`gather_shards`, whose reduce-scatter sums each rank's partial
  cotangent, so a use of the input that every rank computes alike must
  not enter through :func:`replicated_in` there.

Without a group (a size-1 axis) each is the identity.  Ranks that share
one card run the ``gloo`` backend with CUDA tensors: on the H100 (torch
2.11) gloo carries all-reduce (SUM and MAX; fp32, bf16, int32),
broadcast and all-gather of CUDA tensors itself, so nothing here is
staged through a host copy by hand (gloo copies through the host
internally).  DTensor's own redistribution (``full_tensor()``) did not
return under gloo with CUDA tensors there, so the port never redistributes
a DTensor: :func:`full_tensor` gathers with ``all_gather``.  Gloo has no
``ReduceOp.AVG``: a mean is a SUM all-reduce and a division.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


#: bytes this process has sent into each collective (its tensors' sizes),
#: and as the payload of the wavefront engine's point-to-point moves
#: (:class:`repro_torch.runtime.moves.Wire`), since the last
#: :func:`reset_traffic`
TRAFFIC = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
           "moves": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (none: the identity)."""
    if group is not None:
        TRAFFIC["all_reduce"] += t.numel() * t.element_size()
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    src = t.contiguous()
    TRAFFIC["all_gather"] += src.numel() * src.element_size()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_sum(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``t`` SUMmed over ``group``, this rank's slice along ``dim`` (its
    size divided by the group's, in group-rank order).  Counted under
    ``"reduce_scatter"``: under gloo the SUM all-reduce's whole tensor."""
    if group is None:
        return t
    n, r = dist.get_world_size(group), dist.get_rank(group)
    src = t.movedim(dim, 0).contiguous()
    TRAFFIC["reduce_scatter"] += src.numel() * src.element_size()
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=group)
    else:
        src = src.clone()  # the cotangent may be shared: reduce a copy
        dist.all_reduce(src, group=group)
        out = src.chunk(n)[r].contiguous()
    return out.movedim(0, dim)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group, ctx.dim), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The FSDP pair (see the module doc): all-gather forward,
    reduce-scatter backward."""
    return x if group is None else _GatherShards.apply(x, group, dim)


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


def sum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Partial sums onto this rank's slice along ``dim`` (see the module
    doc): reduce-scatter forward, all-gather backward."""
    return x if group is None else _SumScatter.apply(x, group, dim)


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None


def take_shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a value the group holds alike
    (see the module doc): slice forward, all-gather backward."""
    return x if group is None else _TakeShard.apply(x, group, dim)


def gather_alike(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's slices along ``dim`` gathered into a value every rank
    then uses alike (see the module doc): all-gather forward, this rank's
    slice of the cotangent backward."""
    return x if group is None else _GatherAlike.apply(x, group, dim)


def tp_in(x: torch.Tensor, tp) -> torch.Tensor:
    """The entry of ``tp``'s tensor-parallel region (see the module doc)."""
    if tp is None or tp.seq:
        return x
    return replicated_in(x, tp.group)


def tp_out(y: torch.Tensor, tp) -> torch.Tensor:
    """The exit of ``tp``'s tensor-parallel region: the partial sums
    all-reduced, or under Megatron-SP reduce-scattered onto this rank's
    positions (dim 1)."""
    if tp is None:
        return y
    return sum_scatter(y, tp.group, 1) if tp.seq else sum_out(y, tp.group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """MAX all-reduce of a detached copy of ``x`` (no gradient: the
    log-sum-exp shifts it feeds are invariant to it)."""
    return all_reduce_(x.detach().clone(), group, dist.ReduceOp.MAX)


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_reduce_(x.clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _SumOverShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


class _MeanOverShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return all_reduce_(x.clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReplicatedIn.apply(x, group)


def sum_out(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOut.apply(x, group)


def mean_over_replicas(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return x if group is None else _MeanOverReplicas.apply(x, group, n)


def mean_over_shards(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return x if group is None else _MeanOverShards.apply(x, group, n)


def sum_over_shards(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return x if group is None else _SumOverShards.apply(x, group, n)


#: elements of one all-reduce bucket of :func:`mean_grads`
BUCKET = 1 << 26


def _buckets(ts: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``ts`` in runs of one dtype and at most :data:`BUCKET`
    elements (a larger tensor is a bucket of its own)."""
    out: List[List[int]] = []
    size, dtype = 0, None
    for i, t in enumerate(ts):
        if not out or t.dtype != dtype or size + t.numel() > BUCKET:
            out.append([])
            size, dtype = 0, t.dtype
        out[-1].append(i)
        size += t.numel()
    return out


def sum_grads(grads: Dict[str, torch.Tensor],
              group) -> Dict[str, torch.Tensor]:
    """Each gradient SUM all-reduced over ``group``, in buckets of
    :data:`BUCKET` elements (one call each).  Returns new tensors."""
    if group is None:
        return dict(grads)
    names = list(grads)
    ts = [grads[k] for k in names]
    out: Dict[str, torch.Tensor] = {}
    for idx in _buckets(ts):
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        all_reduce_(flat, group)
        for i, piece in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[names[i]] = piece.view_as(ts[i])
    return out


def mean_grads(grads: Dict[str, torch.Tensor], group,
               n: int) -> Dict[str, torch.Tensor]:
    """The data-parallel sync: :func:`sum_grads` over the batch-axes
    ``group``, each gradient divided by its size ``n``."""
    out = sum_grads(grads, group)
    if group is not None:
        for g in out.values():
            g /= n
    return out


def sharded_norm(grads: Dict[str, torch.Tensor],
                 axes: Dict[str, Tuple[str, ...]], mesh) -> torch.Tensor:
    """√(Σ‖g‖²) in fp32 of a placed gradient tree: ``grads`` are this
    rank's shards, ``axes[name]`` the mesh axes leaf ``name`` is split
    over.  Each leaf's squares are summed over its own axes' group, so
    every distinct shard counts once and a replica not again.  The
    leaves are summed per set of axes in one fixed order, so every rank
    gets the same bits."""
    from .mesh import axis_group

    by_axes: Dict[Tuple[str, ...], List[str]] = {}
    for name in grads:
        by_axes.setdefault(tuple(axes.get(name, ())), []).append(name)
    total = None
    for ax in sorted(by_axes):
        part = torch.stack([grads[n].float().square().sum()
                            for n in by_axes[ax]]).sum()
        part = all_reduce_(part, axis_group(mesh, ax)[0])
        total = part if total is None else total + part
    return torch.sqrt(total)


def full_tensor(x) -> torch.Tensor:
    """The logical tensor of a DTensor (a plain tensor as it is): each
    ``Shard(d)`` mesh dim gathered along ``d`` over that dim's group,
    minor mesh dims first, so the pieces land in JAX's major-to-minor
    order."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    out = x.to_local()
    mesh = x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            out = all_gather_cat(out, mesh.get_group(i), dim=p.dim)
    return out
