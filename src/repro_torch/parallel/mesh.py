"""Mesh axis conventions and process setup (port of ``repro/parallel/mesh.py``).

Production meshes are ``(data, model)`` single-pod and ``(pod, data,
model)`` multi-pod.  The batch dimension shards over ``("pod", "data")``
(DP); experts shard over ``"model"`` (EP).  A mesh is a ``torch.distributed``
``DeviceMesh`` over the ranks of the default process group: every rank
runs the same program on its own local tensors, where JAX runs one
controller over every device.

:func:`batch_axes`, :func:`model_axis` and :func:`axis_size` read only
``mesh.mesh_dim_names`` and ``mesh.shape``, so a shape-only stand-in (the
tests' ``FakeMesh``) works in them and in the sharding rules.
:func:`axis_group` gives the process group of one or more mesh axes (the
batch axes flattened into one group), which the collectives of
:mod:`repro_torch.parallel.collectives` run on.

:func:`pick_backend` and :func:`init_rank` are the one place the port's
own multi-rank callers (tests, ``chip_smoke.py``, through
:func:`run_ranks`) start a rank: ``nccl`` when every rank has a card of
its own, ``gloo`` when the ranks run on the CPU or share one card (NCCL
refuses two ranks on one device).  The choice follows from the world
size and the device count, never from an error.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD = "pod"
DATA = "data"
MODEL = "model"

AxisNames = Tuple[str, ...]

log = logging.getLogger(__name__)


def pick_backend(world: int, device: str) -> str:
    """``"nccl"`` when every one of ``world`` ranks has a card of its own,
    ``"gloo"`` when they run on the CPU or share cards."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def init_rank(rank: int, world: int, store: str, device: str = "cuda") -> str:
    """Join the default process group as ``rank`` of ``world`` through the
    file store at ``store`` (a path; no TCP port to collide on), with the
    backend :func:`pick_backend` picks, and bind a CUDA rank to card
    ``rank % device_count`` (ranks that share a card share ``cuda:0``).
    Returns the backend."""
    backend = pick_backend(world, device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    log.info("rank %d of %d: backend %s on %s", rank, world, backend, device)
    return backend


def _rank_entry(rank: int, fn, world: int, store: str, device: str,
                args) -> None:
    init_rank(rank, world, store, device)
    try:
        out = fn(rank, *args)
        torch.save(out, f"{store}.out{rank}")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device: str = "cuda", args=()) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes (the
    ``spawn`` start method, which CUDA needs), each joined to one group
    through :func:`init_rank` (a file store in a fresh temporary
    directory, so parallel runs never share a rendezvous).  ``fn`` must be
    importable by the children (a module-level function).  Returns each
    rank's return value (saved with ``torch.save``: return host data).  A
    rank that fails makes the whole run raise."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        store = f"{tmp}/store"
        mp.spawn(_rank_entry, args=(fn, world, store, device, tuple(args)),
                 nprocs=world, join=True)
        return [torch.load(f"{store}.out{r}", weights_only=False)
                for r in range(world)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default group (its size must be the
    product of ``shape``), rank-major as ``jax.make_mesh`` lays devices."""
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_over_devices(ranks: Iterable[int], axes: Sequence[str] = (DATA,),
                      shape: Optional[Sequence[int]] = None,
                      device: str = "cuda") -> DeviceMesh:
    """A mesh over an explicit subset of ranks — the elastic re-mesh
    primitive.  Ranks past the world size are dropped (plans are sized for
    the full cluster, as JAX drops devices past its runtime's count);
    ``shape`` defaults to 1-D over the survivors.  Every rank of the
    default group calls this; one outside the subset gets a mesh whose
    ``get_coordinate()`` is None."""
    world = dist.get_world_size()
    keep = [r for r in ranks if r < world]
    if not keep:
        raise ValueError("mesh_over_devices: no rank of the group in subset")
    arr = torch.tensor(keep, dtype=torch.int64)
    if shape is not None:
        arr = arr.reshape(tuple(shape))
    return DeviceMesh(torch.device(device).type, arr,
                      mesh_dim_names=tuple(axes))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dimension shards over (none without a mesh)."""
    if mesh is None:
        return ()
    names = tuple(mesh.mesh_dim_names)
    out = tuple(a for a in (POD, DATA) if a in names)
    return out or (names[0],)


def model_axis(mesh) -> Optional[str]:
    return MODEL if MODEL in mesh.mesh_dim_names else None


def axis_size(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        return 1
    return tuple(mesh.shape)[names.index(name)]


def axis_group(mesh: Optional[DeviceMesh], axes: Sequence[str]):
    """(process group, size) of this rank's slice of ``mesh`` along
    ``axes`` (absent axes are dropped; several are flattened major to
    minor, as JAX orders a tuple of mesh axes).  A size-1 slice, or no
    mesh, has no group (None): the collectives skip it.  The groups of a
    multi-axis slice are made once per mesh, by every rank in the same
    order."""
    if mesh is None:
        return None, 1
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in axes if a in names)
    size = math.prod(axis_size(mesh, a) for a in axes)
    if size == 1:
        return None, 1
    if len(axes) == 1:
        return mesh.get_group(axes[0]), size
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in cache:
        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        rows = mesh.mesh.permute(*rest, *idx).reshape(-1, size)
        me = dist.get_rank()
        mine = None
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        cache[axes] = mine
    return cache[axes], size


@dataclass(frozen=True)
class ModelShard:
    """This rank's place on the ``"model"`` axis, as the tensor-parallel
    layers read it: the axis' process group, its size and this rank's
    index along it.  ``seq_cache`` marks a decode whose KV cache is split
    over ``"model"`` along the sequence (the rules' choice where the KV
    heads do not divide the axis).  ``seq`` marks a training forward under
    Megatron-SP: the residual stream is split over ``"model"`` along the
    sequence, a tensor-parallel region's input arrives gathered whole by
    ``gather_shards`` and its row-parallel output leaves through
    ``sum_scatter`` onto this rank's positions
    (:func:`repro_torch.parallel.collectives.tp_in`, ``tp_out``)."""

    group: Any
    n: int
    rank: int
    seq_cache: bool = False
    seq: bool = False

    def own_positions(self, y):
        """This rank's block of positions (dim 1) of ``y``, a value every
        rank of the axis computes whole (a plain slice: its cotangent is
        this rank's positions only)."""
        S = y.shape[1] // self.n
        return y[:, self.rank * S:(self.rank + 1) * S]


def model_shard(mesh, *, seq_cache: bool = False,
                seq: bool = False) -> Optional[ModelShard]:
    """The :class:`ModelShard` of this rank under ``mesh`` (None without a
    mesh or with a ``"model"`` axis of size 1)."""
    group, n = axis_group(mesh, (MODEL,))
    if group is None:
        return None
    return ModelShard(group, n, mesh.get_local_rank(MODEL), seq_cache, seq)
