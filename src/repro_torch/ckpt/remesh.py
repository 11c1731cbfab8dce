"""Re-mesh restore: place a restored checkpoint onto devices or a mesh
(port of ``repro/ckpt/remesh.py``).

Checkpoints store logical (unsharded) arrays, so restoring after losing or
gaining hosts is placement: each leaf goes to its target.  A target is a
``torch.device`` (or a name such as ``"cuda"``), or a ``(DeviceMesh,
placements)`` pair — what :func:`repro_torch.parallel.tree_param_shardings`
gives — under which the leaf becomes a DTensor holding this rank's shard.
Every rank holds the whole restored array, so the placement is local: no
collective runs.  A rank outside the target mesh gets a DTensor with an
empty local tensor.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..optim.adamw import OptState
from ..parallel.collectives import full_tensor


def _is_sharding(target) -> bool:
    return (isinstance(target, tuple) and len(target) == 2
            and isinstance(target[0], DeviceMesh))


def _device(target) -> torch.device:
    if isinstance(target, (torch.device, str)):
        return torch.device(target)
    raise TypeError(f"restore target {target!r} is neither a device nor a "
                    f"(DeviceMesh, placements) pair")


def _distribute(x: torch.Tensor, mesh: DeviceMesh, places) -> DTensor:
    """``x`` as a DTensor on ``mesh``: this rank's chunk of every
    ``Shard`` mesh dim, taken major to minor (torch's chunk layout)."""
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    coord = mesh.get_coordinate()
    if coord is None:
        local = x.new_empty((0,), device=dev)
    else:
        local = x
        for i, p in enumerate(places):
            if isinstance(p, Shard):
                local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
        local = local.to(dev, copy=True).contiguous()
    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def _place(x, target):
    if isinstance(x, OptState):
        per_leaf = isinstance(target, OptState)
        return OptState(mu=_place(x.mu, target.mu if per_leaf else target),
                        nu=_place(x.nu, target.nu if per_leaf else target),
                        count=x.count)
    if isinstance(x, dict):
        return {k: _place(v, target[k] if isinstance(target, dict)
                          else target) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        each = isinstance(target, (list, tuple)) and not _is_sharding(target)
        ts = target if each else [target] * len(x)
        return type(x)(_place(v, t) for v, t in zip(x, ts))
    if isinstance(x, torch.Tensor):
        if _is_sharding(target):
            return _distribute(x, *target)
        return x.to(_device(target))
    return x  # a Python scalar (an OptState count) has no device


def restore_to_mesh(tree, targets) -> Any:
    """Place ``tree`` (restored CPU tensors) onto ``targets``: a tree of the
    same structure holding a target per leaf, or one target for all."""
    return _place(tree, targets)


def reshard(tree, new_targets) -> Any:
    """Live re-placement onto new targets: every DTensor is gathered to its
    logical tensor (a collective over its mesh: every rank calls this),
    then placed.  The old layout is implicit in the tensors themselves."""
    return restore_to_mesh(_gather(tree), new_targets)


def _gather(x):
    if isinstance(x, OptState):
        return OptState(mu=_gather(x.mu), nu=_gather(x.nu), count=x.count)
    if isinstance(x, dict):
        return {k: _gather(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_gather(v) for v in x)
    return full_tensor(x)


def fresh_module(module: torch.nn.Module,
                 named: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """A new copy of ``module`` holding ``named`` (``{parameter name:
    tensor}``, as :func:`repro_torch.ckpt.restore_checkpoint` returns a
    module); ``module`` itself is left as it was."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(named[name])
    return out
