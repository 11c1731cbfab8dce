"""Re-mesh restore: place a restored checkpoint onto devices (port of
``repro/ckpt/remesh.py``, one process).

Checkpoints store logical (unsharded) arrays, so restoring after losing or
gaining hosts is just placement: each leaf goes to its target device.  In
one process a target is a ``torch.device`` (or a name such as ``"cuda"``);
a ``DeviceMesh`` or a DTensor placement is the multi-GPU path and raises
(ROADMAP queue 1, item 5c) rather than quietly staying on one device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ..optim.adamw import OptState
from .straggler import ITEM_5C


def _device(target) -> torch.device:
    if isinstance(target, (torch.device, str)):
        return torch.device(target)
    raise NotImplementedError(
        f"restore onto {type(target).__name__} (a mesh or DTensor placement) "
        f"is not ported yet: {ITEM_5C}")


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
        ts = target if isinstance(target, (list, tuple)) else [target] * len(x)
        return type(x)(_place(v, t) for v, t in zip(x, ts))
    if isinstance(x, torch.Tensor):
        return x.to(_device(target))
    return x  # a Python scalar (an OptState count) has no device


def restore_to_mesh(tree, targets) -> Any:
    """Place ``tree`` (restored CPU tensors) onto ``targets``: a pytree of
    the same structure holding a device per leaf, or one device for all."""
    return _place(tree, targets)


def reshard(tree, new_targets) -> Any:
    """Live re-placement of device tensors onto new targets (the source
    devices are implicit in the tensors themselves)."""
    return restore_to_mesh(tree, new_targets)


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
