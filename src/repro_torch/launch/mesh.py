"""Production and debug meshes (port of ``repro/launch/mesh.py``).

Both are FUNCTIONS: importing this module touches no process group.
``make_production_mesh`` lays ``(16, 16)`` over ``(data, model)`` (one
pod of 256 ranks) or ``(2, 16, 16)`` over ``(pod, data, model)`` (512);
the sharding rules put DP/FSDP on ``data`` (and optionally ``pod``) and
EP on ``model``.  Either needs a default group of that many ranks.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..parallel.mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device: str = "cuda") -> DeviceMesh:
    """A small ``(data, model)`` mesh over the default group (tests, smoke
    runs)."""
    return make_mesh((n_data, n_model), ("data", "model"), device)
