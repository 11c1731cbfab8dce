"""Parallelism substrate: mesh axes, sharding rules, collectives (port of
``repro.parallel``; JAX's ``constrain`` has no counterpart — every rank
holds local tensors)."""

from .mesh import (
    AxisNames,
    DATA,
    MODEL,
    POD,
    axis_size,
    batch_axes,
    make_mesh,
    mesh_over_devices,
    model_axis,
)
from .sharding import (
    ShardingRules,
    tree_batch_specs,
    tree_cache_specs,
    tree_param_shardings,
    tree_param_specs,
)

__all__ = [
    "AxisNames",
    "DATA",
    "MODEL",
    "POD",
    "axis_size",
    "batch_axes",
    "make_mesh",
    "mesh_over_devices",
    "model_axis",
    "ShardingRules",
    "tree_batch_specs",
    "tree_cache_specs",
    "tree_param_shardings",
    "tree_param_specs",
]
