"""The port's placed steps (``repro_torch.launch.steps``) against the JAX
package's ``repro/launch/steps.py``, without spawned ranks.

* ``SHAPES`` and ``applicable_shapes`` equal JAX's for all ten archs.
* Every ``StepSpec``'s ``in_specs`` and ``out_specs`` equal JAX's
  ``build_step``'s leaf for leaf, for all ten archs at full size, each at
  its applicable shapes, on the shape-only (16, 16) and (2, 16, 16)
  meshes (the port's ``FakeMesh`` of ``tests/test_torch_sharding.py``; on
  the JAX side an ``AbstractMesh`` that also shows its ``devices``'
  shape, which the rules read and ``shard_map`` accepts).  A param spec
  is JAX's without its stacked layer entry (``repro_torch.bridge`` names
  the leaves); a cache spec is JAX's per layer (a decoder's remainder
  layers unstacked, its groups and the enc-dec's layers stacked).
* The clamped ``grad_accum`` equals the one JAX's train step closes over.
* ``seq_parallel`` under a model axis builds, with JAX's specs (the
  enc-dec's too, which JAX never runs under SP).
* Full size without memory: on an in-process ``fake`` group of 256 ranks
  over (16, 16), deepseek-67b and llama3-405b built on ``"meta"`` and
  placed by ``make_train_state``: every leaf's local shape — and its
  moments' — is the shard shape JAX's spec names.
"""

import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.config as jcfg
from repro.launch.steps import build_step as jax_build_step
from repro_torch import bridge
from repro_torch.config import (SHAPES, ShapeConfig, ShardingConfig,
                                applicable_shapes, default_sharding, get_arch)
from repro_torch.launch.steps import build_step
from repro_torch.optim import OptState

ARCHS = ("qwen3-0.6b", "glm4-9b", "deepseek-67b", "llama3-405b",
         "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "pixtral-12b")
#: the hybrid, ssm and enc-dec archs
OTHERS = ("recurrentgemma-9b", "xlstm-125m", "seamless-m4t-medium")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """The port's: what the rules read of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(shape)


class ShapeMesh(AbstractMesh):
    """JAX's shape-only mesh: an ``AbstractMesh`` (which ``shard_map``
    takes) that shows the ``devices`` shape the rules read."""

    @property
    def devices(self):
        return np.empty(tuple(self.axis_sizes), dtype=object)


def _specs_of(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


@lru_cache(maxsize=None)
def _steps(arch, shape, mesh):
    dims, axes = MESHES[mesh]
    port = build_step(arch, shape, FakeMesh(dims, axes), device="meta")
    ref = jax_build_step(arch, shape, ShapeMesh(dims, axes))
    return port, ref


def _origin(arch, params_shape):
    """{port name: (JAX leaf index, stacked entries)} of a JAX params tree
    (the bridge's unstacking of zero-stride arrays holding each index)."""
    flat, treedef = jax.tree_util.tree_flatten(params_shape)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.broadcast_to(np.int64(i), leaf.shape)
                  for i, leaf in enumerate(flat)])
    origin = {}
    for n, a in bridge.from_jax(ids, get_arch(arch)).items():
        i = int(a.flat[0])
        origin[n] = (i, len(flat[i].shape) - a.ndim)
    return origin


def _param_specs_equal(arch, port_specs, jax_tree, params_shape):
    jspecs = _specs_of(jax_tree)
    origin = _origin(arch, params_shape)
    assert set(origin) == set(port_specs)
    for name, (i, stacked) in origin.items():
        want = tuple(jspecs[i])
        assert want[:stacked] == (None,) * stacked, name
        assert port_specs[name] == want[stacked:], (name, want)


def _cache_specs_equal(arch, port_cache, jax_cache):
    cfg = get_arch(arch)
    L = len(cfg.block_pattern) or 1
    n_rem = cfg.n_layers % L
    assert len(port_cache) == cfg.n_layers
    for i, layer in enumerate(port_cache):
        if cfg.is_encdec:
            ref, lead = jax_cache, 1
        elif i < n_rem:
            ref, lead = jax_cache["rem"][i], 0
        else:
            ref, lead = jax_cache["groups"][f"p{(i - n_rem) % L}"], 1
        assert set(layer) == set(ref), i
        for key, spec in layer.items():
            want = tuple(ref[key])
            assert want[:lead] == (None,) * lead
            assert spec == want[lead:], (i, key)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) | set(OTHERS)))
def test_shape_cells_equal_jax(arch):
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert applicable_shapes(get_arch(arch)) == jcfg.applicable_shapes(
        jcfg.get_arch(arch))


def test_sharding_config_keeps_the_step_knobs():
    ours = {f.name: f.default for f in dataclasses.fields(ShardingConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(
        jcfg.ShardingConfig)}
    for k in ("grad_accum", "accum_dtype", "seq_parallel", "logits_chunk"):
        assert ours[k] == ref[k], k
    for arch in ARCHS:
        got = default_sharding(get_arch(arch))
        for k, v in get_arch(arch).sharding_defaults:
            assert getattr(got, k) == v, (arch, k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS + OTHERS)
def test_step_specs_equal_jax(arch, mesh):
    for shape in applicable_shapes(get_arch(arch)):
        port, ref = _steps(arch, shape, mesh)
        assert port.name == ref.name
        params_shape = ref.in_shapes[0]
        _param_specs_equal(arch, port.in_specs[0], ref.in_specs[0],
                           params_shape)
        if port.name == "train_step":
            p_o, r_o = port.in_specs[1], ref.in_specs[1]
            assert isinstance(p_o, OptState) and p_o.count == ()
            assert tuple(r_o.count) == ()
            for mine, theirs in ((p_o.mu, r_o.mu), (p_o.nu, r_o.nu)):
                _param_specs_equal(arch, mine, theirs, params_shape)
            assert port.in_specs[2] == {k: tuple(v) for k, v in
                                        ref.in_specs[2].items()}
            assert port.out_specs[2:] == ((), {"nll": (), "aux": ()})
            assert tuple(ref.out_specs[2]) == ()
            assert {k: tuple(v) for k, v in ref.out_specs[3].items()} == {
                "nll": (), "aux": ()}
            _param_specs_equal(arch, port.out_specs[0], ref.out_specs[0],
                               params_shape)
        elif port.name == "prefill_step":
            assert port.in_specs[1] == {k: tuple(v) for k, v in
                                        ref.in_specs[1].items()}
            assert port.out_specs[0] == tuple(ref.out_specs[0])
            _cache_specs_equal(arch, port.out_specs[1], ref.out_specs[1])
        else:
            assert port.in_specs[1] == tuple(ref.in_specs[1])
            _cache_specs_equal(arch, port.in_specs[2], ref.in_specs[2])
            assert port.in_specs[3] == tuple(ref.in_specs[3]) == ()
            assert port.out_specs[0] == tuple(ref.out_specs[0])
            _cache_specs_equal(arch, port.out_specs[1], ref.out_specs[1])


def _jax_ga(spec):
    fn = spec.fn
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))["ga"]


@pytest.mark.parametrize("case", [
    ("qwen2-moe-a2.7b", "16x16", 256, 8), ("llama3-405b", "2x16x16", 256, 16),
    ("llama3-405b", "16x16", 48, 16), ("glm4-9b", "16x16", 24, 8),
    ("qwen3-0.6b", "2x16x16", 64, 6), ("pixtral-12b", "16x16", 160, 8)])
def test_grad_accum_clamp_equals_jax(case):
    arch, mesh, batch, ga = case
    dims, axes = MESHES[mesh]
    shape = ShapeConfig("t", 64, batch, "train")
    port = build_step(arch, shape, FakeMesh(dims, axes), device="meta",
                      shcfg=default_sharding(get_arch(arch), grad_accum=ga))
    ref = jax_build_step(arch, jcfg.ShapeConfig("t", 64, batch, "train"),
                         ShapeMesh(dims, axes),
                         shcfg=dataclasses.replace(
                             jcfg.default_sharding(jcfg.get_arch(arch)),
                             grad_accum=ga))
    assert port.grad_accum == _jax_ga(ref)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-125m",
                                  "seamless-m4t-medium"])
def test_seq_parallel_raises_under_a_model_axis(arch):
    """``seq_parallel`` under a model axis no longer raises: the train step
    builds with JAX's specs on (16, 16) (Megatron-SP changes no spec: the
    split of the residual stream lives inside the step), the enc-dec's
    too, and so does the step without a model axis."""
    dims, axes = MESHES["16x16"]
    port = build_step(arch, "train_4k", FakeMesh(dims, axes),
                      shcfg=default_sharding(get_arch(arch),
                                             seq_parallel=True),
                      device="meta")
    ref = jax_build_step(arch, "train_4k", ShapeMesh(dims, axes),
                         shcfg=dataclasses.replace(
                             jcfg.default_sharding(jcfg.get_arch(arch)),
                             seq_parallel=True))
    assert port.model.shcfg.seq_parallel
    _param_specs_equal(arch, port.in_specs[0], ref.in_specs[0],
                       ref.in_shapes[0])
    assert port.in_specs[2] == {k: tuple(v) for k, v in
                                ref.in_specs[2].items()}
    build_step(arch, "train_4k", FakeMesh((4,), ("data",)),
               shcfg=ShardingConfig(seq_parallel=True), device="meta")


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_step("qwen3-0.6b", "train_4k", FakeMesh(*MESHES["16x16"]))


# ------------------------------------------- full size on a fake group


@pytest.fixture(scope="module")
def fake_world():
    """An in-process ``fake`` default group of 256 ranks (this process is
    rank 0), destroyed after the module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-67b", "llama3-405b"])
def test_full_size_placement_on_meta(fake_world, arch):
    """Item 5e's "each leaf's local shard is the slice its PartitionSpec
    names", at full size: the local shape of every placed leaf (and of its
    moments) on (16, 16) is the JAX spec's shard shape."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.train import make_train_state
    from repro_torch.parallel import make_mesh

    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    spec = build_step(arch, "train_4k", mesh, device="meta")
    params, opt = make_train_state(spec.model, spec.optimizer, 0, mesh=mesh,
                                   rules=spec.rules)
    ref = jax_build_step(arch, "train_4k", ShapeMesh(*MESHES["16x16"]))
    jspecs = _specs_of(ref.in_specs[0])
    jshapes = jax.tree.leaves(ref.in_shapes[0])
    sizes = dict(zip(("data", "model"), (16, 16)))
    live = dict(spec.model.impl.named_parameters())
    for name, (i, stacked) in _origin(arch, ref.in_shapes[0]).items():
        want = []
        for dim, entry in zip(jshapes[i].shape[stacked:],
                              tuple(jspecs[i])[stacked:]):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            want.append(dim // int(np.prod([sizes[a] for a in axes])))
        assert isinstance(live[name], DTensor), name
        assert params[name].device.type == "meta"
        assert tuple(params[name].shape) == tuple(want), name
        assert tuple(opt.mu[name].shape) == tuple(want), name
        assert tuple(live[name].shape) == jshapes[i].shape[stacked:], name
