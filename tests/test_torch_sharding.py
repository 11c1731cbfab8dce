"""The port's sharding rules against the JAX package's, without processes.

* For every registered arch at full size — deepseek-67b and llama3-405b
  included — and every parameter leaf, the port's ``param_spec`` equals
  JAX's spec of the same leaf without its stacked layer entry (the port
  holds one ``Block`` per layer; ``repro_torch.bridge``): shapes from a
  ``"meta"`` build and ``jax.eval_shape``, so nothing is allocated.
  Meshes (16, 16), (2, 16, 16) and (2, 2); the defaults and ``fsdp``,
  ``fsdp_over_pod`` and ``shard_experts`` each flipped.
* ``batch_spec`` and ``cache_spec`` (per-layer and stacked layouts) on the
  same meshes, the activation specs, JAX's ten cases of
  ``tests/test_sharding_rules.py`` restated on the port's per-layer
  shapes, and ``placements`` for a dim split over a tuple of axes.
* The two configs registered here, deepseek-67b and llama3-405b, carry
  the JAX package's numbers.
"""

import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.parallel import ShardingRules as JaxRules
from repro.parallel.sharding import _key_str
from repro_torch import bridge
from repro_torch.config import ArchConfig, ShardingConfig, get_arch
from repro_torch.models.model import Model
from repro_torch.parallel import ShardingRules, tree_param_specs
from repro_torch.parallel.sharding import (placements, tree_batch_specs,
                                           tree_cache_specs)

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
         "recurrentgemma-9b", "seamless-m4t-medium", "pixtral-12b",
         "glm4-9b", "xlstm-125m", "deepseek-67b", "llama3-405b")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
KNOBS = {"default": {}, "no_fsdp": {"fsdp": False},
         "fsdp_over_pod": {"fsdp_over_pod": True},
         "expert_tp": {"shard_experts": False}}


class JaxFakeMesh:
    """``tests/test_sharding_rules.py``'s shape-only stand-in."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape, dtype=object)
        self.empty = False


class FakeMesh:
    """The port's: what the rules read of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(shape)


def _rules(mesh="16x16", **kw):
    shape, axes = MESHES[mesh] if isinstance(mesh, str) else mesh
    return (ShardingRules(FakeMesh(shape, axes), ShardingConfig(**kw)),
            JaxRules(JaxFakeMesh(shape, axes), JaxShardingConfig(**kw)))


@lru_cache(maxsize=None)
def _leaves(arch):
    """{port name: (port shape, JAX path, JAX shape)} at full size."""
    cfg = get_arch(arch)
    port = Model(cfg, ShardingConfig(), torch.device("meta"), train=True)
    shapes = {n: tuple(p.shape) for n, p in port.impl.named_parameters()}
    jshapes = jax.eval_shape(jax_build_model(jax_get_arch(arch)).init,
                             jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(jshapes)
    paths = ["/".join(_key_str(k) for k in path) for path, _ in flat]
    # leaf i as a zero-stride array of its shape holding i: the bridge's
    # unstacking tells which JAX leaf each port parameter comes from
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.broadcast_to(np.int64(i), leaf.shape)
                  for i, (_, leaf) in enumerate(flat)])
    origin = {n: int(a.flat[0]) for n, a in bridge.from_jax(ids, cfg).items()}
    assert set(origin) == set(shapes)
    return {n: (shapes[n], paths[origin[n]], tuple(flat[origin[n]][1].shape))
            for n in shapes}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_per_leaf(arch, mesh, knob):
    port, ref = _rules(mesh, **KNOBS[knob])
    leaves = _leaves(arch)
    specs = tree_param_specs(port, {n: s for n, (s, _, _) in leaves.items()})
    sharded = 0
    for name, (shape, jpath, jshape) in leaves.items():
        want = tuple(ref.param_spec(jpath, jshape))
        stacked = len(jshape) - len(shape)
        assert stacked in (0, 1) and jshape[stacked:] == shape, name
        assert want[:stacked] == (None,) * stacked, (name, want)
        assert specs[name] == want[stacked:], (name, jpath, want)
        sharded += any(e is not None for e in specs[name])
    assert sharded > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_jax(mesh):
    port, ref = _rules(mesh)
    for shape in [(256, 4096), (8, 1024), (5, 32), (1, 524288),
                  (8, 16, 1024), (4, 1024, 80)]:
        for path in ("tokens", "labels", "embeds", "frames"):
            assert port.batch_spec(path, shape) == tuple(
                ref.batch_spec(path, shape)), (path, shape)
    batch = {"tokens": (8, 128), "embeds": (8, 16, 64)}
    assert tree_batch_specs(port, batch) == {
        k: tuple(ref.batch_spec(k, s)) for k, s in batch.items()}
    per_layer = {"k": (128, 16, 4096, 128), "v": (128, 8, 4096, 128),
                 "C": (64, 4, 192, 192), "n": (64, 4, 192), "m": (64, 4),
                 "c": (64, 4, 192), "h": (8, 4096), "conv": (8, 3, 4096)}
    for leaf, shape in per_layer.items():
        # the port's per-layer cache leaf is JAX's remainder-layer layout
        assert port.cache_spec(f"3/{leaf}", shape) == tuple(
            ref.cache_spec(f"rem0/{leaf}", shape)), leaf
        stacked = (28,) + shape
        assert port.cache_spec(f"groups/p0/{leaf}", stacked) == tuple(
            ref.cache_spec(f"groups/p0/{leaf}", stacked)), leaf
    for leaf in ("self_k", "cross_v"):
        shape = (12, 8, 16, 1024, 64)
        assert port.cache_spec(leaf, shape) == tuple(
            ref.cache_spec(leaf, shape))
    cache = [{"k": per_layer["k"], "v": per_layer["v"]}]
    assert tree_cache_specs(port, cache)[0]["k"] == port.cache_spec(
        "0/k", per_layer["k"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_equal_jax(mesh):
    for seq in (True, False):
        port, ref = _rules(mesh, seq_shard_acts=seq)
        for fn in ("act_btd", "act_btd_seqsharded", "tokens", "logits",
                   "kv_cache", "rnn_state", "scalar"):
            assert getattr(port, fn)() == tuple(getattr(ref, fn)()), fn
        assert port.fsdp_axes == ref.fsdp_axes and port.batch == ref.batch


# -------------------------- tests/test_sharding_rules.py, on the port


def _port(shape=(16, 16), axes=("data", "model"), **kw):
    return _rules((shape, axes), **kw)[0]


def test_attention_param_specs():
    r = _port()
    # per layer (d, H·hd): heads over model, then FSDP on d
    assert r.param_spec("decoder.layers.0.mix.wq", (1024, 2048)) == (
        "data", "model")
    assert r.param_spec("decoder.layers.0.mix.wo", (2048, 1024)) == (
        "model", "data")


def test_vocab_parallel_embedding():
    r = _port()
    assert r.param_spec("tok_embed", (151936, 1024)) == ("model", "data")
    # indivisible vocab (seamless 256206) falls back off the model axis
    assert r.param_spec("tok_embed", (256206, 1024))[0] != "model"


def test_expert_parallel_vs_expert_tp():
    r = _port()
    # 128 experts divide 16 → EP on the expert dim
    assert r.param_spec("decoder.layers.0.ffn.we_gate",
                        (128, 2048, 768))[0] == "model"
    # 60 experts don't; with shard_experts=False the hidden dim shards
    spec = _port(shard_experts=False).param_spec(
        "decoder.layers.0.ffn.we_gate", (60, 2048, 1408))
    assert spec[0] is None and spec[2] == "model"


def test_norms_replicated():
    spec = _port().param_spec("decoder.layers.0.norm1.scale", (1024,))
    assert all(s in (None, "data") for s in spec)


def test_ragged_dims_never_sharded():
    r = _port()
    for shape in [(1024, 7), (30, 9)]:
        spec = r.param_spec("decoder.layers.0.mix.wq", shape)
        for dim, s in zip(shape, spec):
            if s in ("model", "data"):
                assert dim % 16 == 0


def test_cache_specs_kv_heads_vs_seq():
    r = _port()
    # kv heads divide 16 → heads sharded
    assert r.cache_spec("3/k", (128, 16, 32768, 128))[1] == "model"
    # kv=8 doesn't divide 16 → sequence sharding (flash-decode)
    spec = r.cache_spec("3/k", (128, 8, 32768, 128))
    assert spec[1] is None and spec[2] == "model"


def test_batch_spec_divisibility():
    r = _port()
    assert r.batch_spec("tokens", (256, 4096))[0] in ("data", ("data",))
    assert r.batch_spec("tokens", (1, 524288))[0] is None  # batch 1


def test_multipod_batch_axes():
    r = _port((2, 16, 16), ("pod", "data", "model"))
    assert r.batch == ("pod", "data")
    assert r.batch_spec("tokens", (256, 4096))[0] == ("pod", "data")


def test_fsdp_over_pod_optional():
    r = _port((2, 16, 16), ("pod", "data", "model"), fsdp_over_pod=True)
    assert r.fsdp_axes == ("pod", "data")
    assert r.param_spec("decoder.layers.0.mix.wq", (1024, 2048))[0] == (
        "pod", "data")


def test_production_mesh_is_a_function():
    """Importing ``launch/mesh.py`` touches no process group (its meshes
    need 256 or 512 ranks, built only when called)."""
    import torch.distributed as dist

    import repro_torch.launch.mesh as lm

    assert callable(lm.make_production_mesh) and callable(lm.make_debug_mesh)
    assert not dist.is_initialized()


def test_no_constrain_counterpart():
    """JAX's ``constrain`` pins GSPMD layouts; every port rank holds local
    tensors, so the port exports JAX's ``__all__`` without it."""
    import repro.parallel as jp
    import repro_torch.parallel as tp

    assert tp.__all__ == jp.__all__
    assert not hasattr(tp, "constrain")


# ------------------------------------------------------------ placements


def test_placements_of_tuple_axes_follow_mesh_order():
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(((("pod", "data")), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements((("data", "pod"),), mesh)
    # an axis the mesh lacks is replicated, as a size-1 axis would be
    assert placements((("pod", "data"),),
                      FakeMesh((4, 2), ("data", "model"))) == (
        Shard(0), Replicate())


def test_jax_partition_specs_are_tuples_of_entries():
    """The port's specs compare to ``tuple(PartitionSpec)`` entry by entry."""
    assert tuple(P(("pod", "data"), None, "model")) == (
        ("pod", "data"), None, "model")


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ["deepseek-67b", "llama3-405b"])
def test_new_arch_configs_match_jax(arch):
    port, ref = get_arch(arch), jax_get_arch(arch)
    for f in dataclasses.fields(ArchConfig):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
