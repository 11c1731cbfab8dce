"""The port's checkpoints against the JAX package's, on the CPU.

* the round trip with keep-k, a bf16 and an int leaf, the shape and
  missing-leaf refusals, no visible ``.tmp``, restore onto a device
  (``tests/test_optim_data_ckpt.py:156-198``);
* durability: a truncated manifest or a missing shard is skipped, a
  re-save keeps a restorable copy, sharded groups round-trip and load
  disjointly (``tests/test_faults.py::TestCheckpointDurability``);
* the async double-buffered manager (``TestAsyncCheckpointManager``),
  plus a real in-place ``AdamW.update`` right after ``save``: the snapshot
  keeps the pre-step values;
* an ``nn.Module`` and an ``OptState`` round-trip (``count`` a 0-d int32);
* format parity, with and without shard groups and with a bf16 leaf: the
  port's manifest lists the same leaves, shards and groups as JAX's for
  the same tree, JAX's ``restore_checkpoint`` / ``load_shard_group`` read
  the port's checkpoint, and the port reads JAX's, equal leaf for leaf.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import load_shard_group as jax_load_shard_group
from repro.ckpt import restore_checkpoint as jax_restore_checkpoint
from repro.ckpt import save_checkpoint as jax_save_checkpoint
from repro_torch.ckpt import (AsyncCheckpointManager, CheckpointManager,
                              all_steps, latest_step, load_shard_group,
                              reshard, restore_checkpoint, restore_to_mesh,
                              save_checkpoint)
from repro_torch.ckpt.remesh import fresh_module
from repro_torch.optim import AdamW, OptState

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "b": {"x": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))},
    }


# ------------------------------------------- tests/test_optim_data_ckpt.py


def test_ckpt_roundtrip_atomic_keep_k(tmp_path):
    base = str(tmp_path / "ck")
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.bfloat16)},
            "n": torch.tensor(3, dtype=torch.int32)}
    for s in (10, 20, 30, 40):
        save_checkpoint(base, s, tree, keep=2, extra={"loss": s * 1.0})
    assert latest_step(base) == 40
    assert len([d for d in os.listdir(base) if d.startswith("step_")]) == 2
    restored, manifest = restore_checkpoint(base, tree)
    assert manifest["extra"]["loss"] == 40.0
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["n"].dtype == torch.int32 and int(restored["n"]) == 3
    assert all(t.device.type == "cpu" for t in
               (restored["a"], restored["b"]["c"], restored["n"]))


def test_ckpt_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    base = str(tmp_path / "ck")
    save_checkpoint(base, 1, {"a": torch.ones((4,))})
    with pytest.raises(ValueError):
        restore_checkpoint(base, {"a": torch.ones((5,))})
    with pytest.raises(KeyError, match="'b'"):
        restore_checkpoint(base, {"a": torch.ones((4,)), "b": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"a": torch.ones((4,))})


def test_manager_cadence_and_empty_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=3, keep=5)
    assert mgr.restore_latest(_tree()) == (None, None)
    saved = [mgr.maybe_save(s, _tree(s)) for s in range(7)]
    assert [s is not None for s in saved] == [True, False, False, True,
                                              False, False, True]
    assert all_steps(mgr.base) == [0, 3, 6]
    tree, manifest = mgr.restore_latest(_tree())
    assert manifest["step"] == 6 and torch.equal(tree["w"], _tree(6)["w"])


def test_ckpt_tmp_dir_never_visible(tmp_path):
    base = str(tmp_path / "ck")
    save_checkpoint(base, 5, {"a": torch.ones(3)})
    assert not any(d.endswith(".tmp") for d in os.listdir(base))


def test_restore_to_device_and_mesh_targets_raise(tmp_path):
    """One process: each leaf goes to its target device (a pytree of
    devices, or one device); a bare DTensor placement, without its mesh,
    is no target and raises (a ``(DeviceMesh, placements)`` pair is one:
    ``tests/test_torch_parallel.py``)."""
    from torch.distributed.tensor import Replicate

    tree = {"w": torch.arange(16.0).reshape(4, 4), "n": [torch.ones(2)]}
    base = str(tmp_path / "ck")
    save_checkpoint(base, 1, tree)
    restored, _ = restore_checkpoint(base, tree)
    cpu = torch.device("cpu")
    placed = restore_to_mesh(restored, {"w": cpu, "n": ["cpu"]})
    assert torch.equal(placed["w"], tree["w"]) and placed["w"].device == cpu
    assert torch.equal(reshard(placed, cpu)["n"][0], tree["n"][0])
    with pytest.raises(TypeError, match="DeviceMesh, placements"):
        restore_to_mesh(restored, {"w": Replicate(), "n": [cpu]})


# --------------------------------- tests/test_faults.py: ckpt durability


class TestCheckpointDurability:
    def test_truncated_manifest_skipped(self, tmp_path):
        base = str(tmp_path)
        save_checkpoint(base, 1, _tree())
        save_checkpoint(base, 2, _tree(1))
        man = os.path.join(base, "step_000000002", "manifest.json")
        with open(man, "w") as f:
            f.write('{"step": 2, "shar')
        assert all_steps(base) == [1]
        assert latest_step(base) == 1
        _, manifest = restore_checkpoint(base, _tree(), 1)
        assert manifest["step"] == 1

    def test_missing_shard_skipped(self, tmp_path):
        base = str(tmp_path)
        save_checkpoint(base, 3, _tree())
        with open(os.path.join(base, "step_000000003",
                               "manifest.json")) as f:
            shard = json.load(f)["shards"][0]
        os.remove(os.path.join(base, "step_000000003", shard))
        assert all_steps(base) == []
        assert latest_step(base) is None

    def test_resave_keeps_restorable_copy(self, tmp_path):
        base = str(tmp_path)
        save_checkpoint(base, 5, _tree(0))
        t1 = _tree(1)
        save_checkpoint(base, 5, t1)  # re-publish the same step
        tree, _ = restore_checkpoint(base, _tree(), 5)
        assert torch.equal(tree["w"], t1["w"])
        assert all_steps(base) == [5]
        assert sorted(os.listdir(base)) == ["step_000000005"]

    def test_sharded_groups_roundtrip(self, tmp_path):
        base = str(tmp_path)
        t = _tree()
        save_checkpoint(base, 7, t, shard_groups=3)
        tree, manifest = restore_checkpoint(base, _tree(), 7)
        assert manifest["shard_groups"] == 3
        assert torch.equal(tree["w"], t["w"])
        assert torch.equal(tree["b"]["x"], t["b"]["x"])
        seen = {}
        for g in range(3):
            part = load_shard_group(base, 7, g)
            assert not set(part) & set(seen)
            seen.update(part)
        assert set(seen) == {l["name"] for l in manifest["leaves"]}


# ----------------------------- tests/test_faults.py: the async manager


class TestAsyncCheckpointManager:
    def test_double_buffer_accounting(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), every=1, keep=10)
        for k in range(6):
            mgr.save(k, _tree(k))
        mgr.wait()
        assert mgr.saves_written + mgr.saves_dropped == mgr.saves_started
        assert mgr.saves_written >= 1
        assert latest_step(str(tmp_path)) == 5
        mgr.close()

    def test_restore_latest_drains(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), every=1)
        t = _tree(3)
        mgr.save(4, {"params": t})
        restored, manifest = mgr.restore_latest({"params": _tree(9)})
        assert manifest["step"] == 4
        assert torch.equal(restored["params"]["w"], t["w"])
        mgr.close()
        with pytest.raises(RuntimeError, match="closed"):
            mgr.save(5, t)

    def test_save_mutation_after_enqueue_is_safe(self, tmp_path):
        # save() copies to host synchronously: mutating the live tree (a
        # CPU tensor and a numpy array) after enqueue must not corrupt it
        mgr = AsyncCheckpointManager(str(tmp_path), every=1)
        t = {**_tree(0), "np": np.arange(5.0)}
        want_w, want_np = t["w"].clone(), t["np"].copy()
        with mgr._cv:  # the writer cannot take the snapshot before the edit
            mgr.save(1, t)
            t["w"][:] = -1.0
            t["np"][:] = -1.0
        mgr.wait()
        tree, _ = restore_checkpoint(str(tmp_path), t, 1)
        assert torch.equal(tree["w"], want_w)
        np.testing.assert_array_equal(tree["np"].numpy(), want_np)
        mgr.close()

    def test_snapshot_survives_in_place_adamw_step(self, tmp_path):
        """AdamW.update writes params and moments in place: a snapshot
        enqueued just before it must hold the pre-step values."""
        params = {k: v.clone() for k, v in
                  {"w": _tree(0)["w"], "x": _tree(0)["b"]["x"]}.items()}
        opt = AdamW(lr=1e-1, weight_decay=0.0)
        state = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                           opt.init(params), params)
        before = {"params": {k: v.clone() for k, v in params.items()},
                  "mu": {k: v.clone() for k, v in state.mu.items()},
                  "count": state.count}
        mgr = AsyncCheckpointManager(str(tmp_path), every=1)
        with mgr._cv:  # the writer cannot take the snapshot before the step
            mgr.save(1, {"params": params, "opt": state})
            state = opt.update({k: torch.full_like(v, 2.0)
                                for k, v in params.items()}, state, params)
        assert not torch.equal(params["w"], before["params"]["w"])
        restored, _ = mgr.restore_latest({"params": params, "opt": state})
        for k in params:
            assert torch.equal(restored["params"][k], before["params"][k])
            assert torch.equal(restored["opt"].mu[k], before["mu"][k])
        assert restored["opt"].count == before["count"] == 1
        mgr.close()


# ------------------------------------------------- modules and OptState


def test_module_and_optstate_roundtrip(tmp_path):
    """An ``nn.Module`` flattens through ``named_parameters()`` (dotted
    names become paths) and an ``OptState`` to ``mu/…``, ``nu/…`` and a 0-d
    int32 ``count``; restore gives ``{name: tensor}`` and an ``OptState``,
    and ``fresh_module`` loads the former into a new copy of the module."""
    torch.manual_seed(0)
    mod = torch.nn.ModuleDict({"enc": torch.nn.Linear(3, 4),
                               "head": torch.nn.Sequential(
                                   torch.nn.Linear(4, 2))})
    params = dict(mod.named_parameters())
    opt = AdamW(lr=1e-2)
    state = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                       opt.init(params), params)
    save_checkpoint(str(tmp_path), 0, {"params": mod, "opt": state})
    with open(tmp_path / "step_000000000" / "manifest.json") as f:
        leaves = {l["name"]: l for l in json.load(f)["leaves"]}
    assert "params/head/0/weight" in leaves and "opt/mu/enc/bias" in leaves
    assert leaves["opt/count"]["dtype"] == "int32"
    assert leaves["opt/count"]["shape"] == []
    tree, _ = restore_checkpoint(str(tmp_path), {"params": mod, "opt": state})
    assert set(tree["params"]) == set(params)
    assert isinstance(tree["opt"], OptState) and tree["opt"].count == 1
    with torch.no_grad():
        for p in mod.parameters():
            p.zero_()
    new = fresh_module(mod, tree["params"])
    assert new is not mod
    for name, p in new.named_parameters():
        assert torch.equal(p, tree["params"][name])
        assert torch.equal(tree["opt"].nu[name], state.nu[name])
    assert all(float(p.detach().abs().sum()) == 0.0
               for p in mod.parameters())


# -------------------------------------------------- format parity with JAX


def _parity_values(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.normal(size=(5, 3)).astype(np.float32),
        "blocks": [{"w": rng.normal(size=(3, 3)).astype(np.float32),
                    "s": rng.normal(size=(3,)).astype(np.float32)}
                   for _ in range(2)],
        "half": rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16),
        "step": np.asarray(7, np.int32),
    }


def _as_torch(v):
    if isinstance(v, dict):
        return {k: _as_torch(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_as_torch(x) for x in v]
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _as_jax(v):
    if isinstance(v, dict):
        return {k: _as_jax(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_as_jax(x) for x in v]
    return jnp.asarray(v)


def _bits(x) -> np.ndarray:
    """A leaf's raw values as numpy (bf16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _layout(base):
    with open(os.path.join(base, "step_000000003", "manifest.json")) as f:
        m = json.load(f)
    return m["leaves"], m["shards"], m["group_shards"], m["shard_groups"]


@pytest.mark.parametrize("shard_groups", [0, 3])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_format_parity_with_jax(tmp_path, writer, shard_groups):
    """Either package reads what the other wrote, leaf for leaf (the bf16
    leaf bit for bit), and both write the same manifest layout."""
    vals = _parity_values()
    port_base, jax_base = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_base, 3, _as_torch(vals), shard_groups=shard_groups,
                    extra={"by": "port"})
    jax_save_checkpoint(jax_base, 3, _as_jax(vals),
                        shard_groups=shard_groups, extra={"by": "jax"})
    assert _layout(port_base) == _layout(jax_base)
    base = port_base if writer == "port" else jax_base
    want = {k: _bits(v) for k, v in _flat(vals).items()}
    dtypes = {k: str(v.dtype) for k, v in _flat(vals).items()}

    got_jax, manifest = jax_restore_checkpoint(base, _as_jax(vals), 3)
    got_port, _ = restore_checkpoint(base, _as_torch(vals), 3)
    assert manifest["extra"] == {"by": writer}
    for name, leaf in _flat(got_jax).items():
        assert str(np.asarray(leaf).dtype) == dtypes[name]
        np.testing.assert_array_equal(_bits(leaf), want[name])
    for name, leaf in _flat(got_port).items():
        assert str(leaf.dtype).replace("torch.", "") == dtypes[name]
        np.testing.assert_array_equal(_bits(leaf), want[name])
    for g in range(max(shard_groups, 1)):
        jax_part = jax_load_shard_group(base, 3, g)
        port_part = load_shard_group(base, 3, g)
        assert set(jax_part) == set(port_part)
        for name in port_part:
            np.testing.assert_array_equal(_bits(port_part[name]),
                                          _bits(jax_part[name]))
            np.testing.assert_array_equal(_bits(port_part[name]), want[name])
