"""The port's dry run (``repro_torch.launch.dryrun``, ``op_analysis`` and
``steps.lower_step``) against the JAX package's ``repro/launch/dryrun.py``.

* The kernel entries' shape-only branch: meta outputs of the kernel's
  shape, one call with the ``work`` formula's FLOPs and bytes, no card
  launch counted; paged decode and mixed devices raise.
* ``op_analysis.analyze`` on a known function: FLOPs, traffic, peak.
* Production cells, qwen3-0.6b ``train_4k`` and ``decode_32k`` on a fake
  (16, 16) group of 256 ranks: JAX's record keys and ``ok``; the argument
  bytes equal, exactly, the sum over JAX's ``build_step(...).in_shapes``
  of each leaf's shard bytes under its ``in_specs`` (on a shape-only
  ``AbstractMesh``, as ``tests/test_torch_steps.py``); ``model_flops``
  equal to JAX's formula; ``n_params`` and ``n_active_params`` equal for
  all ten archs.
* Reduced qwen3-0.6b train, prefill and decode cells on a fake (2, 2)
  group against one JAX subprocess (four host devices, XLA optimization
  level 0) that compiles JAX's own ``build_step`` and ``lower_step`` and
  reads ``memory_analysis()`` and ``hlo_analysis.analyze``, kernels off on
  both sides: argument and alias bytes equal; output bytes equal up to
  XLA's result tuple (8 bytes, one pointer, per output buffer); FLOPs
  equal; the collective kinds equal up to two named causes, each
  asserted: JAX's GSPMD partitions the vocab-sharded embedding lookup
  (``jnp.take``) with all-to-all and collective-permute, where the port's
  lookup is masked and summed over "model" (all-reduce), and JAX's CPU
  module sums the weight gradients with all-reduce, where the port's FSDP
  backward reduce-scatters.
* The hybrid, ssm and enc-dec families: one production cell each on the
  fake (16, 16) group through the CLI (exit 0; recurrentgemma-9b's
  ``prefill_32k``, whose 26 RG-LRU scans each count the work of one
  rank's (2, 32,768, 256) block of features, xlstm-125m's and
  seamless-m4t-medium's ``decode_32k``), argument bytes equal to JAX's
  shard bytes; and each family's reduced train cell against the JAX
  subprocess: argument, output and alias bytes equal, and FLOPs and
  collective kinds equal up to named causes, each asserted: GSPMD splits
  the weight-gradient product of a leaf replicated over "model" between
  the model ranks (xLSTM's ``w_if``, the enc-dec's ``lm_head`` at a
  vocab 2 does not divide and its ``frame_proj``), where each port rank
  computes it whole; the port's sLSTM scan skips the gradient of the
  zero initial state JAX's scan carries; and GSPMD reshards inside the
  layer scans (all-to-all, collective-permute) where the port's layers
  never reshard.
* Launches on reduced qwen3 and qwen2-moe equal what ``chip_smoke.py``
  asserts on the card (``train_launches_per_step``; phase 8e's 2·L flash
  a train step and L a prefill).
* ``run_planner_dry("multitask_clip")`` on the reference's spec and 96 GB
  cards gives JAX's records (waves, steps, makespan).
* qwen2-moe under ``--baseline`` (60 unpadded experts, not sharded: the
  global-batch MoE with each stack's hidden dim split over "model")
  records ``ok``, and the CLI exits 0.
* Megatron-SP: reduced qwen3's train cell with ``seq_parallel=True``
  against JAX's compiled one: argument, output and alias bytes and FLOPs
  equal; collective kinds equal up to GSPMD's resharding (all-to-all and
  collective-permute, now also inside the layer scans) and the port's
  reduce-scatters; and the port's bytes by kind with SP less those
  without equal the formula of its rule (each sublayer's all-reduce of
  the whole activation becomes a reduce-scatter of it, plus an
  all-gather of this rank's positions each way).

``repro.launch.dryrun`` is imported only in the subprocess: it sets
``XLA_FLAGS`` to 512 host devices at import.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.config as jcfg
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.core.costmodel import V5E
from repro.launch.steps import build_step as jax_build_step
from repro_torch.config import (ShapeConfig, default_sharding, get_arch,
                                reduced)
from repro_torch.configs import ASSIGNED
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import flash_attention_bwd as flash_bwd_k
from repro_torch.kernels import grouped_matmul as gmm_k
from repro_torch.kernels import rglru_scan as scan_k
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import analyze
from repro_torch.models.transformer import layer_kinds

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
#: JAX's record keys (``repro/launch/dryrun.py:run_cell``)
JAX_KEYS = {"arch", "shape", "mesh", "variant", "compile_s", "cost",
            "memory", "hlo_flops", "hlo_bytes", "collectives", "model_flops",
            "n_devices", "ok"}
#: the reduced cells compared with JAX: kind → (seq, batch)
REDUCED = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}
#: the hybrid, ssm and enc-dec archs' reduced train cells compared with JAX
#: (seq 64, batch 8): arch → ``reduced`` overrides (the enc-dec at a vocab
#: 2 does not divide, as 256,206 is not divided by 16)
FAMILIES = {"recurrentgemma-9b": {}, "xlstm-125m": {},
            "seamless-m4t-medium": {"vocab": 255}}

_JAX = r"""
import dataclasses, json, os, re, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, numpy as np
from jax.sharding import Mesh
from repro.config import ShapeConfig, default_sharding, get_arch, reduced
from repro.launch.hlo_analysis import analyze
from repro.launch.steps import build_step, lower_step

cells, families = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def record(cfg, kind, S, B, **over):
    sh = dataclasses.replace(default_sharding(cfg), use_pallas=False, **over)
    spec = build_step(cfg, ShapeConfig(kind, S, B, kind), mesh, shcfg=sh)
    with mesh:
        c = lower_step(spec, mesh).compile()
    ma, text = c.memory_analysis(), c.as_text()
    st = analyze(text)
    names = {}
    for kind_ in ("all-to-all", "collective-permute"):
        names[kind_] = sorted(set(
            m.group(1) for line in text.splitlines()
            if re.search(rf"\b{kind_}(-start)?\(", line)
            for m in [re.search(r'op_name="([^"]*)"', line)] if m))
    return dict(
        arg=ma.argument_size_in_bytes, out=ma.output_size_in_bytes,
        alias=ma.alias_size_in_bytes, flops=st.flops,
        collectives=st.collective_bytes,
        n_out=len(jax.tree.leaves(jax.eval_shape(spec.fn, *spec.in_shapes))),
        op_names=names, reduce_scatter_ops=text.count("reduce-scatter("))


cfg = reduced(get_arch("qwen3-0.6b"))
out = {"cells": {}, "families": {}}
for kind, (S, B) in cells.items():
    out["cells"][kind] = record(cfg, kind, S, B)
out["sp"] = record(cfg, "train", 64, 8, seq_parallel=True)
for arch, over in families.items():
    out["families"][arch] = record(reduced(get_arch(arch), **over),
                                   "train", 64, 8)
jax.devices()  # the backend is up: the import below cannot change it
from repro.launch.dryrun import run_planner_dry
out["plans"] = run_planner_dry("multitask_clip", verbose=False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """JAX's reduced cells and planner records, from one subprocess
    started before the module's first test (the port's cells run
    meanwhile)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps(REDUCED),
         json.dumps(FAMILIES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            box["out"] = json.loads(out.strip().splitlines()[-1])
        return box["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


class ShapeMesh(AbstractMesh):
    """JAX's shape-only mesh that shows the ``devices`` shape its rules
    read (``tests/test_torch_steps.py``'s)."""

    @property
    def devices(self):
        return np.empty(tuple(self.axis_sizes), dtype=object)


# ------------------------------------------------------- the kernels' branch


def test_shape_only_kernel_branch():
    """Meta inputs: the kernel's output shape and dtype, one call in
    ``SHAPE_ONLY`` with its ``work`` formula, no card launch."""
    meta = dict(device="meta")
    ops.reset_shape_only()
    launches = ops.launch_counts()
    q = torch.empty(2, 8, 300, 64, dtype=torch.bfloat16, **meta,
                    requires_grad=True)
    kv = torch.empty(2, 4, 300, 64, dtype=torch.bfloat16, **meta)
    out = ops.flash_attention(q, kv, kv, causal=True)
    assert (out.shape, out.dtype, out.device.type) == (
        q.shape, q.dtype, "meta")
    dq, = torch.autograd.grad(out.sum(), [q])  # the flash backward
    assert (dq.shape, dq.dtype, dq.device.type) == (q.shape, q.dtype, "meta")
    x = torch.empty(4, 16, 32, **meta, requires_grad=True)
    w = torch.empty(4, 32, 24, **meta, requires_grad=True)
    sizes = torch.empty(4, dtype=torch.int32, **meta)
    y = ops.grouped_matmul(x, w, sizes)
    assert y.shape == (4, 16, 24)
    torch.autograd.grad(y.sum(), [x, w])  # dx: one more kernel call
    a = torch.empty(2, 10, 6, **meta, requires_grad=True)
    h = ops.rglru_scan(a, a)
    assert h.shape == a.shape
    torch.autograd.grad(h.sum(), [a])  # the reverse scan
    want = {"flash_attention": [1, *flash_k.work(2, 8, 4, 300, 300, 64,
                                                 True, 2)],
            "flash_attention_backward": [
                1, *flash_bwd_k.work(2, 8, 4, 300, 300, 64, True, 2)],
            "grouped_matmul": [2, *(np.array(gmm_k.work(4, 16, 32, 24, 4))
                                    + gmm_k.work(4, 16, 24, 32, 4))],
            "rglru_scan": [2, *(np.array(scan_k.work(2, 10, 6, 4))
                                + scan_k.work(2, 10, 6, 4, reverse=True))],
            "paged_attention": [0, 0.0, 0.0]}
    got = {n: [r["calls"], r["flops"], r["bytes"]]
           for n, r in ops.SHAPE_ONLY.items()}
    assert got == pytest.approx(want)
    assert ops.launch_counts() == launches  # the card's count is untouched
    with pytest.raises(ValueError, match="shape-only"):
        ops.paged_attention(q[:, :, 0].detach(), kv, kv,
                            torch.empty(2, 3, dtype=torch.int32, **meta),
                            torch.empty(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="all on meta"):
        ops.flash_attention(q, torch.empty_like(kv, device="cpu"), kv)


def test_op_analysis_counts_a_known_function():
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 16, device="meta")

    def fn(a, b):
        c = a @ b  # (4, 16): 2·64·8 FLOPs, a new 256-byte storage
        return (c * 2).sum()

    out, st = analyze(fn, a, b)
    assert out.shape == () and st.flops == 2 * 4 * 16 * 8
    # mm, mul, sum: operands and results, fp32
    assert st.hbm_bytes == 4 * ((32 + 128 + 64) + (64 + 64) + (64 + 1))
    # the inputs' 160 floats, c, c * 2 and the sum live together
    assert st.peak_bytes == 4 * (32 + 128 + 64 + 64 + 1)
    assert st.total_collective_bytes == 0


def test_op_analysis_peak_snapshot_names_what_holds_the_peak():
    """``peak_live``: the live storages at the peak (within 1 %), grouped
    by the op that made them with its result's shape and dtype, and the
    step's inputs."""
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(8, 16, device="meta")
    _, st = analyze(lambda a, b: (a @ b * 2).sum(), a, b)
    assert st.peak_live == {"input": 4 * (32 + 128),
                            "aten.mm (4, 16) float32": 4 * 64,
                            "aten.mul (4, 16) float32": 4 * 64}
    assert st.peak_bytes <= 1.01 * sum(st.peak_live.values())


# ------------------------------------------------------ production cells


def _jax_arg_bytes(arch, shape, dims=(16, 16)):
    ref = jax_build_step(arch, shape, ShapeMesh(dims, ("data", "model")))
    sizes = dict(zip(("data", "model"), dims))

    def shard_bytes(spec, leaf):
        n = np.dtype(leaf.dtype).itemsize
        for i, dim in enumerate(leaf.shape):
            entry = tuple(spec)[i] if i < len(tuple(spec)) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        return n

    return sum(jax.tree.leaves(jax.tree.map(
        shard_bytes, ref.in_specs, ref.in_shapes,
        is_leaf=lambda x: isinstance(x, P))))


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_production_cell_on_a_fake_16x16_group(shape):
    rec = dryrun.run_cell("qwen3-0.6b", shape, verbose=False)
    assert JAX_KEYS <= set(rec) and rec["ok"], rec.get("error")
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_size_in_bytes"] == _jax_arg_bytes(
        "qwen3-0.6b", shape)
    jc, shp = jcfg.get_arch("qwen3-0.6b"), jcfg.SHAPES[shape]
    per_token = 6.0 if shp.kind == "train" else 2.0
    tokens = shp.global_batch * (shp.seq_len if shp.kind == "train" else 1)
    assert rec["model_flops"] == per_token * jc.n_active_params() * tokens
    assert rec["launches"]["flash_attention"] == (
        2 * jc.n_layers if shp.kind == "train" else 0)
    assert rec["memory"]["alias_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_counts_equal_jax(arch):
    assert ASSIGNED == JAX_ASSIGNED
    ours, ref = get_arch(arch), jcfg.get_arch(arch)
    assert ours.n_params() == ref.n_params()
    assert ours.n_active_params() == ref.n_active_params()


# ------------------------------------------------- reduced cells vs JAX


@pytest.mark.parametrize("kind", list(REDUCED))
def test_reduced_cell_equals_jax(jax_side, kind):
    S, B = REDUCED[kind]
    cfg = reduced(get_arch("qwen3-0.6b"))
    rec = dryrun.run_cell(cfg, ShapeConfig(kind, S, B, kind),
                          mesh_shape=(2, 2), verbose=False,
                          shcfg=default_sharding(cfg, use_kernels=False))
    assert rec["ok"], rec.get("error")
    ref = jax_side()["cells"][kind]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref["arg"]
    assert mem["alias_size_in_bytes"] == ref["alias"]
    # XLA's output size holds its result tuple: a pointer per buffer
    assert mem["output_size_in_bytes"] + 8 * ref["n_out"] == ref["out"]
    assert rec["hlo_flops"] == ref["flops"]
    ours = {k for k, v in rec["collectives"].items() if v > 0}
    theirs = {k for k, v in ref["collectives"].items() if v > 0}
    # JAX's all-to-all and collective-permute are all its GSPMD partition
    # of the vocab-sharded embedding lookup (the gather, or its transpose)
    embed = {"all-to-all", "collective-permute"}
    assert embed <= theirs and not embed & ours
    for names in ref["op_names"].values():
        assert names and all("_take" in n for n in names), names
    # the FSDP gradient: the port reduce-scatters, JAX's CPU module
    # all-reduces (its HLO has no reduce-scatter)
    assert ref["reduce_scatter_ops"] == 0
    assert ("reduce-scatter" in ours) == (kind == "train")
    assert ours - {"reduce-scatter"} == theirs - embed


def test_reduced_sp_cell_equals_jax(jax_side):
    """Megatron-SP's train cell (reduced qwen3: 2 layers, d 64, fp32; a
    rank's 4 rows x 64 positions) against JAX's, and against the port's
    cell without SP."""
    cfg = reduced(get_arch("qwen3-0.6b"))
    recs = {sp: dryrun.run_cell(
        cfg, ShapeConfig("train", 64, 8, "train"), mesh_shape=(2, 2),
        verbose=False, shcfg=default_sharding(cfg, use_kernels=False,
                                              seq_parallel=sp))
        for sp in (False, True)}
    assert all(r["ok"] for r in recs.values())
    rec, ref = recs[True], jax_side()["sp"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref["arg"]
    assert mem["alias_size_in_bytes"] == ref["alias"]
    assert mem["output_size_in_bytes"] + 8 * ref["n_out"] == ref["out"]
    assert rec["hlo_flops"] == ref["flops"] == recs[False]["hlo_flops"]
    ours = {k for k, v in rec["collectives"].items() if v > 0}
    theirs = {k for k, v in ref["collectives"].items() if v > 0}
    # GSPMD reshards the embedding lookup and, under SP, inside the layer
    # scan's backward (all-to-all, collective-permute); the port never
    # reshards, and its SP exits and FSDP backward reduce-scatter
    reshard = {"all-to-all", "collective-permute"}
    assert reshard <= theirs and not reshard & ours
    assert any("while/body" in n for n in ref["op_names"]["all-to-all"])
    assert ref["reduce_scatter_ops"] == 0 and "reduce-scatter" in ours
    assert ours - {"reduce-scatter"} == theirs - reshard
    # the port's rule, per layer (one group: block remat recomputes it, and
    # the recompute stops before the group's last exit): each sublayer's
    # exit all-reduced the whole activation X (twice forward but the last,
    # once backward: 5 X a layer) and now reduce-scatters it; each entry
    # all-gathers this rank's positions (X / 2) forward, in recompute and
    # backward (sum_scatter's transpose): 3 X a layer; each norm scale's
    # gradient is all-reduced over "model" (d fp32); the residual stream
    # is split once (take_shard: its cotangent all-gathered) and gathered
    # once (gather_alike): X
    L, d = cfg.n_layers, cfg.d_model
    X = 8 // 2 * 64 * d * 4
    diff = {k: rec["collectives"][k] - recs[False]["collectives"][k]
            for k in ("all-gather", "all-reduce", "reduce-scatter")}
    assert diff == {"all-gather": L * 3 * X + X,
                    "all-reduce": -L * 5 * X + L * 2 * d * 4,
                    "reduce-scatter": L * 5 * X}
    assert mem["temp_size_in_bytes"] < recs[False]["memory"][
        "temp_size_in_bytes"]


# ------------------------------------------ the hybrid, ssm and enc-dec


@pytest.mark.parametrize("arch,shape", [
    ("recurrentgemma-9b", "prefill_32k"), ("xlstm-125m", "decode_32k"),
    ("seamless-m4t-medium", "decode_32k")])
def test_family_production_cell(tmp_path, arch, shape):
    """One production cell of each family through the CLI (exit 0) on the
    fake (16, 16) group: JAX's argument bytes; recurrentgemma's scans on
    each rank's features."""
    path = tmp_path / "rec.json"
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(path)])
    rec, = json.loads(path.read_text())
    assert JAX_KEYS <= set(rec) and rec["ok"], rec.get("error")
    assert rec["memory"]["argument_size_in_bytes"] == _jax_arg_bytes(
        arch, shape)
    if arch == "recurrentgemma-9b":
        cfg, shp = get_arch(arch), jcfg.SHAPES[shape]
        n_rglru = sum(k == "rglru" for k in layer_kinds(cfg))
        assert rec["launches"]["rglru_scan"] == n_rglru == 26
        # (rows of a data rank, the sequence, the features of a model rank)
        block = (shp.global_batch // 16, shp.seq_len, cfg.d_model // 16)
        scans = ops.SHAPE_ONLY["rglru_scan"]  # the CLI's one cell
        assert [scans["flops"], scans["bytes"]] == pytest.approx(
            n_rglru * np.array(scan_k.work(*block, 4)))


def _named_flops(arch, cfg, B=8, S=64, n=2):
    """The port's reduced train-cell FLOPs less JAX's, by named cause."""
    tokens = B // n * S  # a data rank's rows x seq
    kinds = layer_kinds(cfg)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    diff = 0
    if arch == "xlstm-125m":
        # GSPMD computes half of w_if's (d, 2H) gradient on each model rank
        diff += kinds.count("mlstm") * tokens * d * 2 * H
        # JAX differentiates sLSTM's recurrent product at the zero initial
        # state; the port's autograd skips it: (H/n, B/n, hd) @ (hd, 4·hd)
        diff -= kinds.count("slstm") * 2 * (H // n) * (B // n) * hd * 4 * hd
    if arch == "seamless-m4t-medium":
        # the same split of lm_head's (d, V) gradient (V 255: replicated
        # over "model") and of frame_proj's (d, d) over its S/4 frames
        diff += tokens * d * cfg.vocab + B // n * (S // 4) * d * d
    return diff


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_reduced_family_train_cell_equals_jax(jax_side, arch):
    cfg = reduced(get_arch(arch), **FAMILIES[arch])
    rec = dryrun.run_cell(cfg, ShapeConfig("train", 64, 8, "train"),
                          mesh_shape=(2, 2), verbose=False,
                          shcfg=default_sharding(cfg, use_kernels=False))
    assert rec["ok"], rec.get("error")
    ref = jax_side()["families"][arch]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref["arg"]
    assert mem["alias_size_in_bytes"] == ref["alias"]
    assert mem["output_size_in_bytes"] + 8 * ref["n_out"] == ref["out"]
    named = _named_flops(arch, cfg)
    assert rec["hlo_flops"] - ref["flops"] == named
    assert (named == 0) == (arch == "recurrentgemma-9b")
    ours = {k for k, v in rec["collectives"].items() if v > 0}
    theirs = {k for k, v in ref["collectives"].items() if v > 0}
    reshard = {"all-to-all", "collective-permute"}
    assert reshard <= theirs and not reshard & ours
    assert ref["reduce_scatter_ops"] == 0 and "reduce-scatter" in ours
    assert ours - {"reduce-scatter"} == theirs - reshard


# ------------------------------------------------------------ launches


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_launches_equal_the_chip_phases(arch):
    """Kernels on: a train step at S 320 (> 256: flash) with two
    microbatches, and a prefill."""
    cfg = reduced(get_arch(arch))
    shcfg = default_sharding(cfg, use_kernels=True, grad_accum=2)
    per_step = _chip_smoke().train_launches_per_step(cfg)
    train = dryrun.run_cell(cfg, ShapeConfig("train", 320, 8, "train"),
                            mesh_shape=(2, 2), shcfg=shcfg, verbose=False)
    assert train["ok"], train.get("error")
    assert train["launches"] == {k: 2 * v for k, v in per_step.items()}
    L = cfg.n_layers
    assert train["launches"]["flash_attention"] == 2 * 2 * L  # 8e: 2·L
    prefill = dryrun.run_cell(cfg, ShapeConfig("prefill", 320, 8, "prefill"),
                              mesh_shape=(2, 2), shcfg=shcfg, verbose=False)
    assert prefill["launches"] == {
        "flash_attention": L, "flash_attention_backward": 0,
        "paged_attention": 0, "rglru_scan": 0,
        "grouped_matmul": 3 * L if cfg.is_moe else 0}


# ------------------------------------------------------------- planner


def test_planner_dry_run_equals_jax(jax_side):
    got = dryrun.run_planner_dry(
        "multitask_clip", verbose=False, mem_bytes=96e9,
        hw=HardwareSpec(**dataclasses.asdict(V5E)))
    keys = ("planner", "n_devices", "n_waves", "n_steps", "makespan_s")
    assert [{k: r[k] for k in keys} for r in got] == [
        {k: r[k] for k in keys} for r in jax_side()["plans"]]


# ------------------------------------------------- the baseline's cells


@pytest.mark.parametrize("arch,shape,baseline", [
    ("qwen2-moe-a2.7b", "decode_32k", True)])
def test_unported_cells_record_the_error(tmp_path, arch, shape, baseline):
    """The cells that recorded ``NotImplementedError`` before the
    global-batch MoE was ported now run: qwen2-moe under ``--baseline``
    (60 experts on a 16-way model axis, not sharded) records ``ok`` with
    the grouped matmul on each rank's (E, C, d) @ (E, d, 1,408 / 16), and
    the CLI exits 0."""
    rec = dryrun.run_cell(arch, shape, baseline=baseline, verbose=False)
    assert rec["ok"], rec.get("error")
    assert rec["launches"]["grouped_matmul"] == 3 * get_arch(arch).n_layers
    path = tmp_path / "rec.json"
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(path)]
                + (["--baseline"] if baseline else []))
    assert json.loads(path.read_text())[0]["variant"] == "baseline"
