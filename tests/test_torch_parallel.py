"""Multi-rank training on the port against the JAX package, on the CPU.

The JAX references come from one subprocess that forces four host devices
and builds each mesh with ``jax.sharding.Mesh`` over them (Auto axes: the
Explicit axes of ``jax.make_mesh``, which ``make_debug_mesh`` uses, make
jax 0.9's ``train(mesh=)`` raise in its embedding gather).  The port's
ranks come from one spawn of four ``gloo`` ranks on the CPU, one torch
thread each (``repro_torch.parallel.mesh.run_ranks``); both run at once.
Both read one set of inputs written here: the reduced models' params are
the port's seeded init, handed to JAX through ``repro_torch.bridge``, and
the batches are the port's ``SyntheticLM`` stream.

* ``moe_apply`` on reduced qwen2-moe at (data 2, model 2): the output
  rows, the aux loss and the gradients of ``Σ out·cot / B + w·aux`` for
  every MoE leaf and the input, with ``router_aux_weight`` 0.01 and 1.0,
  within 1e-5 (each rank's gradients averaged over the batch axes, as the
  data-parallel sync does; an input row's gradient is its rank's over
  the batch-axes size, since each rank differentiates its own mean);
* ``train(mesh=)`` for 3 steps: reduced qwen2-moe at (2, 2) (aux weight
  0.01 and 1.0) and reduced qwen3 at (4, 1) against JAX's ``train`` step
  (``model.loss(p, b, mesh=mesh)`` under ``value_and_grad``), within
  1e-5; compressed DP on reduced xlstm at (4, 1) for 4 steps against
  JAX's ``_make_compressed_dp_step``, within 1e-4, and the same run
  uncompressed within 1e-5 — which, as a control, lies more than 1e-4
  from JAX's compressed history.  JAX's AdamW runs on
  the port's per-layer names, so both decay the same leaves (JAX decays
  its stacked (G, d) norms; ROADMAP queue 3);
* every rank of a model group holds bit-identical replicated params after
  three steps (an aux gradient counted twice, or a router gradient summed
  whole, would part them), and every rank reports the same history;
* a checkpoint written under EP holds the logical arrays: its names and
  shapes equal a one-process run's; the EP run stopped after step 1 and
  resumed by ``train`` on its mesh equals the uninterrupted run;
* one EP ``prefill`` + ``decode_step`` at (2, 2) against JAX's under the
  same mesh (each rank's logit rows);
* ``shard_batch``'s rows on each rank and the DTensor layout of
  ``placements`` for a dim split over ``("pod", "data")`` against JAX's
  ``NamedSharding`` layout; the rank-0 ``TimingCollector``; ``restore_to_mesh`` onto a
  subset mesh from ``mesh_over_devices`` and back through ``reshard``;
* ``optim/compress.py`` against ``tests/test_optim_data_ckpt.py:89,96``
  and JAX's ``int8_compress`` on the same values; ``compressed_mean`` over
  four ranks against JAX's under ``shard_map``.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.ckpt import TimingCollector, reshard, restore_to_mesh
from repro_torch.ckpt.checkpoint import _read_manifest, latest_step
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLM, shard_batch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.optim import (ErrorFeedback, compressed_mean,
                               int8_compress, int8_decompress)
from repro_torch.parallel import ShardingRules, make_mesh, mesh_over_devices
from repro_torch.parallel.collectives import mean_grads
from repro_torch.parallel.mesh import DATA, MODEL, axis_group, run_ranks
from repro_torch.parallel.sharding import placements

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
INT8_TOL = 1e-4
MOE = "qwen2-moe-a2.7b"
AUX_WEIGHTS = (0.01, 1.0)
#: name: (arch, mesh shape over (data, model), steps, compress, aux
#: weight, lr).  xlstm at 5e-5: its tied embedding's gradient is
#: ill-conditioned (the mLSTM normaliser divides by a signed sum), and
#: Adam turns an int8 entry that fp32 noise tips between 0 and one
#: quantum into a whole lr step: at 1e-3 even the uncompressed (4, 1)
#: histories part by 2.4e-3 within 4 steps, at 1e-4 the compressed ones
#: by 1.3e-4
TRAIN_CASES = {
    "moe_22": (MOE, (2, 2), 3, False, None, 1e-3),
    "moe_22_aux1": (MOE, (2, 2), 3, False, 1.0, 1e-3),
    "qwen3_41": ("qwen3-0.6b", (4, 1), 3, False, None, 1e-3),
    "xlstm_41_int8": ("xlstm-125m", (4, 1), 4, True, None, 5e-5),
    "xlstm_41": ("xlstm-125m", (4, 1), 4, False, None, 5e-5),
}
TRAIN_KW = dict(batch=8, seq=32, seed=3)
DECODE_S, DECODE_B = 12, 4


def _cfg(arch, aux=None):
    cfg = reduced(get_arch(arch))
    if aux is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router_aux_weight=aux))
    return cfg


def _moe_inputs(rng):
    cfg = _cfg(MOE)
    m, d = cfg.moe, cfg.d_model
    E, f, fs = m.n_physical, m.d_ff_expert, m.d_ff_expert * m.n_shared_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    params = {"router": w(d, m.n_experts), "we_gate": w(E, d, f),
              "we_up": w(E, d, f), "we_down": w(E, f, d),
              "shared": {"w_gate": w(d, fs), "w_up": w(d, fs),
                         "w_down": w(fs, d)}}
    x = rng.standard_normal((4, 8, d)).astype(np.float32)
    cot = rng.standard_normal((4, 8, d)).astype(np.float32)
    return params, x, cot


def _inputs():
    rng = np.random.default_rng(0)
    moe_params, x, cot = _moe_inputs(rng)
    init, batches = {}, {}
    for name, (arch, _, steps, _, aux, _) in TRAIN_CASES.items():
        cfg = _cfg(arch, aux)
        model = build_model(cfg, device="cpu", train=True).init(
            TRAIN_KW["seed"])
        init[name] = bridge.jax_params(model)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_KW["seq"],
                                      global_batch=TRAIN_KW["batch"],
                                      seed=TRAIN_KW["seed"]))
        batches[name] = [{k: v.numpy().astype(np.int32)
                          for k, v in data.batch(s).items()}
                         for s in range(steps)]
    dec = build_model(_cfg(MOE), device="cpu", train=True).init(4)
    return {"moe_params": moe_params, "moe_x": x, "moe_cot": cot,
            "train_cases": TRAIN_CASES, "train_kw": TRAIN_KW, "init": init,
            "batches": batches, "aux_weights": AUX_WEIGHTS,
            "decode_params": bridge.jax_params(dec),
            "decode_port": {n: p.detach().numpy()
                            for n, p in dec.impl.named_parameters()},
            "decode_tokens": rng.integers(0, 256, (DECODE_B, DECODE_S + 1)
                                          ).astype(np.int32),
            "cmean": rng.standard_normal((4, 64)).astype(np.float32)
            * np.array([[1.0], [3.0], [0.5], [2.0]], np.float32)}


_JAX = r"""
import dataclasses, os, pickle, sys
from functools import partial
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config import get_arch, reduced
from repro.data.pipeline import shard_batch
from repro.launch.train import _make_compressed_dp_step
from repro.models import build_model
from repro.models.moe import moe_apply
from repro.optim import AdamW, warmup_cosine
from repro.optim.compress import int8_compress
from repro.parallel.mesh import batch_axes
from repro_torch import bridge

d = sys.argv[1]
inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
out = {}

def mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

def cfg_of(arch, aux=None):
    cfg = reduced(get_arch(arch))
    if aux is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router_aux_weight=aux))
    return cfg

tree = lambda t: jax.tree.map(np.asarray, t)
m22 = mesh((2, 2), ("data", "model"))
x, cot = jnp.asarray(inp["moe_x"]), jnp.asarray(inp["moe_cot"])
for w in inp["aux_weights"]:
    cfg = cfg_of("qwen2-moe-a2.7b", w)
    def f(p, x):
        o, a = moe_apply(p, x, cfg, mesh=m22)
        return jnp.sum(o * cot) / x.shape[0] + w * a, (o, a)
    (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(inp["moe_params"], x)
    out[f"moe_{w}"] = dict(out=np.asarray(o), aux=float(a), gp=tree(gp),
                           gx=np.asarray(gx))

class Grab:  # the compressed step's "optimizer": hand back the synced grads
    def update(self, grads, state, params):
        return grads, state

kw = inp["train_kw"]
for name, (arch, shape, steps, compress, aux, lr) in inp["train_cases"].items():
    cfg = cfg_of(arch, aux)
    model = build_model(cfg)
    m = mesh(shape, ("data", "model"))
    opt = AdamW(lr=partial(warmup_cosine, peak_lr=lr,
                           warmup_steps=max(steps // 10, 1),
                           total_steps=steps), moment_dtype=jnp.float32)
    flat = {k: jnp.asarray(v)
            for k, v in bridge.from_jax(inp["init"][name], cfg).items()}
    state = opt.init(flat)
    update = jax.jit(opt.update)  # eager, each op of it compiles apart
    if compress:
        grads_fn = _make_compressed_dp_step(model, Grab(), m)
    else:
        grads_fn = jax.jit(lambda p, b: jax.value_and_grad(
            lambda q: model.loss(q, b, mesh=m), has_aux=True)(p))
    hist = []
    for step in range(steps):
        b = shard_batch({k: jnp.asarray(v) for k, v in
                         inp["batches"][name][step].items()}, m,
                        batch_axes(m))
        p = bridge.to_jax(tree(flat), cfg)
        if compress:
            g, _, loss = grads_fn(p, None, b)
        else:
            (loss, _), g = grads_fn(p, b)
        g = {k: jnp.asarray(v) for k, v in bridge.from_jax(tree(g), cfg).items()}
        flat, state = update(g, state, flat)
        hist.append(float(loss))
    out[name] = hist

cfg = cfg_of("qwen2-moe-a2.7b")
model = build_model(cfg)
toks = jnp.asarray(inp["decode_tokens"])
S = toks.shape[1] - 1
pre = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, mesh=m22,
                                         cache_len=S + 4,
                                         cache_dtype=jnp.float32))
logits0, cache = pre(inp["decode_params"], toks[:, :S])
dec = jax.jit(lambda p, t, c: model.decode_step(p, t, c, S, mesh=m22))
logits1, _ = dec(inp["decode_params"], toks[:, S], cache)
out["decode"] = (np.asarray(logits0), np.asarray(logits1))

m3 = mesh((2, 2, 1), ("pod", "data", "model"))
idx = NamedSharding(m3, P(("pod", "data"))).devices_indices_map((8,))
out["rows"] = {tuple(int(c) for c in np.argwhere(m3.devices == dev)[0]):
               (s[0].start or 0, s[0].stop or 8) for dev, s in idx.items()}
v = np.concatenate([np.linspace(-3.0, 3.0, 61), [0.5, 1.5, -2.5, 127.0]])
q, s = int8_compress(jnp.asarray(v, jnp.float32))
out["int8"] = (v, np.asarray(q), float(s))
from jax.experimental.shard_map import shard_map
from repro.optim.compress import compressed_mean
m41 = mesh((4,), ("data",))
out["cmean"] = np.asarray(shard_map(
    lambda x: compressed_mean(x, "data"), mesh=m41, in_specs=P("data"),
    out_specs=P("data"), check_rep=False)(jnp.asarray(inp["cmean"])))
pickle.dump(out, open(os.path.join(d, "jax.pkl"), "wb"))
"""


def _rows(x, mesh):
    return shard_batch({"x": x}, mesh, ("data",))["x"]


def _rank_moe(rank, inp, mesh, w):
    """One rank's ``moe_apply`` at (2, 2): its output rows, aux, and the
    data-parallel-averaged gradients (of this rank's experts).  The expert
    stacks are DTensors, as a trained model holds them."""
    from repro_torch.models.moe import moe_apply

    cfg = _cfg(MOE, w)
    p = inp["moe_params"]
    place = (mesh, placements((MODEL, None, None), mesh))
    leaves = {"router": torch.from_numpy(p["router"]).requires_grad_()}
    for k in ("we_gate", "we_up", "we_down"):
        leaves[k] = restore_to_mesh(torch.from_numpy(p[k]),
                                    place).requires_grad_()
    shared = {k: torch.from_numpy(v).requires_grad_()
              for k, v in p["shared"].items()}
    x = _rows(torch.from_numpy(inp["moe_x"]), mesh).requires_grad_()
    cot = _rows(torch.from_numpy(inp["moe_cot"]), mesh)
    out, aux = moe_apply({**leaves, "shared": shared}, x, cfg, mesh=mesh)
    loss = (out * cot).sum() / x.shape[0] + w * aux
    names = list(leaves) + [f"shared/{k}" for k in shared] + ["x"]
    grads = torch.autograd.grad(
        loss, list(leaves.values()) + list(shared.values()) + [x])
    grads = dict(zip(names, grads))
    gx = grads.pop("x")
    grads = {k: g.to_local() if k.startswith("we_") else g
             for k, g in grads.items()}
    group, nb = axis_group(mesh, (DATA,))
    grads = mean_grads(grads, group, nb)
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "gx": gx.numpy() / nb}


def _train_result(out):
    return {"history": out["history"],
            "params": {k: v.detach().numpy().copy()
                       for k, v in out["params"].items()}}


def _rank_main(rank, d):
    torch.set_num_threads(1)
    inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
    meshes = {s: make_mesh(s, ("data", "model"), "cpu")
              for s in {(2, 2), (4, 1)}}
    res = {"coord22": meshes[(2, 2)].get_coordinate()}
    debug = make_debug_mesh(2, 2, device="cpu")
    res["debug_mesh"] = (debug.mesh_dim_names, tuple(debug.shape),
                         debug.get_coordinate())
    for w in AUX_WEIGHTS:
        res[f"moe_{w}"] = _rank_moe(rank, inp, meshes[(2, 2)], w)
    for name, (arch, shape, steps, compress, aux, lr) in TRAIN_CASES.items():
        out = train(_cfg(arch, aux), reduced_cfg=False, steps=steps, lr=lr,
                    device="cpu", verbose=False, mesh=meshes[shape],
                    compress_grads=compress,
                    ckpt_dir=os.path.join(d, "ep_ckpt") if name == "moe_22"
                    else None, ckpt_every=2, **TRAIN_KW)
        res[name] = _train_result(out)
    # the same EP run cut after step 1 and resumed on the (2, 2) mesh
    kw = dict(TRAIN_KW, steps=3, lr=1e-3, device="cpu", verbose=False,
              mesh=meshes[(2, 2)], ckpt_dir=os.path.join(d, "ep_resume"),
              ckpt_every=1)
    train(_cfg(MOE), reduced_cfg=False, stop_at_step=2, **kw)
    out = train(_cfg(MOE), reduced_cfg=False, **kw)
    res["moe_22_resumed"] = dict(_train_result(out),
                                 resumed_from=out["resumed_from"])
    # EP prefill + decode at (2, 2)
    from repro_torch.models.moe import shard_expert_stacks

    mesh = meshes[(2, 2)]
    model = build_model(_cfg(MOE), device="cpu").load_state(
        {k: torch.from_numpy(v) for k, v in inp["decode_port"].items()})
    shard_expert_stacks(model.impl, model.cfg, mesh)
    toks = _rows(torch.from_numpy(inp["decode_tokens"]).long(), mesh)
    with torch.no_grad():
        l0, cache = model.prefill({"tokens": toks[:, :DECODE_S]},
                                  cache_len=DECODE_S + 4,
                                  cache_dtype=torch.float32, mesh=mesh)
        l1, _ = model.decode_step(toks[:, DECODE_S], cache, DECODE_S,
                                  mesh=mesh)
    res["decode"] = (l0.numpy(), l1.numpy())
    # a dim split over ("pod", "data"): DTensor's layout of the spec
    m3 = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    spec = (("pod", "data"),)
    local = restore_to_mesh(torch.arange(8.0), (m3, placements(spec, m3)))
    res["pod_data"] = (tuple(m3.get_coordinate()),
                       local.to_local().tolist())
    res["rows"] = {
        "pod_data": shard_batch({"t": torch.arange(8)}, m3,
                                ("pod", "data"))["t"].tolist(),
        "data": _rows(torch.arange(8), mesh).tolist(),
        "odd": _rows(torch.arange(5), mesh).tolist()}
    res["collector"] = TimingCollector(n_hosts=3).gather(float(rank + 1))
    res["cmean"] = compressed_mean(
        torch.from_numpy(inp["cmean"][rank:rank + 1]),
        axis_group(meshes[(4, 1)], (DATA,))[0]).numpy()
    # restore onto a subset mesh (rank 9 is past the world: dropped)
    sub = mesh_over_devices([0, 1, 9], (DATA,), device="cpu")
    full = torch.arange(12.0).reshape(4, 3)
    placed = restore_to_mesh({"w": full}, (sub, placements((DATA, None), sub)))
    res["subset"] = (sub.get_coordinate(), placed["w"].to_local().numpy())
    if sub.get_coordinate() is not None:
        res["subset_back"] = reshard(placed, "cpu")["w"].numpy()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parallel"))
    inp = _inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX, d], env=env,
                                cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_rank_main, 4, "cpu", args=(d,))
    finally:
        _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    with open(os.path.join(d, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    one = train(_cfg(MOE), reduced_cfg=False, steps=3, lr=1e-3, device="cpu",
                verbose=False, ckpt_dir=os.path.join(d, "one_ckpt"),
                ckpt_every=2, **TRAIN_KW)
    return dict(d=d, inp=inp, ranks=ranks, jax=ref, one=one)


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# ------------------------------------------------------------ moe_apply


@pytest.mark.parametrize("w", AUX_WEIGHTS)
def test_ep_moe_apply_matches_jax_shard_map(runs, w):
    ref = runs["jax"][f"moe_{w}"]
    B = ref["out"].shape[0]
    for r in runs["ranks"]:
        data = r["coord22"][0]
        rows = slice(data * B // 2, (data + 1) * B // 2)
        got = r[f"moe_{w}"]
        _close(got["out"], ref["out"][rows], TOL, "out")
        assert abs(got["aux"] - ref["aux"]) <= TOL
        _close(got["gx"], ref["gx"][rows], TOL, "d x")
        e_loc = ref["gp"]["we_gate"].shape[0] // 2
        experts = slice(r["coord22"][1] * e_loc, (r["coord22"][1] + 1) * e_loc)
        for k, g in got["grads"].items():
            want = (ref["gp"]["shared"][k.split("/")[1]] if "/" in k
                    else ref["gp"][k])
            if k.startswith("we_"):
                want = want[experts]
            _close(g, want, TOL, k)


# ------------------------------------------------------------------ train


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_mesh_history_matches_jax(runs, name):
    tol = INT8_TOL if TRAIN_CASES[name][3] else TOL
    hists = [r[name]["history"] for r in runs["ranks"]]
    assert all(h == hists[0] for h in hists), "ranks disagree"
    _close(hists[0], runs["jax"][name], tol, name)


@pytest.mark.parametrize("name", ["moe_22", "moe_22_aux1"])
def test_model_group_replicas_stay_bit_identical(runs, name):
    """Ranks 0, 1 form a model group (data 0), 2, 3 the other; after three
    steps every replicated param is bit-identical on all four ranks, and
    an expert shard on the two ranks that hold it."""
    ps = [r[name]["params"] for r in runs["ranks"]]
    coords = [tuple(r["coord22"]) for r in runs["ranks"]]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for k in ps[0]:
        if k.rsplit(".", 1)[-1].startswith("we_"):
            assert np.array_equal(ps[0][k], ps[2][k]), k
            assert np.array_equal(ps[1][k], ps[3][k]), k
            assert not np.array_equal(ps[0][k], ps[1][k]), k
        else:
            assert all(np.array_equal(ps[0][k], p[k]) for p in ps[1:]), k


def test_ep_resume_on_the_mesh_continues_the_run(runs):
    """A (2, 2) EP run stopped after step 1 and resumed by the same call
    on the same mesh (``train``'s restore: the logical arrays placed onto
    each rank's expert shard) equals the uninterrupted run: step 2's loss
    and every rank's params, its expert shards included."""
    for r in runs["ranks"]:
        got, whole = r["moe_22_resumed"], r["moe_22"]
        assert got["resumed_from"] == 1
        assert len(got["history"]) == 1
        _close(got["history"], whole["history"][2:], TOL, "resumed loss")
        assert set(got["params"]) == set(whole["params"])
        for k, v in got["params"].items():
            _close(v, whole["params"][k], TOL, k)


def test_ep_checkpoint_holds_the_logical_arrays(runs):
    def layout(base):
        man = _read_manifest(base, latest_step(base))
        return {l["name"]: tuple(l["shape"]) for l in man["leaves"]}

    ep = layout(os.path.join(runs["d"], "ep_ckpt"))
    one = layout(os.path.join(runs["d"], "one_ckpt"))
    assert ep == one and any("we_gate" in k for k in ep)


def test_ep_decode_step_matches_jax(runs):
    l0, l1 = runs["jax"]["decode"]
    for r in runs["ranks"]:
        data = r["coord22"][0]
        rows = slice(data * DECODE_B // 2, (data + 1) * DECODE_B // 2)
        _close(r["decode"][0], l0[rows], TOL, "prefill logits")
        _close(r["decode"][1], l1[rows], TOL, "decode logits")


# --------------------------------------------------------- layout, ranks


class FakeMesh:
    """Shape-only stand-in (``tests/test_sharding_rules.py:11``)."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(shape)


def test_shard_batch_rows_follow_jax_named_sharding(runs):
    """Each rank's rows on the (pod 2, data 2, model 1) mesh are the rows
    JAX's NamedSharding gives the device at its coordinate; on (2, 2) the
    ranks of one model group get the same rows, and an indivisible batch
    dim stays whole, as batch_spec leaves it."""
    for r in runs["ranks"]:
        coord = r["pod_data"][0]
        lo, hi = runs["jax"]["rows"][coord]
        assert r["rows"]["pod_data"] == list(range(lo, hi)), coord
        data = r["coord22"][0]
        assert r["rows"]["data"] == list(range(4 * data, 4 * data + 4))
        assert r["rows"]["odd"] == list(range(5))
    m22 = FakeMesh((2, 2), ("data", "model"))
    assert ShardingRules(m22, ShardingConfig()).batch_spec("t", (5,)) == (
        None,)


def test_pod_data_placement_is_jax_major_to_minor(runs):
    """A dim split over ("pod", "data"): each rank's DTensor shard holds
    the rows JAX's NamedSharding gives the device at its coordinate."""
    for r in runs["ranks"]:
        coord, rows = r["pod_data"]
        lo, hi = runs["jax"]["rows"][coord]
        assert rows == [float(i) for i in range(lo, hi)], coord


def test_debug_mesh_lays_ranks_as_jax_make_mesh(runs):
    """``make_debug_mesh(2, 2)``: rank r at (r // 2, r % 2), row-major over
    (data, model), as ``jax.make_mesh`` lays devices."""
    for rank, r in enumerate(runs["ranks"]):
        names, shape, coord = r["debug_mesh"]
        assert (names, shape) == (("data", "model"), (2, 2))
        assert list(coord) == [rank // 2, rank % 2]


def test_rank_zero_timing_collector(runs):
    got = [r["collector"] for r in runs["ranks"]]
    assert got[0] == [1.0, 2.0, 3.0] and got[1:] == [None] * 3


def test_restore_to_subset_mesh(runs):
    full = np.arange(12.0).reshape(4, 3)
    for rank, r in enumerate(runs["ranks"]):
        coord, local = r["subset"]
        if rank < 2:
            assert coord == [rank] or tuple(coord) == (rank,)
            assert np.array_equal(local, full[2 * rank:2 * rank + 2])
            assert np.array_equal(r["subset_back"], full)
        else:
            assert coord is None and local.size == 0


# ------------------------------------------------------------ compression


def test_compressed_case_tells_int8_from_fp32(runs):
    """The control of the compressed xlstm case: at its lr the port's
    uncompressed (4, 1) history differs from JAX's compressed one by more
    than ``INT8_TOL``, so an uncompressed sync (or a compressed mean off
    by its scale) cannot pass as the compressed one."""
    err = float(np.max(np.abs(np.asarray(runs["ranks"][0]["xlstm_41"]
                                         ["history"])
                              - np.asarray(runs["jax"]["xlstm_41_int8"]))))
    assert err > INT8_TOL, err


def test_compressed_mean_matches_jax_on_four_ranks(runs):
    """``compressed_mean`` over the four ranks of (4, 1)'s ``"data"``: each
    rank's result equals JAX's ``shard_map`` of its own on the same rows
    (a wrong scale or group size, which Adam would hide in a history,
    shows here), and lies within half a quantum a rank of the fp32 mean."""
    ref = runs["jax"]["cmean"]
    x = runs["inp"]["cmean"]
    quantum = np.abs(x).max() / 127.0
    for rank, r in enumerate(runs["ranks"]):
        _close(r["cmean"][0], ref[rank], 1e-7, "compressed mean")
        _close(r["cmean"][0], x.mean(0), quantum / 2, "vs the fp32 mean")


def test_int8_compress_matches_jax(runs):
    v, q, s = runs["jax"]["int8"]
    tq, ts = int8_compress(torch.from_numpy(v).float())
    assert float(ts) == pytest.approx(s, rel=1e-7)
    assert np.array_equal(tq.numpy(), q)  # ties round half to even in both


def test_int8_roundtrip_bounded_error():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=30, deadline=None)
    @hypothesis.given(seed=st.integers(0, 1000), scale=st.floats(1e-3, 1e3))
    def check(seed, scale):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(128, generator=g) * scale
        q, s = int8_compress(x)
        err = float((int8_decompress(q, s) - x).abs().max())
        assert err <= float(s) * 0.5 + 1e-9  # half-ULP of the int8 grid

    check()


def test_error_feedback_unbiased_over_time():
    """EF compensates quantization: averaged update ≈ averaged gradient."""
    def sync(x):
        return int8_decompress(*int8_compress(x))

    g = {"w": torch.linspace(-1.0, 1.0, 64)}
    e = ErrorFeedback.init(g)
    total = torch.zeros(64)
    for _ in range(50):
        out, e = ErrorFeedback.apply(g, e, sync)
        total = total + out["w"]
    assert float((total / 50 - g["w"]).abs().max()) < 1e-3
