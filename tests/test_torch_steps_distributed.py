"""The placed train, prefill and serve steps on four ranks against JAX's
jitted ``build_step(...).fn`` on the same (data 2, model 2) mesh, on the CPU.

The port's ranks come from one spawn of four ``gloo`` ranks, one torch
thread each (``repro_torch.parallel.mesh.run_ranks``).  Beside them one
JAX subprocess forces four host devices, builds its mesh with
``jax.sharding.Mesh`` (Auto axes: ``make_debug_mesh``'s Explicit axes
break jax 0.9's ``constrain``), jits each step's ``fn`` with
``in_shardings``/``out_shardings`` from its specs and compiles at XLA
optimization level 0.  Both take the port's seeded init of each reduced
model (whole, numpy; JAX through ``repro_torch.bridge``, the port through
``make_train_state(weights=)``, which places it by the rules), the
``SyntheticLM`` batches and one set of random prompts, tokens and caches.
The port runs its kernel route (``use_kernels``: on CPU tensors each
kernel's plain version), so a prefill at S 272 goes through the flash
wrapper on each rank's local heads.

Cases: reduced qwen3-0.6b (tied vocab-parallel head, qk-norm, KV heads
split over "model"), reduced qwen2-moe-a2.7b at ``grad_accum=2`` (EP and
FSDP on the expert stacks, the strided microbatches) and reduced
llama3-405b (one KV head on a 2-way model axis: the split-head gather and
a decode cache split over the sequence; its config's ``grad_accum`` 16
clamps to 4, bf16 accumulators, sqrt remat).

* two train steps: every rank's losses within 1e-5 of JAX's; each rank's
  local block of every param equals JAX's addressable shard at its mesh
  coordinate at init (bit for bit) and after the steps (within a quarter
  of the two steps' summed lr: Adam moves an entry by up to lr a step,
  and JAX decays its stacked (G, d) norms — ROADMAP queue 3); the first
  moments within 1e-6 (+1e-4 relative; 2^-7 relative with bf16
  accumulators): they are the clipped gradients, so a gradient reduced
  over a wrong axis shows there;
* leaves replicated over an axis are bit-identical on its replicas;
* the clamped ``grad_accum`` equals JAX's;
* the prefill step's logits (each rank's rows, whole vocab) within 1e-5
  and its bf16 cache blocks within one bf16 rounding of JAX's shards;
  two serve steps' logits within 1e-5;
* a placed checkpoint (every leaf gathered over "data" and "model")
  restores through ``restore_to_mesh`` onto the same blocks bit for bit.
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
from repro_torch.config import ShapeConfig, default_sharding, get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLM, shard_batch
from repro_torch.launch.steps import build_step
from repro_torch.launch.train import make_train_state
from repro_torch.models import build_model
from repro_torch.parallel import make_mesh
from repro_torch.parallel.mesh import run_ranks
from repro_torch.parallel.sharding import local_block, placements, spec_axes

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
#: name: (arch, ShardingConfig overrides of both packages)
CASES = {"qwen3": ("qwen3-0.6b", {}),
         "moe": ("qwen2-moe-a2.7b", {"grad_accum": 2}),
         "llama": ("llama3-405b", {})}
SEED = 3
B, S, STEPS = 8, 32, 2  # train
BP, SP = 4, 272  # prefill: S > 256 takes the flash route
SC, POS = 16, 9  # serve: cache length, first position


def _cfg(arch):
    return reduced(get_arch(arch))


def _inputs():
    rng = np.random.default_rng(0)
    out = {"cases": CASES, "flat": {}, "tree": {}, "batches": {},
           "prompts": {}, "serve": {}}
    for name, (arch, _) in CASES.items():
        cfg = _cfg(arch)
        model = build_model(cfg, device="cpu", train=True).init(SEED)
        flat = {n: p.detach().numpy().copy()
                for n, p in model.impl.named_parameters()}
        out["flat"][name] = flat
        out["tree"][name] = bridge.to_jax(flat, cfg)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=SEED))
        out["batches"][name] = [{k: v.numpy().astype(np.int32)
                                 for k, v in data.batch(s).items()}
                                for s in range(STEPS)]
        out["prompts"][name] = rng.integers(0, cfg.vocab, (BP, SP)).astype(
            np.int32)
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        out["serve"][name] = {
            "cache": [{k: rng.standard_normal((BP, K, SC, hd)).astype(
                np.float32) for k in ("k", "v")}
                for _ in range(cfg.n_layers)],
            "tokens": rng.integers(0, cfg.vocab, (2, BP)).astype(np.int32)}
    return out


_JAX = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config import ShapeConfig, default_sharding, get_arch, reduced
from repro.launch.steps import build_step, make_optimizer

d = sys.argv[1]
inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
is_p = lambda x: isinstance(x, P)

def shardings(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_p)

def jitted(spec):
    return jax.jit(spec.fn, in_shardings=shardings(spec.in_specs),
                   out_shardings=shardings(spec.out_specs))

def put(tree, specs):
    return jax.device_put(tree, shardings(specs))

def blocks(specs, shapes):
    # per leaf: {mesh coordinate: ((start, stop), ...)}
    def one(s, x):
        m = NamedSharding(mesh, s).devices_indices_map(tuple(x.shape))
        return {tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0]):
                tuple((sl.start or 0, x.shape[i] if sl.stop is None
                       else sl.stop) for i, sl in enumerate(idx))
                for dev, idx in m.items()}
    return jax.tree.map(one, specs, shapes, is_leaf=is_p)

tree = lambda t: jax.tree.map(np.asarray, t)
out = {}
for name, (arch, over) in inp["cases"].items():
    cfg = reduced(get_arch(arch))
    shcfg = dataclasses.replace(default_sharding(cfg), **over)
    res = out[name] = {}
    spec = build_step(cfg, ShapeConfig("t", %(S)d, %(B)d, "train"), mesh,
                      shcfg=shcfg)
    fv = dict(zip(spec.fn.__code__.co_freevars,
                  (c.cell_contents for c in spec.fn.__closure__)))
    res["ga"] = fv["ga"]
    params = inp["tree"][name]
    res["param_blocks"] = blocks(spec.in_specs[0], params)
    opt = make_optimizer(cfg).init(jax.tree.map(jnp.asarray, params))
    p, o = put(params, spec.in_specs[0]), put(opt, spec.in_specs[1])
    step = jitted(spec)
    hist = []
    for b in inp["batches"][name]:
        p, o, loss, _ = step(p, o, put(b, spec.in_specs[2]))
        hist.append(float(loss))
    res.update(hist=hist, params=tree(p), mu=tree(o.mu))
    pre = build_step(cfg, ShapeConfig("p", %(SP)d, %(BP)d, "prefill"), mesh,
                     shcfg=shcfg)
    logits, cache = jitted(pre)(put(params, pre.in_specs[0]), put(
        {"tokens": inp["prompts"][name]}, pre.in_specs[1]))
    res["prefill"] = (np.asarray(logits), tree(cache),
                      blocks(pre.out_specs[1], cache))
    srv = build_step(cfg, ShapeConfig("d", %(SC)d, %(BP)d, "decode"), mesh,
                     shcfg=shcfg)
    layers = inp["serve"][name]["cache"]
    cache = {"groups": {"p0": {k: np.stack([l[k] for l in layers])
                               for k in ("k", "v")}}, "rem": []}
    fn, c = jitted(srv), put(cache, srv.in_specs[2])
    ps = put(params, srv.in_specs[0])
    served = []
    for i, tok in enumerate(inp["serve"][name]["tokens"]):
        logits, c = fn(ps, put(tok, srv.in_specs[1]), c,
                       jnp.asarray(%(POS)d + i, jnp.int32))
        served.append(np.asarray(logits))
    res["serve"] = served
pickle.dump(out, open(os.path.join(d, "jax.pkl"), "wb"))
""" % dict(S=S, B=B, SP=SP, BP=BP, SC=SC, POS=POS)


def _shcfg(arch, over):
    return default_sharding(_cfg(arch), use_kernels=True, **over)


def _state(spec, mesh, inp, name, with_opt=True):
    weights = {n: torch.from_numpy(v) for n, v in inp["flat"][name].items()}
    return make_train_state(spec.model, spec.optimizer if with_opt else None,
                            SEED, mesh=mesh, rules=spec.rules, weights=weights)


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _ckpt_round_trip(spec, params, opt, mesh, base):
    """A placed state saved (every leaf gathered) by rank 0, restored
    through ``restore_to_mesh`` onto every rank's blocks: bit-exact?"""
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.train import _logical, _logical_like, _placed_locals

    mgr = CheckpointManager(base, every=1, keep=1)
    tree = _logical(spec.model, params, opt)
    if dist.get_rank() == 0:
        mgr.save(STEPS, tree)
    dist.barrier()
    restored, manifest = mgr.restore_latest(
        _logical_like(spec.model, params, opt))
    got = _placed_locals(spec.model, restored, torch.device("cpu"))
    ok = int(manifest["step"]) == STEPS and got["opt"].count == opt.count
    for live, back in ((params, got["params"]), (opt.mu, got["opt"].mu),
                       (opt.nu, got["opt"].nu)):
        ok = ok and all(torch.equal(live[n], back[n]) for n in live)
    logical = all(tuple(tree["params"][n].shape) == tuple(p.shape) for n, p
                  in spec.model.impl.named_parameters())
    dist.barrier()  # nobody removes the directory while another reads
    return ok and logical


def _rank_main(rank, d):
    torch.set_num_threads(1)
    inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    res = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for name, (arch, over) in CASES.items():
        cfg, shcfg = _cfg(arch), _shcfg(arch, over)
        spec = build_step(cfg, ShapeConfig("t", S, B, "train"), mesh,
                          shcfg=shcfg, device="cpu")
        params, opt = _state(spec, mesh, inp, name)
        r = res[name] = {"init": _np(params), "ga": spec.grad_accum,
                         "specs": spec.in_specs[0]}
        hist = []
        for b in inp["batches"][name]:
            b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()},
                            mesh, ("data",))
            params, opt, loss, _ = spec.fn(params, opt, b)
            hist.append(float(loss))
        r.update(hist=hist, params=_np(params), mu=_np(opt.mu))
        r["ckpt"] = _ckpt_round_trip(spec, params, opt, mesh,
                                     os.path.join(d, f"ckpt_{name}"))
        pre = build_step(cfg, ShapeConfig("p", SP, BP, "prefill"), mesh,
                         shcfg=shcfg, device="cpu")
        pp, _ = _state(pre, mesh, inp, name, with_opt=False)
        toks = shard_batch({"tokens": torch.from_numpy(
            inp["prompts"][name])}, mesh, ("data",))
        logits, cache = pre.fn(pp, toks)
        r["prefill"] = (logits.numpy(), [{k: v.float().numpy() for k, v in
                                          layer.items()} for layer in cache])
        srv = build_step(cfg, ShapeConfig("d", SC, BP, "decode"), mesh,
                         shcfg=shcfg, device="cpu")
        sp, _ = _state(srv, mesh, inp, name, with_opt=False)
        cache = [{k: local_block(torch.from_numpy(v), mesh, placements(
            srv.in_specs[2][i][k], mesh)).contiguous() for k, v in
            layer.items()} for i, layer in enumerate(inp["serve"][name]
                                                     ["cache"])]
        served = []
        for i, tok in enumerate(inp["serve"][name]["tokens"]):
            tok = shard_batch({"t": torch.from_numpy(tok)}, mesh,
                              ("data",))["t"]
            logits, cache = srv.fn(sp, tok, cache, POS + i)
            served.append(logits.numpy())
        r["serve"] = served
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("steps"))
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
    return dict(inp=inp, ranks=ranks, jax=ref)


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64))))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _jax_leaves(name, tree):
    """({port name: (JAX leaf index, stacked entries, layer's index in
    its stack)}, the JAX leaves) of a JAX-layout params tree: each leaf
    replaced by its index · 10⁴ plus its row index, the bridge's
    unstacking tells where each port param comes from."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten(tree)
    ids = treedef.unflatten([
        np.broadcast_to((i * 10_000 + np.arange(x.shape[0])).reshape(
            (-1,) + (1,) * (x.ndim - 1)), x.shape)
        for i, x in enumerate(flat)])
    out = {}
    for n, a in bridge.from_jax(ids, _cfg(CASES[name][0])).items():
        i, g = divmod(int(np.asarray(a).flat[0]), 10_000)
        stacked = flat[i].ndim - np.ndim(a)
        out[n] = (i, stacked, g if stacked else None)
    return out, flat


def _jax_block(whole, blocks, coord, stacked, g):
    """JAX's addressable shard at ``coord`` of a (stacked) leaf, as the
    port's layer holds it."""
    idx = tuple(slice(a, b) for a, b in blocks[coord])
    x = np.asarray(whole)[idx]
    return x[g] if stacked else x


@pytest.fixture(scope="module")
def leaves(runs):
    """Per case: {port name: (whole JAX init leaf, its blocks, final JAX
    leaf, final JAX mu, stacked, layer)}."""
    import jax

    out = {}
    for name in CASES:
        ref = runs["jax"][name]
        tree = runs["inp"]["tree"][name]
        origin, flat = _jax_leaves(name, tree)
        blocks = jax.tree_util.tree_flatten(
            ref["param_blocks"], is_leaf=lambda x: isinstance(x, dict)
            and x and all(isinstance(k, tuple) for k in x))[0]
        fin = jax.tree_util.tree_leaves(ref["params"])
        mu = jax.tree_util.tree_leaves(ref["mu"])
        out[name] = {n: (flat[i], blocks[i], fin[i], mu[i], st, g)
                     for n, (i, st, g) in origin.items()}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_train_losses_match_jax(runs, name):
    ref = runs["jax"][name]["hist"]
    for r in runs["ranks"]:
        assert r[name]["hist"] == runs["ranks"][0][name]["hist"]
        _close(r[name]["hist"], ref, TOL, f"{name} losses")


@pytest.mark.parametrize("name", list(CASES))
def test_grad_accum_clamped_as_jax(runs, name):
    want = runs["jax"][name]["ga"]
    assert all(r[name]["ga"] == want for r in runs["ranks"])
    assert want == {"qwen3": 1, "moe": 2, "llama": 4}[name]


@pytest.mark.parametrize("name", list(CASES))
def test_local_shards_equal_jax_addressable_shards(runs, leaves, name):
    """Each rank's block of every param at init is JAX's addressable shard
    at the rank's coordinate, bit for bit; after two steps within a
    quarter of the summed lr; the first moments within the gradient
    tolerance."""
    lr = 3e-4 / 200 * (1 + 2)  # warmup: lr(1) + lr(2)
    rel = 2.0 ** -7 if name == "llama" else 1e-4  # bf16 accumulators
    for r in runs["ranks"]:
        coord, got = r["coord"], r[name]
        for n, (whole, blocks, fin, mu, st, g) in leaves[name].items():
            want0 = _jax_block(whole, blocks, coord, st, g)
            assert got["init"][n].shape == want0.shape, n
            assert np.array_equal(got["init"][n], want0), n
            _close(got["params"][n], _jax_block(fin, blocks, coord, st, g),
                   lr / 4, f"{n} after {STEPS} steps")
            want_mu = _jax_block(mu, blocks, coord, st, g)
            _close(got["mu"][n], want_mu,
                   1e-6 + rel * float(np.abs(want_mu).max()), f"mu {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_identical(runs, name):
    """Ranks that differ only along axes a leaf is not split on hold the
    same block, bit for bit, after two steps (a gradient reduced over a
    shard axis, or a replica's update off by a rounding, would part
    them)."""
    ranks = runs["ranks"]
    specs = ranks[0][name]["specs"]
    split_any = False
    for n, spec in specs.items():
        axes = spec_axes(spec)
        keep = [i for i, a in enumerate(("data", "model")) if a in axes]
        groups = {}
        for r in ranks:
            groups.setdefault(tuple(r["coord"][i] for i in keep), []).append(
                r[name]["params"][n])
        for blocks in groups.values():
            assert all(np.array_equal(blocks[0], b) for b in blocks[1:]), n
        split_any |= len(groups) < len(ranks)
    assert split_any


@pytest.mark.parametrize("name", list(CASES))
def test_placed_checkpoint_round_trip(runs, name):
    assert all(r[name]["ckpt"] for r in runs["ranks"])


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(runs, name):
    import jax

    logits, cache, blocks = runs["jax"][name]["prefill"]
    cfg = _cfg(CASES[name][0])
    for r in runs["ranks"]:
        coord = r["coord"]
        rows = slice(coord[0] * BP // 2, (coord[0] + 1) * BP // 2)
        got_logits, got_cache = r[name]["prefill"]
        _close(got_logits, logits[rows], TOL, "prefill logits")
        assert len(got_cache) == cfg.n_layers
        for i, layer in enumerate(got_cache):
            for k, v in layer.items():
                whole = cache["groups"]["p0"][k]
                want = _jax_block(whole, blocks["groups"]["p0"][k], coord,
                                  1, i)
                assert v.shape == want.shape, (i, k)
                want = np.asarray(want, np.float32)
                _close(v, want, 2.0 ** -8 * float(np.abs(want).max()),
                       f"cache {i} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_serve_steps_match_jax(runs, name):
    ref = runs["jax"][name]["serve"]
    for r in runs["ranks"]:
        data = r["coord"][0]
        rows = slice(data * BP // 2, (data + 1) * BP // 2)
        for step, (got, want) in enumerate(zip(r[name]["serve"], ref)):
            _close(got, want[rows], TOL, f"serve step {step}")
