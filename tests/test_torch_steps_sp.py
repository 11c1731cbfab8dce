"""Megatron-SP and the global-batch MoE in the placed train step, on four
ranks against JAX's jitted ``build_step(...).fn`` on the same meshes, on
the CPU.

The harness is ``tests/test_torch_steps_distributed.py``'s: one spawn of
four ``gloo`` ranks (one torch thread each) beside JAX subprocesses (two,
each compiling every other case) forcing four host devices (``jax.sharding.Mesh``, XLA optimization level
0), both from the port's seeded init of each reduced model and the same
``SyntheticLM`` batches, the port on its kernel route (each kernel's
plain version on CPU tensors).  Two train steps a case.

Cases, on (data 2, model 2) unless named:

* ``seq_parallel=True`` (Megatron-SP: the residual stream and the remat
  carries split along the sequence over "model"): reduced qwen3-0.6b;
  qwen2-moe-a2.7b (expert parallelism under SP at ``grad_accum=2``,
  strided microbatches; the other MoE cases at 1); recurrentgemma-9b at 4 layers (one remainder layer runs
  on the whole sequence first, as in JAX); llama3-405b at 4 layers (sqrt
  remat of two segments of two groups, one KV head split over "model",
  bf16 accumulators, ``grad_accum=2``); xlstm-125m; the global-batch MoE
  under SP with ``shard_experts`` on, its stacks left whole over "model"
  (every rank computes them whole); and llama3-405b at head dim 18 and
  d_ff 130 on a model-only (1, 4) mesh, which 4 divides neither: its one
  KV head's ``wk``/``wv`` replicated (every rank projects the KV head
  from the gathered input) and its SwiGLU whole over "model" (every rank
  computes it on the gathered sequence and keeps its positions).
* The paper baseline's MoE (``shard_experts=False``: the rules split
  each expert stack's hidden dim over "model"): 8 unpadded experts, which
  2 divides, so JAX's expert-parallel branch re-lays the stacks into each
  rank's whole experts; 5 experts, which 4 and 2 do not divide, on a
  model-only (1, 4) mesh (JAX's global branch, the hidden-split products'
  partial sums over "model") and on (2, 2) under SP (the global batch
  split over "data": the capacity, the kept assignments and the aux loss
  are the global batch's; the partials reduce-scattered).  Every case runs on all four ranks: a mesh over some
  of them would make its ranks create process groups the others never
  join (``mesh.axis_group`` of two axes calls ``new_group``, which every
  rank of the world must call).

Checks: every rank's losses within 1e-5 of JAX's; each rank's block of
every param equal to JAX's addressable shard at init (bit for bit) and
after the steps within a quarter of the summed lr; the first moments (the
clipped gradients) within 1e-6 + 1e-4 relative (2^-7 with bf16
accumulators); xlstm at ``tests/test_torch_xlstm.py``'s tolerances; the
clamped ``grad_accum`` equal to JAX's; leaves replicated over an axis
bit-identical on its replicas.  A unit test without ranks holds the port's
SP predicate against JAX's ``Decoder.forward`` over a grid of sequence
lengths, model-axis sizes, stub lengths and cache flags.
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
from repro_torch.launch.steps import build_step, make_optimizer
from repro_torch.launch.train import make_train_state
from repro_torch.models import build_model
from repro_torch.models.transformer import seq_parallel_on
from repro_torch.parallel import make_mesh
from repro_torch.parallel.mesh import run_ranks
from repro_torch.parallel.sharding import spec_axes

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SP = {"seq_parallel": True}
BASE = {"shard_experts": False}
GA = {"grad_accum": 2}  # qwen2-moe's 8 and llama's 16 would clamp to 4-8
ONE = {"grad_accum": 1}
FIVE = {"moe": {"n_experts": 5}}
#: name: (arch, ShardingConfig overrides, ``reduced`` overrides (a dict for
#: ``moe`` replaces its fields), mesh shape), the same in both packages
CASES = {
    "qwen3": ("qwen3-0.6b", SP, {}, (2, 2)),
    "moe": ("qwen2-moe-a2.7b", {**SP, **GA}, {}, (2, 2)),
    "rg": ("recurrentgemma-9b", SP, {"n_layers": 4}, (2, 2)),
    "llama": ("llama3-405b", {**SP, **GA}, {"n_layers": 4}, (2, 2)),
    "xlstm": ("xlstm-125m", SP, {}, (2, 2)),
    "moe8_base": ("qwen2-moe-a2.7b", {**BASE, **ONE}, {}, (2, 2)),
    "moe5_base_1x4": ("qwen2-moe-a2.7b", {**BASE, **ONE}, FIVE, (1, 4)),
    "moe5_base_sp": ("qwen2-moe-a2.7b", {**BASE, **SP, **ONE}, FIVE, (2, 2)),
    "moe5_whole_sp": ("qwen2-moe-a2.7b", {**SP, **ONE}, FIVE, (2, 2)),
    "llama_whole_sp": ("llama3-405b", {**SP, **ONE},
                       {"head_dim": 18, "d_ff": 130}, (1, 4)),
}
SEED = 3
B, S, STEPS = 8, 32, 2
#: xlstm's tolerances (``tests/test_torch_steps_distributed.py``'s XLSTM)
XLSTM = {"mu": (1e-5, 1e-4), "params": (2.0, 0.05)}


def _cfg(name):
    """Case ``name``'s reduced config (the JAX subprocess builds its own
    alike)."""
    arch, _, over, _ = CASES[name]
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(reduced(get_arch(arch)).moe,
                                          **over["moe"])
    return reduced(get_arch(arch), **over)


def _shcfg(name):
    return default_sharding(_cfg(name), use_kernels=True, **CASES[name][1])


def _inputs():
    out = {"cases": CASES, "flat": {}, "tree": {}, "batches": {}}
    for name in CASES:
        cfg = _cfg(name)
        model = build_model(cfg, device="cpu", train=True).init(SEED)
        flat = {n: p.detach().numpy().copy()
                for n, p in model.impl.named_parameters()}
        out["flat"][name] = flat
        out["tree"][name] = bridge.to_jax(flat, cfg)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=SEED))
        out["batches"][name] = [
            {k: v.numpy().astype(np.int32) for k, v in data.batch(s).items()}
            for s in range(STEPS)]
    return out


_JAX = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.config as jcfg
from repro.launch.steps import build_step, make_optimizer

d, part = sys.argv[1], int(sys.argv[2])
inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
is_p = lambda x: isinstance(x, P)
tree = lambda t: jax.tree.map(np.asarray, t)
out = {}
for name, (arch, over, cfg_over, shape) in list(inp["cases"].items())[
        part::%(PARTS)d]:
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    sh = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                    is_leaf=is_p)
    cfg_over = dict(cfg_over)
    base = jcfg.reduced(jcfg.get_arch(arch))
    if "moe" in cfg_over:
        cfg_over["moe"] = dataclasses.replace(base.moe, **cfg_over["moe"])
    cfg = jcfg.reduced(jcfg.get_arch(arch), **cfg_over)
    shcfg = dataclasses.replace(jcfg.default_sharding(cfg), **over)
    spec = build_step(cfg, jcfg.ShapeConfig("t", %(S)d, %(B)d, "train"), mesh,
                      shcfg=shcfg)
    fv = dict(zip(spec.fn.__code__.co_freevars,
                  (c.cell_contents for c in spec.fn.__closure__)))
    params = inp["tree"][name]

    def blocks(s, x):
        m = NamedSharding(mesh, s).devices_indices_map(tuple(x.shape))
        return {tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0]):
                tuple((sl.start or 0, x.shape[i] if sl.stop is None
                       else sl.stop) for i, sl in enumerate(idx))
                for dev, idx in m.items()}

    res = out[name] = {"ga": fv["ga"], "param_blocks": jax.tree.map(
        blocks, spec.in_specs[0], params, is_leaf=is_p)}
    opt = make_optimizer(cfg).init(jax.tree.map(jnp.asarray, params))
    p = jax.device_put(params, sh(spec.in_specs[0]))
    o = jax.device_put(opt, sh(spec.in_specs[1]))
    step = jax.jit(spec.fn, in_shardings=sh(spec.in_specs),
                   out_shardings=sh(spec.out_specs))
    hist = []
    for b in inp["batches"][name]:
        p, o, loss, _ = step(p, o, jax.device_put(b, sh(spec.in_specs[2])))
        hist.append(float(loss))
    res.update(hist=hist, params=tree(p), mu=tree(o.mu))
pickle.dump(out, open(os.path.join(d, f"jax{part}.pkl"), "wb"))
""" % dict(S=S, B=B, PARTS=2)


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _rank_main(rank, d):
    torch.set_num_threads(1)
    inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in ((2, 2), (1, 4))}
    res = {}
    for name, (_, _, _, shape) in CASES.items():
        mesh = meshes[shape]
        spec = build_step(_cfg(name), ShapeConfig("t", S, B, "train"), mesh,
                          shcfg=_shcfg(name), device="cpu")
        weights = {n: torch.from_numpy(v)
                   for n, v in inp["flat"][name].items()}
        params, opt = make_train_state(spec.model, spec.optimizer, SEED,
                                       mesh=mesh, rules=spec.rules,
                                       weights=weights)
        r = res[name] = {"coord": tuple(mesh.get_coordinate()),
                         "init": _np(params), "ga": spec.grad_accum,
                         "specs": spec.in_specs[0]}
        hist = []
        for b in inp["batches"][name]:
            b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()},
                            mesh, ("data",))
            params, opt, loss, _ = spec.fn(params, opt, b)
            hist.append(float(loss))
        r.update(hist=hist, params=_np(params), mu=_np(opt.mu))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("steps_sp"))
    inp = _inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # two JAX subprocesses, each compiling every other case
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, d, str(part)],
                              env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for part in range(2)]
    try:
        ranks = run_ranks(_rank_main, 4, "cpu", args=(d,))
    finally:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    ref = {}
    for part, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, err[-3000:]
        with open(os.path.join(d, f"jax{part}.pkl"), "rb") as f:
            ref.update(pickle.load(f))
    return dict(inp=inp, ranks=ranks, jax=ref)


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"]]


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64))))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _leaves(runs, name):
    """{port name: (whole JAX init leaf, its blocks, final JAX leaf, final
    JAX mu, stacked, layer)}: each JAX leaf replaced by its index · 10⁴
    plus its row index, the bridge's unstacking tells where each port
    param comes from."""
    import jax

    tree, ref = runs["inp"]["tree"][name], runs["jax"][name]
    flat, treedef = jax.tree_util.tree_flatten(tree)
    ids = treedef.unflatten([
        np.broadcast_to((i * 10_000 + np.arange(x.shape[0])).reshape(
            (-1,) + (1,) * (x.ndim - 1)), x.shape)
        for i, x in enumerate(flat)])
    blocks = jax.tree_util.tree_flatten(
        ref["param_blocks"], is_leaf=lambda x: isinstance(x, dict)
        and x and all(isinstance(k, tuple) for k in x))[0]
    fin = jax.tree_util.tree_leaves(ref["params"])
    mu = jax.tree_util.tree_leaves(ref["mu"])
    out = {}
    for n, a in bridge.from_jax(ids, _cfg(name)).items():
        i, g = divmod(int(np.asarray(a).flat[0]), 10_000)
        stacked = flat[i].ndim - np.ndim(a)
        out[n] = (flat[i], blocks[i], fin[i], mu[i], stacked,
                  g if stacked else None)
    return out


def _block(whole, blocks, coord, stacked, g):
    x = np.asarray(whole)[tuple(slice(a, b) for a, b in blocks[coord])]
    return x[g] if stacked else x


@pytest.mark.parametrize("name", list(CASES))
def test_train_losses_match_jax(runs, name):
    got = _ranks(runs, name)
    for r in got:
        assert r["hist"] == got[0]["hist"]
        _close(r["hist"], runs["jax"][name]["hist"], TOL, f"{name} losses")


@pytest.mark.parametrize("name", list(CASES))
def test_grad_accum_clamped_as_jax(runs, name):
    want = runs["jax"][name]["ga"]
    assert all(r["ga"] == want for r in _ranks(runs, name))
    assert want == CASES[name][1].get("grad_accum", 1)


@pytest.mark.parametrize("name", list(CASES))
def test_local_shards_equal_jax_addressable_shards(runs, name):
    """Each rank's block of every param at init is JAX's shard at the
    rank's coordinate, bit for bit; after two steps within a quarter of
    the summed lr (JAX's decay of a stacked (G, d) vector added back
    first, ROADMAP queue 3); the first moments within the gradient
    tolerance."""
    lr = 3e-4 / 200 * (1 + 2)  # warmup: lr(1) + lr(2)
    wd = make_optimizer(_cfg(name)).weight_decay
    xlstm = CASES[name][0] == "xlstm-125m"
    atol, rel = XLSTM["mu"] if xlstm else (1e-6, 1e-4)
    if CASES[name][0] == "llama3-405b":  # bf16 accumulators
        rel = 2.0 ** -7
    most, share = XLSTM["params"] if xlstm else (0.25, None)
    moved = []
    for r in _ranks(runs, name):
        for n, (whole, blocks, fin, mu, st, g) in _leaves(runs, name).items():
            want0 = _block(whole, blocks, r["coord"], st, g)
            assert np.array_equal(r["init"][n], want0), n
            want = _block(fin, blocks, r["coord"], st, g)
            if st and want0.ndim == 1:  # decayed as a stacked (G, d) leaf
                want = want + lr * wd * want0
            _close(r["params"][n], want, most * lr, f"{n} after the steps")
            moved.append(np.abs(r["params"][n] - want).ravel() / lr)
            want_mu = _block(mu, blocks, r["coord"], st, g)
            _close(r["mu"][n], want_mu,
                   atol + rel * float(np.abs(want_mu).max()), f"mu {n}")
    if share is not None:
        assert float(np.quantile(np.concatenate(moved), 0.999)) <= share


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_identical(runs, name):
    """Ranks that differ only along axes a leaf is not split on hold the
    same block after the steps, bit for bit: a norm scale that sees one
    rank's positions under SP, or a router whose aux-loss gradient is the
    global batch's, summed over the wrong axis would part them."""
    got = _ranks(runs, name)
    for n, spec in got[0]["specs"].items():
        axes = spec_axes(spec)
        keep = [i for i, a in enumerate(("data", "model")) if a in axes]
        groups = {}
        for r in got:
            groups.setdefault(tuple(r["coord"][i] for i in keep),
                              []).append(r["params"][n])
        for blocks in groups.values():
            assert all(np.array_equal(blocks[0], b) for b in blocks[1:]), n


# ---------------------------------------------------------- the predicate


class _ModelMesh:
    """What the port's predicate reads of a ``DeviceMesh``."""

    def __init__(self, n):
        self.mesh_dim_names = ("data", "model")
        self.shape = (2, n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sp_predicate_equals_jax(n):
    """The port's :func:`seq_parallel_on` against JAX's ``Decoder.forward``
    over (S, stub length, return_cache, seq_parallel): JAX's choice read
    from the sequence entry of the carry's sharding constraint, traced
    shape-only on an ``AbstractMesh`` (reduced pixtral-12b: its stub
    positions count in S)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    import repro.config as jcfg
    from repro.models import build_model as jax_build_model
    from repro.models import transformer as jt

    class ShapeMesh(AbstractMesh):  # tests/test_torch_steps.py's
        @property
        def devices(self):
            return np.empty(tuple(self.axis_sizes), dtype=object)

    mesh = ShapeMesh((2, n), ("data", "model"))
    cfg = jcfg.reduced(jcfg.get_arch("pixtral-12b"))
    models = {sp: jax_build_model(cfg, dataclasses.replace(
        jcfg.ShardingConfig(), seq_parallel=sp)) for sp in (False, True)}
    params = jax.eval_shape(models[True].impl.init, jax.random.PRNGKey(0))
    seen = []
    real = jt.constrain

    def spy(x, m, *dims):
        seen.append(dims)
        return x

    # every (S, stub, cache) with SP asked for, and one control without
    grid = [(S, stub, cache, True) for S in (1, 2, 3, 6, 8, 12)
            for stub in (0, 2) for cache in (False, True)]
    for S, stub, cache, sp in grid + [(8, 0, False, False)]:
        tokens = jax.ShapeDtypeStruct((2, S), jnp.int32)
        embeds = (jax.ShapeDtypeStruct((2, stub, cfg.d_model), jnp.float32)
                  if stub else None)
        seen.clear()
        jt.constrain = spy
        try:
            jax.eval_shape(lambda p, t, e: models[sp].impl.forward(
                p, t, e, mesh=mesh, return_cache=cache), params, tokens,
                embeds)
        finally:
            jt.constrain = real
        theirs = any(len(dims) == 3 and dims[1] == "model" for dims in seen)
        ours = seq_parallel_on(_ModelMesh(n), S + stub, sp, cache)
        assert ours == theirs, (S, stub, cache, sp, n)
