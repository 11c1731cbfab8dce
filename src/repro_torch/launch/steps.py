"""Step builders: (arch, shape, mesh) → the train, prefill and serve steps
of a state placed by the sharding rules (port of ``repro/launch/steps.py``).

One place defines what each shape cell runs:

  * ``train_4k``    → ``train_step``  (loss + grads + AdamW update)
  * ``prefill_32k`` → ``prefill_step`` (forward + cache build)
  * ``decode_32k`` / ``long_500k`` → ``serve_step`` (one token via cache)

Every builder returns a :class:`StepSpec` whose ``in_specs`` and
``out_specs`` are JAX's, leaf for leaf, on the port's per-layer names (a
param spec is JAX's without its stacked layer entry; the optimizer state
is an :class:`~repro_torch.optim.OptState` of the param specs and
``()``; a cache spec is per layer).  Where JAX jits ``fn`` with those
shardings, here every rank of the mesh calls ``fn`` on its local blocks:

    spec = build_step("qwen3-0.6b", ShapeConfig("t", 1024, 8, "train"),
                      mesh)                                # on the GPU
    params, opt = make_train_state(spec.model, spec.optimizer, seed,
                                   mesh=mesh, rules=spec.rules)
    params, opt, loss, metrics = spec.fn(params, opt, rows_of_batch)

The model is built on ``"meta"`` (nothing allocated: ``in_shapes`` are
meta tensors) and placed by :func:`~repro_torch.launch.train.
make_train_state` on ``device`` (the GPU unless the caller passes
``device="cpu"``; ``"meta"`` keeps it shape-only).  It holds its params
in ``param_dtype`` and casts per layer, as JAX's step functions take
them.  The kernels run on the GPU by default (``use_kernels``): flash on
each rank's local heads, the grouped matmul on its local experts.

The train step clamps ``grad_accum`` as JAX's does and splits strided
microbatches (:func:`~repro_torch.launch.train.placed_train_step`); the
prefill step returns the fp32 logits (B, V), whole over ``"model"``, and
this rank's block of the bf16 cache; the serve step decodes one token
from a slab cache placed by ``tree_cache_specs`` — where the KV heads do
not divide ``"model"`` the cache's sequence is split over it, and the
partial softmaxes are merged by log-sum-exp.  The dense, MoE and VLM
families are ported; the hybrid, ssm and enc-dec ones, and
``seq_parallel``, raise under a mesh that shards anything (ROADMAP queue
1, item 5g).

:func:`lower_step` is JAX's ``lower_step`` without a compiler: it makes
one rank's inputs of a step built on ``"meta"`` (the placed state and
this rank's blocks of the batch, token and cache), and its
``.compile()`` runs the step once on them under
:func:`~repro_torch.launch.op_analysis.analyze` — the dry run's trace
(:mod:`repro_torch.launch.dryrun`), which needs no GPU:

    cfg = get_arch("qwen3-0.6b")
    spec = build_step(cfg, "train_4k", mesh, device="meta",
                      shcfg=default_sharding(cfg, use_kernels=True))
    compiled = lower_step(spec, mesh).compile()
    compiled.memory_analysis().temp_size_in_bytes, compiled.stats.flops
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import (ArchConfig, SHAPES, ShapeConfig, ShardingConfig,
                      default_sharding, get_arch, resolve_device)
from ..models.layers import dtype_of
from ..models.model import Model
from ..models.moe import ep_size
from ..models.transformer import layer_kinds
from ..optim import AdamW, OptState, warmup_cosine
from ..parallel.mesh import MODEL, axis_size
from ..parallel.sharding import (ShardingRules, Spec, local_block,
                                 placements, tree_batch_specs,
                                 tree_cache_specs, tree_param_specs)
from .op_analysis import OpStats, analyze
from .train import make_train_state, placed_train_step

#: the families whose placed steps are ported
FAMILIES = ("dense", "moe", "vlm")


@dataclass
class StepSpec:
    name: str
    fn: Callable
    in_specs: Tuple[Any, ...]
    out_specs: Any
    in_shapes: Tuple[Any, ...]  # meta-tensor trees of the step's inputs
    model: Any
    rules: ShardingRules
    optimizer: Optional[AdamW] = None  # the train step's
    grad_accum: int = 1  # the train step's, clamped


def make_optimizer(cfg: ArchConfig, *, total_steps: int = 10000) -> AdamW:
    return AdamW(
        lr=partial(warmup_cosine, peak_lr=3e-4, warmup_steps=200,
                   total_steps=total_steps),
        moment_dtype=dtype_of(cfg.opt_dtype),
    )


def _meta(t) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def param_and_opt_shapes(model, optimizer: AdamW):
    """The params and optimizer state of ``model`` as meta tensors (a
    ``"meta"`` build's shapes: nothing allocated)."""
    params = {n: _meta(p) for n, p in model.impl.named_parameters()}
    mom = {n: torch.empty(p.shape, dtype=optimizer.moment_dtype,
                          device="meta") for n, p in params.items()}
    return params, OptState(mu=mom, nu=dict(mom), count=0)


def _stub_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return min(cfg.frontend_stub_len, seq_len // 2)
    return 0


def input_shapes(model, shp: ShapeConfig,
                 cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    """JAX's ``Model.input_specs`` as meta tensors: the batch dict of a
    train or prefill cell, ``{token, cache, pos}`` of a decode cell."""
    cfg = model.cfg
    B, S = shp.global_batch, shp.seq_len
    i32 = torch.int32
    if shp.kind in ("train", "prefill"):
        P = _stub_len(cfg, S)
        batch = {"tokens": torch.empty((B, S - P), dtype=i32, device="meta")}
        if P:
            batch["embeds"] = torch.empty((B, P, cfg.d_model),
                                          dtype=dtype_of(cfg.compute_dtype),
                                          device="meta")
        if shp.kind == "train":
            batch["labels"] = torch.empty((B, S - P), dtype=i32,
                                          device="meta")
        return batch
    cache = model.impl.decoder.init_cache(B, S, cache_dtype, "meta")
    return {"token": torch.empty((B,), dtype=i32, device="meta"),
            "cache": cache,
            "pos": torch.empty((), dtype=i32, device="meta")}


def _check_ported(model, rules: ShardingRules, specs) -> None:
    """Raise for what the placed steps do not run yet, never falling back
    to replicated weights without saying so."""
    cfg, mesh = model.cfg, rules.mesh
    if rules.cfg.seq_parallel and axis_size(mesh, MODEL) > 1:
        raise NotImplementedError(
            "seq_parallel (Megatron-SP) under a model axis > 1 is not "
            "ported (ROADMAP queue 1, item 5g)")
    shards = any(e is not None for sp in specs.values() for e in sp)
    if shards and (cfg.family not in FAMILIES or cfg.is_encdec
                   or set(layer_kinds(cfg)) != {"attn"}):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): placed steps of the hybrid, ssm "
            f"and enc-dec families are not ported (ROADMAP queue 1, item "
            f"5g); only {FAMILIES} under a mesh that shards anything")
    if cfg.is_moe and ep_size(cfg, mesh) == 1 and rules._axsize(
            rules.batch) > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE without expert parallelism under a split "
            f"batch (JAX routes the global batch there) is not ported")


def build_step(
    arch: "str | ArchConfig",
    shape: "str | ShapeConfig",
    mesh,
    *,
    shcfg: Optional[ShardingConfig] = None,
    device: str = "cuda",
    model=None,
    cache_dtype=torch.bfloat16,
) -> StepSpec:
    """The step of ``shape``'s kind for ``arch`` under ``mesh`` (a
    ``DeviceMesh``, or a shape-only stand-in for the specs alone).
    ``device``: where :func:`~repro_torch.launch.train.make_train_state`
    places the state (``"cuda"`` without a GPU raises; ``"meta"`` keeps
    it shape-only).  ``shcfg`` defaults to the arch's
    :func:`~repro_torch.config.default_sharding`, with the kernels on the
    GPU.  ``model``: the model of an earlier step of the same arch,
    sharding and mesh, whose placed state this step then shares (a
    prefill and the serve steps after it).  ``cache_dtype``: the prefill's
    and the serve cell's KV cache (JAX's default, bf16; fp32 for parity
    runs of fp32 configs)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    shcfg = shcfg or default_sharding(cfg, use_kernels=dev.type == "cuda")
    rules = ShardingRules(mesh, shcfg)
    if model is None:
        model = Model(cfg, shcfg, torch.device("meta"), train=True)
        model.device = model.impl.device = dev  # where the state is placed
    elif (model.cfg, model.shcfg) != (cfg, shcfg):
        raise ValueError("build_step: the shared model has another arch or "
                         "sharding")
    if shp.kind == "train":
        return _train_step(model, shp, mesh, rules)
    if shp.kind == "prefill":
        return _prefill_step(model, shp, mesh, rules, cache_dtype)
    return _serve_step(model, shp, mesh, rules, cache_dtype)


# ---------------------------------------------------------------------------


def _train_step(model, shp: ShapeConfig, mesh, rules: ShardingRules):
    optimizer = make_optimizer(model.cfg)
    params_shape, opt_shape = param_and_opt_shapes(model, optimizer)
    p_specs = tree_param_specs(rules, params_shape)
    _check_ported(model, rules, p_specs)
    batch_shape = input_shapes(model, shp)
    o_specs = OptState(mu=p_specs, nu=dict(p_specs), count=())
    b_specs = tree_batch_specs(rules, batch_shape)
    # clamp grad_accum so every microbatch still divides the batch shards
    # (a ragged microbatch would silently replicate over the data axis)
    ga = max(rules.cfg.grad_accum, 1)
    n_batch_shards = rules._axsize(rules.batch)
    B = shp.global_batch
    while ga > 1 and (B % ga != 0 or (B // ga) % n_batch_shards != 0):
        ga -= 1
    acc_dt = dtype_of(rules.cfg.accum_dtype)

    def train_step(params, opt_state, batch):
        return placed_train_step(model, optimizer, params, opt_state, batch,
                                 mesh=mesh, grad_accum=ga,
                                 accum_dtype=acc_dt)

    out_specs = (p_specs, o_specs, (), {"nll": (), "aux": ()})
    return StepSpec(name="train_step", fn=train_step,
                    in_specs=(p_specs, o_specs, b_specs), out_specs=out_specs,
                    in_shapes=(params_shape, opt_shape, batch_shape),
                    model=model, rules=rules, optimizer=optimizer,
                    grad_accum=ga)


def _local_blocks(cache, whole, specs, mesh):
    """Each cache leaf cut to this rank's block along the dims its spec
    splits and the tensor still holds whole (a prefill computes the
    sequence whole; its batch rows and KV heads are this rank's already)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()

    def cut(t, spec: Spec, whole):
        for i, entry in enumerate(spec):
            if entry is None or t.shape[i] != whole[i]:
                continue
            n, k = 1, 0
            for a in ((entry,) if isinstance(entry, str) else entry):
                j = names.index(a)
                n, k = n * mesh.shape[j], k * mesh.shape[j] + coord[j]
            t = t.chunk(n, dim=i)[k]
        return t.contiguous()

    return [{key: cut(t, specs[i][key], whole[i][key].shape)
             for key, t in layer.items()} for i, layer in enumerate(cache)]


def _prefill_step(model, shp: ShapeConfig, mesh, rules: ShardingRules,
                  cache_dtype):
    params_shape = {n: _meta(p) for n, p in model.impl.named_parameters()}
    p_specs = tree_param_specs(rules, params_shape)
    _check_ported(model, rules, p_specs)
    batch_shape = input_shapes(model, shp)
    b_specs = tree_batch_specs(rules, batch_shape)
    cache_out = model.impl.decoder.init_cache(
        shp.global_batch, shp.seq_len, cache_dtype, "meta")
    c_specs = tree_cache_specs(rules, cache_out)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model.prefill(batch, mesh=mesh,
                                      cache_len=shp.seq_len,
                                      cache_dtype=cache_dtype)
        return logits, _local_blocks(cache, cache_out, c_specs, mesh)

    logits_spec = rules.batch_spec("logits",
                                   (shp.global_batch, model.cfg.vocab))
    return StepSpec(name="prefill_step", fn=prefill_step,
                    in_specs=(p_specs, b_specs),
                    out_specs=(logits_spec, c_specs),
                    in_shapes=(params_shape, batch_shape),
                    model=model, rules=rules)


def _serve_step(model, shp: ShapeConfig, mesh, rules: ShardingRules,
                cache_dtype):
    params_shape = {n: _meta(p) for n, p in model.impl.named_parameters()}
    p_specs = tree_param_specs(rules, params_shape)
    _check_ported(model, rules, p_specs)
    specs_in = input_shapes(model, shp, cache_dtype)
    token_shape, cache_shape, pos_shape = (
        specs_in["token"], specs_in["cache"], specs_in["pos"])
    c_specs = tree_cache_specs(rules, cache_shape)
    t_spec = rules.batch_spec("token", tuple(token_shape.shape))
    # a cache whose sequence (dim 2 of a layer's (B, K, S, hd)) is split
    # over "model": the decode merges its partial softmaxes over it
    seq_cache = any(MODEL in (sp["k"][2] if isinstance(sp["k"][2], tuple)
                              else (sp["k"][2],)) for sp in c_specs)

    @torch.no_grad()
    def serve_step(params, token, cache, pos):
        return model.decode_step(token, cache, pos, mesh=mesh,
                                 seq_cache=seq_cache)

    logits_spec = rules.batch_spec("logits",
                                   (shp.global_batch, model.cfg.vocab))
    return StepSpec(name="serve_step", fn=serve_step,
                    in_specs=(p_specs, t_spec, c_specs, ()),
                    out_specs=(logits_spec, c_specs),
                    in_shapes=(params_shape, token_shape, cache_shape,
                               pos_shape),
                    model=model, rules=rules)


# ---------------------------------------------------------------------------
# lowering without a compiler: one rank's step traced on "meta"


def tree_bytes(tree) -> int:
    """Bytes of a step's inputs or outputs as this rank holds them (dicts,
    lists, tuples and an :class:`~repro_torch.optim.OptState`): each
    tensor's (a DTensor's local block), and 4 for each Python int (the
    optimizer count and the decode position, int32 scalars in JAX)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    if isinstance(tree, OptState):
        tree = (tree.mu, tree.nu, tree.count)
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(tree_bytes(x) for x in tree)


def _local_meta(whole: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``whole`` under ``spec``, as a new meta
    tensor."""
    block = local_block(whole, mesh, placements(spec, mesh))
    return torch.empty(block.shape, dtype=whole.dtype, device="meta")


@dataclass(frozen=True)
class MemoryAnalysis:
    """JAX's ``compiled.memory_analysis()`` fields, per rank.  Argument
    and output bytes are this rank's blocks; alias is what the step
    donates (a train step its params and optimizer state, a serve step its
    cache: JAX's ``donate_argnums``); temp is the traced peak of live
    bytes less the arguments."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int


@dataclass
class Compiled:
    """A traced step: its :class:`MemoryAnalysis`, its cost and its
    :class:`~repro_torch.launch.op_analysis.OpStats`."""

    memory: MemoryAnalysis
    stats: OpStats

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": self.stats.flops,
                "bytes accessed": self.stats.hbm_bytes}


@dataclass
class Lowered:
    spec: StepSpec
    args: Tuple[Any, ...]
    donate: Tuple[int, ...]

    def compile(self) -> Compiled:
        """Run the step once on the meta inputs under
        :func:`~repro_torch.launch.op_analysis.analyze`."""
        out, stats = analyze(self.spec.fn, *self.args)
        arg = tree_bytes(self.args)
        return Compiled(
            MemoryAnalysis(
                argument_size_in_bytes=arg,
                output_size_in_bytes=tree_bytes(out),
                temp_size_in_bytes=stats.peak_bytes - arg,
                alias_size_in_bytes=sum(tree_bytes(self.args[i])
                                        for i in self.donate)),
            stats)


def lower_step(spec: StepSpec, mesh) -> Lowered:
    """One rank's inputs of ``spec`` (built with ``device="meta"`` under
    ``mesh``, a ``DeviceMesh`` over a real or ``fake`` group) as meta
    tensors: the state :func:`~repro_torch.launch.train.make_train_state`
    places, and this rank's blocks of the batch (train, prefill) or of
    the token and cache (serve, decoding the cache's last position).
    Train steps donate (params, optimizer state), serve steps the cache,
    as JAX's do."""
    if spec.model.device.type != "meta":
        raise ValueError("lower_step: the step must be built on 'meta'")
    params, opt = make_train_state(spec.model, spec.optimizer, 0,
                                   mesh=mesh, rules=spec.rules)
    if spec.name == "train_step":
        batch = {k: _local_meta(t, spec.in_specs[2][k], mesh)
                 for k, t in spec.in_shapes[2].items()}
        return Lowered(spec, (params, opt, batch), (0, 1))
    if spec.name == "prefill_step":
        batch = {k: _local_meta(t, spec.in_specs[1][k], mesh)
                 for k, t in spec.in_shapes[1].items()}
        return Lowered(spec, (params, batch), ())
    token = _local_meta(spec.in_shapes[1], spec.in_specs[1], mesh)
    cache = [{k: _local_meta(t, sp[k], mesh) for k, t in layer.items()}
             for layer, sp in zip(spec.in_shapes[2], spec.in_specs[2])]
    pos = spec.in_shapes[2][0]["k"].shape[2] - 1
    return Lowered(spec, (params, token, cache, pos), (2,))


# ---------------------------------------------------------------------------
# a placed run on spawned ranks: the CLI, the chip smoke and the GPU tests


def _regrow_cache(cache, old, new, mesh, length: int):
    """A prefill's cache blocks (specs ``old``) as a longer serve cache's
    (specs ``new``, ``length`` positions): a sequence split over
    ``"model"`` is gathered, the sequence zero-padded to ``length`` and
    split again as ``new`` says (the batch and KV-head splits are the
    same in both)."""
    import torch.nn.functional as F

    from ..parallel.collectives import all_gather_cat
    from ..parallel.mesh import axis_group

    def axes(entry):
        return () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))

    out = []
    for layer, so, sn in zip(cache, old, new):
        grown = {}
        for key, t in layer.items():
            if axes(so[key][2]):
                t = all_gather_cat(t, axis_group(mesh, axes(so[key][2]))[0], 2)
            t = F.pad(t, (0, 0, 0, length - t.shape[2]))
            if axes(sn[key][2]):
                group, n = axis_group(mesh, axes(sn[key][2]))
                t = t.chunk(n, dim=2)[torch.distributed.get_rank(group)]
            grown[key] = t.contiguous()
        out.append(grown)
    return out


def placed_run(rank: int, arch: str, *, reduced_cfg: bool = True,
               mesh_shape=(2, 2), device: str = "cuda", batch: int = 8,
               seq: int = 64, steps: int = 3, prompt_len: int = 64,
               gen: int = 2, seed: int = 0, sharding=None,
               keep_params: bool = False,
               cache_dtype: str = "bfloat16") -> Dict[str, Any]:
    """One rank of a placed run (every rank of the default group calls it;
    :func:`main` spawns them): ``steps`` train steps of ``arch`` on a
    ``(data, model)`` mesh of ``mesh_shape`` from a state placed by the
    rules (this rank's rows of the ``SyntheticLM`` stream at ``batch`` x
    ``seq``), then, from the same state put back to its initial blocks, a
    prefill of ``batch`` random prompts of ``prompt_len`` tokens and
    ``gen`` greedy serve steps on its slab cache (in ``cache_dtype``).  The kernel
    launch counts are zeroed
    before each part and read after it.  Returns host data: per part the
    losses or logits and tokens, seconds (host clock, ending in a device
    sync), launch counts, collective bytes, and on the GPU the peak
    memory; the train part also this rank's bytes of params and moments
    (what the dry run's argument bytes count besides the batch);
    ``keep_params`` adds the trained local blocks."""
    import time

    import torch.distributed as dist

    from ..data import DataConfig, SyntheticLM, shard_batch
    from ..kernels import ops
    from ..parallel import collectives, make_mesh
    from ..parallel.mesh import batch_axes

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:  # the ranks share the host's cores
        import os

        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dist.get_world_size()))
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(tuple(mesh_shape), ("data", "model")[-len(mesh_shape):],
                     device)
    cfg = get_arch(arch)
    if reduced_cfg:
        from ..config import reduced

        cfg = reduced(cfg)
    shcfg = default_sharding(cfg, use_kernels=cuda, **(sharding or {}))
    bax = batch_axes(mesh)
    out: Dict[str, Any] = {"coord": [int(c) for c in mesh.get_coordinate()],
                           "backend": dist.get_backend()}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def begin():
        sync()
        ops.reset_launch_counts()
        collectives.reset_traffic()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        return time.perf_counter()

    def part(**kw):
        kw.update(counts=ops.launch_counts(), traffic=dict(
            collectives.TRAFFIC))
        if cuda:
            kw["peak"] = torch.cuda.max_memory_allocated(dev)
        return kw

    spec = build_step(cfg, ShapeConfig("train", seq, batch, "train"), mesh,
                      shcfg=shcfg, device=device)
    params, opt = make_train_state(spec.model, spec.optimizer, seed,
                                   mesh=mesh, rules=spec.rules)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    init = {n: t.detach().clone() for n, t in params.items()}
    losses, secs, per_step = [], [], []
    begin()
    for step in range(steps):
        b = {k: v.to(dev) for k, v in
             shard_batch(data.batch(step), mesh, bax).items()}
        before = dict(collectives.TRAFFIC)
        t0 = time.perf_counter()
        params, opt, loss, _ = spec.fn(params, opt, b)
        losses.append(float(loss))
        sync()
        secs.append(time.perf_counter() - t0)
        per_step.append({k: v - before[k]
                         for k, v in collectives.TRAFFIC.items()})
    out["train"] = part(losses=losses, step_s=secs, traffic_per_step=per_step,
                        grad_accum=spec.grad_accum,
                        param_bytes=tree_bytes(params),
                        moment_bytes=tree_bytes((opt.mu, opt.nu)))
    if keep_params:
        out["train"]["params"] = {n: t.detach().cpu()
                                  for n, t in params.items()}
    with torch.no_grad():
        for n, t in params.items():
            t.copy_(init[n])
    state, model = params, spec.model
    del spec, params, opt, init
    if cuda:
        torch.cuda.empty_cache()

    cdt = dtype_of(cache_dtype)
    pre = build_step(cfg, ShapeConfig("prefill", prompt_len, batch,
                                      "prefill"), mesh, shcfg=shcfg,
                     device=device, model=model, cache_dtype=cdt)
    srv = build_step(cfg, ShapeConfig("decode", prompt_len + gen, batch,
                                      "decode"), mesh, shcfg=shcfg,
                     device=device, model=pre.model, cache_dtype=cdt)
    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g)
    rows = shard_batch({"tokens": prompts}, mesh, bax)["tokens"].to(dev)
    t0 = begin()
    logits, cache = pre.fn(state, {"tokens": rows})
    sync()
    out["prefill"] = part(logits=logits.float().cpu(),
                          s=time.perf_counter() - t0)
    cache = _regrow_cache(cache, pre.out_specs[1], srv.in_specs[2], mesh,
                          prompt_len + gen)
    tok = logits.argmax(dim=-1)
    tokens, served = [tok], []
    t0 = begin()
    for i in range(gen):
        logits, cache = srv.fn(state, tok, cache, prompt_len + i)
        tok = logits.argmax(dim=-1)
        tokens.append(tok)
        served.append(logits.float().cpu())
    sync()
    out["serve"] = part(tokens=torch.stack(tokens, 1).cpu(), logits=served,
                        s=time.perf_counter() - t0)
    return out


def _placed_rank(rank: int, kw: Dict[str, Any]) -> Dict[str, Any]:
    return placed_run(rank, **kw)


def main(argv=None) -> int:
    """Spawn ``--ranks`` ranks (gloo on the CPU or on one shared card, NCCL
    with a card a rank) and run :func:`placed_run` on each; print each
    step's loss and the greedy tokens, and fail unless every rank reports
    the same losses and tokens of its rows' data group."""
    import argparse

    from ..parallel.mesh import run_ranks

    ap = argparse.ArgumentParser(description="placed train, prefill and "
                                 "serve steps on a (data, model) mesh")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default="2,2", help="data,model")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    shape = tuple(int(x) for x in args.mesh.split(","))
    n = 1
    for x in shape:
        n *= x
    kw = dict(arch=args.arch, reduced_cfg=args.reduced, mesh_shape=shape,
              device=args.device, batch=args.batch, seq=args.seq,
              steps=args.steps, prompt_len=args.prompt_len, gen=args.gen,
              seed=args.seed)
    ranks = run_ranks(_placed_rank, n, args.device, args=(kw,))
    r0 = ranks[0]
    for r in ranks:
        print(f"[steps] rank coord {r['coord']} ({r['backend']}): losses "
              f"{r['train']['losses']} step_ms "
              f"{[t * 1e3 for t in r['train']['step_s']]} launches "
              f"{r['train']['counts']}")
    if any(r["train"]["losses"] != r0["train"]["losses"] for r in ranks):
        print("[steps] FAIL: the ranks report different losses")
        return 1
    groups = {}
    for r in ranks:
        groups.setdefault(r["coord"][0], []).append(r["serve"]["tokens"])
    if any(not torch.equal(t, ts[0]) for ts in groups.values() for t in ts):
        print("[steps] FAIL: ranks of one data group decode different tokens")
        return 1
    print(f"[steps] OK: {args.arch}{' (reduced)' if args.reduced else ''} on "
          f"mesh {shape}: losses {r0['train']['losses']}; greedy tokens of "
          f"data group 0 {groups[0][0].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
