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
not divide ``"model"`` the cache's sequence is split over it (a local
layer's circular buffer too), and the partial softmaxes are merged by
log-sum-exp.  Every family is ported: the dense, MoE and VLM decoders,
the hybrid (the Griffin block on each rank's features, the RG-LRU scan
kernel on (B, S, d_rnn / n)), the ssm (the xLSTM cells on each rank's
heads, or on every head where a shard splits one) and the enc-dec (its
inputs JAX's ``input_specs``: ``frames`` (B, S // 4, d) beside the
tokens).  ``seq_parallel`` runs Megatron-SP in the train step's forward
under a model axis > 1 where JAX's does (``models.transformer.
seq_parallel_on``; never with a cache, so never in a prefill or serve
step, and never in the enc-dec), and an MoE layer without expert
parallelism routes the global batch under a split batch, as JAX's does
(``models.moe``).

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
from ..optim import AdamW, OptState, warmup_cosine
from ..parallel.mesh import MODEL
from ..parallel.sharding import (ShardingRules, Spec, local_block,
                                 placements, spec_axes, tree_batch_specs,
                                 tree_cache_specs, tree_param_specs)
from .op_analysis import OpStats, analyze
from .train import make_train_state, placed_train_step

#: the cache leaves whose dim 2 is a sequence of positions: attention K/V
#: (a local layer's circular buffer too) and the enc-dec's self and cross
#: slabs
KV_KEYS = ("k", "v", "self_k", "self_v", "cross_k", "cross_v")


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
    cache_len: int = 0  # the serve step's cache positions


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


def enc_len(seq_len: int) -> int:
    """The encoder-decoder's frames a cell of ``seq_len`` carries (JAX's
    ``Model._enc_len``)."""
    return max(seq_len // 4, 1)


def cache_shapes(model, batch: int, seq_len: int, cache_dtype):
    """The slab decode cache of a cell as meta tensors (an encoder-decoder
    cell's cross memory holds :func:`enc_len` positions)."""
    if model.cfg.is_encdec:
        return model.impl.init_cache(batch, seq_len, enc_len(seq_len),
                                     cache_dtype, "meta")
    return model.impl.decoder.init_cache(batch, seq_len, cache_dtype, "meta")


def input_shapes(model, shp: ShapeConfig,
                 cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    """JAX's ``Model.input_specs`` as meta tensors: the batch dict of a
    train or prefill cell (an encoder-decoder's ``frames`` beside its
    tokens), ``{token, cache, pos}`` of a decode cell."""
    cfg = model.cfg
    B, S = shp.global_batch, shp.seq_len
    i32, cdt = torch.int32, dtype_of(cfg.compute_dtype)

    def meta(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shp.kind in ("train", "prefill"):
        P = _stub_len(cfg, S)
        batch = {}
        if cfg.is_encdec:
            batch["frames"] = meta((B, enc_len(S), cfg.d_model), cdt)
        batch["tokens"] = meta((B, S - P))
        if P:
            batch["embeds"] = meta((B, P, cfg.d_model), cdt)
        if shp.kind == "train":
            batch["labels"] = meta((B, S - P))
        return batch
    return {"token": meta((B,)),
            "cache": cache_shapes(model, B, S, cache_dtype),
            "pos": meta(())}


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
    batch_shape = input_shapes(model, shp)
    b_specs = tree_batch_specs(rules, batch_shape)
    cache_out = cache_shapes(model, shp.global_batch, shp.seq_len,
                             cache_dtype)
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
    specs_in = input_shapes(model, shp, cache_dtype)
    token_shape, cache_shape, pos_shape = (
        specs_in["token"], specs_in["cache"], specs_in["pos"])
    c_specs = tree_cache_specs(rules, cache_shape)
    t_spec = rules.batch_spec("token", tuple(token_shape.shape))
    # a cache whose sequence (dim 2 of a layer's (B, K, S, hd) K/V) is
    # split over "model": the decode merges its partial softmaxes over it
    seq_cache = any(MODEL in spec_axes(sp[key][2:3]) for sp in c_specs
                    for key in sp if key in KV_KEYS)

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
                    model=model, rules=rules, cache_len=shp.seq_len)


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
    return Lowered(spec, (params, token, cache, spec.cache_len - 1), (2,))


# ---------------------------------------------------------------------------
# a placed run on spawned ranks: the CLI, the chip smoke and the GPU tests


def _regrow_cache(cache, old, new, shapes, mesh):
    """A prefill's cache blocks (specs ``old``) as a serve cache's (specs
    ``new``, whole meta shapes ``shapes``): each K/V leaf's sequence (dim
    2), gathered where ``old`` splits it over ``"model"``, is zero-padded
    to its serve length and split again as ``new`` says (the batch and
    KV-head splits are the same in both; a local layer's buffer grows
    only while the prompt is shorter than its window, when no slot has
    wrapped); recurrent states pass as they are."""
    import torch.nn.functional as F

    from ..parallel.collectives import all_gather_cat
    from ..parallel.mesh import axis_group

    out = []
    for layer, so, sn, whole in zip(cache, old, new, shapes):
        grown = {}
        for key, t in layer.items():
            if key in KV_KEYS:
                if spec_axes(so[key][2:3]):
                    t = all_gather_cat(
                        t, axis_group(mesh, spec_axes(so[key][2:3]))[0], 2)
                t = F.pad(t, (0, 0, 0, whole[key].shape[2] - t.shape[2]))
                if spec_axes(sn[key][2:3]):
                    group, n = axis_group(mesh, spec_axes(sn[key][2:3]))
                    t = t.chunk(n, dim=2)[torch.distributed.get_rank(group)]
            grown[key] = t.contiguous()
        out.append(grown)
    return out


#: ``frames_for``'s stream of a placed run's prompts (its train steps
#: take the step's index)
PROMPT_FRAMES = 0xFFFF


def frames_for(cfg: ArchConfig, batch: int, seq_len: int, seed: int,
               stream: int) -> torch.Tensor:
    """An encoder-decoder cell's stub frames (batch, :func:`enc_len`
    (seq_len), d), fp32 on the CPU from ``seed`` and ``stream`` (a placed
    run's train step, or :data:`PROMPT_FRAMES`): the same on every rank
    and in a one-process reference."""
    g = torch.Generator().manual_seed((seed << 16) + stream)
    return torch.randn((batch, enc_len(seq_len), cfg.d_model), generator=g)


def draw_weights(cfg: ArchConfig, seed: int) -> Dict[str, torch.Tensor]:
    """Every param of ``cfg``'s training layout, whole on the CPU, drawn
    from ``seed`` as :func:`~repro_torch.launch.train.make_train_state`
    draws it (``SeededParams.draw_into``): one draw that a one-process
    model loads (``load_state``) and :func:`placed_run`'s ranks read from
    a file (``weights``)."""
    impl = Model(cfg, default_sharding(cfg), torch.device("meta"),
                 train=True).impl
    out = {n: torch.empty(p.shape, dtype=p.dtype)
           for n, p in impl.named_parameters()}
    impl.draw_into(seed, out)
    return out


def placed_config(arch: str, reduced_cfg: bool = True,
                  cfg_overrides=None) -> ArchConfig:
    """The config :func:`placed_run` runs: ``arch`` (reduced with
    ``reduced_cfg``), its fields replaced by ``cfg_overrides``."""
    from dataclasses import replace

    from ..config import reduced

    cfg = get_arch(arch)
    cfg = reduced(cfg) if reduced_cfg else cfg
    return replace(cfg, **cfg_overrides) if cfg_overrides else cfg


def placed_run(rank: int, arch: str, *, reduced_cfg: bool = True,
               mesh_shape=(2, 2), device: str = "cuda", batch: int = 8,
               seq: int = 64, steps: int = 3, prompt_len: int = 64,
               gen: int = 2, seed: int = 0, sharding=None,
               keep_params: bool = False,
               cache_dtype: str = "bfloat16",
               cfg_overrides=None,
               weights: Optional[str] = None,
               serve: bool = True) -> Dict[str, Any]:
    """One rank of a placed run (every rank of the default group calls it;
    :func:`main` spawns them): ``steps`` train steps of ``arch`` on a
    ``(data, model)`` mesh of ``mesh_shape`` from a state placed by the
    rules (this rank's rows of the ``SyntheticLM`` stream at ``batch`` x
    ``seq``, an encoder-decoder's with :func:`frames_for`'s frames), then,
    from the same state put back to its initial blocks, a prefill of
    ``batch`` random prompts of ``prompt_len`` tokens (an encoder-decoder's
    with the frames of the serve cell, ``enc_len(prompt_len + gen)``) and
    ``gen`` greedy serve steps on its slab cache (in ``cache_dtype``).  The
    kernel launch counts are zeroed
    before each part and read after it.  Returns host data: per part the
    losses or logits and tokens, seconds (host clock, ending in a device
    sync), launch counts, collective bytes, and on the GPU the peak
    memory; the train part also this rank's bytes of params and moments
    (what the dry run's argument bytes count besides the batch);
    ``keep_params`` adds the trained local blocks.  ``cfg_overrides``
    replace fields of the (reduced) config, e.g. a depth cut.
    ``weights``: a file of the whole params (``torch.save`` of ``{name:
    tensor}``, drawn once from ``seed`` by the caller), read memory-mapped:
    each rank copies only its blocks, where by default every rank draws
    every leaf whole.  ``serve=False`` stops after the train steps (a
    Megatron-SP run: the prefill and serve steps never run SP)."""
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
    cfg = placed_config(arch, reduced_cfg, cfg_overrides)
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
        kw.update(counts=ops.launch_counts(), keys=ops.launch_keys(),
                  traffic=dict(collectives.TRAFFIC))
        if cuda:
            kw["peak"] = torch.cuda.max_memory_allocated(dev)
        return kw

    spec = build_step(cfg, ShapeConfig("train", seq, batch, "train"), mesh,
                      shcfg=shcfg, device=device)
    if weights is not None:
        weights = torch.load(weights, mmap=True, weights_only=True)
    params, opt = make_train_state(spec.model, spec.optimizer, seed,
                                   mesh=mesh, rules=spec.rules,
                                   weights=weights)
    del weights
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))

    def rows(b):
        return {k: v.to(dev) for k, v in shard_batch(b, mesh, bax).items()}

    init = {n: t.detach().clone() for n, t in params.items()}
    losses, secs, per_step = [], [], []
    begin()
    for step in range(steps):
        b = data.batch(step)
        if cfg.is_encdec:
            b["frames"] = frames_for(cfg, batch, seq, seed, step)
        b = rows(b)
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
    if not serve:
        return out
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
    prompts = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                       generator=g)}
    if cfg.is_encdec:
        prompts["frames"] = frames_for(cfg, batch, prompt_len + gen, seed,
                                       PROMPT_FRAMES)
    prompts = rows(prompts)
    t0 = begin()
    logits, cache = pre.fn(state, prompts)
    sync()
    out["prefill"] = part(logits=logits.float().cpu(),
                          s=time.perf_counter() - t0)
    cache = _regrow_cache(cache, pre.out_specs[1], srv.in_specs[2],
                          srv.in_shapes[2], mesh)
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
