"""Training entry point — a thin CLI shell over the model, optimizer and data
stream (port of ``repro/launch/train.py``).

Trains a registered arch — dense, MoE, ssm, hybrid, VLM or enc-dec (full or
``--reduced`` smoke size) — on the deterministic synthetic LM stream with
AdamW and straggler detection, on the GPU unless ``--device cpu`` is
given (``cuda`` without a GPU raises).  The model is built in the
training layout (fp32 masters, a bf16 cast per layer) and its loss runs
the decoder under the arch's remat (block by default; ``"sqrt"``
too): on the GPU the attention of every layer with S > 256 is the flash
kernel, forward and remat recompute alike, and its gradient recomputes
the plain version; an MoE layer's expert products are the grouped-matmul
kernel (forward, recompute and dx) and an rglru layer's recurrence the
scan kernel (forward, recompute and the reverse scan of its gradient);
an xLSTM layer's cells are plain PyTorch under autograd.
The loss adds the MoE router's aux loss, weighted, as JAX's does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --batch 8 --seq 1024                     # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 3 --seq 320
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --reduced --device cpu --steps 3 --seq 64   # or recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --device cpu --steps 20 --ckpt-dir ck --ckpt-every 5
    PYTHONPATH=src python -m repro_torch.launch.train --crash-smoke \\
        --device cpu --steps 6 --kill-at 3          # drop --device on the GPU

With ``--ckpt-dir`` the run saves its params, moments and step count every
``--ckpt-every`` steps (and once more at the end of a completed run off
that cadence) and resumes from the latest restorable step when started
again with the same directory: the restored values are copied into the
model's own parameters and moments, so the resumed run continues the
uninterrupted one step for step.  ``--crash-smoke`` kills a host of a
simulated cluster under a bound wavefront session and requires the
rollback to the last durable snapshot plus the replay of the lost steps to
reproduce an uninterrupted run on the survivors (:func:`crash_smoke`).

With ``--plan-workload`` the trainer also stands up a plan-only
:class:`repro_torch.session.SpindleSession` for the named MT workload: the
training loop feeds its step times into a
:class:`repro_torch.launch.events.StragglerEventSource` (through an
in-process :class:`repro_torch.ckpt.straggler.TimingCollector`), and the
session polls it every step, so a detected straggler fires the §5.5
re-plan hook.

``train(mesh=)`` trains on a mesh of ``torch.distributed`` ranks
(:func:`repro_torch.parallel.make_mesh`; axes ``"pod"``, ``"data"``,
``"model"``): every rank runs the same call.  The batch is split over the
batch axes (:func:`repro_torch.data.shard_batch`), an MoE layer shards
its experts over ``"model"`` (expert parallelism:
:func:`repro_torch.models.moe.moe_apply`), each rank backpropagates the
mean loss of its rows, the gradients are SUM all-reduced over the batch
axes and divided by their size, and the history holds the loss averaged
over them — JAX's global mean, the same on every rank.  With
``compress_grads`` the data-parallel sync is int8
(:func:`repro_torch.optim.compressed_mean` over ``"data"``) and the loss
runs without the mesh, as JAX's ``_make_compressed_dp_step`` does.  A
caller starts the ranks itself (``torchrun``, or ``torch.multiprocessing``
with the ``spawn`` start method, which CUDA needs), joins the group
(:func:`repro_torch.parallel.mesh.init_rank`) and builds the mesh; the
CLI trains in one process.

``make_train_state(mesh=, rules=)`` places a state by the sharding rules
(``parallel.sharding.place_module``: FSDP over ``"data"``, tensor and
expert parallelism over ``"model"``, each leaf drawn whole from the seed
and sliced), and :func:`placed_train_step` trains it: the step of
``launch/steps.py``'s train step, with its microbatches.

``--elastic-smoke`` runs the straggler scenario on the distributed
WaveEngine (:func:`elastic_smoke`): ``--ranks`` spawned ranks (gloo on the
CPU or on one shared card, NCCL with a card a rank) run one bound
wavefront session; a scripted straggler after ``--straggler-at`` must take
the checkpoint → re-mesh → restore path and training must go on without
the flagged hosts' ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --elastic-smoke \\
        --device cpu --ranks 4 --steps 8 --straggler-at 3
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..ckpt.straggler import StragglerDetector, TimingCollector, world_size
from ..config import (ArchConfig, default_sharding, get_arch, reduced,
                      resolve_device)
from ..data import DataConfig, SyntheticLM, shard_batch
from ..models import build_model
from ..models.layers import dtype_of
from ..models.moe import shard_expert_stacks
from ..optim import AdamW, OptState, compressed_mean, warmup_cosine
from ..parallel.collectives import (all_reduce_, full_tensor, sharded_norm,
                                    sum_grads)
from ..parallel.mesh import DATA, axis_group, batch_axes
from ..parallel.sharding import place_module
from .events import StragglerEventSource


def plan_preview(workload: str, *, planner: str = "spindle",
                 n_devices: int = 16, island_size: int = 8,
                 verbose: bool = True, event_sources=(), callbacks=()):
    """Stand up a plan-only SpindleSession for a named MT workload, planned
    for ``n_devices`` H100s in NVLink islands of ``island_size``.  Returns
    the session; its ``current_plan`` is the built plan, and later
    ``session.poll()`` / ``session.signal(...)`` replan through the cache."""
    from ..core.costmodel import ICI_BW
    from ..core.pipeline import available_planners
    from ..core.placement import ClusterSpec
    from ..core.workloads import WORKLOADS
    from ..session import SessionConfig, SpindleSession

    if workload not in WORKLOADS:
        raise SystemExit(f"[train] unknown --plan-workload {workload!r}; "
                         f"choose from {sorted(WORKLOADS)}")
    if planner not in available_planners():
        raise SystemExit(f"[train] unknown --planner {planner!r}; "
                         f"choose from {available_planners()}")
    cfg = SessionConfig(
        workload=workload,
        planner=planner,
        cluster=ClusterSpec(n_devices=n_devices, island_size=island_size,
                            mem_bytes=80e9, intra_island_bw=ICI_BW),
        # straggler replans must adapt, not vacuously re-hit the cache:
        # shrink the planning cluster by the flagged hosts (restored on
        # recovery) so the regenerated plan routes around them
        straggler_shrink=True,
    )
    session = SpindleSession(cfg, event_sources=list(event_sources),
                             callbacks=list(callbacks))
    p = session.plan()
    if verbose:
        print(f"[plan] {workload} via {planner!r}: "
              f"{len(p.waves())} waves / {len(p.steps)} steps, "
              f"makespan {p.makespan*1e3:.1f} ms/iter "
              f"(planned in {p.planning_seconds*1e3:.0f} ms)")
    return session


def make_train_state(model, optimizer: Optional[AdamW], seed: int, mesh=None,
                     rules=None, weights=None):
    """Random weights from ``seed`` (fp32 masters) and fresh optimizer
    state.  With ``rules`` (a :class:`~repro_torch.parallel.ShardingRules`
    over the mesh) every parameter becomes a DTensor placed by its spec
    (:func:`repro_torch.parallel.sharding.place_module`) on the model's
    device: each leaf is drawn whole from the seed on the CPU — or taken
    from ``weights`` (``{name: whole tensor}``, e.g. through
    ``bridge.from_jax``) — and this rank keeps its block, so every mesh
    trains the one model; a model built on ``"meta"`` gets only the local
    shapes.  The moments are placed like the params (JAX's
    ``launch/steps.py:98-99``).  Without rules, under ``mesh`` only the
    MoE expert stacks become DTensors sharded over ``"model"``
    (:func:`repro_torch.models.moe.shard_expert_stacks`).  Returns (params
    by name — this rank's local tensors, which the optimizer updates in
    place —, optimizer state: None without an ``optimizer``)."""
    if rules is not None:
        impl = model.impl
        source = ((lambda i, name, p: torch.as_tensor(weights[name]))
                  if weights is not None else
                  (lambda i, name, p: impl.draw(seed, i, name, p)))
        place_module(impl, rules, source=source, device=impl.device)
    else:
        model.init(seed)
        if mesh is not None:
            shard_expert_stacks(model.impl, model.cfg, mesh)
    params = _local_params(model)
    return params, None if optimizer is None else optimizer.init(params)


def _local_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, a DTensor as its local tensor (the
    same storage: an in-place update reaches the DTensor)."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return {n: p.to_local() if isinstance(p, DTensor) else p
                for n, p in model.impl.named_parameters()}


def _split_axes(model) -> Dict[str, Tuple[str, ...]]:
    """``{name: the mesh axes the parameter is split over}`` (in mesh
    order; () for a plain tensor), read from the DTensors' placements."""
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for n, p in model.impl.named_parameters():
        names = (tuple(p.device_mesh.mesh_dim_names)
                 if isinstance(p, DTensor) else ())
        out[n] = tuple(names[i] for i, pl in enumerate(
            p.placements if names else ()) if isinstance(pl, Shard))
    return out


def train_step(model, optimizer: AdamW, params, opt_state, batch, *,
               mesh=None, compress_grads: bool = False):
    """Loss, backward, AdamW update (in place on ``params``): the step of
    :func:`placed_train_step` without microbatches.  Returns (new
    optimizer state, loss as a 0-d tensor)."""
    _, opt_state, loss, _ = placed_train_step(
        model, optimizer, params, opt_state, batch, mesh=mesh,
        compress_grads=compress_grads)
    return opt_state, loss


def placed_train_step(model, optimizer: AdamW, params, opt_state, batch, *,
                      mesh=None, grad_accum: int = 1,
                      accum_dtype=torch.float32,
                      compress_grads: bool = False):
    """One train step (every rank calls it with its rows of the batch;
    without a mesh every collective is the identity): loss and backward —
    a leaf placed by the rules enters its layer gathered over its data
    axes, so its gradient comes back reduce-scattered onto this rank's
    block —, the gradients reduced over the batch axes only (SUM over
    those a leaf is not split on, then divided by their size: the mean,
    never a sum over the axes a leaf is sharded on, read from its
    placements), the clip norm over every distinct shard once
    (:func:`~repro_torch.parallel.collectives.sharded_norm`; the
    optimizer's own norm when no leaf is split), and AdamW on the local
    shards in place.  ``compress_grads``: the loss runs without the mesh
    and the gradients are averaged int8 over ``"data"``
    (:func:`~repro_torch.optim.compressed_mean`).  With ``grad_accum`` >
    1 the rows are split strided (microbatch m takes local rows m, m + ga,
    …: JAX's global rows i·ga + m, shard by shard) and the synced
    gradients summed in ``accum_dtype``, then divided by ``grad_accum``,
    as JAX's scan does.  Returns (params, optimizer state, loss, {"nll",
    "aux"}), the loss and metrics the global means, the same on every
    rank."""
    from torch.distributed.tensor import DTensor

    live = dict(model.impl.named_parameters())
    names = list(live)
    split = _split_axes(model)
    bgroup, nb = axis_group(mesh, (DATA,) if compress_grads
                            else batch_axes(mesh))
    rest: Dict[Tuple[str, ...], list] = {}
    for n in names:
        ax = tuple(a for a in batch_axes(mesh) if a not in split[n])
        rest.setdefault(ax, []).append(n)

    def grads_of(b):
        loss, metrics = model.loss(b, mesh=None if compress_grads else mesh)
        gs = torch.autograd.grad(loss, [live[n] for n in names])
        gs = {n: g.to_local() if isinstance(g, DTensor) else g
              for n, g in zip(names, gs)}
        if compress_grads:
            return loss.detach(), metrics, {
                n: compressed_mean(g, bgroup) for n, g in gs.items()}
        out = {}
        for ax, group in rest.items():
            out.update(sum_grads({n: gs[n] for n in group},
                                 axis_group(mesh, ax)[0]))
        if bgroup is not None:
            for g in out.values():
                g /= nb
        return loss.detach(), metrics, out

    def global_mean(x):
        return all_reduce_(x.detach().float().clone(), bgroup) / nb

    ga = max(grad_accum, 1)
    if ga > 1:
        grads, loss = None, torch.zeros((), device=batch["tokens"].device)
        for m in range(ga):
            lm, _, g = grads_of({k: v[m::ga] for k, v in batch.items()})
            if grads is None:
                grads = {n: t.to(accum_dtype) for n, t in g.items()}
            else:
                for n, t in g.items():
                    grads[n] += t.to(accum_dtype)
            loss = loss + global_mean(lm)
        grads = {n: t / ga for n, t in grads.items()}
        loss = loss / ga
        metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
    else:
        loss, metrics, grads = grads_of(batch)
        loss = global_mean(loss)
        metrics = {"nll": global_mean(metrics["nll"]),
                   "aux": metrics["aux"].detach()}
    gnorm = None
    if optimizer.grad_clip > 0 and any(split.values()):
        gnorm = sharded_norm(grads, split, mesh)
    opt_state = optimizer.update(grads, opt_state, params, gnorm=gnorm)
    return params, opt_state, loss, metrics


def _logical(model, params, opt_state):
    """The checkpoint tree with every placed leaf gathered to its logical
    shape over every axis it is split on, ``"data"`` as well as
    ``"model"`` (a collective: every rank calls it), so that the files
    equal one process's name for name and shape for shape."""
    from torch.distributed.tensor import DTensor

    placed = {n: p for n, p in model.impl.named_parameters()
              if isinstance(p, DTensor)}
    if not placed:
        return {"params": params, "opt": opt_state}

    def whole(n, t):
        p = placed[n]
        return full_tensor(DTensor.from_local(
            t, p.device_mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride()))

    def full(d):
        return {n: whole(n, t) if n in placed else t for n, t in d.items()}

    return {"params": full(params),
            "opt": OptState(mu=full(opt_state.mu), nu=full(opt_state.nu),
                            count=opt_state.count)}


def _logical_like(model, params, opt_state):
    """What a checkpoint of this run holds: the logical shapes (a sharded
    leaf as a ``"meta"`` tensor of its whole shape)."""
    shapes = {n: p.shape for n, p in model.impl.named_parameters()}

    def like(d):
        return {n: t if tuple(t.shape) == tuple(shapes[n])
                else torch.empty(shapes[n], dtype=t.dtype, device="meta")
                for n, t in d.items()}

    return {"params": like(params),
            "opt": OptState(mu=like(opt_state.mu), nu=like(opt_state.nu),
                            count=opt_state.count)}


def _placed_locals(model, restored, dev):
    """A restored logical tree placed as the live params are, through
    :func:`repro_torch.ckpt.restore_to_mesh` (a sharded leaf onto its
    mesh and placements, the rest onto ``dev``), as local tensors."""
    from torch.distributed.tensor import DTensor

    from ..ckpt import restore_to_mesh

    targets = {n: (p.device_mesh, p.placements) if isinstance(p, DTensor)
               else dev for n, p in model.impl.named_parameters()}
    placed = restore_to_mesh(restored, {"params": targets, "opt": OptState(
        mu=targets, nu=targets, count=0)})

    def local(d):
        return {n: t.to_local() if isinstance(t, DTensor) else t
                for n, t in d.items()}

    opt = placed["opt"]
    return {"params": local(placed["params"]),
            "opt": OptState(mu=local(opt.mu), nu=local(opt.nu),
                            count=opt.count)}


@torch.no_grad()
def _load_into(live: Dict[str, torch.Tensor], restored: Dict[str, torch.Tensor],
               what: str) -> None:
    """Copy restored tensors into the live ones, which the model (or
    the optimizer) holds — rebinding the names instead would leave the
    model training from its fresh weights.  Names, shapes and dtypes must
    match."""
    if set(live) != set(restored):
        raise KeyError(f"restore {what}: names differ: "
                       f"{sorted(set(live) ^ set(restored))}")
    for name, t in live.items():
        r = restored[name]
        if r.dtype != t.dtype or r.shape != t.shape:
            raise ValueError(f"restore {what} {name!r}: checkpoint "
                             f"{r.dtype} {tuple(r.shape)} != live {t.dtype} "
                             f"{tuple(t.shape)}")
        t.copy_(r)


def train(
    arch: "str | ArchConfig" = "qwen3-0.6b",
    *,
    reduced_cfg: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    stop_at_step: Optional[int] = None,  # simulate an interrupt
    mesh=None,
    compress_grads: bool = False,
    verbose: bool = True,
    plan_workload: Optional[str] = None,
    planner: str = "spindle",
    device: str = "cuda",
    use_kernels: Optional[bool] = None,
) -> Dict[str, Any]:
    """Train ``arch`` (a registered name, or an ``ArchConfig`` such as a
    depth cut) for ``steps`` steps on ``device``.  ``use_kernels``
    (default: on the GPU) routes attention through the CUDA kernels; off,
    attention is plain PyTorch on either device.  With ``ckpt_dir`` the
    run resumes from that directory's latest step and saves every
    ``ckpt_every`` steps (under a mesh, world rank 0 writes the logical
    arrays).  ``mesh``: train on a mesh of ranks (see the module doc);
    ``compress_grads`` takes effect under a mesh with a ``"data"`` axis,
    as in JAX.  Returns the loss history (this run's steps), each step's
    seconds (host clock, ending in a device sync), the step it resumed
    from (or ``None``) and the seconds of that restore and of each save
    (host clock), the params (this rank's local tensors) and optimizer
    state and the MT plan of ``plan_workload``."""
    dev = resolve_device(device)
    compress = bool(compress_grads and mesh is not None
                    and DATA in mesh.mesh_dim_names)
    lead = mesh is None or dist.get_rank() == 0  # prints and saves
    verbose = verbose and lead
    n_hosts = max(world_size(), 1)
    straggler_src = StragglerEventSource(
        StragglerDetector(n_hosts=n_hosts),
        collector=TimingCollector(n_hosts=n_hosts),
    )
    session = None
    if plan_workload:
        from ..session import SessionCallbacks

        class _ReplanLogger(SessionCallbacks):
            def on_replan(self, sess, event, old_plan, new_plan, info):
                if verbose:
                    print(f"[train] {event.kind} -> replanned ({info.mode}, "
                          f"{info.planning_seconds*1e3:.1f} ms planner)")

        session = plan_preview(plan_workload, planner=planner,
                               verbose=verbose, event_sources=[straggler_src],
                               callbacks=[_ReplanLogger()])
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    arch = cfg.name
    if reduced_cfg:
        cfg = reduced(cfg)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    shcfg = default_sharding(cfg, use_kernels=use_kernels)
    model = build_model(cfg, shcfg, device=str(dev), train=True)
    optimizer = AdamW(
        lr=partial(warmup_cosine, peak_lr=lr,
                   warmup_steps=max(steps // 10, 1), total_steps=steps),
        moment_dtype=dtype_of(cfg.opt_dtype),
    )
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    ep_mesh = None if compress else mesh
    params, opt_state = make_train_state(model, optimizer, seed, ep_mesh)

    start_step, resumed_from = 0, None
    mgr = None
    save_seconds, restore_seconds = [], None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, every=ckpt_every, keep=3)
        if mesh is not None:
            # every rank restores one step: none reads the directory while
            # world rank 0 may still be writing an earlier run's last save
            dist.barrier()
        t0 = time.perf_counter()
        like = _logical_like(model, params, opt_state)
        restored, manifest = mgr.restore_latest(like)
        if restored is not None:
            restored = _placed_locals(model, restored, dev)
            _load_into(params, restored["params"], "params")
            _load_into(opt_state.mu, restored["opt"].mu, "first moments")
            _load_into(opt_state.nu, restored["opt"].nu, "second moments")
            opt_state.count = restored["opt"].count
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restore_seconds = time.perf_counter() - t0
            resumed_from = int(manifest["step"])
            start_step = resumed_from + 1
            if verbose:
                print(f"[train] resumed from step {resumed_from}")

    history, step_seconds = [], []
    t_start = time.perf_counter()
    for step in range(start_step, steps):
        if stop_at_step is not None and step >= stop_at_step:
            break  # simulated interruption (schedule still sized by `steps`)
        b = data.batch(step)
        if mesh is not None:
            b = shard_batch(b, mesh, (DATA,) if compress else batch_axes(mesh))
        b = {k: v.to(dev) for k, v in b.items()}
        t0 = time.perf_counter()
        opt_state, loss = train_step(model, optimizer, params, opt_state, b,
                                     mesh=mesh, compress_grads=compress)
        loss = float(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        # the collector turns this process's time into the per-host vector
        straggler_src.record_step(dt)
        history.append(loss)
        step_seconds.append(dt)
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d}  loss {loss:.4f}  "
                  f"{dt*1e3:7.1f} ms  {batch * seq / dt:9.0f} tok/s")
        if mgr and mgr.every > 0 and step % mgr.every == 0:
            t0 = time.perf_counter()
            tree = _logical(model, params, opt_state)
            if lead:
                mgr.save(step, tree, extra={"loss": loss, "arch": arch})
                save_seconds.append(time.perf_counter() - t0)
        if session is not None:
            # the session drains the straggler source and replans the MT
            # workload through its cache (§5.5 hook, one production path)
            session.poll()
        else:
            for ev in straggler_src.poll():
                if verbose and ev.hosts:
                    print(f"[train] stragglers detected: {list(ev.hosts)} "
                          f"— re-plan trigger")
                elif verbose:
                    print("[train] stragglers recovered")
    wall = time.perf_counter() - t_start
    interrupted = stop_at_step is not None and stop_at_step < steps
    if mgr and history and not interrupted and (
            ckpt_every <= 0 or (steps - 1) % ckpt_every != 0):
        # off-cadence final step of a COMPLETED schedule: save
        # unconditionally (maybe_save skips it by construction).  An
        # interrupted run must not stamp steps-1 onto older state — a real
        # crash saves nothing either, and resume would skip the tail.
        t0 = time.perf_counter()
        tree = _logical(model, params, opt_state)
        if lead:
            mgr.save(steps - 1, tree, extra={"loss": history[-1]})
            save_seconds.append(time.perf_counter() - t0)
    return {
        "arch": arch,
        "steps": steps,
        "device": str(dev),
        "first_loss": history[0] if history else None,
        "final_loss": history[-1] if history else None,
        "wall_seconds": wall,
        "params": params,
        "opt_state": opt_state,
        "history": history,
        "step_seconds": step_seconds,
        "resumed_from": resumed_from,
        "ckpt_save_seconds": save_seconds,
        "ckpt_restore_seconds": restore_seconds,
        "mt_plan": session.current_plan if session is not None else None,
        "mt_session": session,
    }


ELASTIC_TASKS = ("img_text", "audio_text", "audio_vision")


def elastic_cluster(ranks: int):
    """The elastic smoke's cluster: one device a rank, two a host from four
    ranks on (one below), islands of two hosts."""
    from ..core.placement import ClusterSpec

    per_host = 2 if ranks >= 4 else 1
    return ClusterSpec(n_devices=ranks, island_size=max(per_host * 2, 2),
                       devices_per_host=per_host, mem_bytes=80e9)


def elastic_rank(rank: int, steps: int, straggler_at: int,
                 bad: Tuple[int, ...], ckpt_dir: str, device: str,
                 verbose: bool = True) -> Dict[str, Any]:
    """One rank of :func:`elastic_smoke` (every rank of the world calls
    it): a bound distributed session over ``tiny_multitask_clip`` with 3
    tasks, a :class:`repro_torch.ckpt.CheckpointManager` in the shared
    ``ckpt_dir`` saving every ``straggler_at`` steps, and hosts ``bad``
    flagged after step ``straggler_at``.  Rank 0 prints the transcript.
    Returns what :func:`check_elastic` reads."""
    from ..ckpt import CheckpointManager
    from ..parallel import mesh_over_devices
    from ..runtime import tiny_multitask_clip
    from ..session import CheckpointCallbacks, SessionConfig, SpindleSession
    from .events import ScriptedEventSource, StragglerDetected

    world = dist.get_world_size()
    say = verbose and rank == 0
    mgr = CheckpointManager(ckpt_dir, every=max(straggler_at, 1), keep=3)
    session = SpindleSession(
        SessionConfig(cluster=elastic_cluster(world), straggler_shrink=True,
                      mesh=mesh_over_devices(range(world), device=device),
                      device=device),
        model_factory=lambda tasks: tiny_multitask_clip(n_tasks=len(tasks)),
        tasks=ELASTIC_TASKS,
        callbacks=[CheckpointCallbacks(mgr)],
        event_sources=[ScriptedEventSource([StragglerDetected(bad)],
                                           fire_at=[straggler_at])],
    ).bind()
    announced = 0
    for k in range(steps):
        loss = session.step()
        restored = any(r.mode == "restore" for r in session.replans)
        if say:
            print(f"[elastic] step {k:3d}  loss {loss:.4f}  "
                  f"({'post-restore' if restored else 'healthy'})",
                  flush=True)
        for r in session.replans[announced:]:
            if r.mode == "restore" and say:
                print(f"[elastic] straggler {list(bad)} -> replan "
                      f"mode=restore plan_mode={r.plan_mode} "
                      f"restored_step={r.restored_step} healthy_devices="
                      f"{len(session.cluster.healthy_devices())} live "
                      f"ranks {list(session.engine.live)}", flush=True)
        announced = len(session.replans)
    return {
        "rank": rank,
        "steps": session.step_count,
        "history": list(session.history),
        "replans": [(r.mode, r.plan_mode, r.restored_step)
                    for r in session.replans],
        "plan_devices": sorted({d for s in session.current_plan.steps
                                for d in s.devices}),
        "live": list(session.engine.live),
    }


def check_elastic(results, bad: Tuple[int, ...], straggler_at: int
                  ) -> Dict[str, Any]:
    """The elastic smoke's conditions on its ranks' results; any violation
    raises ``SystemExit``, success prints ``[elastic] OK``."""
    cluster = elastic_cluster(len(results))
    r0 = results[0]
    for r in results[1:]:
        if (r["history"], r["replans"], r["live"]) != (
                r0["history"], r0["replans"], r0["live"]):
            raise SystemExit(f"[elastic] FAIL: rank {r['rank']} disagrees "
                             f"with rank 0")
    restores = [r for r in r0["replans"] if r[0] == "restore"]
    if not restores:
        raise SystemExit("[elastic] FAIL: no restore replan occurred")
    flagged = {d for h in bad for d in cluster.devices_of(h)}
    if set(r0["plan_devices"]) & flagged or set(r0["live"]) & flagged:
        raise SystemExit(
            f"[elastic] FAIL: flagged devices "
            f"{sorted((set(r0['plan_devices']) | set(r0['live'])) & flagged)}"
            " still placed after the restore replan")
    if r0["steps"] <= straggler_at + 1:
        raise SystemExit("[elastic] FAIL: no post-restore training step")
    print(f"[elastic] OK: {len(restores)} restore replan(s), "
          f"{r0['steps'] - straggler_at - 1} post-restore steps on live "
          f"ranks {r0['live']} of {len(results)}, final loss "
          f"{r0['history'][-1]:.4f}", flush=True)
    return {"steps": r0["steps"], "history": r0["history"],
            "replans": r0["replans"], "live": r0["live"], "ranks": results}


def elastic_smoke(
    *,
    steps: int = 10,
    straggler_at: int = 4,
    straggler_hosts: Tuple[int, ...] = (1,),
    ckpt_dir: Optional[str] = None,
    ranks: int = 8,
    device: str = "cuda",
    verbose: bool = True,
) -> Dict[str, Any]:
    """Straggler scenario on the distributed WaveEngine: ``ranks`` spawned
    ranks (:func:`repro_torch.parallel.mesh.run_ranks`) run
    :func:`elastic_rank` over :func:`elastic_cluster`, and a scripted
    straggler flags ``straggler_hosts`` after step ``straggler_at``.  The
    run must produce a ``ReplanRecord(mode="restore")`` whose plan and
    live mesh exclude exactly the flagged hosts' devices, then keep
    training; any violation raises ``SystemExit`` (:func:`check_elastic`).
    """
    import shutil
    import tempfile

    from ..parallel.mesh import run_ranks

    cluster = elastic_cluster(ranks)
    bad = tuple(h for h in straggler_hosts if 0 <= h < cluster.n_hosts)
    if not bad or len(bad) >= cluster.n_hosts:
        raise SystemExit("[elastic] no valid straggler host to inject")
    base = ckpt_dir or tempfile.mkdtemp(prefix="elastic_")
    try:
        results = run_ranks(elastic_rank, ranks, device, args=(
            steps, straggler_at, bad, base, device, verbose))
    finally:
        if ckpt_dir is None:
            shutil.rmtree(base, ignore_errors=True)
    return check_elastic(results, bad, straggler_at)


#: the simulated cluster of the crash smoke: four hosts of two devices in
#: two islands, so killing a host removes a block the planner routes around
CRASH_CLUSTER = dict(n_devices=8, island_size=4, devices_per_host=2,
                     mem_bytes=96e9)


def crash_smoke(
    *,
    steps: int = 8,
    kill_at: int = 4,
    kill_hosts: Tuple[int, ...] = (1,),
    ckpt_every: int = 2,
    ckpt_dir: Optional[str] = None,
    verbose: bool = True,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Hard-failure scenario: a bound session survives a host KILL through
    the async-snapshot → rollback → replan → replay path.

    The planner plans for a simulated cluster (:data:`CRASH_CLUSTER`, eight
    devices on four hosts); the engine runs every step on the one
    ``device``.  A :class:`repro_torch.launch.faults.FaultInjector`
    hard-kills ``kill_hosts`` after step ``kill_at`` while an
    :class:`repro_torch.ckpt.AsyncCheckpointManager` snapshots every
    ``ckpt_every`` steps off the step turn.  The session must roll back to
    the last durable snapshot, evict the dead hosts' devices, replan over
    the survivors and replay the lost steps: the loss history must equal
    an uninterrupted run planned for the surviving topology within 1e-6,
    and the final plan must not place the dead devices.  Any violation
    raises ``SystemExit``; success prints ``[crash] OK``.
    """
    import shutil
    import tempfile

    import numpy as np

    from ..ckpt import AsyncCheckpointManager, all_steps
    from ..core.placement import ClusterSpec
    from ..runtime import tiny_multitask_clip
    from ..session import CheckpointCallbacks, SessionConfig, SpindleSession
    from .faults import FaultInjector, FaultScript

    cluster = ClusterSpec(**CRASH_CLUSTER)
    bad = tuple(h for h in kill_hosts if 0 <= h < cluster.n_hosts)
    if not bad or len(bad) >= cluster.n_hosts:
        raise SystemExit("[crash] no valid host to kill")
    if not 0 < kill_at < steps:
        raise SystemExit(f"[crash] --kill-at must be in 1..{steps - 1}")
    tasks = ("img_text", "audio_text", "audio_vision")
    factory = lambda ts: tiny_multitask_clip(n_tasks=len(ts))  # noqa: E731

    # uninterrupted reference on the surviving topology — the ground truth
    # the recovered run must reproduce loss for loss
    ref = SpindleSession(
        SessionConfig(cluster=cluster.shrink(bad), device=device),
        model_factory=factory, tasks=tasks,
    ).bind()
    ref_hist = [ref.step() for _ in range(steps)]

    base = ckpt_dir or tempfile.mkdtemp(prefix="crash_")
    mgr = AsyncCheckpointManager(base, every=max(ckpt_every, 1), keep=3)
    inj = FaultInjector(cluster.n_hosts,
                        schedule=[FaultScript(step=kill_at, hosts=bad)])
    try:
        session = SpindleSession(
            SessionConfig(cluster=cluster, device=device),
            model_factory=factory,
            tasks=tasks,
            callbacks=[CheckpointCallbacks(mgr)],
            event_sources=[inj],
        ).bind()
        announced = 0
        for k in range(steps):
            loss = session.step()
            if verbose:
                phase = "recovered" if any(
                    r.mode == "restore" for r in session.replans
                ) else "healthy"
                print(f"[crash] step {k:3d}  loss {loss:.4f}  ({phase})")
            for r in session.replans[announced:]:
                if r.mode == "restore" and verbose:
                    print(f"[crash] host kill {list(bad)} -> rollback to "
                          f"step {r.restored_step}, replayed "
                          f"{r.rollback_steps} lost step(s), replanned on "
                          f"{len(session.cluster.healthy_devices())} devices")
            announced = len(session.replans)
        mgr.wait()
        durable = all_steps(mgr.base)
    finally:
        mgr.close()
        if ckpt_dir is None:
            shutil.rmtree(base, ignore_errors=True)

    restores = [r for r in session.replans if r.mode == "restore"]
    if not restores:
        raise SystemExit("[crash] FAIL: no rollback-restore replan occurred")
    dead_devs = {d for h in bad for d in cluster.devices_of(h)}
    plan_devs = {d for s in session.current_plan.steps for d in s.devices}
    if plan_devs & dead_devs:
        raise SystemExit(
            f"[crash] FAIL: dead devices {sorted(plan_devs & dead_devs)} "
            "still placed after recovery"
        )
    if len(session.history) != steps:
        raise SystemExit(
            f"[crash] FAIL: {len(session.history)} steps recorded, "
            f"expected {steps}"
        )
    err = float(np.max(np.abs(np.asarray(session.history)
                              - np.asarray(ref_hist))))
    if err > 1e-6:
        raise SystemExit(
            f"[crash] FAIL: recovered losses diverge from the "
            f"uninterrupted reference (max abs err {err:.2e})"
        )
    if not durable:
        raise SystemExit("[crash] FAIL: no restorable checkpoint on disk")
    print(f"[crash] OK: rollback_steps={restores[0].rollback_steps} "
          f"restored_step={restores[0].restored_step} "
          f"loss-exact vs reference (max err {err:.1e}), "
          f"{len(durable)} durable snapshot(s), async saves "
          f"{mgr.saves_written} written / {mgr.saves_dropped} dropped, "
          f"on {device}")
    return {
        "steps": session.step_count,
        "history": session.history,
        "ref_history": ref_hist,
        "replans": session.replans,
        "durable_steps": durable,
        "max_err": err,
        "session": session,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--plan-workload", default=None,
                    help="also plan this MT workload via the PlannerPipeline")
    ap.add_argument("--planner", default="spindle",
                    help="planner strategy for --plan-workload")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save here, and resume from the latest step here")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--elastic-smoke", action="store_true",
                    help="straggler scenario on the distributed engine: "
                         "scripted straggler -> checkpointed re-mesh "
                         "restore; uses --steps/--straggler-at/"
                         "--straggler-hosts/--ranks/--ckpt-dir")
    ap.add_argument("--straggler-at", type=int, default=4,
                    help="elastic-smoke: flag the stragglers after this step")
    ap.add_argument("--straggler-hosts", default="1",
                    help="elastic-smoke: comma-separated host ids to flag")
    ap.add_argument("--ranks", type=int, default=8,
                    help="elastic-smoke: ranks to spawn (two devices a host "
                         "from four on)")
    ap.add_argument("--crash-smoke", action="store_true",
                    help="hard-failure scenario: scripted host kill -> "
                         "async-snapshot rollback + replay; uses "
                         "--steps/--kill-at/--kill-hosts/--ckpt-every")
    ap.add_argument("--kill-at", type=int, default=4,
                    help="crash-smoke: hard-kill after this step")
    ap.add_argument("--kill-hosts", default="1",
                    help="crash-smoke: comma-separated host ids to kill")
    args = ap.parse_args()
    if args.elastic_smoke:
        elastic_smoke(
            steps=args.steps,
            straggler_at=args.straggler_at,
            straggler_hosts=tuple(int(h) for h in
                                  args.straggler_hosts.split(",") if h != ""),
            ckpt_dir=args.ckpt_dir,
            ranks=args.ranks,
            device=args.device,
        )
        return
    if args.crash_smoke:
        crash_smoke(
            steps=args.steps,
            kill_at=args.kill_at,
            kill_hosts=tuple(int(h) for h in args.kill_hosts.split(",")
                             if h != ""),
            ckpt_every=max(args.ckpt_every, 1),
            ckpt_dir=args.ckpt_dir,
            device=args.device,
        )
        return
    out = train(args.arch, reduced_cfg=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                seed=args.seed, device=args.device,
                plan_workload=args.plan_workload, planner=args.planner)
    if not out["history"]:  # resumed from the schedule's last step
        print(f"[train] nothing left to train: the checkpoint is at step "
              f"{out['resumed_from']} of {args.steps}")
        return
    print(f"[train] done on {out['device']}: loss {out['first_loss']:.4f} → "
          f"{out['final_loss']:.4f} in {out['wall_seconds']:.1f}s")


if __name__ == "__main__":
    main()
