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

With ``--plan-workload`` the trainer also stands up a plan-only
:class:`repro_torch.session.SpindleSession` for the named MT workload: the
training loop feeds its step times into a
:class:`repro_torch.launch.events.StragglerEventSource` (through an
in-process :class:`repro_torch.ckpt.straggler.TimingCollector`), and the
session polls it every step, so a detected straggler fires the §5.5
re-plan hook.  Checkpoints (``--ckpt-dir``), the fault-injection smokes
(``--elastic-smoke``, ``--crash-smoke``) and compressed data-parallel
gradients come with multi-GPU runs and raise (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any, Dict, Optional

import torch

from ..ckpt.straggler import (ITEM_5, StragglerDetector, TimingCollector,
                              world_size)
from ..config import default_sharding, get_arch, reduced, resolve_device
from ..data import DataConfig, SyntheticLM
from ..models import build_model
from ..models.layers import dtype_of
from ..optim import AdamW, warmup_cosine
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


def make_train_state(model, optimizer: AdamW, seed: int):
    """Random weights from ``seed`` (fp32 masters) and fresh optimizer
    state.  Returns (params by name, optimizer state)."""
    model.init(seed)
    params = dict(model.impl.named_parameters())
    return params, optimizer.init(params)


def train_step(model, optimizer: AdamW, params, opt_state, batch):
    """Loss, backward, AdamW update (in place on ``params``).  Returns
    (new optimizer state, loss as a 0-d tensor)."""
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
    return opt_state, loss.detach()


def train(
    arch: str = "qwen3-0.6b",
    *,
    reduced_cfg: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    log_every: int = 10,
    seed: int = 0,
    stop_at_step: Optional[int] = None,  # simulate an interrupt
    compress_grads: bool = False,
    verbose: bool = True,
    plan_workload: Optional[str] = None,
    planner: str = "spindle",
    device: str = "cuda",
    use_kernels: Optional[bool] = None,
) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps on ``device``.  ``use_kernels``
    (default: on the GPU) routes attention through the CUDA kernels; off,
    attention is plain PyTorch on either device.  Returns the loss history,
    each step's seconds (host clock, ending in a device sync), the params
    and the MT plan of ``plan_workload``."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            f"checkpoint/resume (ckpt_dir) is not ported yet: {ITEM_5}")
    if compress_grads:
        raise NotImplementedError(
            f"int8-compressed data-parallel gradients are not ported yet: "
            f"{ITEM_5}")
    dev = resolve_device(device)
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
    cfg = get_arch(arch)
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
    params, opt_state = make_train_state(model, optimizer, seed)

    history, step_seconds = [], []
    t_start = time.perf_counter()
    for step in range(steps):
        if stop_at_step is not None and step >= stop_at_step:
            break  # simulated interruption (schedule still sized by `steps`)
        b = {k: v.to(dev) for k, v in data.batch(step).items()}
        t0 = time.perf_counter()
        opt_state, loss = train_step(model, optimizer, params, opt_state, b)
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
    return {
        "arch": arch,
        "steps": steps,
        "device": str(dev),
        "first_loss": history[0] if history else None,
        "final_loss": history[-1] if history else None,
        "wall_seconds": time.perf_counter() - t_start,
        "params": params,
        "history": history,
        "step_seconds": step_seconds,
        "mt_plan": session.current_plan if session is not None else None,
        "mt_session": session,
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
                    help="not ported yet (ROADMAP queue 1, item 5)")
    ap.add_argument("--elastic-smoke", action="store_true",
                    help="not ported yet (ROADMAP queue 1, item 5)")
    ap.add_argument("--crash-smoke", action="store_true",
                    help="not ported yet (ROADMAP queue 1, item 5)")
    args = ap.parse_args()
    if args.elastic_smoke or args.crash_smoke:
        raise NotImplementedError(
            f"the fault-injection smokes (checkpoint → re-mesh → restore, "
            f"rollback → replay) are not ported yet: {ITEM_5}")
    out = train(args.arch, reduced_cfg=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
                plan_workload=args.plan_workload, planner=args.planner)
    print(f"[train] done on {out['device']}: loss {out['first_loss']:.4f} → "
          f"{out['final_loss']:.4f} in {out['wall_seconds']:.1f}s")


if __name__ == "__main__":
    main()
