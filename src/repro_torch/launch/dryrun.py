"""Dry run: every (arch × shape × mesh) step traced shape-only, per rank
(port of ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell on 512 forced host devices and reads
the compiled module's memory and cost analyses and its HLO.  Here each
cell's placed step (:mod:`repro_torch.launch.steps`) runs once as rank 0
of an in-process ``fake`` process group of the mesh's size (256 ranks for
the single-pod ``(16, 16)`` mesh, 512 for the two-pod ``(2, 16, 16)``),
on ``"meta"`` tensors, with the kernels on — the card's path: on meta
each kernel entry returns its output's shape and counts its work
(:mod:`repro_torch.kernels.ops`) — under
:func:`~repro_torch.launch.op_analysis.analyze`.  Nothing is allocated and
nothing needs a GPU: the CLI runs wherever the port imports.

Records keep JAX's keys: ``arch``, ``shape``, ``mesh``, ``variant``,
``compile_s`` (here the host seconds of building, placing and tracing the
step), ``cost``, ``memory`` (this rank's argument, output, temp and alias
bytes: :class:`~repro_torch.launch.steps.MemoryAnalysis`), ``hlo_flops``
and ``hlo_bytes`` (the trace's FLOPs and HBM-traffic proxy per rank),
``collectives`` (bytes by JAX's five kinds), ``model_flops``,
``n_devices``, ``ok`` and ``error``; and ``launches``, the kernel calls
of the step by name.  Every family's cells run, and so do
qwen2-moe-a2.7b's under ``--baseline`` (60 unpadded experts, which the
model axis does not divide: the global-batch MoE with each expert stack's
hidden dim split over "model").  A cell whose step raises is recorded
``ok: false`` with the error, as JAX records a failed cell, and
:func:`main` exits 1.  JAX's CLI has no flag for Megatron-SP and neither
has this one: ``run_cell(shcfg=...)`` takes a ``seq_parallel`` config.

Left out: JAX's ``collective_bytes(hlo_text)``, an HLO parser nothing
calls; the collective bytes here are the trace's.

``--plan WORKLOAD`` runs the planning analogue: every requested planner
builds an ExecutionPlan through a plan-only
:class:`~repro_torch.session.SpindleSession`, on the port's H100 spec and
80 GB cards unless the caller passes others.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --plan multitask_clip --devices 32
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from ..config import (SHAPES, ArchConfig, ShapeConfig, ShardingConfig,
                      applicable_shapes, default_sharding, get_arch)


def baseline_overrides(arch: str):
    """Paper-faithful baseline: strip the §Perf levers (remat=block, no
    grad accumulation / seq parallelism; qwen2-moe reverts to unpadded
    experts that are not sharded).  The optimized path is the arch's
    sharding defaults."""
    shcfg = ShardingConfig(use_kernels=True)
    cfg = get_arch(arch)
    if arch == "qwen2-moe-a2.7b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               pad_to=0))
        shcfg = dataclasses.replace(shcfg, shard_experts=False)
    return cfg, shcfg


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0, for the duration (none is made where a fake group of that
    size exists already; any other group raises)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_backend() != "fake"
                or dist.get_world_size() != world):
            raise RuntimeError(
                f"dry run: a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks is present; the trace needs "
                f"a fake group of {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _model_flops(cfg: ArchConfig, shp: ShapeConfig) -> float:
    n_active = cfg.n_active_params()
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch  # decode: one token a row


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
             *, multi_pod: bool = False,
             mesh_shape: Optional[Sequence[int]] = None,
             shcfg: Optional[ShardingConfig] = None, baseline: bool = False,
             verbose: bool = True) -> Dict[str, Any]:
    """Trace one cell as rank 0 of the mesh (``mesh_shape``, default the
    production ``(16, 16)`` or, ``multi_pod``, ``(2, 16, 16)``; axes
    ``(pod,) data, model``); return its record.  ``shcfg`` defaults to
    the arch's sharding with the kernels on."""
    from ..kernels import ops
    from ..parallel import collectives, make_mesh
    from .steps import build_step, lower_step

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    dims = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    rec: Dict[str, Any] = {
        "arch": cfg.name,
        "shape": shp.name,
        "mesh": "x".join(str(d) for d in dims),
        "variant": "baseline" if baseline else "optimized",
    }
    # a fresh count per cell: the place of JAX's ``jax.clear_caches()``
    collectives.reset_traffic()
    ops.reset_shape_only()
    t0 = time.perf_counter()
    with fake_group(math.prod(dims)):
        try:
            if baseline:
                cfg, shcfg = baseline_overrides(cfg.name)
            shcfg = shcfg or default_sharding(cfg, use_kernels=True)
            mesh = make_mesh(dims, ("pod", "data", "model")[-len(dims):],
                             "cpu")
            spec = build_step(cfg, shp, mesh, shcfg=shcfg, device="meta")
            compiled = lower_step(spec, mesh).compile()
            stats = compiled.stats
            rec["compile_s"] = time.perf_counter() - t0
            rec["cost"] = compiled.cost_analysis()
            rec["memory"] = dataclasses.asdict(compiled.memory_analysis())
            rec["hlo_flops"] = stats.flops
            rec["hlo_bytes"] = stats.hbm_bytes
            rec["collectives"] = dict(stats.collective_bytes)
            rec["launches"] = dict(stats.launches)
            rec["peak_live"] = dict(stats.peak_live)
            rec["model_flops"] = _model_flops(
                get_arch(arch) if isinstance(arch, str) else arch, shp)
            rec["n_devices"] = math.prod(dims)
            rec["ok"] = True
            if verbose:
                print(f"[dryrun] {rec['arch']} × {rec['shape']} × "
                      f"{rec['mesh']}: OK ({rec['compile_s']:.1f}s)")
                print(f"  memory:      {rec['memory']}")
                print(f"  flops/rank:  {rec['hlo_flops']:.3e}  (model "
                      f"flops {rec['model_flops']:.3e} over "
                      f"{rec['n_devices']} ranks)")
                print(f"  bytes/rank:  {rec['hlo_bytes']:.3e}")
                print("  collectives: "
                      f"{ {k: v for k, v in rec['collectives'].items() if v} }")
                print(f"  launches:    "
                      f"{ {k: v for k, v in rec['launches'].items() if v} }")
        except Exception as e:  # noqa: BLE001 — record and continue
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["compile_s"] = time.perf_counter() - t0
            if verbose:
                print(f"[dryrun] {rec['arch']} × {rec['shape']} × "
                      f"{rec['mesh']}: FAIL {rec['error']}")
                if not isinstance(e, NotImplementedError):
                    traceback.print_exc()
    return rec


def run_all(*, multi_pod: bool = False, archs: Optional[List[str]] = None,
            shapes: Optional[List[str]] = None,
            baseline: bool = False) -> List[Dict[str, Any]]:
    from ..configs import ASSIGNED

    records = []
    for arch in archs or ASSIGNED:
        cfg = get_arch(arch)
        for shape in shapes or applicable_shapes(cfg):
            records.append(
                run_cell(arch, shape, multi_pod=multi_pod, baseline=baseline)
            )
    n_ok = sum(r["ok"] for r in records)
    print(f"[dryrun] {n_ok}/{len(records)} cells OK "
          f"({'multi-pod' if multi_pod else 'single-pod'})")
    return records


def run_planner_dry(workload: str, *, planners: Optional[List[str]] = None,
                    n_devices: int = 16, verbose: bool = True, hw=None,
                    mem_bytes: float = 80e9) -> List[Dict[str, Any]]:
    """Planner dry run: plan ``workload`` through a plan-only
    :class:`~repro_torch.session.SpindleSession` per requested strategy
    and record the plan's shape and planning cost.  ``hw`` (default the
    port's H100 spec) and ``mem_bytes`` (per card, default the H100's 80
    GB) set the cluster; the JAX package plans on its v5e spec and 96
    GB."""
    from ..core.costmodel import H100
    from ..core.pipeline import available_planners
    from ..core.placement import ClusterSpec
    from ..core.workloads import WORKLOADS
    from ..session import SessionConfig, SpindleSession

    if workload not in WORKLOADS:
        raise SystemExit(
            f"[dryrun] unknown workload {workload!r}; "
            f"choose from {sorted(WORKLOADS)}"
        )
    for name in planners or ():
        if name not in available_planners():
            raise SystemExit(
                f"[dryrun] unknown planner {name!r}; "
                f"choose from {available_planners()}"
            )
    cluster = ClusterSpec(n_devices=n_devices, island_size=8,
                          mem_bytes=mem_bytes)
    records = []
    for name in planners or available_planners():
        cfg = SessionConfig(workload=workload, planner=name, cluster=cluster,
                            hw=hw or H100)
        p = SpindleSession(cfg).plan()
        rec = {
            "workload": workload,
            "planner": name,
            "n_devices": n_devices,
            "n_waves": len(p.waves()),
            "n_steps": len(p.steps),
            "makespan_s": p.makespan,
            "planning_s": p.planning_seconds,
            "ok": True,
        }
        records.append(rec)
        if verbose:
            print(f"[dryrun] plan {workload} × {name:10s}: "
                  f"{rec['n_waves']:3d} waves {rec['n_steps']:3d} steps  "
                  f"makespan {rec['makespan_s']*1e3:8.2f} ms  "
                  f"planned in {rec['planning_s']*1e3:6.1f} ms")
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful configs (no §Perf levers)")
    ap.add_argument("--plan", default=None, metavar="WORKLOAD",
                    help="planner dry-run for an MT workload "
                         "(multitask_clip | ofasys | qwen_val | ...)")
    ap.add_argument("--planner", default=None,
                    help="restrict --plan to one strategy")
    ap.add_argument("--devices", type=int, default=16,
                    help="cluster size for --plan")
    ap.add_argument("--out", default=None, help="write records JSON here")
    args = ap.parse_args(argv)

    if args.plan:
        records = run_planner_dry(
            args.plan,
            planners=[args.planner] if args.planner else None,
            n_devices=args.devices,
        )
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
            print(f"[dryrun] wrote {len(records)} records to {args.out}")
        return

    records: List[Dict[str, Any]] = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    for mp in meshes:
        if args.all:
            records += run_all(multi_pod=mp, baseline=args.baseline)
        else:
            if not args.arch or not args.shape:
                ap.error("--arch and --shape required unless --all")
            records.append(run_cell(args.arch, args.shape, multi_pod=mp,
                                    baseline=args.baseline))
            print(json.dumps(records[-1]))
    print(f"[dryrun] {len(records)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    if not all(r["ok"] for r in records):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
