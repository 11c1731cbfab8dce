"""Fleet driver: N jobs, one cluster, one planner (port of
``repro/launch/fleet.py``; DESIGN.md §14).

A thin shell over :class:`repro_torch.fleet.FleetScheduler`: registers a
mix of plan-only training jobs and a real serving job, admits them onto one
``ClusterSpec`` (8 hosts of 4 H100s by default) under the chosen policy,
and drives the cooperative loop to completion, printing one line per fleet
lifecycle event.  Serve jobs run on ``--device`` (``cuda`` by default:
the hand-written kernels; ``cuda`` without a GPU raises, ``cpu`` runs their
plain PyTorch versions).

    PYTHONPATH=src python -m repro_torch.launch.fleet --policy fleet
    PYTHONPATH=src python -m repro_torch.launch.fleet --smoke --straggler-at 6
    PYTHONPATH=src python -m repro_torch.launch.fleet --policy colocate --smoke
    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu --smoke

``--smoke`` is the CI contract (the ``fleet-smoke`` job): 2 duplicate
training jobs + 1 serving job with a scripted straggler at step N.  It
exits non-zero unless (a) every job drains, (b) at least one fleet
rebalance fired, (c) every job still live at the rebalance made at least
one step AFTER it (progress post-eviction), and (d) the duplicate-arch
pair deduplicated through the shared PlanCache (``cross_job_hits > 0``).

``--policy colocate --smoke`` is the ``colocation-smoke`` contract: the
serving job rides a training lease as a co-resident tenant instead of
holding hosts.  It exits non-zero unless (a) every job drains, (b) at
least one decode step landed inside a training idle window
(``colocated_steps >= 1``), and (c) every tenant's KV page-pool
high-water stayed within the window memory headroom it was budgeted
against.

``--revoke-smoke`` is the preemptive-lease contract (DESIGN.md §17): a
long-step holder, a short-step job that keeps the tick clock moving, and
a high-priority late arrival whose expansion defers behind the holder's
applied lease.  With a bounded ``--revoke-deadline`` the arbiter must
force-evict the slow holder's contested blocks when the deadline expires
mid-step (``forced_revokes >= 1``), every job must still drain, and the
lease invariants must hold at exit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Set

from ..config import get_arch, reduced, resolve_device
from ..core.costmodel import ICI_BW
from ..core.placement import ClusterSpec
from ..fleet import FleetCallbacks, FleetConfig, FleetScheduler, JobSpec
from ..launch.events import ScriptedEventSource, StragglerDetected


class FleetPrinter(FleetCallbacks):
    """One line per fleet lifecycle event; remembers which jobs were still
    live at each rebalance (the smoke contract's survivor set)."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.survivors_at_rebalance: List[Set[str]] = []

    def on_job_admitted(self, fleet, handle):
        if self.verbose:
            lease = fleet.arbiter.granted.get(handle.name)
            grant = (
                f"granted hosts {lease.hosts}" if lease is not None
                else "co-tenant (no lease: rides a training job's windows)"
            )
            print(
                f"[fleet] t={fleet.t:.3f} admitted {handle.name} "
                f"({handle.spec.kind}, prio {handle.spec.priority}): "
                f"{grant}"
            )

    def on_rebalance(self, fleet, event, leases):
        live = {
            h.name for h in fleet.jobs.values()
            if h.state in ("running", "queued")
        }
        self.survivors_at_rebalance.append(live)
        if self.verbose:
            carve = {j: lease.hosts for j, lease in leases.items()}
            print(
                f"[fleet] t={fleet.t:.3f} rebalance #{fleet.rebalances}: "
                f"evicted hosts {tuple(event.hosts)}; re-carved leases "
                f"{carve}"
            )

    def on_job_finished(self, fleet, handle):
        if self.verbose:
            print(
                f"[fleet] t={fleet.t:.3f} finished {handle.name} "
                f"after {handle.steps_done} steps "
                f"(p99 step {handle.summary()['p99_step_s'] * 1e3:.1f} ms)"
            )


def default_jobs(steps: int = 8, requests: int = 3) -> List[JobSpec]:
    """The heterogeneous reference mix (also the bench_fleet scenario):
    two duplicate CLIP jobs (the cross-job dedup pair), a priority-2
    OFASys job, a late-arriving priority-3 validation job, and a real
    serving job over a ``configs/`` arch."""
    return [
        JobSpec(name="trainA", kind="train", workload="multitask_clip",
                steps=steps),
        JobSpec(name="trainB", kind="train", workload="multitask_clip",
                steps=steps),
        JobSpec(name="trainC", kind="train", workload="ofasys",
                steps=max(2, steps - 2), priority=2),
        JobSpec(name="trainD", kind="train", workload="qwen_val",
                steps=max(2, steps // 2), priority=3, arrival=0.3),
        JobSpec(name="serve0", kind="serve", arch="qwen3-0.6b",
                requests=requests, prompt_len=8, gen_len=4, slots=2,
                cache_len=32),
    ]


def smoke_jobs(steps: int = 8, requests: int = 3) -> List[JobSpec]:
    """The CI smoke mix: 2 duplicate train jobs + 1 serving job."""
    return [
        JobSpec(name="trainA", kind="train", workload="multitask_clip",
                steps=steps),
        JobSpec(name="trainB", kind="train", workload="multitask_clip",
                steps=steps),
        JobSpec(name="serve0", kind="serve", arch="qwen3-0.6b",
                requests=requests, prompt_len=8, gen_len=4, slots=2,
                cache_len=32),
    ]


def revoke_jobs(steps: int = 8) -> List[JobSpec]:
    """The revoke-smoke mix: ``slowA`` steps rarely (big per-step
    makespan, so it sits between boundaries for many ticks), ``fastC``
    keeps the fleet tick clock advancing, and high-priority ``hipriB``
    arrives after slowA's first step — its quota wants slowA's blocks,
    deferring behind the applied lease until the revoke deadline expires."""
    return [
        JobSpec(name="slowA", kind="train", workload="mt_backbone_suite",
                steps=max(2, steps // 2)),
        JobSpec(name="fastC", kind="train", workload="ofasys",
                steps=steps * 5),
        # 0.15 s falls inside slowA's second step under the H100 spec; the
        # reference's 0.7 s suits its own spec's longer steps (under the
        # H100's, every job has finished by then and nothing is revoked)
        JobSpec(name="hipriB", kind="train", workload="multitask_clip",
                steps=steps, priority=4, arrival=0.15),
    ]


def first_serve_step_dt(spec: JobSpec, config: FleetConfig,
                        arch_cfg=None) -> float:
    """The virtual cost of serve job ``spec``'s first step, priced by its
    own planner: the widest decode step of the plan of the mix that step
    leaves behind (one ``prompt_len`` request: the fleet's trace admits one
    per serving step) on ``config``'s cluster under ``config.hw``, as
    ``FleetScheduler._serve_dt`` prices every later step.  ``arch_cfg`` is
    the served model's config (default: the reduced one the fleet builds).

    A colocate fleet takes it as ``serve_fallback_dt``, the cost of a step
    taken before any plan exists: the reference's 1 ms constant outlasts
    every idle window of an H100 plan of multitask_clip (the widest is
    under 1 ms), so a tenant would never take the step that gives it a
    plan and would co-locate nothing."""
    from ..core.workloads import serving_mix_workload
    from ..serving.mix import prompt_bucket, tower_from_arch
    from ..session import SessionConfig, SpindleSession

    cfg = arch_cfg if arch_cfg is not None else reduced(get_arch(spec.arch))
    mix = [(spec.name, prompt_bucket(spec.prompt_len), 1)]
    tower = tower_from_arch(cfg, seq=spec.cache_len)
    plan = SpindleSession(
        SessionConfig(cluster=config.cluster, planner=config.planner,
                      placement_strategy=config.placement_strategy,
                      hw=config.hw),
        graph_factory=lambda tasks: serving_mix_workload(mix, tower=tower),
    ).plan()
    dec = [s.duration for s in plan.steps if "decode" in s.meta_name]
    return max(dec) if dec else plan.makespan


def revoke_smoke(
    *,
    steps: int = 8,
    revoke_deadline: int = 4,
    n_hosts: int = 8,
    devices_per_host: int = 4,
    verbose: bool = True,
    device: str = "cuda",
) -> Dict:
    """Run the preemptive-lease scenario; returns metrics (checks in main)."""
    printer = FleetPrinter(verbose=verbose)
    fleet = FleetScheduler(
        FleetConfig(cluster=_cluster(n_hosts, devices_per_host),
                    policy="fleet", revoke_deadline=revoke_deadline,
                    device=device),
        revoke_jobs(steps),
        callbacks=[printer],
    )
    metrics = fleet.run()
    fleet.arbiter.check()  # lease invariants must hold at exit
    lease = metrics["lease"]
    if verbose:
        print(
            f"[fleet] revoke: deadline={revoke_deadline} ticks, "
            f"{lease['revokes_issued']} revocation(s) issued, "
            f"{lease['cooperative_yields']} cooperative yield(s), "
            f"{lease['forced_revokes']} forced revoke(s), "
            f"{lease['pending_revocations']} pending at exit"
        )
        for r in metrics["jobs"]:
            if r["forced_revokes"]:
                print(f"[fleet] revoke: {r['name']} force-evicted "
                      f"{r['forced_revokes']} time(s), still finished "
                      f"{r['steps_done']} steps")
    metrics["_handles"] = fleet.jobs
    return metrics


def run_fleet(
    policy: str = "fleet",
    *,
    smoke: bool = False,
    steps: int = 8,
    requests: int = 3,
    n_hosts: int = 8,
    devices_per_host: int = 4,
    slice_steps: int = 4,
    straggler_at: int = -1,
    verbose: bool = True,
    device: str = "cuda",
) -> Dict:
    """Build the mix, run it under ``policy``, return metrics + checks."""
    cluster = _cluster(n_hosts, devices_per_host)
    jobs = (smoke_jobs if smoke else default_jobs)(steps, requests)
    sources = []
    if straggler_at >= 0:
        # flag the last host after the Nth cooperative tick
        sources.append(
            ScriptedEventSource(
                [StragglerDetected((n_hosts - 1,))], fire_at=[straggler_at]
            )
        )
    printer = FleetPrinter(verbose=verbose)
    config = FleetConfig(cluster=cluster, policy=policy,
                         slice_steps=slice_steps, device=device)
    if policy == "colocate":
        # price the tenants' first step by their planner (see
        # first_serve_step_dt): the reference's 1 ms outlasts H100 windows
        config = dataclasses.replace(config, serve_fallback_dt=max(
            first_serve_step_dt(j, config) for j in jobs if j.kind == "serve"))
    fleet = FleetScheduler(
        config,
        jobs,
        callbacks=[printer],
        event_sources=sources,
    )
    metrics = fleet.run()
    fleet.arbiter.check()  # lease invariants must hold at exit
    if verbose:
        print(
            f"[fleet] policy={policy}: {metrics['n_jobs']} jobs, "
            f"{metrics['ticks']} steps, makespan {metrics['makespan_s']:.3f} s"
            f" (virtual), device idle {metrics['device_idle_frac']:.1%}, "
            f"{metrics['rebalances']} rebalances, "
            f"plan cache hit rate {metrics['cache']['hit_rate']:.2f} "
            f"({metrics['cross_job_hits']} cross-job hits)"
        )
    if policy == "colocate" and verbose:
        for h in fleet.jobs.values():
            if h.spec.kind != "serve" or h.colocated_steps < 1:
                continue
            hw = _tenant_kv_high_water_bytes(h)
            print(
                f"[fleet] colocated decode steps: {h.colocated_steps} "
                f"({h.windows_seen} windows, {h.deferred_windows} deferred) "
                f"for {h.name}"
            )
            print(
                f"[fleet] tenant {h.name} kv high-water {hw:.0f} B "
                f"<= window headroom {h.window_headroom_bytes:.0f} B: "
                f"{hw <= h.window_headroom_bytes}"
            )
    metrics["_survivors_at_rebalance"] = printer.survivors_at_rebalance
    metrics["_handles"] = fleet.jobs
    return metrics


def _cluster(n_hosts: int, devices_per_host: int) -> ClusterSpec:
    """``n_hosts`` hosts of ``devices_per_host`` H100s (80 GB, NVLink)."""
    return ClusterSpec(
        n_devices=n_hosts * devices_per_host,
        island_size=8,
        mem_bytes=80e9,
        intra_island_bw=ICI_BW,
        devices_per_host=devices_per_host,
    )


def _tenant_kv_high_water_bytes(handle) -> float:
    """Device bytes the tenant's KV page pool actually peaked at."""
    batcher = getattr(handle.session, "batcher", None)
    if batcher is None or batcher.pool is None:
        return 0.0
    return float(batcher.pool.high_water * batcher.kv_page_bytes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policy", default="fleet",
                    choices=("fleet", "static", "fifo", "colocate"))
    ap.add_argument("--smoke", action="store_true",
                    help="CI contract: 2 train + 1 serving job, scripted "
                         "straggler, hard checks on the outcome")
    ap.add_argument("--steps", type=int, default=8,
                    help="training steps per train job")
    ap.add_argument("--requests", type=int, default=3,
                    help="request-trace length of the serving job")
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--devices-per-host", type=int, default=4)
    ap.add_argument("--slice-steps", type=int, default=4,
                    help="fifo policy: steps per whole-cluster slice")
    ap.add_argument("--straggler-at", type=int, default=-1,
                    help="inject a straggler after the Nth fleet step "
                         "(-1 = none; --smoke defaults to 6)")
    ap.add_argument("--revoke-smoke", action="store_true",
                    help="CI contract: bounded-deadline preemptive leases "
                         "— a slow holder must be force-evicted and every "
                         "job must still drain")
    ap.add_argument("--revoke-deadline", type=int, default=4,
                    help="revoke-smoke: ticks a holder gets to yield")
    ap.add_argument("--device", default="cuda",
                    help="where serve jobs run: cuda (hand-written kernels) "
                         "or cpu (plain PyTorch)")
    args = ap.parse_args()
    resolve_device(args.device)  # cuda without a GPU raises, whatever the mix

    if args.revoke_smoke:
        m = revoke_smoke(
            steps=args.steps,
            revoke_deadline=args.revoke_deadline,
            n_hosts=args.hosts,
            devices_per_host=args.devices_per_host,
            device=args.device,
        )
        failures = []
        not_done = [r["name"] for r in m["jobs"] if r["state"] != "done"]
        if not_done:
            failures.append(f"jobs did not drain: {not_done}")
        if m["lease"]["revokes_issued"] < 1:
            failures.append("no revocation was ever issued")
        if m["forced_revokes"] < 1:
            failures.append(
                "the slow holder was never force-evicted "
                "(forced_revokes == 0)"
            )
        if m["lease"]["pending_revocations"] != 0:
            failures.append("revocations still pending at exit")
        if failures:
            for f in failures:
                print(f"[fleet] FAILED: {f}", file=sys.stderr)
            sys.exit(1)
        return

    straggler_at = args.straggler_at
    if args.smoke and straggler_at < 0 and args.policy != "colocate":
        # the colocate smoke exercises the window contract, not eviction
        straggler_at = 6
    m = run_fleet(
        args.policy,
        smoke=args.smoke,
        steps=args.steps,
        requests=args.requests,
        n_hosts=args.hosts,
        devices_per_host=args.devices_per_host,
        slice_steps=args.slice_steps,
        straggler_at=straggler_at,
        device=args.device,
    )

    failures = []
    not_done = [r["name"] for r in m["jobs"] if r["state"] != "done"]
    if not_done:
        failures.append(f"jobs did not drain: {not_done}")
    if args.smoke and args.policy == "colocate":
        if m["colocated_steps"] < 1:
            failures.append(
                "no decode step landed inside a training idle window "
                "(colocated_steps == 0)"
            )
        handles = m["_handles"]
        for h in handles.values():
            if h.spec.kind != "serve" or h.colocated_steps < 1:
                continue
            hw = _tenant_kv_high_water_bytes(h)
            if hw > h.window_headroom_bytes:
                failures.append(
                    f"tenant {h.name} kv high-water {hw:.0f} B exceeds "
                    f"window headroom {h.window_headroom_bytes:.0f} B"
                )
    elif args.smoke:
        if m["rebalances"] < 1:
            failures.append("no fleet rebalance fired")
        handles = m["_handles"]
        for live in m["_survivors_at_rebalance"]:
            stalled = [
                n for n in live if handles[n].post_rebalance_steps < 1
            ]
            if stalled:
                failures.append(
                    f"no post-rebalance step for surviving jobs {stalled}"
                )
        if m["cross_job_hits"] < 1:
            failures.append(
                "duplicate-arch jobs did not dedup through the shared "
                "PlanCache (cross_job_hits == 0)"
            )
    if failures:
        for f in failures:
            print(f"[fleet] FAILED: {f}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
