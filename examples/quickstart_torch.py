"""Quickstart on the PyTorch port (the counterpart of ``quickstart.py``):
train a reduced qwen3 for a few hundred steps on the GPU.

Exercises the full public path of ``repro_torch``, in the order of the JAX
quickstart: a plan-only :class:`repro_torch.session.SpindleSession`
previews the wavefront plan of a multi-task workload; a queue-driven
:class:`repro_torch.serving.ServingSession` continuously batches requests
with prefix sharing and grow admission (the hand-written paged-decode
kernel on the card); a :class:`repro_torch.fleet.FleetScheduler` admits two
jobs onto one cluster and plans both through one shared PlanCache; the
plan timeline exposes a plan's idle windows, and the ``colocate`` fleet
slots a serving tenant's decode steps into them; a scripted host kill
rolls a bound session back to its last durable async snapshot; and the
arch registry → reduced qwen3 → synthetic data → AdamW → checkpoints →
loss curve path trains 300 steps and must learn.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.config import get_arch
from repro_torch.launch.train import train
from repro_torch.serving import Request, ServingConfig, ServingSession
from repro_torch.session import SessionConfig, SpindleSession


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain PyTorch)")
    device = ap.parse_args().device

    # the planning side, in three lines: a plan-only session for a named
    # MT workload (plan → cache → replan lives behind the same object)
    session = SpindleSession(SessionConfig(workload="multitask_clip"))
    p = session.plan()
    print(f"multitask_clip plan: {len(p.waves())} waves / {len(p.steps)} "
          f"steps, makespan {p.makespan*1e3:.1f} ms/iter")

    # the serving side: requests go to a queue; the session stacks
    # same-length admissions into one prefill, streams long prompts into
    # the shared KV page pool in chunks interleaved with decode steps, and
    # replans through the same PlanCache whenever the request mix shifts.
    # Every prompt opens with the same 8-token preamble, so with prefix
    # sharing later admissions map the preamble's page read-shared instead
    # of re-prefilling it, and grow admission allocates decode pages as
    # they are written instead of reserving max_new_tokens up front
    serving = ServingSession(
        ServingConfig(arch="qwen3-0.6b", max_slots=4, cache_len=32,
                      page_size=8, prefill_chunk=8, prefix_sharing=True,
                      kv_admission="grow", device=device)
    )
    rng = np.random.default_rng(0)
    vocab = serving.model.cfg.vocab
    preamble = rng.integers(0, vocab, (8,), dtype=np.int32)
    for rid in range(6):
        plen = 12 if rid < 4 else 16  # the code prompts stream in chunks
        suffix = rng.integers(0, vocab, (plen - 8,), dtype=np.int32)
        serving.submit(Request(rid=rid,
                               tokens=np.concatenate([preamble, suffix]),
                               max_new_tokens=6,
                               family="chat" if rid < 4 else "code"))
    while serving.busy:
        serving.step()
    m = serving.metrics()
    print(f"served {m['requests']} requests ({m['output_tokens']} tokens) in "
          f"{m['decode_steps']} decode steps + {m['chunk_steps']} prefill "
          f"chunks; kv high-water {m['kv_page_hw_tokens']} of "
          f"{m['kv_slab_tokens']} slab tokens; {m['replans']} replans "
          f"{m['replan_modes']}")
    print(f"prefix sharing: hit rate {m['prefix_hit_rate']:.2f} "
          f"({m['kv_shared_maps']} pages mapped instead of prefilled), "
          f"kv compression {m['kv_compression']:.2f}x, "
          f"{m['kv_grow_allocs']} pages grown on write")

    # the fleet tier: two duplicate training jobs share one cluster — the
    # lease arbiter carves disjoint device blocks, both plan against
    # canonical lease views through ONE cache, so the second job's plan is
    # a cross-job cache hit (it never reaches the planner)
    from repro_torch.core.placement import ClusterSpec
    from repro_torch.fleet import FleetConfig, FleetScheduler, JobSpec
    from repro_torch.launch.fleet import first_serve_step_dt

    fleet = FleetScheduler(
        FleetConfig(cluster=ClusterSpec(n_devices=8, island_size=8,
                                        devices_per_host=2), device=device),
        [JobSpec(name="jobA", workload="multitask_clip", steps=3),
         JobSpec(name="jobB", workload="multitask_clip", steps=3)],
    )
    fm = fleet.run()
    print(f"fleet: {fm['n_jobs']} jobs on one cluster, makespan "
          f"{fm['makespan_s']*1e3:.0f} ms (virtual), "
          f"{fm['cross_job_hits']} cross-job plan-cache hits, "
          f"device idle {fm['device_idle_frac']:.0%}")

    # bubble co-location: every plan exposes its idle windows — per-device
    # gaps with the memory headroom the placement left unclaimed — and the
    # fleet's "colocate" policy slots a serving job's decode steps into
    # them instead of granting it devices
    tl = p.timeline()
    gangs = tl.gang_windows(k=2)
    widest = max(gangs, key=lambda g: g.duration)
    print(f"plan timeline: {len(tl.windows)} idle windows "
          f"({tl.idle_fraction():.0%} of device-time idle), "
          f"{len(gangs)} gang windows with >= 2 devices; widest "
          f"{widest.duration*1e3:.2f} ms across {widest.n_devices} devices")
    # (the tenant's first step, taken before it has a plan, is priced by
    # its planner: the reference's 1 ms constant outlasts every H100 window)
    co_jobs = [JobSpec(name="hostjob", workload="multitask_clip", steps=3),
               JobSpec(name="tenant", kind="serve", arch="qwen3-0.6b",
                       requests=2, prompt_len=8, gen_len=4, slots=2,
                       cache_len=32)]
    co_config = FleetConfig(cluster=ClusterSpec(n_devices=8, island_size=8,
                                                devices_per_host=2),
                            policy="colocate", device=device)
    co_config = dataclasses.replace(
        co_config, serve_fallback_dt=first_serve_step_dt(co_jobs[1], co_config))
    co = FleetScheduler(co_config, co_jobs)
    cm = co.run()
    tenant = co.jobs["tenant"]
    print(f"colocate: tenant decoded {tenant.colocated_steps} steps inside "
          f"{tenant.windows_seen} training idle windows "
          f"({cm['lease']['colocations']} binding, no lease of its own)")

    # hard-failure tolerance: async double-buffered snapshots keep the save
    # off the step turn, and a scripted host kill mid-run rolls the session
    # back to the last durable step, re-meshes over the survivors, and
    # replays the lost steps loss-exactly
    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.launch.faults import FaultInjector, FaultScript
    from repro_torch.runtime import tiny_multitask_clip
    from repro_torch.session import CheckpointCallbacks

    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as d:
        mgr = AsyncCheckpointManager(d, every=2, keep=3)
        faulty = SpindleSession(
            SessionConfig(cluster=ClusterSpec(n_devices=8, island_size=4,
                                              devices_per_host=2),
                          device=device),
            model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts)),
            tasks=("img_text", "audio_text", "audio_vision"),
            callbacks=[CheckpointCallbacks(mgr)],
            event_sources=[FaultInjector(
                4, schedule=[FaultScript(step=3, hosts=(1,))]
            )],
        ).bind()
        for _ in range(6):
            faulty.step()
        mgr.close()
    rec = [r for r in faulty.replans if r.mode == "restore"][0]
    print(f"crash recovery: host 1 killed at step 3 -> rolled back "
          f"{rec.rollback_steps} step(s) to durable step "
          f"{rec.restored_step}, re-meshed on "
          f"{len(faulty.cluster.healthy_devices())} devices, finished all "
          f"{faulty.step_count} steps "
          f"({mgr.saves_written} async snapshots written)")

    # qwen3-0.6b's reduced config: its family, shrunk in depth and width
    base = get_arch("qwen3-0.6b")
    print(f"base arch: {base.name} ({base.n_layers} layers, d "
          f"{base.d_model}, vocab {base.vocab}); training its reduced config")

    with tempfile.TemporaryDirectory(prefix="quickstart_train_") as d:
        out = train(
            "qwen3-0.6b",
            reduced_cfg=True,
            steps=300,
            batch=16,
            seq=128,
            lr=3e-3,
            ckpt_dir=d,
            ckpt_every=100,
            log_every=25,
            device=device,
        )
    h = out["history"]
    print("\nloss curve (every 25 steps):")
    for i in range(0, len(h), 25):
        bar = "#" * int((h[i] - 4.0) * 20)
        print(f"  step {i:4d}  {h[i]:.4f} {bar}")
    drop = (sum(h[:10]) - sum(h[-10:])) / 10
    print(f"\nloss drop over {len(h)} steps: {drop:.3f} "
          f"({h[0]:.3f} → {h[-1]:.3f})")
    if not drop > 0.05:
        raise SystemExit("quickstart should demonstrably learn")
    print("quickstart OK")


if __name__ == "__main__":
    main()
