"""The paper's core scenario on the PyTorch port: plan + execute MT MM
training wave by wave (the counterpart of ``wavefront_mt_training.py``).

A thin demo shell over :class:`repro_torch.session.SpindleSession`.  Builds
a small Multitask-CLIP-style model (3 tasks, shared towers); the session
plans it through the PlanCache, binds a WaveEngine and trains wave by
wave on the GPU (``--device cpu`` for the plain CPU run).  Then a task
completes mid-run via ``session.signal(TaskCompleted)`` — the §5.5 re-plan
hook — the plan is regenerated through the cache, the engine rebinds
without rebuilding unchanged step closures, and training continues.  The
engine's loss and gradients are held against autograd of the
single-program ``reference_loss`` before AND after the shift.

    PYTHONPATH=src python examples/wavefront_mt_training_torch.py
    PYTHONPATH=src python examples/wavefront_mt_training_torch.py --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import ClusterSpec, simulate_plan, simulate_sequential
from repro_torch.launch.events import TaskCompleted
from repro_torch.runtime import tiny_multitask_clip
from repro_torch.session import SessionCallbacks, SessionConfig, SpindleSession

TASKS = ("img_text", "audio_text", "audio_vision")
#: engine vs reference: the same fp32 arithmetic in another order
TOL = 1e-5


def describe_plan(p) -> None:
    mg = p.meta_graph
    print(f"  MetaOps: {len(mg.meta_ops)}  levels: {len(mg.levels())}  "
          f"waves: {len(p.waves())}  makespan: {p.makespan*1e3:.2f} ms "
          f"(C̃* {p.c_star_total*1e3:.2f} ms)")
    for widx, steps in sorted(p.waves().items()):
        names = ", ".join(
            f"{mg.meta_ops[s.meta_id].name}[{len(s.op_ids)}]×{len(s.devices)}d"
            for s in steps
        )
        print(f"  wave {widx}: {names}")


class DemoObserver(SessionCallbacks):
    """Observe the lifecycle: new plans and replans print as they happen."""

    def on_plan(self, session, plan):
        describe_plan(plan)

    def on_replan(self, session, event, old_plan, new_plan, info):
        print(f"  re-plan on {event.kind}({event.task}): {info.mode} "
              f"({info.planning_seconds*1e3:.1f} ms planner, "
              f"{info.closures_cached} engine closures kept)")


def verify_engine(session) -> None:
    """Numerical contract: engine ≡ autograd of reference_loss."""
    dev = next(session.params.parameters()).device
    batches = {t: {k: v.to(dev) for k, v in b.items()}
               for t, b in session.batches.items()}
    ref_l, ref_g = session.model.reference_loss_and_grads(session.params,
                                                          batches)
    loss, grads = session.engine.loss_and_grads(session.params, batches)
    dl = abs(float(loss) - float(ref_l))
    dg = max(float((grads[n] - g).abs().max()) for n, g in ref_g.items())
    if not (dl <= TOL and dg <= TOL):
        raise SystemExit(f"engine != reference: loss Δ={dl:.2e}, max grad "
                         f"Δ={dg:.2e} (tolerance {TOL})")
    print(f"  engine == reference: loss Δ={dl:.2e}, max grad Δ={dg:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 as on the CPU
    cluster = ClusterSpec(n_devices=8, island_size=4, mem_bytes=80e9)
    session = SpindleSession(
        SessionConfig(cluster=cluster, device=args.device),
        model_factory=lambda tasks: tiny_multitask_clip(n_tasks=len(tasks)),
        tasks=TASKS,
        callbacks=[DemoObserver()],
    )

    print("== Spindle plan (3 tasks) ==")
    session.bind()
    p = session.current_plan
    seq = simulate_sequential(session.model.graph, cluster)
    sp = simulate_plan(p, cluster)
    print("  analytic speedup vs sequential: "
          f"{seq.makespan / sp.makespan:.2f}x  "
          f"(utilization {seq.avg_flops_utilization:.2f} → "
          f"{sp.avg_flops_utilization:.2f})")

    print(f"\n== WaveEngine training on {args.device} (session.step) ==")
    verify_engine(session)
    for step in range(6):
        print(f"  step {step}: loss {session.step():.4f}")

    print("\n== dynamicity: task 'audio_vision' completes → "
          "session.signal re-plans ==")
    session.signal(TaskCompleted("audio_vision"))
    # shared tower parameters carried over automatically (same instances)
    verify_engine(session)
    for step in range(3):
        print(f"  step {step}: loss {session.step():.4f}")
    print(f"  cache: {session.cache.stats.as_dict()}")
    print("wavefront MT training OK")


if __name__ == "__main__":
    main()
