"""The distributed WaveEngine and the distributed session on the port
against the JAX package, on the CPU.

The port's ranks come from one spawn of four ``gloo`` ranks on the CPU, one
torch thread each (``repro_torch.parallel.mesh.run_ranks``).  The JAX side
runs beside them in three subprocesses that force four host devices (the
engine cases in two, the session in one).  Eager JAX compiles every
operation of the distributed engine for each device group, which cost
over a minute for one model, so the subprocesses compile each step
closure whole (``jax.jit`` around the closures the JAX engine builds; its
placement, dispatch and gradient sums run as they are) and compile at a
lower XLA optimization level.  Params are the port's seeded init, handed
to JAX through ``repro_torch.bridge``; the batches are the port's demo
batches, given to both.  Both plan with the reference's hardware values
(``HardwareSpec(**asdict(V5E))``), so the plans are the same.

* ``WaveEngine(distributed=True)`` on clip and ofasys (3 tasks) planned
  for 4 devices, clip at batch 3 (no group size but 1 divides it: every
  step runs on its group's lowest rank) and clip planned for 8 devices run
  by 4 ranks (steps on devices 4-7 have no rank and run on rank 0): each
  rank's loss and every gradient within 1e-5 / 1e-4 of JAX's
  ``value_and_grad(reference_loss)`` and of JAX's
  ``WaveEngine(distributed=True)`` (``tests/test_engine_distributed.py``'s
  bounds), and both packages' plans equal;
* the distributed session of ``tests/test_engine_distributed.py:54`` on 4
  devices (2 a host): a straggler on host 1 at step 2 restores the
  snapshot of step 2, devices 2 and 3 leave the plan and the live mesh,
  ranks 2 and 3 run no step after it, every rank's history is the JAX
  session's within 1e-5, and the live ranks' params are bit-identical;
* a host killed under async snapshots: every rank rolls back to the
  writer's last durable snapshot and replays, equal to an uninterrupted
  run on the survivors within 1e-5;
* a detector event that only rank 0 sees replans every rank; a flagged
  host's recovery without a checkpoint grows the mesh back and broadcasts
  the state, after which all four ranks hold bit-identical params;
* a ``TaskCompleted`` rebinds the distributed engine, keeping its
  closures, and the engine still equals the reference;
* a plan that differs on one rank raises on every rank;
* ``launch.train.elastic_smoke``'s per-rank body (:func:`elastic_rank`)
  on 4 ranks and its checks.
"""

import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.train import check_elastic, elastic_rank
from repro_torch.parallel.mesh import run_ranks
from repro_torch.runtime import tiny_multitask_clip, tiny_ofasys
from repro_torch.runtime.moves import Piece, pieces, row_layout

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_engine_distributed.py:50-51
HIST_TOL = 1e-5  # tests/test_torch_faults.py: session histories
MAKERS = {"clip": tiny_multitask_clip, "ofasys": tiny_ofasys}
#: name: (model, maker kwargs, devices planned for)
CASES = {"clip": ("clip", {}, 4), "ofasys": ("ofasys", {}, 4),
         "clip_b3": ("clip", {"batch": 3}, 4),
         "clip_8dev": ("clip", {}, 8)}
ISLAND = 4
SESSION_CLUSTER = dict(n_devices=4, island_size=4, devices_per_host=2,
                       mem_bytes=1e13)
SESSION_TASKS = ("img_text", "audio_text")
SESSION_STEPS, STRAGGLER_AT = 5, 2


def _named(params):
    return {n: p.detach().numpy().copy() for n, p in params.named_parameters()}


def _inputs():
    from repro.core.costmodel import V5E  # here: the ranks import no JAX

    inp = {"cases": CASES, "island": ISLAND, "v5e": dataclasses.asdict(V5E),
           "params": {}, "batches": {}, "session_cluster": SESSION_CLUSTER,
           "session_tasks": SESSION_TASKS, "session_steps": SESSION_STEPS,
           "straggler_at": STRAGGLER_AT}
    for name, (mk, kw, _) in CASES.items():
        model, batches = MAKERS[mk](n_tasks=3, **kw)
        inp["params"][name] = _named(model.init(0, device="cpu"))
        inp["batches"][name] = {t: {k: v.numpy() for k, v in b.items()}
                                for t, b in batches.items()}
    model, batches = tiny_multitask_clip(n_tasks=len(SESSION_TASKS))
    inp["session_params"] = _named(model.init(0, device="cpu"))
    inp["session_batches"] = {t: {k: v.numpy() for k, v in b.items()}
                              for t, b in batches.items()}
    return inp


_JAX = r"""
import os, pickle, sys, tempfile
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np, torch
from repro.ckpt import CheckpointManager
from repro.core import ClusterSpec, plan
from repro.launch.events import ScriptedEventSource, StragglerDetected
from repro.parallel import mesh_over_devices
from repro.runtime import WaveEngine, tiny_multitask_clip, tiny_ofasys
from repro.session import CheckpointCallbacks, SessionConfig, SpindleSession
from repro_torch import bridge

# compile each step closure whole: the engine's own placement, dispatch
# and accumulation run unchanged around it
jitted = {}
def whole(make):
    def made(self, *a, **k):
        fn = make(self, *a, **k)
        if fn not in jitted:
            jitted[fn] = jax.jit(fn)
        return jitted[fn]
    return made
WaveEngine._make_entry_fn = whole(WaveEngine._make_entry_fn)
WaveEngine._make_mid_fn = whole(WaveEngine._make_mid_fn)

d, part = sys.argv[1], sys.argv[2]
inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
makers = {"clip": tiny_multitask_clip, "ofasys": tiny_ofasys}
to_jax = lambda named: jax.tree.map(jnp.asarray, bridge.mt_params_to_jax(
    {k: torch.from_numpy(v) for k, v in named.items()}))
jb = lambda b: {t: {k: jnp.asarray(v) for k, v in x.items()}
                for t, x in b.items()}
flat = lambda t: bridge.flatten_tree(jax.tree.map(np.asarray, t))
out = {"n_devices": jax.device_count()}
if part == "session":
    c = inp["session_cluster"]
    s = SpindleSession(
        SessionConfig(cluster=ClusterSpec(**c), straggler_shrink=True,
                      mesh=mesh_over_devices(range(c["n_devices"]))),
        model_factory=lambda tasks: tiny_multitask_clip(n_tasks=len(tasks)),
        tasks=inp["session_tasks"],
        callbacks=[CheckpointCallbacks(CheckpointManager(
            tempfile.mkdtemp(dir=d), every=0))],
        event_sources=[ScriptedEventSource(
            [StragglerDetected((1,))], fire_at=[inp["straggler_at"]])],
    ).bind()
    s.params = to_jax(inp["session_params"])
    s.batches = jb(inp["session_batches"])
    res = s.run(inp["session_steps"])
    rec = next(r for r in s.replans if r.mode == "restore")
    out["session"] = dict(
        history=res["history"], restored_step=rec.restored_step,
        distributed=s.engine.distributed,
        plan_devices=sorted({x for st in s.current_plan.steps
                             for x in st.devices}),
        mesh=sorted(dv.id for dv in s.mesh.devices.flat))
else:
    for name in part.split(","):
        mk, kw, nd = inp["cases"][name]
        model, _ = makers[mk](n_tasks=3, **kw)
        params, b = to_jax(inp["params"][name]), jb(inp["batches"][name])
        rl, rg = jax.jit(jax.value_and_grad(model.reference_loss))(params, b)
        p = plan(model.graph, ClusterSpec(n_devices=nd,
                                          island_size=inp["island"],
                                          mem_bytes=1e13))
        eng = WaveEngine(model, p, distributed=True)
        el, eg = eng.loss_and_grads(params, b)
        out[name] = dict(
            ref=(float(rl), flat(rg)), eng=(float(el), flat(eg)),
            plan=[(w, s.meta_id, tuple(s.op_ids), tuple(s.devices))
                  for w, st in sorted(p.waves().items()) for s in st])
pickle.dump(out, open(os.path.join(d, f"jax_{part}.pkl"), "wb"))
"""
JAX_PARTS = ("clip,ofasys", "clip_b3,clip_8dev", "session")


# ------------------------------------------------------------ the ranks


def _sha(params):
    return hashlib.sha256(b"".join(
        p.detach().numpy().tobytes() for p in params.parameters())
    ).hexdigest()


def _session(inp, hw, mesh, ckpt_dir=None, sources=(), cluster=None,
             tasks=None, n_tasks=None):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import ClusterSpec
    from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                     SpindleSession)

    cb = ([CheckpointCallbacks(CheckpointManager(ckpt_dir, every=0))]
          if ckpt_dir else [])
    return SpindleSession(
        SessionConfig(cluster=ClusterSpec(**(cluster or
                                             inp["session_cluster"])),
                      straggler_shrink=True, mesh=mesh, device="cpu", hw=hw),
        model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts)),
        tasks=tasks or inp["session_tasks"], callbacks=cb,
        event_sources=list(sources)).bind()


def _rank_engines(inp, hw, mesh):
    from repro_torch.core import ClusterSpec, plan
    from repro_torch.runtime import WaveEngine

    out = {}
    for name, (mk, kw, nd) in inp["cases"].items():
        model, _ = MAKERS[mk](n_tasks=3, **kw)
        params = model.init(0, device="cpu")
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(torch.from_numpy(inp["params"][name][n]))
        batches = {t: {k: torch.from_numpy(v) for k, v in b.items()}
                   for t, b in inp["batches"][name].items()}
        p = plan(model.graph, ClusterSpec(n_devices=nd,
                                          island_size=inp["island"],
                                          mem_bytes=1e13), hw=hw)
        eng = WaveEngine(model, p, distributed=True, mesh=mesh)
        loss, grads = eng.loss_and_grads(params, batches)
        out[name] = dict(
            loss=float(loss), grads={k: v.numpy() for k, v in grads.items()},
            ran=dict(eng.ran),
            plan=[(w, s.meta_id, tuple(s.op_ids), tuple(s.devices))
                  for w, st in sorted(p.waves().items()) for s in st])
    return out


def _rank_straggler(inp, hw, mesh, d):
    from repro_torch.launch.events import (ScriptedEventSource,
                                           StragglerDetected)

    s = _session(inp, hw, mesh, ckpt_dir=os.path.join(d, "session_ckpt"),
                 sources=[ScriptedEventSource([StragglerDetected((1,))],
                                              fire_at=[inp["straggler_at"]])])
    with torch.no_grad():
        for n, p in s.params.named_parameters():
            p.copy_(torch.from_numpy(inp["session_params"][n]))
    ran = []
    for _ in range(inp["session_steps"]):
        before = dict(s.engine.ran)
        s.step()
        ran.append(s.engine.ran["steps"] - before["steps"])
    rec = next(r for r in s.replans if r.mode == "restore")
    return dict(history=list(s.history), restored_step=rec.restored_step,
                distributed=s.engine.distributed, active=s.engine.active,
                plan_devices=sorted({x for st in s.current_plan.steps
                                     for x in st.devices}),
                mesh=sorted(s.mesh.mesh.flatten().tolist()),
                live=list(s.engine.live), ran=ran, sha=_sha(s.params))


def _rank_crash(inp, hw, mesh, d):
    """A host killed after step 3 under async snapshots every 2 steps: every
    rank rolls back to the writer's last durable snapshot and replays; the
    history equals an uninterrupted one-process run planned for the
    survivors (``launch.train.crash_smoke``'s contract)."""
    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.core import ClusterSpec
    from repro_torch.launch.faults import FaultInjector, FaultScript
    from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                     SpindleSession)

    cluster = ClusterSpec(**inp["session_cluster"])
    factory = lambda ts: tiny_multitask_clip(n_tasks=len(ts))  # noqa: E731
    ref = SpindleSession(
        SessionConfig(cluster=cluster.shrink((1,)), device="cpu", hw=hw),
        model_factory=factory, tasks=inp["session_tasks"]).bind()
    ref_hist = [ref.step() for _ in range(6)]
    mgr = AsyncCheckpointManager(os.path.join(d, "crash_ckpt"), every=2)
    s = SpindleSession(
        SessionConfig(cluster=cluster, device="cpu", hw=hw, mesh=mesh),
        model_factory=factory, tasks=inp["session_tasks"],
        callbacks=[CheckpointCallbacks(mgr)],
        event_sources=[FaultInjector(cluster.n_hosts, schedule=[
            FaultScript(step=3, hosts=(1,))])]).bind()
    s.run(6)
    mgr.close()
    rec = s.replans[-1]
    return dict(mode=rec.mode, restored_step=rec.restored_step,
                rollback_steps=rec.rollback_steps, live=list(s.engine.live),
                history=list(s.history), ref_history=ref_hist,
                sha=_sha(s.params))


def _rank_broadcast(rank, inp, hw, mesh):
    """Only rank 0's detector flags host 1 (its ring holds slow times for
    it); every rank replans.  Then the recovery, signalled on every rank
    without a checkpoint manager, grows the mesh back."""
    from repro_torch.ckpt import StragglerDetector
    from repro_torch.launch.events import (StragglerDetected,
                                           StragglerEventSource)

    det = StragglerDetector(n_hosts=4, min_samples=2)  # fed by rank
    if rank == 0:
        for _ in range(4):
            det.record(0, 0.01)
            det.record(1, 10.0)
    s = _session(inp, hw, mesh, sources=[StragglerEventSource(det)])
    s.step()
    out = dict(replans=[(r.mode, r.event.kind, r.event.hosts)
                        for r in s.replans],
               flagged=s.cluster.flagged_hosts, live=list(s.engine.live))
    s.step()
    s.event_sources = []
    s.signal(StragglerDetected(()))
    s.step()
    out.update(live_after=list(s.engine.live), history=list(s.history),
               sha=_sha(s.params))
    return out


def _rank_rebind(inp, hw, mesh):
    from repro_torch.launch.events import TaskCompleted

    s = _session(inp, hw, mesh, tasks=("img_text", "audio_text",
                                       "audio_vision"))
    s.run(2)
    engine = s.engine
    s.signal(TaskCompleted("audio_vision"))
    rec = s.replans[-1]
    ref_l, ref_g = s.model.reference_loss_and_grads(s.params, s.batches)
    loss, grads = s.engine.loss_and_grads(s.params, s.batches)
    s.step()
    return dict(same_engine=s.engine is engine,
                closures_cached=rec.closures_cached,
                model_rebuilt=rec.model_rebuilt, tasks=s.tasks,
                dloss=abs(float(loss) - float(ref_l)),
                dgrad=max(float((grads[n] - g).abs().max())
                          for n, g in ref_g.items()),
                history=list(s.history))


def _rank_mismatch(rank, inp, hw, mesh):
    from repro_torch.core import ClusterSpec, plan
    from repro_torch.runtime import WaveEngine

    model, _ = tiny_multitask_clip(n_tasks=3)
    nd = 8 if rank == 3 else 4
    p = plan(model.graph, ClusterSpec(n_devices=nd, island_size=4,
                                      mem_bytes=1e13), hw=hw)
    try:
        WaveEngine(model, p, distributed=True, mesh=mesh)
    except RuntimeError as e:
        return str(e)
    return None


def _rank_main(rank, d):
    from repro_torch.core.costmodel import HardwareSpec
    from repro_torch.parallel import mesh_over_devices

    torch.set_num_threads(1)
    inp = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
    hw = HardwareSpec(**inp["v5e"])
    mesh = mesh_over_devices(range(4), device="cpu")
    return {
        "engines": _rank_engines(inp, hw, mesh),
        "straggler": _rank_straggler(inp, hw, mesh, d),
        "crash": _rank_crash(inp, hw, mesh, d),
        "broadcast": _rank_broadcast(rank, inp, hw, mesh),
        "rebind": _rank_rebind(inp, hw, mesh),
        "mismatch": _rank_mismatch(rank, inp, hw, mesh),
        "elastic": elastic_rank(rank, 8, 3, (1,),
                                os.path.join(d, "elastic_ckpt"), "cpu",
                                verbose=False),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("engine_distributed"))
    inp = _inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, d, part],
                              env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for part in JAX_PARTS]
    try:
        ranks = run_ranks(_rank_main, 4, "cpu", args=(d,))
    finally:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    jax_out = {}
    for p, err, part in zip(procs, errs, JAX_PARTS):
        assert p.returncode == 0, f"{part}: {err[-3000:]}"
        with open(os.path.join(d, f"jax_{part}.pkl"), "rb") as f:
            jax_out.update(pickle.load(f))
    return dict(inp=inp, ranks=ranks, jax=jax_out)


def _grad_err(got, want):
    assert set(got) == set(want)
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["ref", "eng"])
def test_engine_matches_jax(runs, name, against):
    """Every rank's loss and gradients equal JAX's reference (``ref``) and
    JAX's ``WaveEngine(distributed=True)`` (``eng``) on the same plan."""
    assert runs["jax"]["n_devices"] == 4
    want_loss, want_grads = runs["jax"][name][against]
    for r in runs["ranks"]:
        got = r["engines"][name]
        assert abs(got["loss"] - want_loss) < LOSS_TOL, (name, got["loss"])
        assert _grad_err(got["grads"], want_grads) < GRAD_TOL, name


@pytest.mark.parametrize("name", list(CASES))
def test_plans_equal_jax(runs, name):
    for r in runs["ranks"]:
        assert r["engines"][name]["plan"] == runs["jax"][name]["plan"]


def test_groups_spread_the_steps(runs):
    """On the 4-device clip plan every rank runs a part of some step; at
    batch 3 only the groups' lowest ranks run; on the 8-device plan rank 0
    also runs the steps whose devices have no rank."""
    ran = {n: [r["engines"][n]["ran"]["steps"] for r in runs["ranks"]]
           for n in CASES}
    assert all(k > 0 for k in ran["clip"]), ran
    assert ran["clip_b3"][1] == ran["clip_b3"][3] == 0, ran
    assert ran["clip_8dev"][0] > ran["clip_8dev"][1], ran


def test_row_layout_and_pieces():
    """Each task's rows split contiguously when the group size divides
    every task's batch, else (or for a contrastive join) all on the
    lowest rank; pieces carry a consumer's rows from whichever ranks hold
    them, in row order."""
    sizes = {"a": 4, "b": 4}
    split = row_layout((2, 3), sizes, whole=False)
    assert split == {2: [("a", 0, 2), ("b", 0, 2)],
                     3: [("a", 2, 4), ("b", 2, 4)]}
    assert row_layout((2, 3), {"a": 3}, whole=False) == {2: [("a", 0, 3)]}
    assert row_layout((1, 0), sizes, whole=True) == {0: [("a", 0, 4),
                                                         ("b", 0, 4)]}
    # rank 0 needs all of task b: rows 0-1 from rank 2's local rows 2-3,
    # rows 2-3 from rank 3's
    assert pieces(split, 0, [("b", 0, 4)]) == [Piece(2, 0, 2, 4, 0, 2),
                                                Piece(3, 0, 2, 4, 2, 4)]
    quarter = row_layout((0, 1, 2, 3), {"a": 4}, whole=False)
    assert pieces(quarter, 3, [("a", 1, 3)]) == [Piece(1, 3, 0, 1, 0, 1),
                                                  Piece(2, 3, 0, 1, 1, 2)]
    with pytest.raises(ValueError, match="not held whole"):
        pieces({0: [("a", 0, 2)]}, 1, [("a", 0, 4)])


def test_mismatched_plans_raise_on_every_rank(runs):
    for r in runs["ranks"]:
        assert r["mismatch"] and "different plans" in r["mismatch"]


# ----------------------------------------------------------- the session


def test_session_straggler_restore_matches_jax(runs):
    """``tests/test_engine_distributed.py:54`` on 4 devices: the restore
    of step 2, host 1's devices out of the plan and the live mesh, no step
    on ranks 2 and 3 after it, and the JAX session's history."""
    ref = runs["jax"]["session"]
    assert ref["distributed"] and ref["restored_step"] == STRAGGLER_AT
    for i, r in enumerate(runs["ranks"]):
        got = r["straggler"]
        assert got["distributed"] and got["restored_step"] == STRAGGLER_AT
        assert not set(got["plan_devices"]) & {2, 3}
        assert got["mesh"] == got["live"] == ref["mesh"] == [0, 1]
        assert got["active"] == (i < 2)
        after = got["ran"][STRAGGLER_AT + 1:]
        assert (all(k > 0 for k in after) if i < 2
                else not any(after)), got["ran"]
        assert len(got["history"]) == SESSION_STEPS
        np.testing.assert_allclose(got["history"], ref["history"],
                                   atol=HIST_TOL)
    hists = [r["straggler"]["history"] for r in runs["ranks"]]
    assert all(h == hists[0] for h in hists)


def test_host_kill_rolls_back_every_rank(runs):
    for r in runs["ranks"]:
        got = r["crash"]
        assert got["mode"] == "restore" and got["rollback_steps"] >= 1
        assert got["restored_step"] < 3 and got["live"] == [0, 1]
        np.testing.assert_allclose(got["history"], got["ref_history"],
                                   atol=HIST_TOL)
    assert runs["ranks"][0]["crash"]["sha"] == runs["ranks"][1]["crash"]["sha"]


def test_live_replicas_stay_bit_identical(runs):
    shas = [r["straggler"]["sha"] for r in runs["ranks"]]
    assert shas[0] == shas[1]
    # after a recovery without a checkpoint the state is broadcast to the
    # returning ranks: all four agree after one more step
    shas = [r["broadcast"]["sha"] for r in runs["ranks"]]
    assert len(set(shas)) == 1


def test_rank0_detector_event_replans_every_rank(runs):
    for r in runs["ranks"]:
        got = r["broadcast"]
        assert got["replans"][0][1:] == ("straggler", (1,)), got["replans"]
        assert got["flagged"] == (1,) and got["live"] == [0, 1]
        assert got["live_after"] == [0, 1, 2, 3]
    hists = [r["broadcast"]["history"] for r in runs["ranks"]]
    assert all(h == hists[0] for h in hists)


def test_task_completed_rebinds_the_distributed_engine(runs):
    for r in runs["ranks"]:
        got = r["rebind"]
        assert got["same_engine"] and got["model_rebuilt"]
        assert got["closures_cached"] > 0
        assert got["tasks"] == ("img_text", "audio_text")
        assert got["dloss"] < LOSS_TOL and got["dgrad"] < GRAD_TOL
    hists = [r["rebind"]["history"] for r in runs["ranks"]]
    assert all(h == hists[0] for h in hists) and len(hists[0]) == 3


def test_elastic_smoke_rank_body(runs):
    out = check_elastic([r["elastic"] for r in runs["ranks"]], (1,), 3)
    assert out["live"] == [0, 1] and out["steps"] == 8
    assert [m for m, _, _ in out["replans"]] == ["restore"]
    assert out["replans"][0][2] == 3
    assert all(np.isfinite(out["history"]))
