"""The port's plan-only ``SpindleSession`` against the JAX one.

Both sessions are driven through the same script of plan calls, events and
leases (``tests/test_session.py:284,401,458``); after every turn they must
agree on what was returned (no-op or a plan, compared by ``to_json``
without ``planning_seconds``), on the live cluster, and on the replan
records (mode, headline event and the coalesced events).  Both are built
with the reference's hardware and cluster values, so the plans must be
equal to the last bit.
"""

import dataclasses
import json

import pytest
import torch

import repro.launch.events as jax_events
import repro.session as jax_session
from repro.core.costmodel import V5E
from repro.core.placement import ClusterSpec as JaxClusterSpec
from repro.core.workloads import multitask_clip as jax_multitask_clip

import repro_torch.launch.events as events
import repro_torch.session as session
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.placement import ClusterSpec
from repro_torch.core.workloads import multitask_clip

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


CLUSTER = dict(n_devices=16, island_size=8, mem_bytes=96e9,
               devices_per_host=4)
PACKAGES = {
    "jax": (jax_session, jax_events, JaxClusterSpec, V5E, jax_multitask_clip),
    "port": (session, events, ClusterSpec,
             HardwareSpec(**dataclasses.asdict(V5E)), multitask_clip),
}


def _plan_json(p):
    if p is None:
        return None
    d = json.loads(p.to_json())
    d.pop("planning_seconds")
    return d


def _event(e):
    return type(e).__name__, e.kind, dataclasses.asdict(e)


class _Count:
    def __init__(self):
        self.plans = 0
        self.replans = []

    def on_plan(self, sess, plan):
        self.plans += 1

    def on_replan(self, sess, event, old, new, info):
        self.replans.append((_event(event), old is None, info.mode))


def _drive(pkg, script, *, factory=False, tasks=None, **config):
    """Run ``script`` on one package's session: each item is "plan",
    ("lease", cluster kwargs), ("burst", [events]) or one event
    (class name, args); returns what every turn gave and the records."""
    sess_mod, ev_mod, cluster_cls, hw, mtc = PACKAGES[pkg]
    cfg = sess_mod.SessionConfig(cluster=cluster_cls(**CLUSTER), hw=hw,
                                 **config)
    counter = _Count()
    kw = dict(callbacks=[counter])
    if factory:
        kw.update(graph_factory=lambda t: mtc(len(t)), tasks=tasks)
    s = sess_mod.SpindleSession(cfg, **kw)

    def ev(name, *args):
        if name == "LeaseChanged":
            return ev_mod.LeaseChanged(cluster=cluster_cls(**args[0]))
        return getattr(ev_mod, name)(*args)

    out = []
    for item in script:
        if item == "plan":
            got = _plan_json(s.plan())
        elif item[0] == "lease":
            rec = s.apply_lease(cluster_cls(**item[1]))
            got = None if rec is None else rec.mode
        elif item[0] == "burst":
            got = _plan_json(s.signal_all([ev(*e) for e in item[1]]))
        else:
            got = _plan_json(s.signal(ev(*item)))
        out.append((got, dataclasses.asdict(s.cluster), s.tasks))
    records = [(r.mode, r.plan_mode, _event(r.event),
                [_event(e) for e in r.events]) for r in s.replans]
    return out, records, (counter.plans, counter.replans), s


def _both(script, **kw):
    jax_run = _drive("jax", script, **kw)
    port_run = _drive("port", script, **kw)
    assert port_run[:3] == jax_run[:3]
    return port_run


def test_named_workload_straggler_and_host_events():
    """tests/test_session.py:401 plus the cluster events: a named workload
    plans once and hits on the re-plan; task events are no-ops without
    tracked membership; stragglers shrink the cluster, duplicates are
    no-ops, host failures evict, recoveries restore."""
    script = ["plan", "plan", ("TaskArrived", "x"), ("TaskCompleted", "x"),
              ("StragglerDetected", (1,)), ("StragglerDetected", (1,)),
              ("HostFailed", (0,)), ("StragglerDetected", ()),
              ("HostFailed", ()), ("HostFailed", (0, 1, 2, 3))]
    out, records, _, sess = _both(script, workload="multitask_clip",
                                  straggler_shrink=True)
    assert out[0][0] == out[1][0] and out[2][0] is None and out[3][0] is None
    assert [o[1]["flagged_hosts"] for o in out[4:]] == [
        (1,), (1,), (0, 1), (0,), (), ()]
    assert out[5][0] is None  # a duplicate straggler event
    assert [r[2][1] for r in records] == ["straggler", "host_failed",
                                          "straggler", "host_failed"]
    assert records[-1][0] == "hit"  # the full cluster's plan again
    assert out[-1][0] is None  # never evict the whole cluster
    assert sess.cluster == sess.config.cluster


def test_graph_factory_signals_and_duplicate_noops():
    """tests/test_session.py:458 and :284 on a plan-only session: a task
    arrival replans, its completion is an exact hit on the way back,
    duplicate arrivals and absent completions are no-ops."""
    script = ["plan", ("TaskArrived", "t3"), ("TaskCompleted", "t3"),
              ("TaskArrived", "t0"), ("TaskCompleted", "nonexistent")]
    out, records, callbacks, sess = _both(script, factory=True,
                                          tasks=("t0", "t1", "t2"))
    assert out[1][0] != out[0][0] and out[2][0] == out[0][0]
    assert out[3][0] is None and out[4][0] is None
    assert [r[0] for r in records] == ["incremental", "hit"]
    assert callbacks[0] == 3 and len(callbacks[1]) == 2
    assert sess.tasks == ("t0", "t1", "t2")


def test_signal_all_burst_coalesces_into_one_replan():
    script = ["plan", ("burst", [("TaskArrived", "t3"), ("TaskArrived", "t4"),
                                 ("TaskArrived", "t3"),
                                 ("TaskCompleted", "t0")])]
    out, records, _, sess = _both(script, factory=True,
                                  tasks=("t0", "t1", "t2"))
    assert len(records) == 1 and len(records[0][3]) == 3
    assert sess.tasks == ("t1", "t2", "t3", "t4")
    assert sess.cache.stats.lookups == 2  # no intermediate set planned


def test_apply_lease_adopts_then_replans():
    """First lease: adopted silently and planned over; the same view again
    is a no-op; a new view replans through one LeaseChanged turn."""
    half = dict(n_devices=8, island_size=8, mem_bytes=96e9)
    other = dict(n_devices=8, island_size=4, mem_bytes=96e9)
    script = [("lease", half), ("lease", half), ("lease", other),
              ("LeaseChanged", other), ("StragglerDetected", (1,))]
    out, records, _, sess = _both(script, factory=True, tasks=("t0", "t1"),
                                  straggler_shrink=True)
    assert out[0][0] is None and out[0][1]["n_devices"] == 8
    assert out[1][0] is None and out[2][0] is not None and out[3][0] is None
    assert [r[2][1] for r in records] == ["lease_changed", "straggler"]
    assert out[-1][1]["flagged_hosts"] == (1,)  # shrunk within the lease
    assert sess.cluster.n_devices == 8


def test_failed_replan_rolls_back_session_state():
    for pkg in PACKAGES:
        sess_mod, ev_mod, cluster_cls, hw, mtc = PACKAGES[pkg]
        s = sess_mod.SpindleSession(
            sess_mod.SessionConfig(cluster=cluster_cls(**CLUSTER), hw=hw),
            graph_factory=lambda t: mtc(len(t)), tasks=("t0",))
        p0 = s.plan()
        with pytest.raises(Exception):
            s.signal(ev_mod.TaskCompleted("t0"))  # 0-task workload: invalid
        assert s.tasks == ("t0",) and s.current_plan is p0 and not s.replans


def test_elastic_smoke_cli_passes_its_options(monkeypatch):
    """The elastic smoke's CLI hands ``--steps``, ``--straggler-at``,
    ``--straggler-hosts``, ``--ranks``, ``--ckpt-dir`` and ``--device`` to
    ``elastic_smoke`` (whose run on four ranks is
    ``tests/test_torch_engine_distributed.py``'s)."""
    from repro_torch.launch import train as train_mod

    calls = []
    monkeypatch.setattr(train_mod, "elastic_smoke",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr("sys.argv", [
        "train", "--elastic-smoke", "--steps", "8", "--straggler-at", "3",
        "--straggler-hosts", "1,2", "--ranks", "4", "--device", "cpu"])
    train_mod.main()
    assert calls == [dict(steps=8, straggler_at=3, straggler_hosts=(1, 2),
                          ckpt_dir=None, ranks=4, device="cpu")]


def test_compress_grads_without_a_mesh_trains_as_without():
    """int8-compressed gradients without a mesh train as without them
    (JAX's ``train`` compresses only under a mesh with a "data" axis)."""
    from repro_torch.launch import train as train_mod

    kw = dict(steps=1, batch=2, seq=32, device="cpu", verbose=False)
    assert (train_mod.train(compress_grads=True, **kw)["history"]
            == train_mod.train(**kw)["history"])


def test_bare_placement_is_no_restore_target():
    """A bare placement is no target of ``restore_to_mesh`` (a
    ``(DeviceMesh, placements)`` pair is)."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.ckpt import restore_to_mesh

    with pytest.raises(TypeError, match="DeviceMesh, placements"):
        restore_to_mesh({"w": torch.ones(2)}, Replicate())


def test_checkpointed_straggler_restores(tmp_path):
    """A cluster-changing event on a bound session that carries a
    checkpoint manager snapshots and restores, as the JAX session does.
    The plan-only path still works."""
    from repro_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), every=0)  # periodic saves off
    s = _bound(callbacks=[session.CheckpointCallbacks(mgr)],
               config={"straggler_shrink": True,
                       "cluster": ClusterSpec(n_devices=8, island_size=4,
                                              devices_per_host=1,
                                              mem_bytes=96e9)})
    s.step()
    s.signal(events.StragglerDetected((6,)))
    rec = s.replans[-1]
    assert rec.mode == "restore" and rec.restored_step == 0
    assert s.cluster.flagged_hosts == (6,) and len(s.replans) == 1
    assert session.SpindleSession(
        session.SessionConfig(workload="qwen_val")).plan().steps
    with pytest.raises(ValueError, match="no workload"):
        session.SpindleSession().plan()


def test_event_taxonomy_matches_jax():
    assert events.EVENT_KINDS == jax_events.EVENT_KINDS
    for name in ("TaskArrived", "TaskCompleted", "StragglerDetected",
                 "HostFailed", "RequestArrived", "RequestCompleted",
                 "LeaseChanged", "JobArrived", "JobFinished"):
        ours, ref = getattr(events, name), getattr(jax_events, name)
        assert ours.kind == ref.kind
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(ref)]
    src = events.ScriptedEventSource(
        [events.TaskArrived("a"), events.TaskArrived("b")], fire_at=[1, 3])
    assert isinstance(src, events.EventSource)
    assert [src.poll() for _ in range(4)] == [
        [], [events.TaskArrived("a")], [], [events.TaskArrived("b")]]
    with pytest.raises(ValueError):
        events.ScriptedEventSource([events.TaskArrived("a")], fire_at=[])


def test_poll_drains_sources_into_one_replan():
    s = session.SpindleSession(
        session.SessionConfig(cluster=ClusterSpec(**CLUSTER)),
        graph_factory=lambda t: multitask_clip(len(t)), tasks=("t0", "t1"),
        event_sources=[events.ScriptedEventSource(
            [events.TaskArrived("t2"), events.TaskCompleted("t0")],
            fire_at=[0, 0])])
    s.plan()
    assert len(s.poll()) == 2 and len(s.replans) == 1
    assert s.poll() == [] and s.tasks == ("t1", "t2")


# --------------------------------------------------------------------------
# Bound sessions (tests/test_session.py:54,85,129,155,433): the wave engine
# under the session, on the CPU, against the reference and the JAX session
# --------------------------------------------------------------------------

TASKS = ("img_text", "audio_text", "audio_vision")
BOUND_CLUSTER = dict(n_devices=8, island_size=4, mem_bytes=96e9)


def _bound(callbacks=(), event_sources=(), config=None):
    from repro_torch.runtime import tiny_multitask_clip

    cfg = {"cluster": ClusterSpec(**BOUND_CLUSTER), "device": "cpu",
           **(config or {})}
    return session.SpindleSession(
        session.SessionConfig(**cfg),
        model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts)),
        tasks=TASKS, callbacks=list(callbacks),
        event_sources=list(event_sources)).bind()


def _reference_delta(sess):
    """Engine vs single-program reference on the session's current state."""
    ref_l, ref_g = sess.model.reference_loss_and_grads(sess.params,
                                                       sess.batches)
    loss, grads = sess.engine.loss_and_grads(sess.params, sess.batches)
    dg = max(float((grads[n] - g).abs().max()) for n, g in ref_g.items())
    return abs(float(loss) - float(ref_l)), dg


def test_task_completed_rebinds_and_matches_reference_and_jax():
    """A mid-run TaskCompleted rebuilds the model, replans and rebinds the
    engine with its closures kept; engine == reference (1e-6) before and
    after; and the loss history equals the JAX session's on the same
    (bridged) params and batches (1e-5)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.runtime import tiny_multitask_clip as jax_tiny_clip
    from repro_torch import bridge

    sess = _bound()
    jsess = jax_session.SpindleSession(
        jax_session.SessionConfig(cluster=JaxClusterSpec(**BOUND_CLUSTER)),
        model_factory=lambda ts: jax_tiny_clip(n_tasks=len(ts)),
        tasks=TASKS).bind()
    # the JAX step runs jitted, one trace per plan and optimizer (eager JAX
    # compiles every op: its steps took ~70 s here); the session's wave
    # callbacks fire after the step, in wave order, as the eager engine
    # fires them after each forward wave
    engine, eager_step, traced = jsess.engine, jsess.engine.train_step, {}

    def jitted_step(params, opt_state, batches, optimizer, on_wave=None):
        key = (id(engine.plan), id(optimizer))
        if key not in traced:
            traced[key] = (engine.plan, optimizer, jax.jit(
                lambda p, o, b: eager_step(p, o, b, optimizer)))
        out = traced[key][2](params, opt_state, batches)
        if on_wave is not None:
            waves = engine.plan.waves()
            for widx in sorted(waves):
                on_wave(widx, waves[widx])
        return out

    engine.train_step = jitted_step
    bridge.load_mt_params(sess.params,
                          jax.tree.map(np.asarray, jsess.params))

    def same_batches():
        jsess.batches = {t: {k: jnp.asarray(v.numpy()) for k, v in b.items()}
                         for t, b in sess.batches.items()}

    same_batches()
    dl, dg = _reference_delta(sess)
    assert dl < 1e-6 and dg < 1e-6  # contract before the shift
    sess.run(steps=2)
    jsess.run(steps=2)
    n_closures = len(sess.engine._fn_cache)
    p = sess.signal(events.TaskCompleted("audio_vision"))
    jsess.signal(jax_events.TaskCompleted("audio_vision"))
    same_batches()
    assert p is sess.current_plan and sess.tasks == ("img_text", "audio_text")
    rec = sess.replans[-1]
    assert rec.model_rebuilt and rec.closures_cached == n_closures
    assert len(sess.model.flows) == 2
    dl, dg = _reference_delta(sess)
    assert dl < 1e-6 and dg < 1e-6
    sess.run(steps=2)
    jsess.run(steps=2)
    dl, dg = _reference_delta(sess)
    assert dl < 1e-6 and dg < 1e-6
    assert np.max(np.abs(np.asarray(sess.history)
                         - np.asarray(jsess.history))) < 1e-5
    assert sess.history[-1] < sess.history[0]
    assert len(traced) == 2  # the JAX engine stepped on both plans


def test_bound_cache_hit_replan_vs_full_replan():
    sess = _bound()
    sess.step()
    assert sess.cache.stats.misses == 1  # the initial plan
    sess.signal(events.TaskCompleted("audio_vision"))
    assert sess.replans[-1].mode in ("full", "incremental", "fallback")
    sess.signal(events.TaskArrived("audio_vision"))
    hits = sess.cache.stats.hits
    sess.signal(events.TaskCompleted("audio_vision"))
    assert sess.replans[-1].mode == "hit"
    assert sess.cache.stats.hits == hits + 1
    sess.step()  # still executable after the cached rebind
    dl, dg = _reference_delta(sess)
    assert dl < 1e-6 and dg < 1e-6


class _Recorder(session.SessionCallbacks):
    def __init__(self):
        self.log = []

    def on_plan(self, sess, plan):
        self.log.append(("plan", plan.planner))

    def on_wave(self, sess, wave_index, steps):
        self.log.append(("wave", wave_index))

    def on_replan(self, sess, event, old_plan, new_plan, info):
        self.log.append(("replan", event.kind, info.mode))

    def on_step_end(self, sess, step, loss, dt):
        self.log.append(("step_end", step))


def test_bound_callback_firing_order():
    rec = _Recorder()
    sess = _bound(callbacks=[rec])
    assert rec.log[0] == ("plan", "spindle")  # bind planned before stepping
    sess.step()
    kinds = [e[0] for e in rec.log]
    assert kinds.count("wave") == len(sess.current_plan.waves())
    assert kinds[-1] == "step_end" and rec.log[-1] == ("step_end", 0)
    assert kinds.index("wave") > kinds.index("plan")
    rec.log.clear()
    sess.signal(events.TaskCompleted("audio_vision"))
    assert [e[0] for e in rec.log] == ["plan", "replan"]
    assert rec.log[1][1] == "task_completed"


def test_on_wave_windows_reach_callbacks_that_ask():
    seen = []

    class Windows(session.SessionCallbacks):
        def on_wave(self, sess, wave_index, steps, windows=None):
            seen.append(windows)

    sess = _bound(callbacks=[Windows()])
    sess.step()
    assert len(seen) == len(sess.current_plan.waves())
    assert all(w is None or isinstance(w, list) for w in seen)


def test_bound_event_source_polled_and_straggler_replans():
    from repro_torch.ckpt.straggler import StragglerDetector, TimingCollector

    rec = _Recorder()
    src = events.ScriptedEventSource([events.StragglerDetected((3,))])
    sess = _bound(callbacks=[rec], event_sources=[src])
    sess.step()
    assert not src.events  # drained by the step's poll
    assert [e for e in rec.log if e[0] == "replan"] == [
        ("replan", "straggler", "hit")]  # same workload → hit
    # a detector fed by the session's own step times, skewed in-process
    det = StragglerDetector(n_hosts=4, min_samples=2)
    strag = events.StragglerEventSource(
        det, collector=TimingCollector(n_hosts=4, skew={3: 3.0}))
    sess = _bound(event_sources=[strag], config={
        "straggler_shrink": True,
        "cluster": ClusterSpec(n_devices=8, island_size=4, devices_per_host=2,
                               mem_bytes=96e9)})
    sess.run(2)
    assert [r.event.hosts for r in sess.replans] == [(3,)]
    assert sess.cluster.n_healthy == 6  # host 3's two devices evicted


def test_failed_bind_rolls_back():
    """bind() of a broken model must leave the previous binding intact."""
    sess = _bound()
    model_a, params_a, state_a = sess.model, sess.params, sess.opt_state

    class NotAModel:
        pass

    with pytest.raises(AttributeError):
        sess.bind(NotAModel())
    assert sess.model is model_a and sess.engine.model is model_a
    assert sess.params is params_a and sess.opt_state is state_a
    assert sess.tasks == TASKS
    sess.step()  # previous binding still fully usable


def test_bound_session_without_factory_rejects_task_shifts():
    from repro_torch.runtime import tiny_multitask_clip

    model, batches = tiny_multitask_clip(n_tasks=3)
    sess = session.SpindleSession(
        session.SessionConfig(cluster=ClusterSpec(**BOUND_CLUSTER),
                              device="cpu"),
        model=model, batches=batches)
    assert sess.tasks == TASKS
    with pytest.raises(RuntimeError, match="model_factory"):
        sess.signal(events.TaskCompleted("audio_vision"))
    model2, batches2 = tiny_multitask_clip(n_tasks=2)
    sess.batches = batches2
    sess.bind(model2)
    assert sess.tasks == ("img_text", "audio_text")
    sess.step()


def test_bound_session_batch_fn_and_device_policy(monkeypatch):
    import torch

    from repro_torch.runtime import tiny_ofasys

    model, batches = tiny_ofasys()
    seen = []

    def batch_fn(step):
        seen.append(step)
        return batches

    sess = session.SpindleSession(
        session.SessionConfig(cluster=ClusterSpec(**BOUND_CLUSTER),
                              device="cpu"),
        model=model, batch_fn=batch_fn)
    out = sess.run(3)
    assert seen == [0, 1, 2] and out["steps"] == 3
    assert session.SessionConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        session.SpindleSession(model=tiny_ofasys()[0])
