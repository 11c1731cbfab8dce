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


def test_bound_paths_raise_naming_the_training_item():
    s = session.SpindleSession(session.SessionConfig(workload="qwen_val"))
    for call in (s.bind, s.step, lambda: s.run(1)):
        with pytest.raises(NotImplementedError, match="queue 1, item 3"):
            call()
    assert s.plan().steps  # the plan-only path still works
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
