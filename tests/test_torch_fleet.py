"""The port's fleet (``repro_torch/fleet``, ``launch/fleet.py``) against the
JAX package's.

The lease arbiter is plain Python on both sides: a random sequence of
operations must leave both packages' arbiters in equal states after every
step.  The cases of ``tests/test_fleet.py`` and ``tests/test_faults.py``'s
``TestLeaseRevocation`` run on both packages.  End to end, the fleets'
clock is made of plans, so both are built with the reference's hardware
spec (``HardwareSpec(**dataclasses.asdict(V5E))``) and cluster values, the
reference's mixes and one reduced qwen3 (the port's bridged from the JAX
fleet's params); then every ``metrics()`` entry, every job
summary, every fleet event, every callback (admissions, steps with their
virtual seconds, rebalances with the leases handed out, finishes) and
every served token must be equal.  The port's serve jobs run on the CPU
here, through the kernels' plain versions.
"""

import dataclasses
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.fleet as jfleet
import repro.launch.events as jevents
import repro.launch.faults as jfaults
import repro.launch.fleet as jlaunch
from repro.core.costmodel import V5E
from repro.core.placement import ClusterSpec as JaxClusterSpec
from repro.core.plancache import PlanCache as JaxPlanCache
from repro.core.plancache import _cluster_key as jax_cluster_key
from repro.core.plancache import workload_signature as jax_signature
from repro.core.workloads import multitask_clip as jax_multitask_clip
import repro_torch.fleet as tfleet
import repro_torch.launch.events as tevents
import repro_torch.launch.faults as tfaults
import repro_torch.launch.fleet as tlaunch
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.placement import ClusterSpec
from repro_torch.core.plancache import PlanCache, _cluster_key, workload_signature
from repro_torch.core.workloads import multitask_clip
from repro_torch.models import build_model
from repro_torch.serving import ServingConfig, ServingSession

PKG = {
    "jax": SimpleNamespace(
        fleet=jfleet, events=jevents, faults=jfaults, launch=jlaunch,
        ClusterSpec=JaxClusterSpec, PlanCache=JaxPlanCache,
        cluster_key=jax_cluster_key, signature=jax_signature,
        multitask_clip=jax_multitask_clip, config={},
    ),
    "port": SimpleNamespace(
        fleet=tfleet, events=tevents, faults=tfaults, launch=tlaunch,
        ClusterSpec=ClusterSpec, PlanCache=PlanCache,
        cluster_key=_cluster_key, signature=workload_signature,
        multitask_clip=multitask_clip,
        # the reference's spec; serve jobs on the CPU
        config=dict(device="cpu", hw=HardwareSpec(**dataclasses.asdict(V5E))),
    ),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
#: tests/test_fleet.py's cluster; tests/test_faults.py:355's; and the one
#: repro/launch/fleet.py builds for its mixes (8 hosts of 4)
CLUSTER = dict(n_devices=16, island_size=8, mem_bytes=96e9,
               devices_per_host=2)
FAULTS_CLUSTER = dict(n_devices=32, island_size=4, devices_per_host=4,
                      mem_bytes=96e9)
LAUNCH_CLUSTER = dict(n_devices=32, island_size=8, mem_bytes=96e9,
                      devices_per_host=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (restored after): its
    small CPU ops gain nothing from more, and under parallel test workers
    every op's thread team would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- host maps


@BOTH
def test_host_map_noncontiguous(pkg):
    """tests/test_fleet.py TestHostMap.test_noncontiguous_map."""
    c = PKG[pkg].ClusterSpec(n_devices=0, island_size=8,
                             host_map=((0, 1), (6, 7), (2, 3)))
    assert c.n_devices == 6 and c.n_hosts == 3
    assert c.all_devices() == (0, 1, 2, 3, 6, 7)
    assert c.devices_of(1) == (6, 7)
    assert c.host_of(7) == 1 and c.host_of(2) == 2


@BOTH
def test_host_map_rejects_bad_maps(pkg):
    """TestHostMap: an unknown device, a device on two hosts, an empty host
    and an ``n_devices`` that disagrees with the map all raise."""
    cs = PKG[pkg].ClusterSpec
    with pytest.raises(ValueError, match="not in this cluster"):
        cs(n_devices=0, host_map=((0, 1), (4, 5))).host_of(2)
    with pytest.raises(ValueError, match="more than one host"):
        cs(n_devices=0, host_map=((0, 1), (1, 2)))
    with pytest.raises(ValueError, match="at least one device"):
        cs(n_devices=0, host_map=((0, 1), ()))
    with pytest.raises(ValueError, match="n_devices"):
        cs(n_devices=5, host_map=((0, 1), (2, 3)))


@BOTH
def test_host_map_shrink_and_cluster_key(pkg):
    """TestHostMap: shrinking drops the mapped block and restores to an
    equal spec; uniform, mapped and ragged maps key apart."""
    p = PKG[pkg]
    c = p.ClusterSpec(n_devices=0, host_map=((0, 1), (6, 7), (2, 3)))
    s = c.shrink((1,))
    assert s.healthy_devices() == (0, 1, 2, 3) and s.n_healthy == 4
    assert s.restore() == c
    keys = {p.cluster_key(x) for x in (
        p.ClusterSpec(n_devices=4, devices_per_host=2),
        p.ClusterSpec(n_devices=0, host_map=((0, 1), (2, 3))),
        p.ClusterSpec(n_devices=0, host_map=((0,), (1, 2, 3))))}
    assert len(keys) == 3


# --------------------------------------------------------------- lease views


@BOTH
def test_lease_view_equal_shapes_alias(pkg):
    """TestLeaseView: other physical blocks of the same shape give the same
    view and the same workload signature; another shape does not."""
    p = PKG[pkg]
    parent = p.ClusterSpec(**CLUSTER)
    v1 = p.fleet.lease_view(parent, (0, 1))
    v2 = p.fleet.lease_view(parent, (5, 3))
    assert v1 == v2 and v1.n_devices == 4
    assert v1.host_map == ((0, 1), (2, 3))
    g = p.multitask_clip(n_tasks=2, batch_per_task=8)
    assert p.signature(g, v1) == p.signature(
        g, p.fleet.lease_view(parent, (6, 2)))
    assert p.signature(g, v1) != p.signature(
        g, p.fleet.lease_view(parent, (0, 1, 2)))


def test_lease_view_equals_jax():
    """The port's view of host subsets of a 6-host cluster equals
    JAX's, field for field."""
    parent = dict(n_devices=12, island_size=4, mem_bytes=80e9,
                  devices_per_host=2)
    for hosts in [(0,), (5, 1), (2, 3, 4), (0, 1, 2, 3, 4, 5)]:
        j = jfleet.lease_view(JaxClusterSpec(**parent), hosts)
        t = tfleet.lease_view(ClusterSpec(**parent), hosts)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------- cross-job dedup


def _plan_twice(p, owners, batches, hosts):
    cache = p.PlanCache(maxsize=8)
    parent = p.ClusterSpec(**CLUSTER)
    for owner, b, h in zip(owners, batches, hosts):
        cache.owner = owner
        cache.get_or_plan(p.multitask_clip(n_tasks=2, batch_per_task=b),
                          p.fleet.lease_view(parent, h), planner="spindle")
    return cache.stats.as_dict()


@BOTH
@pytest.mark.parametrize("case", ["cross_job", "own_rehit", "other_batch"])
def test_shared_cache_dedup(pkg, case):
    """TestCrossJobDedup: two jobs on equal-shaped leases plan once (one
    cross-job hit); a job re-hitting its own entry is no cross-job hit; a
    different batch is another signature (no false sharing)."""
    owners, batches, hosts, want = {
        "cross_job": (("jobA", "jobB"), (8, 8), ((0, 1), (7, 4)), (1, 1)),
        "own_rehit": (("jobA", "jobA"), (8, 8), ((0, 1), (0, 1)), (1, 0)),
        "other_batch": (("jobA", "jobB"), (8, 16), ((0, 1), (0, 1)), (0, 0)),
    }[case]
    stats = _plan_twice(PKG[pkg], owners, batches, hosts)
    assert (stats["hits"], stats["cross_job_hits"]) == want


def test_shared_cache_stats_equal_jax():
    for args in [(("a", "b"), (8, 8), ((0, 1), (7, 4))),
                 (("a", "b"), (8, 16), ((0, 1), (2, 3)))]:
        assert _plan_twice(PKG["port"], *args) == _plan_twice(PKG["jax"], *args)


# ----------------------------------------------------------- lease arbiter


def _disjoint_and_healthy(arb):
    arb.check()
    healthy = set(arb.cluster.healthy_devices())
    for leases in (arb.granted, arb.applied):
        seen = set()
        for lease in leases.values():
            devs = set(lease.devices)
            assert not devs & seen and devs <= healthy
            seen |= devs


@BOTH
def test_arbiter_carve_weighted(pkg):
    """TestLeaseArbiter.test_carve_disjoint_and_weighted."""
    p = PKG[pkg]
    arb = p.fleet.LeaseArbiter(p.ClusterSpec(n_devices=16, devices_per_host=2))
    for j, w in (("a", 1), ("b", 2), ("c", 1)):
        arb.admit(j, priority=w)
    _disjoint_and_healthy(arb)
    assert {j: len(arb.granted[j].hosts) for j in "abc"} == \
        {"a": 2, "b": 4, "c": 2}
    assert set().union(*(lease.hosts for lease in arb.granted.values())) == \
        set(range(8))


@BOTH
def test_arbiter_release_returns_blocks(pkg):
    p = PKG[pkg]
    arb = p.fleet.LeaseArbiter(p.ClusterSpec(n_devices=8, devices_per_host=2))
    arb.admit("a")
    arb.admit("b")
    arb.apply("a")
    arb.apply("b")
    arb.release("a")
    arb.recarve()
    _disjoint_and_healthy(arb)
    assert len(arb.granted["b"].hosts) == 4


@BOTH
def test_arbiter_eviction_strips_applied(pkg):
    p = PKG[pkg]
    cluster = p.ClusterSpec(n_devices=8, devices_per_host=2)
    arb = p.fleet.LeaseArbiter(cluster)
    arb.admit("a")
    arb.apply("a")
    assert arb.applied["a"].hosts == (0, 1, 2, 3)
    arb.evict_hosts(cluster.shrink((1,)))
    _disjoint_and_healthy(arb)
    assert 1 not in arb.applied["a"].hosts and 1 not in arb.granted["a"].hosts


@BOTH
def test_arbiter_deferred_renewal_no_double_assignment(pkg):
    """TestLeaseArbiter.test_deferred_renewal_no_double_assignment: an
    eviction-driven re-carve defers a's expansion behind b's applied lease,
    and promotes it once b applies, never overlapping."""
    p = PKG[pkg]
    cluster = p.ClusterSpec(n_devices=8, devices_per_host=2)
    arb = p.fleet.LeaseArbiter(cluster)
    arb.admit("a")
    arb.admit("b")
    arb.apply("a")
    arb.apply("b")
    assert (arb.applied["a"].hosts, arb.applied["b"].hosts) == ((0, 1), (2, 3))
    arb.evict_hosts(cluster.shrink((1,)))
    _disjoint_and_healthy(arb)
    assert arb.deferred_renewals > 0
    assert set(arb.granted["a"].hosts).isdisjoint(arb.applied["b"].hosts)
    before = set(arb.granted["a"].hosts)
    arb.apply("b")
    _disjoint_and_healthy(arb)
    arb.apply("a")
    _disjoint_and_healthy(arb)
    assert set(arb.granted["a"].hosts) | set(arb.granted["b"].hosts) == \
        {0, 2, 3}
    assert set(arb.granted["a"].hosts) >= before


@BOTH
def test_arbiter_more_jobs_than_hosts(pkg):
    p = PKG[pkg]
    arb = p.fleet.LeaseArbiter(p.ClusterSpec(n_devices=4, devices_per_host=2))
    for j in "abc":
        arb.admit(j)
    _disjoint_and_healthy(arb)
    assert len([j for j in "abc" if arb.granted[j].hosts]) == 2


# -------------------------------------------------------- lease revocation


def _revocation_arbiter(pkg, deadline):
    p = PKG[pkg]
    arb = p.fleet.LeaseArbiter(p.ClusterSpec(**FAULTS_CLUSTER),
                               revoke_deadline=deadline)
    arb.admit("A")
    arb.apply("A")
    return arb


@BOTH
def test_revocation_deadline_issue_expire_force(pkg):
    """tests/test_faults.py TestLeaseRevocation.test_deadline_issue_expire_force."""
    arb = _revocation_arbiter(pkg, 3)
    arb.clock = 10
    arb.admit("B", priority=3)
    assert arb.granted["B"].hosts == ()
    rev = arb.revocations["A"]
    assert (rev.issued, rev.deadline) == (10, 13)
    arb.clock = 12
    assert arb.expired_revocations() == []
    arb.clock = 13
    assert [r.job for r in arb.expired_revocations()] == ["A"]
    arb.force_revoke("A")
    assert arb.forced_revokes == 1 and "A" not in arb.revocations
    assert len(arb.granted["B"].hosts) > 0
    arb.check()


@BOTH
def test_revocation_cooperative_yield_clears(pkg):
    arb = _revocation_arbiter(pkg, 5)
    arb.admit("B", priority=3)
    assert "A" in arb.revocations
    arb.apply("A")
    assert arb.cooperative_yields == 1 and "A" not in arb.revocations
    assert len(arb.granted["B"].hosts) > 0
    arb.check()


@BOTH
def test_revocation_release_clears_pending(pkg):
    arb = _revocation_arbiter(pkg, 5)
    arb.admit("B", priority=3)
    assert "A" in arb.revocations
    arb.release("A")
    assert "A" not in arb.revocations
    arb.check()


@BOTH
def test_revocation_none_without_deadline(pkg):
    arb = _revocation_arbiter(pkg, None)
    arb.admit("B", priority=3)
    assert arb.revocations == {} and arb.revokes_issued == 0


@BOTH
def test_force_revoke_without_pending_raises(pkg):
    p = PKG[pkg]
    arb = p.fleet.LeaseArbiter(p.ClusterSpec(**FAULTS_CLUSTER),
                               revoke_deadline=1)
    arb.admit("A")
    with pytest.raises(ValueError):
        arb.force_revoke("A")


def _lease(lease):
    view = None if lease.view is None else dataclasses.asdict(lease.view)
    return lease.job, lease.hosts, lease.physical, lease.version, view


# ----------------------------------------------------------------- JobSpec


@BOTH
@pytest.mark.parametrize("kw, match", [
    (dict(kind="batch"), "unknown kind"),
    (dict(priority=0), "priority"),
    (dict(arrival=-1.0), "arrival"),
    (dict(steps=0), "steps"),
    (dict(kind="serve", requests=0), "requests"),
    (dict(kind="serve", prompt_len=30, gen_len=6, cache_len=32), "cache_len"),
])
def test_jobspec_validation(pkg, kw, match):
    """``JobSpec.__post_init__`` (jobs.py:58-77): the same errors, same
    words, in both packages."""
    with pytest.raises(ValueError, match=match) as exc:
        PKG[pkg].fleet.JobSpec(name="j", **kw)
    if pkg == "port":
        with pytest.raises(ValueError) as ref:
            jfleet.JobSpec(name="j", **kw)
        assert str(exc.value) == str(ref.value)


# -------------------------------------------------------------- end to end


def _recorder(p):
    """A callback of package ``p`` that logs every fleet callback as plain
    values (leases with their views)."""

    class Record(p.fleet.FleetCallbacks):
        def __init__(self):
            self.log = []

        def on_job_admitted(self, fleet, handle):
            self.log.append(("admitted", handle.name, fleet.t))

        def on_job_step(self, fleet, handle, step, dt):
            self.log.append(("step", handle.name, step, dt, handle.clock))

        def on_job_finished(self, fleet, handle):
            self.log.append(("finished", handle.name, handle.done_at))

        def on_rebalance(self, fleet, event, leases):
            self.log.append(("rebalance", _event(event),
                             {j: _lease(x) for j, x in leases.items()}))

    return Record()


def _event(e):
    return type(e).__name__, dataclasses.asdict(e)


def _mixes(p):
    launch = p.launch
    # the reference's revoke mix on both sides (the port's own arrives
    # earlier, to suit the H100 clock)
    revoke = [p.fleet.JobSpec(**dataclasses.asdict(j))
              for j in jlaunch.revoke_jobs(8)]
    J = p.fleet.JobSpec
    return {
        "smoke": (launch.smoke_jobs(8, 3), LAUNCH_CLUSTER, {}),
        "default": (launch.default_jobs(8, 3), LAUNCH_CLUSTER, {}),
        "revoke": (revoke, LAUNCH_CLUSTER, dict(revoke_deadline=4)),
        "host_failure": ([
            J(name="t0", kind="train", workload="multitask_clip", steps=12),
            J(name="s0", kind="serve", arch="qwen3-0.6b", requests=6,
              prompt_len=8, gen_len=4, slots=2, cache_len=32),
        ], FAULTS_CLUSTER, {}),
    }


def _run(pkg, mix, policy, straggler_at, model):
    """One package's fleet over ``mix``: (metrics, callback log, events,
    tokens per serve job)."""
    p = PKG[pkg]
    jobs, cluster, extra = _mixes(p)[mix]
    cluster = p.ClusterSpec(**cluster)
    sources = []
    if straggler_at >= 0:
        sources.append(p.events.ScriptedEventSource(
            [p.events.StragglerDetected((cluster.n_hosts - 1,))],
            fire_at=[straggler_at]))
    if mix == "host_failure":
        sources.append(p.faults.FaultInjector(
            cluster.n_hosts, schedule=[p.faults.FaultScript(step=6,
                                                            hosts=(4, 5))]))
    rec = _recorder(p)
    fleet = p.fleet.FleetScheduler(
        p.fleet.FleetConfig(cluster=cluster, policy=policy, **extra,
                            **p.config),
        jobs, callbacks=[rec], event_sources=sources,
        model_cache={"qwen3-0.6b": model})
    m = fleet.run()
    fleet.arbiter.check()
    tokens = {h.name: {rid: [int(t) for t in r.tokens]
                       for rid, r in h.session.results.items()}
              for h in fleet.jobs.values() if h.spec.kind == "serve"}
    return m, rec.log, [_event(e) for e in fleet.events], tokens


SCENARIOS = {
    "smoke_fleet": ("smoke", "fleet", 6),
    "smoke_static": ("smoke", "static", 6),
    "smoke_fifo": ("smoke", "fifo", 6),
    "default_fleet": ("default", "fleet", -1),
    "smoke_colocate": ("smoke", "colocate", -1),
    "revoke": ("revoke", "fleet", -1),
    "host_failure": ("host_failure", "fleet", -1),
}


@pytest.fixture(scope="module")
def fleets():
    """Every scenario's JAX fleet, run first: one reduced qwen3 (the JAX
    fleet's own ``PRNGKey(0)`` init) serves all of them, and its params,
    bridged, make the port's model."""
    jmodel = jfleet.FleetScheduler(jfleet.FleetConfig(), ())._model(
        "qwen3-0.6b")
    out = {name: _run("jax", *args, jmodel)
           for name, args in SCENARIOS.items()}
    model = build_model(reduced(get_arch("qwen3-0.6b")),
                        ShardingConfig(use_kernels=True), device="cpu")
    model = bridge.load_jax_params(model, jax.tree.map(np.asarray, jmodel[1]))
    return out, model


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_equals_jax(fleets, name):
    """The port's fleet under each policy and scenario (the smoke mix with a
    straggler at tick 6 under fleet, static and fifo; the 5-job default
    mix; colocate; ``revoke_jobs`` with deadline 4; the host failure of
    tests/test_faults.py:440) equals the JAX fleet exactly: metrics, job
    summaries, callbacks, events and tokens."""
    ref, model = fleets
    want = ref[name]
    got = _run("port", *SCENARIOS[name], model)
    for part, g, w in zip(("metrics", "callbacks", "events", "tokens"),
                          got, want):
        assert g == w, part
    m = got[0]
    assert all(r["state"] == "done" for r in m["jobs"])
    if name.startswith("smoke") and name != "smoke_colocate":
        assert m["cross_job_hits"] >= 1
    if name in ("smoke_fleet", "smoke_static"):
        assert m["rebalances"] == 1
    if name == "smoke_colocate":
        assert m["colocated_steps"] >= 1
    if name == "revoke":
        assert m["forced_revokes"] >= 1
        assert m["lease"]["pending_revocations"] == 0
    if name == "host_failure":
        assert m["host_failures"] == 1 and m["requeued_requests"] >= 1


# ------------------------------------------------------------- co-location


def test_colocated_decode_token_exact():
    """tests/test_timeline.py:110 on the port, under its own defaults (the
    H100 spec, 80 GB cards, the first serve step priced by the planner):
    the co-located tenant decodes exactly what a solo ``ServingSession``
    decodes over the same trace, at least one step rides a window, and the
    tenant never holds devices of its own."""
    cluster = ClusterSpec(n_devices=32, island_size=8, devices_per_host=4)
    jobs = [
        tfleet.JobSpec(name="train0", kind="train", workload="multitask_clip",
                       steps=6),
        tfleet.JobSpec(name="tenant", kind="serve", arch="qwen3-0.6b",
                       requests=2, prompt_len=8, gen_len=4, slots=2,
                       cache_len=32),
    ]
    config = tfleet.FleetConfig(cluster=cluster, policy="colocate",
                                device="cpu")
    config = dataclasses.replace(
        config, serve_fallback_dt=tlaunch.first_serve_step_dt(jobs[1], config))
    fleet = tfleet.FleetScheduler(config, jobs)
    m = fleet.run()
    assert all(r["state"] == "done" for r in m["jobs"])
    tenant = fleet.jobs["tenant"]
    assert tenant.colocated_steps >= 1 and tenant.co_host == "train0"
    assert m["lease"]["colocations"] >= 1
    assert "tenant" not in fleet.arbiter.granted
    solo = ServingSession(ServingConfig(arch="qwen3-0.6b", max_slots=2,
                                        cache_len=32, replan="off",
                                        device="cpu"))
    pending = fleet._make_requests(jobs[1])
    while pending or solo.busy:
        while pending and pending[0].arrival <= solo.steps:
            solo.submit(pending.pop(0))
        solo.step()
    got = {rid: list(r.tokens) for rid, r in tenant.session.results.items()}
    assert got == {rid: list(r.tokens) for rid, r in solo.results.items()}


def test_tenant_kv_high_water_within_headroom():
    """tests/test_timeline.py:154 on the port: the tenant's KV pool peak
    stays within the window headroom its page budget was carved from."""
    m = tlaunch.run_fleet("colocate", smoke=True, steps=6, requests=2,
                          straggler_at=-1, verbose=False, device="cpu")
    served = [h for h in m["_handles"].values()
              if h.spec.kind == "serve" and h.colocated_steps > 0]
    assert served
    for h in served:
        hw = tlaunch._tenant_kv_high_water_bytes(h)
        assert 0 < hw <= h.window_headroom_bytes


@pytest.mark.parametrize("fallback", ["reference", "planned"])
def test_fallback_step_fits_h100_windows(fallback):
    """Under the H100 spec every idle window of a multitask_clip plan is
    shorter than the reference's 1 ms pre-plan serve step (the port's
    default too), so a tenant never takes the step that would give it a
    plan: it is promoted once training ends, with 0 co-located steps.
    Priced by its planner (``launch.fleet.first_serve_step_dt``), the first
    step costs what the plan it leaves behind charges the second, fits, and
    the tenant rides the windows."""
    jobs = [
        tfleet.JobSpec(name="train0", kind="train", workload="multitask_clip",
                       steps=6),
        tfleet.JobSpec(name="tenant", kind="serve", arch="qwen3-0.6b",
                       requests=2, prompt_len=8, gen_len=4, slots=2,
                       cache_len=32),
    ]
    config = tfleet.FleetConfig(policy="colocate", device="cpu")
    assert config.serve_fallback_dt == 1e-3
    if fallback == "planned":
        config = dataclasses.replace(
            config,
            serve_fallback_dt=tlaunch.first_serve_step_dt(jobs[1], config))

    class Steps(tfleet.FleetCallbacks):
        dts = []

        def on_job_step(self, fleet, handle, step, dt):
            if handle.name == "tenant":
                self.dts.append(dt)

    fleet = tfleet.FleetScheduler(config, jobs, callbacks=[Steps()])
    m = fleet.run()
    assert all(r["state"] == "done" for r in m["jobs"])
    if fallback == "planned":
        assert m["colocated_steps"] >= 1
        assert Steps.dts[0] == Steps.dts[1] == config.serve_fallback_dt
    else:
        assert m["colocated_steps"] == 0


# --------------------------------------------------------------------- CLI


CONTRACTS = {"smoke": ["--smoke"], "colocate": ["--policy", "colocate",
                                                "--smoke"],
             "revoke": ["--revoke-smoke"]}


@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_cli_contract_exits_zero_on_cpu(contract, monkeypatch, capsys):
    """``python -m repro_torch.launch.fleet --device cpu`` with each of the
    three contracts of the reference's ``main`` exits 0."""
    monkeypatch.setattr(sys, "argv", ["fleet", "--device", "cpu"]
                        + CONTRACTS[contract])
    try:
        tlaunch.main()
    except SystemExit as exc:
        assert exc.code in (0, None), capsys.readouterr().err
    assert "FAILED" not in capsys.readouterr().err


@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_cli_defaults_to_cuda(contract, monkeypatch):
    """Without ``--device`` the CLI asks for the GPU: here, with none, it
    raises before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    monkeypatch.setattr(sys, "argv", ["fleet"] + CONTRACTS[contract])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tlaunch.main()


def test_fleet_defaults_to_cuda():
    """``FleetConfig`` defaults to ``cuda``, and the scheduler resolves it
    when it is built: with no GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    assert tfleet.FleetConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tfleet.FleetScheduler(tfleet.FleetConfig(), ())
