"""The port's planner (``repro_torch.core``) against the JAX package's
(``repro.core``).

The planner is float arithmetic in plain Python, so a faithful copy given
the same inputs gives the same plan to the last bit: every comparison here
is ``==``, with no tolerance.  The two packages differ in their defaults on
purpose (the port plans for an H100, the reference for its own spec), so
every ``HardwareSpec`` and ``ClusterSpec`` compared below is built with
explicit fields taken from the reference.
"""

import dataclasses
import json

import pytest

import repro.core as R
from repro.core.workloads import WORKLOADS as JAX_WORKLOADS
from repro.core.workloads import TowerSpec as JaxTowerSpec
from repro.core.workloads import serving_mix_workload as jax_serving_mix

import repro_torch.core as T
from repro_torch.config import get_arch
from repro_torch.core.workloads import WORKLOADS
from repro_torch.core.workloads import TowerSpec, serving_mix_workload
from repro_torch.serving.mix import tower_from_arch

PLANNERS = ("spindle", "sequential", "distmm_mt", "optimus")
#: the reference's hardware values, in each package's own class
REF_HW = R.V5E
PORT_HW = T.HardwareSpec(**dataclasses.asdict(R.V5E))


def _clusters(**kw):
    ref = R.ClusterSpec(**kw)
    return ref, T.ClusterSpec(**dataclasses.asdict(ref))


def _plan_json(p):
    d = json.loads(p.to_json())
    d.pop("planning_seconds")
    return d


def test_registries_and_spec_repr_match():
    assert sorted(WORKLOADS) == sorted(JAX_WORKLOADS)
    assert T.available_planners() == R.available_planners()
    assert [f.name for f in dataclasses.fields(T.HardwareSpec)] == [
        f.name for f in dataclasses.fields(R.HardwareSpec)]
    # repr(hw) is part of the PlanCache key
    assert repr(PORT_HW) == repr(REF_HW)
    assert T.H100 != PORT_HW and T.ClusterSpec(n_devices=8).mem_bytes == 80e9


@pytest.mark.parametrize("n_devices", [16, 64])
@pytest.mark.parametrize("planner", PLANNERS)
@pytest.mark.parametrize("workload", sorted(JAX_WORKLOADS))
def test_plan_and_signature_equal_jax(workload, planner, n_devices):
    ref_c, port_c = _clusters(n_devices=n_devices)
    ref_g, port_g = JAX_WORKLOADS[workload](), WORKLOADS[workload]()
    assert R.workload_signature(ref_g, ref_c, planner=planner, hw=REF_HW) == \
        T.workload_signature(port_g, port_c, planner=planner, hw=PORT_HW)
    ref_p = R.plan(ref_g, ref_c, hw=REF_HW, planner=planner)
    port_p = T.plan(port_g, port_c, hw=PORT_HW, planner=planner)
    assert _plan_json(port_p) == _plan_json(ref_p)
    assert port_p.signature == ref_p.signature


MIX = [("chat", 32, 8), ("chat", 128, 4), ("code", 256, 2)]


@pytest.mark.parametrize("chunk,hit", [(0, 0.0), (64, 0.0), (0, 0.4),
                                       (64, 0.6)])
def test_serving_mix_workload_equals_jax(chunk, hit):
    tower = dict(name="t", n_layers=4, d_model=256, d_ff=1024, n_heads=4,
                 seq=128)
    ref = jax_serving_mix(MIX, tower=JaxTowerSpec(**tower),
                          prefill_chunk=chunk, prefix_hit_rate=hit)
    port = serving_mix_workload(MIX, tower=TowerSpec(**tower),
                                prefill_chunk=chunk, prefix_hit_rate=hit)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    ref_c, port_c = _clusters(n_devices=16, island_size=8, mem_bytes=96e9)
    assert T.workload_signature(port, port_c, hw=PORT_HW) == \
        R.workload_signature(ref, ref_c, hw=REF_HW)


def _cache_trace(core, tower_cls, serving_mix, cluster, hw):
    """One PlanCache fed a serving session's life: a first mix, a count
    drift, the first mix again, a new family forced full, a shrunken
    cluster, a restored one.  Returns the stats after each call and the
    plans' JSON."""
    tower = tower_cls(name="t", n_layers=4, d_model=256, d_ff=1024,
                      n_heads=4, seq=128)
    cache = core.PlanCache(maxsize=8)
    steps = [
        ([("chat", 32, 4)], cluster, True),
        ([("chat", 32, 8)], cluster, True),
        ([("chat", 32, 4)], cluster, True),
        ([("chat", 32, 4), ("code", 256, 1)], cluster, False),
        ([("chat", 32, 8), ("code", 256, 1)], cluster, True),
        ([("chat", 32, 4)], cluster.shrink((1,)), True),
        ([("chat", 32, 4)], cluster.shrink((1,)).restore(), True),
    ]
    records = []
    for mix, c, incremental in steps:
        p = cache.get_or_plan(serving_mix(mix, tower=tower), c, hw=hw,
                              incremental=incremental)
        records.append((cache.stats.as_dict(), _plan_json(p)))
    return records


def test_plan_cache_records_equal_jax():
    ref_c, port_c = _clusters(n_devices=16, island_size=8, mem_bytes=96e9)
    ref = _cache_trace(R, JaxTowerSpec, jax_serving_mix, ref_c, REF_HW)
    port = _cache_trace(T, TowerSpec, serving_mix_workload, port_c, PORT_HW)
    assert port == ref
    stats = [s for s, _ in port]
    # hit, incremental and full records all occur on this trace
    assert stats[2]["hits"] == stats[1]["hits"] + 1
    assert stats[1]["incremental"] == stats[0]["incremental"] + 1
    assert stats[3]["misses"] == stats[2]["misses"] + 1


@pytest.mark.parametrize("kw,flag", [
    (dict(n_devices=16, island_size=8), (1,)),
    (dict(n_devices=24, island_size=8, devices_per_host=4), (0, 3, 5)),
    (dict(n_devices=8, host_map=((0, 1, 2), (5, 6), (3, 4, 7))), (1,)),
])
def test_cluster_shrink_restore_equal_jax(kw, flag):
    ref, port = _clusters(**kw)
    assert port.n_hosts == ref.n_hosts
    assert port.hosts() == ref.hosts()
    ref_s, port_s = ref.shrink(flag), port.shrink(flag)
    assert port_s.healthy_devices() == ref_s.healthy_devices()
    assert port_s.n_healthy == ref_s.n_healthy
    assert dataclasses.asdict(port_s) == dataclasses.asdict(ref_s)
    assert port_s.restore() == port and ref_s.restore() == ref
    with pytest.raises(ValueError):
        port.shrink(range(port.n_hosts))


@pytest.mark.parametrize("workload", ["multitask_clip", "serving_mix"])
def test_timeline_windows_equal_jax(workload):
    ref_c, port_c = _clusters(n_devices=16, island_size=8)
    ref = R.plan(JAX_WORKLOADS[workload](), ref_c, hw=REF_HW).timeline()
    port = T.plan(WORKLOADS[workload](), port_c, hw=PORT_HW).timeline()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [dataclasses.asdict(w) for w in port.gang_windows(2)] == [
        dataclasses.asdict(w) for w in ref.gang_windows(2)]
    assert port.idle_fraction() == ref.idle_fraction()


def test_simulator_utilization_uses_the_planning_spec():
    """The port's SimResult is held against the spec the plan was made for;
    with the reference's values it gives the reference's numbers."""
    ref_c, port_c = _clusters(n_devices=16, island_size=8)
    for name in ("sequential", "distmm_mt", "optimus"):
        ref = R.simulate_planner(name, JAX_WORKLOADS["ofasys"](), ref_c, REF_HW)
        port = T.simulate_planner(name, WORKLOADS["ofasys"](), port_c, PORT_HW)
        assert port.makespan == ref.makespan
        assert port.avg_flops_utilization == ref.avg_flops_utilization
        assert port.utilization_curve(16) == ref.utilization_curve(16)
        assert port.per_meta_utilization() == ref.per_meta_utilization()
    h100 = T.simulate_planner("sequential", WORKLOADS["ofasys"](), port_c)
    assert h100.peak_flops == T.H100.peak_flops


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b"])
def test_h100_spec_plans_each_served_arch(arch):
    """The port's default spec and serving cluster plan the serving mix of
    each served arch, and the schedule checks out."""
    from repro_torch.serving import ServingConfig

    graph = serving_mix_workload(MIX, tower=tower_from_arch(get_arch(arch),
                                                            seq=544))
    cluster = ServingConfig().cluster
    p = T.plan(graph, cluster)
    T.check_schedule(p.schedule, p.meta_graph, cluster.n_healthy)
    assert p.makespan > 0 and p.steps
    assert {d for s in p.steps for d in s.devices} <= set(range(16))
