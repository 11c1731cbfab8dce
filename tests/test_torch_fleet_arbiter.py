"""The port's lease arbiter (``repro_torch/fleet/lease.py``) against the
JAX package's on random operations (hypothesis).  It stands apart from
``tests/test_torch_fleet.py`` so that a missing hypothesis skips this test
alone; the arbiter is plain Python on both sides."""

import dataclasses
from types import SimpleNamespace

import pytest

import repro.fleet as jfleet
from repro.core.placement import ClusterSpec as JaxClusterSpec
import repro_torch.fleet as tfleet
from repro_torch.core.placement import ClusterSpec

pytest.importorskip("hypothesis")  # optional extra: skip, never collection-error
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

PKG = {"jax": SimpleNamespace(fleet=jfleet, ClusterSpec=JaxClusterSpec),
       "port": SimpleNamespace(fleet=tfleet, ClusterSpec=ClusterSpec)}

_JOBS = "abcde"
_ARB_OPS = st.lists(st.tuples(
    st.sampled_from(["admit", "apply", "release", "colocate", "evict",
                     "clock", "expire", "force"]),
    st.integers(0, 4), st.integers(1, 3), st.integers(0, 255),
), max_size=40)


def _arb_op(p, arb, parent, op, j, w, bits):
    """One operation on one package's arbiter; returns its result, or the
    exception's type and message (both sides must raise alike)."""
    name, other = _JOBS[j], _JOBS[(j + w) % len(_JOBS)]
    try:
        if op == "admit":
            if name in arb.co_tenants:  # a tenant holds no lease: the
                return "tenant"         # scheduler releases it first
            return _lease(arb.admit(name, priority=w))
        if op == "apply":
            return _lease(arb.apply(name))
        if op == "release":
            return arb.release(name)
        if op == "colocate":
            return arb.colocate(name, other)
        if op == "evict":
            down = tuple(h for h in range(parent.n_hosts) if bits >> h & 1)
            if len(down) >= parent.n_hosts:
                down = down[1:]
            return arb.evict_hosts(parent.shrink(down))
        if op == "clock":
            arb.clock += w
            return arb.clock
        if op == "expire":
            return [(r.job, sorted(r.hosts), r.issued, r.deadline)
                    for r in arb.expired_revocations()]
        return _lease(arb.force_revoke(name))
    except (ValueError, KeyError) as exc:
        return (type(exc).__name__, str(exc))


def _lease(lease):
    view = None if lease.view is None else dataclasses.asdict(lease.view)
    return lease.job, lease.hosts, lease.physical, lease.version, view


def _arb_state(arb):
    return ({j: _lease(x) for j, x in arb.granted.items()},
            {j: _lease(x) for j, x in arb.applied.items()},
            {j: (sorted(r.hosts), r.issued, r.deadline)
             for j, r in arb.revocations.items()},
            arb.stats(), dict(arb.co_tenants), arb.jobs())


@settings(max_examples=80, deadline=None)
@given(ops=_ARB_OPS, deadline=st.sampled_from([None, 0, 2]))
def test_arbiter_equal_jax_on_random_operations(ops, deadline):
    """Both packages' ``LeaseArbiter`` (lease.py:126-477) through the same
    random admits with priorities, applies, releases, co-locations,
    evictions onto shrunk clusters, clock moves, expiries and forced
    revokes: equal results (errors included) and equal granted, applied,
    revocations, ``stats()`` and co-tenants after every operation, and
    ``check()`` passing on both."""
    sides = []
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        parent = p.ClusterSpec(n_devices=12, island_size=4, mem_bytes=80e9,
                               devices_per_host=2)
        sides.append((p, p.fleet.LeaseArbiter(parent, revoke_deadline=deadline),
                      parent))
    for op in ops:
        got = [_arb_op(p, arb, parent, *op) for p, arb, parent in sides]
        assert got[1] == got[0]
        assert _arb_state(sides[1][1]) == _arb_state(sides[0][1])
        for _, arb, _ in sides:
            arb.check()
