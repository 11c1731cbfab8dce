"""Device-block leases: carving one cluster into per-job sub-clusters (port
of ``repro/fleet/lease.py``; pure Python over the port's ``ClusterSpec``).

The fleet scheduler (DESIGN.md §14) shares one physical
:class:`repro_torch.core.placement.ClusterSpec` among N jobs.  The unit of
arbitration is the **host block** — the same granularity the elastic
topology already evicts at — and the currency is a :class:`Lease`: a set
of physical hosts plus a *canonical view* of them (a value-level
``ClusterSpec`` whose ``host_map`` renumbers the leased devices
``0..k-1`` in host order).  Planning happens against the view, so two
jobs holding equal-shaped leases (same host count and sizes) produce the
SAME workload signature for the same arch — that is what makes the shared
:class:`repro_torch.core.plancache.PlanCache` dedup plans across jobs
(``cross_job_hits``).  The arbiter, not the planner, owns which physical
devices back each view (``Lease.physical``).

Grant vs. apply — the double-assignment fix
-------------------------------------------
Leases change hands on job arrival/completion and on straggler eviction,
but a job only *adopts* a new lease at its next step boundary (it is
mid-step on the old one until then).  The arbiter therefore tracks two
states per job: the **granted** lease (the forward-looking assignment)
and the **applied** lease (what the job is actually running on).  The
safety rule: a host may newly enter a job's grant ONLY if no *other*
job's applied lease still holds it.  When a re-carve wants to move a host
from job A to job B while A has not yet applied its shrunken grant, B's
expansion is **deferred** (``deferred_renewals`` counts these) and
promoted automatically when A calls :meth:`LeaseArbiter.apply` — so two
jobs never hold overlapping device blocks, even transiently, and an
eviction-driven re-carve cannot double-assign a surviving block.

Preemptive revocation — the bounded-deadline escape hatch
---------------------------------------------------------
Deferral is cooperative: a holder with a long step (a big model between
boundaries) can starve a waiter indefinitely.  With ``revoke_deadline``
set (in scheduler ticks), a deferral also issues a **revocation** against
the holder: yield the contested hosts (checkpoint + apply the shrunken
grant) within the deadline, or the arbiter **force-evicts** the blocks
from the applied lease (:meth:`LeaseArbiter.force_revoke`) and the holder
recovers from its last snapshot at the next boundary — the same
rollback-restore path a hard host failure takes (DESIGN.md §17).
Applying in time counts a ``cooperative_yields``; expiry counts a
``forced_revokes``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.placement import ClusterSpec

__all__ = ["Lease", "LeaseArbiter", "Revocation", "lease_view"]


def lease_view(parent: ClusterSpec, hosts: Sequence[int]) -> ClusterSpec:
    """Canonical sub-cluster view of ``hosts`` carved from ``parent``.

    Devices are renumbered ``0..k-1`` consecutively in host order and the
    per-host structure is kept as an explicit ``host_map``, so two leases
    with the same host-size sequence compare (and *sign*) equal regardless
    of which physical blocks back them — the cross-job plan-dedup key.
    Bandwidths/memory are inherited; island structure follows from the
    renumbered ids (a modeling simplification: a lease spanning two
    physical islands of 4 presents as one logical island of 8).
    """
    lists: List[Tuple[int, ...]] = []
    nxt = 0
    for h in hosts:
        devs = parent.devices_of(h)
        if not devs:
            raise ValueError(f"host {h} owns no devices in the parent spec")
        lists.append(tuple(range(nxt, nxt + len(devs))))
        nxt += len(devs)
    return ClusterSpec(
        n_devices=nxt,
        island_size=parent.island_size,
        mem_bytes=parent.mem_bytes,
        intra_island_bw=parent.intra_island_bw,
        inter_island_bw=parent.inter_island_bw,
        host_map=tuple(lists),
    )


@dataclass(frozen=True)
class Lease:
    """One job's device-block grant: physical hosts + canonical view."""

    job: str
    #: physical host ids (fleet-cluster indices), in grant order
    hosts: Tuple[int, ...]
    #: physical device ids in host order — index i backs logical device i
    #: of :attr:`view` (the logical→physical mapping)
    physical: Tuple[int, ...]
    #: canonical sub-cluster (logical ids 0..k-1, explicit host_map);
    #: ``None`` for an empty lease (job queued, no devices)
    view: Optional[ClusterSpec]
    #: bumps on every re-grant — a job renews when its applied version lags
    version: int = 0

    @property
    def devices(self) -> Tuple[int, ...]:
        """Physical device ids, ascending (for disjointness accounting)."""
        return tuple(sorted(self.physical))

    @property
    def n_devices(self) -> int:
        return len(self.physical)

    def physical_of(self, logical: int) -> int:
        """Map a logical (view) device id to its physical device id."""
        return self.physical[logical]


@dataclass(frozen=True)
class Revocation:
    """A pending preemptive revoke: ``job`` must yield ``hosts`` by
    ``deadline`` (arbiter-clock ticks) or be force-evicted from them."""

    job: str
    hosts: frozenset
    issued: int
    deadline: int


class LeaseArbiter:
    """Carves one cluster's host blocks into disjoint per-job leases.

    Jobs are weighted by priority (largest-remainder shares over the
    healthy host count, every active job getting at least one host while
    hosts suffice; surplus jobs queue with an empty lease).  Re-carves are
    *stable* — a job keeps the hosts it already holds up to its new quota
    — and obey the grant/apply deferral rule documented in the module
    docstring.  ``fixed`` pins each job to an immutable host share (the
    static-partition baseline): re-carves then never move blocks between
    jobs, only activate/deactivate each job's own share.
    """

    def __init__(self, cluster: ClusterSpec,
                 fixed: Optional[Dict[str, Tuple[int, ...]]] = None,
                 revoke_deadline: Optional[int] = None):
        if revoke_deadline is not None and revoke_deadline < 0:
            raise ValueError(
                f"revoke_deadline must be >= 0 ticks, got {revoke_deadline}"
            )
        self.cluster = cluster
        self.fixed = dict(fixed) if fixed else None
        #: ticks a deferral's holder gets to yield before force-eviction;
        #: ``None`` = purely cooperative leases (no revocations issued)
        self.revoke_deadline = revoke_deadline
        #: the arbiter's notion of now, in scheduler ticks — advanced by
        #: the fleet loop before it arbitrates (deadlines are cut from it)
        self.clock = 0
        self.revocations: Dict[str, Revocation] = {}
        self.granted: Dict[str, Lease] = {}
        self.applied: Dict[str, Lease] = {}
        self._weights: Dict[str, int] = {}
        self._order: List[str] = []  # admission order (share tiebreak)
        self.grants = 0  # non-empty (re-)grants handed out
        self.deferred_renewals = 0  # expansions held back by the apply rule
        self.revokes_issued = 0
        self.cooperative_yields = 0  # revocations resolved by apply()
        self.forced_revokes = 0  # revocations resolved by force_revoke()
        self.evictions = 0
        #: co-resident tenants: tenant job -> host job whose lease's idle
        #: WINDOWS it occupies.  A tenant holds no hosts of its own — it is
        #: deliberately outside granted/applied, so the disjointness
        #: invariants and quota carving never see it.
        self.co_tenants: Dict[str, str] = {}
        self.colocations = 0  # tenant bindings handed out

    # ------------------------------------------------------------ membership
    def jobs(self) -> List[str]:
        return list(self._order)

    def admit(self, job: str, priority: int = 1) -> Lease:
        if job in self._weights:
            raise ValueError(f"job {job!r} already admitted")
        if priority < 1:
            raise ValueError(f"priority must be >= 1, got {priority}")
        self._weights[job] = priority
        self._order.append(job)
        self.granted[job] = Lease(job=job, hosts=(), physical=(), view=None)
        self.applied[job] = self.granted[job]
        self.recarve()
        return self.granted[job]

    def release(self, job: str) -> None:
        """Job finished/left: its blocks return to the carvable pool.

        Releasing a host job also unbinds its co-tenants (their windows
        died with the lease — the scheduler rehomes or promotes them);
        releasing a tenant just drops its binding."""
        self._weights.pop(job, None)
        if job in self._order:
            self._order.remove(job)
        self.granted.pop(job, None)
        self.applied.pop(job, None)
        self.revocations.pop(job, None)
        self.co_tenants.pop(job, None)
        for tenant, host in list(self.co_tenants.items()):
            if host == job:
                del self.co_tenants[tenant]
        self.recarve()

    # ----------------------------------------------------------- co-tenancy
    def colocate(self, tenant: str, host: str) -> None:
        """Bind ``tenant`` as a co-resident of ``host``'s lease.

        The tenant occupies *idle windows* of the host's plan, not hosts:
        it must not be (and never becomes) a lease-holder, and the host
        must hold a live grant.  Re-binding to a new host is allowed (the
        scheduler rehomes tenants when their host finishes)."""
        if tenant in self._weights:
            raise ValueError(
                f"co-tenant {tenant!r} already holds a lease of its own"
            )
        if host not in self._weights:
            raise ValueError(f"co-location host {host!r} is not admitted")
        if host in self.co_tenants:
            raise ValueError(f"host {host!r} is itself a co-tenant")
        self.co_tenants[tenant] = host
        self.colocations += 1
        self.check()

    # -------------------------------------------------------------- topology
    def evict_hosts(self, cluster: ClusterSpec) -> None:
        """Adopt a shrunken cluster (straggler eviction): evicted blocks
        leave every lease IMMEDIATELY — applied included, a job must not
        run another step on dead devices — then re-carve the survivors
        (expansions still deferred behind held blocks)."""
        self.cluster = cluster
        healthy = set(range(cluster.n_hosts)) - set(cluster.flagged_hosts)
        for job, lease in list(self.applied.items()):
            kept = tuple(h for h in lease.hosts if h in healthy)
            if kept != lease.hosts:
                self.applied[job] = self._mk_lease(job, kept, lease.version)
        self.evictions += 1
        self.recarve()

    # --------------------------------------------------------------- carving
    def _healthy_hosts(self) -> List[int]:
        flagged = set(self.cluster.flagged_hosts)
        return [h for h in range(self.cluster.n_hosts) if h not in flagged]

    def _share_order(self) -> List[str]:
        """Jobs by descending priority, admission order as the tiebreak."""
        return sorted(
            self._order, key=lambda j: (-self._weights[j], self._order.index(j))
        )

    def _quotas(self, n_hosts: int) -> Dict[str, int]:
        jobs = self._share_order()
        if not jobs or n_hosts == 0:
            return {j: 0 for j in jobs}
        total_w = sum(self._weights[j] for j in jobs)
        raw = {j: n_hosts * self._weights[j] / total_w for j in jobs}
        quota = {j: int(raw[j]) for j in jobs}
        left = n_hosts - sum(quota.values())
        # largest remainder, priority order as the tiebreak
        for j in sorted(jobs, key=lambda j: (-(raw[j] - quota[j]),
                                             jobs.index(j))):
            if left <= 0:
                break
            quota[j] += 1
            left -= 1
        # every active job gets at least one host while hosts suffice:
        # steal from the currently largest share (never below 1)
        for j in jobs[: n_hosts]:
            if quota[j] == 0:
                donor = max(jobs, key=lambda k: quota[k])
                if quota[donor] > 1:
                    quota[donor] -= 1
                    quota[j] = 1
        return quota

    def _target(self) -> Dict[str, List[int]]:
        """The ideal (deferral-blind) host assignment for the active jobs."""
        healthy = self._healthy_hosts()
        if self.fixed is not None:
            hset = set(healthy)
            return {
                j: [h for h in self.fixed.get(j, ()) if h in hset]
                for j in self._order
            }
        quota = self._quotas(len(healthy))
        assign: Dict[str, List[int]] = {}
        taken: Set[int] = set()
        hset = set(healthy)
        # stability first: keep what each job already holds, up to quota
        for j in self._share_order():
            keep = [h for h in self.granted[j].hosts if h in hset]
            assign[j] = keep[: quota[j]]
            taken.update(assign[j])
        free = [h for h in healthy if h not in taken]
        for j in self._share_order():
            while len(assign[j]) < quota[j] and free:
                assign[j].append(free.pop(0))
        return assign

    def _mk_lease(self, job: str, hosts: Tuple[int, ...],
                  version: int) -> Lease:
        physical = tuple(
            d for h in hosts for d in self.cluster.devices_of(h)
        )
        view = lease_view(self.cluster, hosts) if hosts else None
        return Lease(job=job, hosts=hosts, physical=physical, view=view,
                     version=version)

    def recarve(self) -> Dict[str, Lease]:
        """Recompute grants under the deferral rule; returns the grants.

        Called on admit/release/eviction AND after every :meth:`apply`
        (an apply releases physically-held blocks, which may promote a
        previously deferred expansion).
        """
        target = self._target()
        for j in self._order:
            held_elsewhere: Set[int] = set()
            for other, lease in self.applied.items():
                if other != j:
                    held_elsewhere.update(lease.hosts)
            want = target.get(j, [])
            current = self.granted[j].hosts
            grantable = tuple(
                h for h in want if h in current or h not in held_elsewhere
            )
            if len(grantable) < len(want):
                self.deferred_renewals += 1
            if grantable != current:
                self.granted[j] = self._mk_lease(
                    j, grantable, self.granted[j].version + 1
                )
                if grantable:
                    self.grants += 1
        self._update_revocations(target)
        self.check()
        return dict(self.granted)

    def _update_revocations(self, target: Dict[str, List[int]]) -> None:
        """Issue/refresh/clear revocations against slow-to-yield holders.

        A holder owes a revocation for every applied host it has been
        granted away from AND that some other job's target wants (a host
        merely shrunk away, wanted by nobody, needs no deadline).  The
        deadline is cut once, when the revocation is first issued — a
        re-carve that changes the contested set keeps the original clock.
        """
        if self.revoke_deadline is None:
            return
        target_of = {h: j for j, hosts in target.items() for h in hosts}
        for j in self._order:
            gone = set(self.applied[j].hosts) - set(self.granted[j].hosts)
            contested = frozenset(
                h for h in gone if target_of.get(h) not in (None, j)
            )
            pending = self.revocations.get(j)
            if not contested:
                if pending is not None:
                    del self.revocations[j]
                continue
            if pending is None:
                self.revocations[j] = Revocation(
                    job=j, hosts=contested, issued=self.clock,
                    deadline=self.clock + self.revoke_deadline,
                )
                self.revokes_issued += 1
            elif pending.hosts != contested:
                self.revocations[j] = dataclasses.replace(
                    pending, hosts=contested
                )
        for j in list(self.revocations):
            if j not in self._weights:
                del self.revocations[j]

    # ------------------------------------------------------------- lifecycle
    def needs_renewal(self, job: str) -> bool:
        return self.granted[job].version != self.applied[job].version

    def apply(self, job: str) -> Lease:
        """Job adopted its granted lease (step boundary): the blocks its
        old lease held are now physically free — promote any deferred
        expansions.  Adopting while a revocation is pending resolves it
        cooperatively (the job yielded the contested hosts in time)."""
        if job in self.revocations:
            del self.revocations[job]
            self.cooperative_yields += 1
        self.applied[job] = self.granted[job]
        self.recarve()
        return self.applied[job]

    # ------------------------------------------------------------ revocation
    def expired_revocations(self, now: Optional[int] = None) -> List[Revocation]:
        """Revocations whose deadline has passed at ``now`` (default: the
        arbiter clock) — the scheduler force-revokes each of these."""
        t = self.clock if now is None else now
        return [r for r in self.revocations.values() if t >= r.deadline]

    def force_revoke(self, job: str) -> Lease:
        """Deadline expired: strip the contested hosts from ``job``'s
        APPLIED lease — the blocks are physically reclaimed even though the
        holder never reached a step boundary.  The holder's runtime must
        treat this like a hard host loss on those blocks (rollback to its
        last snapshot and re-mesh on what its grant still holds).  The
        re-carve then promotes the deferred waiter immediately."""
        rev = self.revocations.pop(job, None)
        if rev is None:
            raise ValueError(f"no pending revocation for job {job!r}")
        lease = self.applied[job]
        kept = tuple(h for h in lease.hosts if h not in rev.hosts)
        self.applied[job] = self._mk_lease(job, kept, lease.version)
        self.forced_revokes += 1
        self.recarve()
        return self.applied[job]

    # ------------------------------------------------------------ invariants
    def check(self) -> None:
        """The fleet safety invariants; raises AssertionError on violation.

        * granted leases are pairwise disjoint, union ⊆ healthy devices
        * applied leases are pairwise disjoint, union ⊆ healthy devices
        * no job's grant contains a device another job still has applied
          (the deferral rule — the double-assignment regression guard)
        * co-tenants hold no hosts of their own, and each is bound to a
          job that IS a lease-holder (windows, not devices)
        """
        for tenant, host in self.co_tenants.items():
            assert tenant not in self._weights, (
                f"co-tenant {tenant!r} holds a lease of its own"
            )
            assert host in self._weights, (
                f"co-tenant {tenant!r} bound to released host {host!r}"
            )
        healthy = set(self.cluster.healthy_devices())
        for kind, leases in (("granted", self.granted),
                             ("applied", self.applied)):
            seen: Dict[int, str] = {}
            for j, lease in leases.items():
                for d in lease.devices:
                    assert d in healthy, (
                        f"{kind} lease of {j!r} holds evicted device {d}"
                    )
                    assert d not in seen, (
                        f"device {d} {kind} to both {seen[d]!r} and {j!r}"
                    )
                    seen[d] = j
        for j, lease in self.granted.items():
            for other, applied in self.applied.items():
                if other == j:
                    continue
                overlap = set(lease.devices) & set(applied.devices)
                assert not overlap, (
                    f"grant of {j!r} overlaps devices {sorted(overlap)} "
                    f"still applied to {other!r} (double-assignment)"
                )
        for j, rev in self.revocations.items():
            assert j in self._weights, (
                f"revocation pending for released job {j!r}"
            )
            assert rev.hosts <= set(self.applied[j].hosts), (
                f"revocation of {j!r} names hosts "
                f"{sorted(rev.hosts - set(self.applied[j].hosts))} "
                f"it no longer has applied"
            )

    def stats(self) -> Dict[str, int]:
        return {
            "grants": self.grants,
            "deferred_renewals": self.deferred_renewals,
            "evictions": self.evictions,
            "colocations": self.colocations,
            "co_tenants": len(self.co_tenants),
            "revokes_issued": self.revokes_issued,
            "cooperative_yields": self.cooperative_yields,
            "forced_revokes": self.forced_revokes,
            "pending_revocations": len(self.revocations),
        }
