"""Multi-tenant fleet scheduling: many sessions, one cluster, one planner
(port of ``repro/fleet``).

See DESIGN.md §14.  :class:`FleetScheduler` admits N jobs (plan-only
training sessions + real serving sessions) onto one
:class:`repro_torch.core.placement.ClusterSpec`; a :class:`LeaseArbiter` carves
the host→device map into disjoint per-job leases whose canonical views
all plan through ONE shared :class:`repro_torch.core.plancache.PlanCache`.
"""

from .jobs import JobHandle, JobSpec
from .lease import Lease, LeaseArbiter, lease_view
from .scheduler import FleetCallbacks, FleetConfig, FleetScheduler

__all__ = [
    "FleetCallbacks",
    "FleetConfig",
    "FleetScheduler",
    "JobHandle",
    "JobSpec",
    "Lease",
    "LeaseArbiter",
    "lease_view",
]
