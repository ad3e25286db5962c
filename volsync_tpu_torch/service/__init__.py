"""mover-jax on the port: the card's chunk/hash data plane as a gRPC
service (ports ``volsync_tpu/service/``), with the multi-tenant service
plane in front of it: admission control (service/admission.py),
weighted deficit-round-robin scheduling with deadline classes
(service/scheduler.py), the tenancy model (service/tenants.py), and the
fleet replica plane on top — N fenced server replicas on one repository
with headroom routing (service/fleet.py) and a continuous GC service
(service/gc.py).
"""

from volsync_tpu_torch.service.admission import (
    AdmissionController,
    AdmissionRejected,
    StreamTicket,
)
from volsync_tpu_torch.service.client import (
    MoverJaxClient,
    ShedError,
    open_client,
)
from volsync_tpu_torch.service.fleet import (
    FleetRouter,
    Replica,
    ReplicaGroup,
    ReplicaHeartbeat,
    ReplicaStamp,
)
from volsync_tpu_torch.service.gc import ContinuousGC
from volsync_tpu_torch.service.scheduler import (
    DeadlineExceeded,
    SchedulerStopped,
    SegmentScheduler,
    parse_deadline_classes,
)
from volsync_tpu_torch.service.server import MoverJaxServer
from volsync_tpu_torch.service.tenants import (
    TenantConfig,
    TenantRegistry,
    sanitize_tenant,
)

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "ContinuousGC",
    "DeadlineExceeded",
    "FleetRouter",
    "MoverJaxClient",
    "MoverJaxServer",
    "Replica",
    "ReplicaGroup",
    "ReplicaHeartbeat",
    "ReplicaStamp",
    "SchedulerStopped",
    "SegmentScheduler",
    "ShedError",
    "StreamTicket",
    "TenantConfig",
    "TenantRegistry",
    "open_client",
    "parse_deadline_classes",
    "sanitize_tenant",
]
