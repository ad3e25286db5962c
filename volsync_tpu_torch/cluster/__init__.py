"""Cluster substrate: typed object store + storage provider + job runner.

The reference is a Kubernetes operator; its substrate (API server, CSI
driver, kubelet) is external. The framework is standalone, so this
package provides the equivalent substrate natively:

- ``objects``   — the resource kinds the movers build (Volume, VolumeSnapshot,
                  Job, Service, Secret, ServiceAccount, Deployment, Event),
                  mirroring what the reference's movers create via
                  controller-runtime (SURVEY.md §2 #10-13).
- ``cluster``   — an in-process API server: CRUD with resource versions,
                  labels/owner refs, label-selector deletes, and watch
                  notification. Controller tests run against it exactly the
                  way the reference's envtest suites run against a real
                  kube-apiserver with no kubelet (SURVEY.md §4 tier 2).
- ``storage``   — directory-backed volume provisioner with snapshot/clone
                  (hardlink PiT images), the CSI analogue.
- ``runner``    — the kubelet analogue: executes Job/Deployment payloads
                  from a registered entrypoint catalog in worker threads.
                  Optional — envtest-style tests flip Job status manually.
- ``sessions``  — supervised accelerator sessions: TTL leases with
                  keepalive, the ACQUIRING/HEALTHY/DEGRADED/RECYCLING
                  supervisor with fencing epochs, and the serialized
                  verify-then-measure bench queue (docs/sessions.md).

Ports ``volsync_tpu/cluster/__init__.py``: the same names, with
``TorchSessionBackend`` in the place of ``JaxSessionBackend``.
"""

from volsync_tpu_torch.cluster.objects import (
    Volume,
    VolumeSpec,
    VolumeStatus,
    VolumeSnapshot,
    VolumeSnapshotSpec,
    VolumeSnapshotStatus,
    Job,
    JobSpec,
    JobStatus,
    Service,
    ServicePort,
    ServiceSpec,
    ServiceStatus,
    Secret,
    ServiceAccount,
    Deployment,
    DeploymentSpec,
    DeploymentStatus,
    Event,
)
from volsync_tpu_torch.cluster.cluster import Cluster, NotFound, Conflict
from volsync_tpu_torch.cluster.storage import StorageProvider
from volsync_tpu_torch.cluster.runner import JobRunner, EntrypointCatalog
from volsync_tpu_torch.cluster.sessions import (
    BenchQueue,
    FakeSessionBackend,
    FencedError,
    TorchSessionBackend,
    Lease,
    SessionBusy,
    SessionError,
    SessionSupervisor,
)

__all__ = [
    "Volume",
    "VolumeSpec",
    "VolumeStatus",
    "VolumeSnapshot",
    "VolumeSnapshotSpec",
    "VolumeSnapshotStatus",
    "Job",
    "JobSpec",
    "JobStatus",
    "Service",
    "ServicePort",
    "ServiceSpec",
    "ServiceStatus",
    "Secret",
    "ServiceAccount",
    "Deployment",
    "DeploymentSpec",
    "DeploymentStatus",
    "Event",
    "Cluster",
    "NotFound",
    "Conflict",
    "StorageProvider",
    "JobRunner",
    "EntrypointCatalog",
    "BenchQueue",
    "FakeSessionBackend",
    "FencedError",
    "TorchSessionBackend",
    "Lease",
    "SessionBusy",
    "SessionError",
    "SessionSupervisor",
]
