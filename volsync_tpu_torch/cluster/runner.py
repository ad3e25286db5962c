"""What a data-plane entry point receives: ``JobContext``.

Ports ``JobContext`` of ``volsync_tpu/cluster/runner.py``. The rest of
that module (``JobRunner``, the kubelet analogue, and
``EntrypointCatalog``) belongs to the operator, which the port does not
have.

The port's context carries one more field than the reference's:
``device``, the device the entry point's engines run on. ``None`` (the
default) means CUDA through ``resolve_device``, which raises where CUDA
is absent; it never falls back to the CPU. The entry points pass it to
``resolve_device`` before they touch a tree or a connection. The reference's entry points
run on JAX's default device instead.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class JobContext:
    """What a data-plane entrypoint sees: its config and its mounts.

    ``cluster`` is provided for substrate interactions that a pod would do
    through its environment (e.g. a daemon publishing its bound port on its
    Service); data-plane logic must otherwise stick to env/mounts/secrets —
    that discipline preserves the reference's process boundary. Here it
    is duck-typed: anything with the reference cluster's ``try_get`` and
    ``update_status``.
    """

    name: str
    namespace: str
    env: dict
    mounts: dict            # mount name -> Path
    secrets: dict           # mount name -> {key: bytes}
    stop_event: threading.Event
    cluster: object = None
    attempt: int = 0
    kind: str = "Job"       # Job | Deployment — which object hosts us
    device: object = None   # None: CUDA (raises without it)

    def report_transfer(self, nbytes: int, seconds: float):
        """Data-plane self-report (the termination-message analogue): the
        entrypoint records how many bytes its transfer moved and how long
        the data path took; the control plane reads this off the completed
        Job and drives the throughput gauge + TransferCompleted event."""
        if self.cluster is None:
            return
        obj = self.cluster.try_get(self.kind, self.namespace, self.name)
        if obj is None:
            return
        obj.status.transfer_bytes = int(nbytes)
        obj.status.transfer_seconds = float(seconds)
        self.cluster.update_status(obj)
