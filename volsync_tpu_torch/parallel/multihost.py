"""Joining processes into one mesh with ``torch.distributed``.

Ports ``volsync_tpu/parallel/multihost.py``. ``init_distributed()``
joins this process to a process group (NCCL for CUDA shards, gloo for
CPU ones), after which ``make_mesh()`` / ``make_stream_mesh()`` span
every process and the sharded programs' collectives
(``parallel/mesh.py``) cross the process boundary. The fused sharded
engine's only cross-shard traffic is the all-gather of the 32-byte page
digests and the compacted candidate tables.

The contract is the reference's: idempotent; a second call with other
arguments raises; ``require=True`` turns a missing or failed join into
a hard failure; a soft failure does not latch. Two differences:

- configuration comes from the arguments or torchrun's standard
  environment, ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
  ``RANK`` (``LOCAL_RANK`` picks the card), where the reference reads
  ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``;
- torch has no pod auto-detection: with no configuration the soft path
  warns and returns the one-process summary, and ``require=True``
  raises.

``device`` picks the backend: None is CUDA (NCCL; raises without CUDA,
before any socket is opened), ``"cpu"`` is gloo.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

from volsync_tpu_torch import resolve_device

log = logging.getLogger("volsync_tpu_torch.multihost")

#: The joined group's state: (group, rank, world, this process's devices).
_JOINED: Optional[tuple] = None


def _default_local(dev: torch.device) -> list:
    """This process's devices for ``dev``: the given card, the card
    ``LOCAL_RANK`` names, or every CUDA device; one CPU device."""
    if dev.type != "cuda":
        return [dev]
    if dev.index is not None:
        return [dev]
    if os.environ.get("LOCAL_RANK"):
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_group():
    """The group ``init_distributed`` joined, or None."""
    return _JOINED[0] if _JOINED else None


def process_index() -> int:
    return _JOINED[1] if _JOINED else 0


def process_count() -> int:
    return _JOINED[2] if _JOINED else 1


def local_devices() -> list:
    """This process's devices: those it joined with, else every CUDA
    device (raises without CUDA)."""
    if _JOINED:
        return list(_JOINED[3])
    return _default_local(resolve_device(None))


def _summary(local: list) -> dict:
    return {"process_index": process_index(),
            "process_count": process_count(),
            "local_devices": len(local),
            "global_devices": len(local) * process_count()}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     require: bool = False, device=None) -> dict:
    """Join the process group of a multi-process mesh -> a summary
    (process_index, process_count, local/global device counts).

    ``coordinator_address`` is ``host:port``; with none, the torchrun
    environment triplet is read. ``require=True`` (the operator's
    VOLSYNC_DISTRIBUTED=1) refuses to continue alone when nothing is
    configured: peers that did join would wait at the rendezvous."""
    global _JOINED
    dev = resolve_device(device)
    args = (coordinator_address, num_processes, process_id, str(dev))
    prev = getattr(init_distributed, "_done_args", None)
    if prev is not None:
        if prev != args:
            raise RuntimeError(
                f"init_distributed already ran with {prev}; cannot "
                f"re-initialize with {args} (a process joins one group)")
        return _summary(_JOINED[3])
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    local = _default_local(dev)
    if not (coordinator_address or num_processes is not None):
        msg = ("no process group is configured (torch has no pod "
               "auto-detection): pass coordinator_address/num_processes/"
               "process_id or set MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK")
        if require:
            raise RuntimeError(
                "distributed mode was explicitly requested "
                "(VOLSYNC_DISTRIBUTED=1) but " + msg + "; refusing to run "
                "alone while peers wait at the rendezvous")
        log.warning("%s; continuing as one process", msg)
        # Do NOT latch: a later require=True must still fail hard.
        return _summary(local)
    # Explicit configuration: failures propagate (a worker quietly
    # running alone would leave its peers blocked at the rendezvous).
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise RuntimeError(
            f"distributed configuration is incomplete: coordinator "
            f"{coordinator_address!r}, processes {num_processes!r}, "
            f"process id {process_id!r}")
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.set_device(local[0])
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=300))
    _JOINED = (dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
               tuple(local))
    init_distributed._done_args = args
    return _summary(local)


def shutdown_distributed() -> None:
    """Leave the joined group (if any) and forget it, so the process
    may join another."""
    global _JOINED
    if _JOINED is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    _JOINED = None
    if hasattr(init_distributed, "_done_args"):
        del init_distributed._done_args
