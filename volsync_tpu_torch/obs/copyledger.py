"""Copy ledger: accounting for the sanctioned host copies of the data
plane.

Ports ``volsync_tpu/obs/copyledger.py``. The data plane moves payload
bytes as memoryviews over pooled buffers; the few copies that stay
(moving bytes onto the device, the pending-tail carry between chunker
segments, materializing an iovec for network-backend bodies, ...) call
``record_copy(site, nbytes)`` at their site:

- ``volsync_copy_bytes_total{site}`` of the port's in-memory
  ``metrics.GLOBAL`` counts them, one fixed label value per site;
- a process-local table feeds ``copies_by_site()`` (also
  ``copy_totals()``, the name the port used before) so benches compute
  ``copy_ratio`` = host bytes copied / payload bytes moved;
- when a sampled trace is active, a flight-recorder instant event
  attributes the copy to the stage span that paid it
  (``obs.tracing.trace_instant``).

Site names are literal dotted lowercase strings, like span names.
"""

from __future__ import annotations

from collections import defaultdict

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs.tracing import trace_instant

_lock = lockcheck.make_lock("obs.copyledger")
_by_site: defaultdict = defaultdict(int)

# Every site allowed to call record_copy (the reference's set).
SANCTIONED_SITES = frozenset({
    "chunker.ingest",      # read()-only source copied into the pooled segment
    "chunker.tail_carry",  # sub-min_size tail carried between segments
    "device.pad",          # host buffer staged into the padded device lane
    "device.stage",        # segment rows gathered for the batched kernel
    "verify.stage",        # restore verify staging onto the device
    "objstore.assemble",   # iovec joined for a contiguous-transport backend
    "repo.buffered_read",  # blob read back while still in the write pipeline
    "svc.frame",           # gRPC frame materialization (protobuf wants bytes)
    "ec.encode",           # field-lane packing + shard blob materialization
    "ec.decode",           # device->host shard copy-out + body assembly
})


def record_copy(site: str, nbytes: int) -> None:
    """Account ``nbytes`` host bytes copied at sanctioned site
    ``site``. Cheap enough for per-segment frequency; the
    flight-recorder event is a no-op unless a sampled trace is active."""
    if nbytes <= 0:
        return
    GLOBAL_METRICS.copy_bytes.labels(site=site).inc(nbytes)
    with _lock:
        _by_site[site] += nbytes
    trace_instant("copy", site=site, nbytes=nbytes)


def copies_by_site() -> dict:
    """``{site: bytes copied}`` since process start / last reset."""
    with _lock:
        return dict(_by_site)


copy_totals = copies_by_site


def total_copied() -> int:
    with _lock:
        return sum(_by_site.values())


def reset_copies() -> None:
    """Zero the process-local table (bench rounds, tests). The counter
    family is monotonic by contract and is left alone."""
    with _lock:
        _by_site.clear()
