"""Device meshes of the port and the collectives its sharded programs use.

Ports ``volsync_tpu/parallel/mesh.py``: a ``(wave, seq)`` mesh (``wave``
batches independent streams, ``seq`` shards one stream's bytes) built
as squarely as possible by ``_factor_2d``. JAX's ``shard_map`` has no
torch counterpart, so a sharded program of the port is written as
explicit phases: a loop over this process's shards, then a collective
(the functions below), then a replicated stage on ``mesh.device``.

A ``Mesh`` is an object array of ``torch.device`` (devices may repeat:
four shards on ``cuda:0`` run every per-shard kernel, seam and gather
for real on one card) plus, when it spans processes, the
``torch.distributed`` group. Shard ``k`` (row-major over the array)
belongs to process ``k // n_local``; the processes must hold equal
shares. Each collective takes the local shards' tensors in order and
runs one of two ways:

- in process, by copies between the shards' devices;
- across processes, through ``torch.distributed`` (``all_gather`` by
  ``all_gather_into_tensor``, ``ppermute`` by ``batch_isend_irecv``,
  ``psum`` and ``pmax`` by ``all_reduce``); NCCL carries CUDA tensors,
  gloo CPU ones.

``stream_sharding`` and ``replicated`` take the place of the
reference's shardings: they split a ``[W, L]`` host array into the
local shards' tensors and place one tensor on the replicated device.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

WAVE_AXIS = "wave"
SEQ_AXIS = "seq"


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into (wave, seq) as square as possible, seq-major
    (a longer seq axis gives more intra-volume sharding)."""
    best = (1, n)
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = (f, n // f)
        f += 1
    return best


class Mesh:
    """Devices laid out over named axes, and the processes that own
    them.

    ``devices`` is an object array of ``torch.device`` whose shape
    matches ``axis_names``; ``group`` is the process group when the mesh
    spans processes (None in process); ``local`` lists the flat indices
    this process drives, in order."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, *,
                 group=None, local: Optional[Sequence[int]] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.local = tuple(range(devices.size) if local is None else local)
        if not self.local:
            raise ValueError("a mesh needs at least one local shard")
        self._flat = list(devices.reshape(-1))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> list:
        return [self._flat[k] for k in self.local]

    @property
    def device(self) -> torch.device:
        """Where this process runs the replicated stages: its first
        shard's device."""
        return self._flat[self.local[0]]

    def owner(self, k: int) -> int:
        """The rank that drives shard ``k``."""
        return k // len(self.local)

    def axis_index(self, k: int, axis: str) -> int:
        """Shard ``k``'s coordinate along ``axis``."""
        return int(np.unravel_index(k, self.devices.shape)[
            self.axis_names.index(axis)])

    def neighbor(self, k: int, axis: str, shift: int) -> int:
        """The shard ``shift`` steps along the ring of ``axis`` from
        ``k``."""
        coord = list(np.unravel_index(k, self.devices.shape))
        a = self.axis_names.index(axis)
        coord[a] = (coord[a] + shift) % self.devices.shape[a]
        return int(np.ravel_multi_index(coord, self.devices.shape))

    def __repr__(self) -> str:
        where = "in process" if self.group is None else \
            f"over {self.size // len(self.local)} processes"
        return (f"Mesh({self.shape}, {[str(d) for d in self._flat]}, "
                f"{where})")


def _as_devices(devices) -> list:
    return [torch.device(d) for d in devices]


def build_mesh(devices, shape: tuple, axis_names: tuple) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (the GLOBAL list when a
    process group is up; None: every CUDA device of every process)."""
    from volsync_tpu_torch.parallel import multihost

    group = multihost.process_group()
    world = multihost.process_count()
    if devices is None:
        devices = multihost.local_devices() * world
    devices = _as_devices(devices)
    n = len(devices)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty((n,), dtype=object)
    arr[:] = devices
    local = None
    if group is not None:
        if n % world:
            raise ValueError(f"{n} devices do not split evenly over "
                             f"{world} processes")
        per = n // world
        rank = multihost.process_index()
        local = range(rank * per, (rank + 1) * per)
    return Mesh(arr.reshape(shape), axis_names, group=group, local=local)


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple[int, int]] = None) -> Mesh:
    """Build the (wave, seq) mesh over ``devices`` (default: every CUDA
    device of every process; raises without CUDA)."""
    n = len(devices) if devices is not None else None
    if shape is None:
        if n is None:
            from volsync_tpu_torch.parallel import multihost

            n = len(multihost.local_devices()) * multihost.process_count()
        shape = _factor_2d(n)
    return build_mesh(devices, tuple(shape), (WAVE_AXIS, SEQ_AXIS))


def stream_sharding(mesh: Mesh, host: np.ndarray) -> list:
    """A [W, L] host array -> this process's shards of it, W over wave
    and L over seq: shard (w, s) is ``host[w*Wl:(w+1)*Wl,
    s*Sl:(s+1)*Sl]`` as a tensor on its device (its own allocation)."""
    wave, seq = mesh.devices.shape
    W, L = host.shape
    if W % wave or L % seq:
        raise ValueError(f"[{W}, {L}] does not split over the mesh "
                         f"{mesh.shape}")
    Wl, Sl = W // wave, L // seq
    out = []
    for k, dev in zip(mesh.local, mesh.local_devices):
        w, s = np.unravel_index(k, (wave, seq))
        piece = np.ascontiguousarray(host[w * Wl:(w + 1) * Wl,
                                          s * Sl:(s + 1) * Sl])
        out.append(torch.from_numpy(piece).to(dev, copy=True))  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
    return out


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` placed on the mesh's replicated device."""
    return torch.as_tensor(x).to(mesh.device)


# ---------------------------------------------------------------------------
# Collectives over the local shards' tensors
# ---------------------------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    """Where a cross-process collective's buffers live: the CPU under
    gloo, the first local card under NCCL."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "gloo":
        return torch.device("cpu")
    return mesh.device


def _wire(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` as a contiguous tensor on ``dev`` that a backend carries
    (bool travels as uint8)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.to(dev).contiguous()


def all_gather(mesh: Mesh, shards: list, device=None) -> torch.Tensor:
    """Every shard's tensor (all of one shape and dtype) stacked in
    shard order -> [mesh.size, ...] on ``device`` (default: the
    replicated device)."""
    device = mesh.device if device is None else torch.device(device)
    if mesh.group is None:
        return torch.stack([s.to(device) for s in shards])  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
    import torch.distributed as dist

    dtype = shards[0].dtype
    comm = _comm_device(mesh)
    local = torch.stack([_wire(s, comm) for s in shards])  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
    out = local.new_empty((mesh.size, *local.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, local, group=mesh.group)
    return out.to(device=device, dtype=dtype)


def _reduce(mesh: Mesh, shards: list, device, op: str) -> torch.Tensor:
    device = mesh.device if device is None else torch.device(device)
    vals = torch.stack([s.to(device) for s in shards])  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
    acc = vals.sum(dim=0) if op == "sum" else vals.amax(dim=0)
    if mesh.group is None:
        return acc
    import torch.distributed as dist

    buf = _wire(acc, _comm_device(mesh))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    return buf.to(device=device, dtype=acc.dtype)


def psum(mesh: Mesh, shards: list, device=None) -> torch.Tensor:
    """The sum over every shard of the mesh, on ``device``."""
    return _reduce(mesh, shards, device, "sum")


def pmax(mesh: Mesh, shards: list, device=None) -> torch.Tensor:
    """The elementwise maximum over every shard, on ``device``."""
    return _reduce(mesh, shards, device, "max")


def ppermute(mesh: Mesh, shards: list, shift: int,
             axis: str = SEQ_AXIS) -> list:
    """A ring shift along ``axis``: local shard ``k`` receives the
    tensor of shard ``neighbor(k, axis, -shift)`` (``shift=+1`` moves
    every tensor one step right, ``-1`` one step left), on its own
    device. Across processes the sends and receives of one call go as
    one ``batch_isend_irecv``; each pair of ranks matches its messages in
    destination-shard order, which NCCL needs and gloo's tags agree
    with."""
    mine = dict(zip(mesh.local, shards))
    devs = dict(zip(mesh.local, mesh.local_devices))
    out: dict = {}
    sends, recvs = [], {}
    if mesh.group is not None:
        import torch.distributed as dist

        comm = _comm_device(mesh)
    for k in mesh.local:
        d = mesh.neighbor(k, axis, shift)
        if d in mine:
            out[d] = mine[k].to(devs[d])  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
        else:
            sends.append((d, k))
    ops = [dist.P2POp(dist.isend, _wire(mine[k], comm), mesh.owner(d),  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
                      mesh.group, d) for d, k in sorted(sends)]
    for k in mesh.local:
        s = mesh.neighbor(k, axis, -shift)
        if s not in mine:
            buf = torch.empty(mine[k].shape, device=comm,  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
                              dtype=torch.uint8 if mine[k].dtype == torch.bool
                              else mine[k].dtype)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(s),
                                  mesh.group, k))
            recvs[k] = buf
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for k, buf in recvs.items():
        out[k] = buf.to(device=devs[k], dtype=mine[k].dtype)  # lint: ignore[VL502] per-shard collective: one copy or message a local mesh shard
    return [out[k] for k in mesh.local]
