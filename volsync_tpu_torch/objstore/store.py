"""Key/value object stores: filesystem-backed and in-memory.

Ports ``volsync_tpu/objstore/store.py``: the store protocol, the
filesystem and in-memory stores, ``open_store`` and ``unwrap``. The
network backends (``objstore/s3.py``, ``azure.py``, ``swift.py``, and
``b2:``/``gs:`` through the S3 client) are not ported: ``open_store``
raises for their URL schemes instead of serving them from a local
store. A set ``VOLSYNC_FAULT_SEED`` wraps the local stores in the
fault-injection store (``objstore/faultstore.py``), as in the
reference.

Keys are slash-separated paths (``data/ab/abcdef...``). Writes are
atomic (temp file + rename) so a crashed backup never leaves a torn
object — the repository layer relies on this for its crash-consistency
story (objects are immutable once visible, like S3 PUTs).

``put``/``put_if_absent`` bodies are a *PutBody*: one buffer (bytes,
bytearray, memoryview) OR an iovec — a list/tuple of such buffers whose
logical concatenation is the object. The iovec form is the zero-copy
seal path's contract: the repository hands the pack down as its sealed
segment list and NO monolithic pack-body ``bytes`` is ever built on the
write path. Backends that can scatter-write (the filesystem store's
``writelines``) consume the parts directly; backends whose transport
needs one contiguous body (HTTP stores, the in-memory map) materialize
via ``body_bytes`` — the ledger-sanctioned ``objstore.assemble`` copy
site (docs/performance.md, "Zero-copy data movement").
"""

from __future__ import annotations

import os
import threading

from pathlib import Path
from typing import Iterator, Optional, Protocol, Sequence, Union

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.obs import record_copy

#: A put() body: one buffer or an iovec of buffers (see module doc).
PutBody = Union[bytes, bytearray, memoryview, Sequence[Union[
    bytes, bytearray, memoryview]]]


def body_parts(data: PutBody) -> Sequence:
    """Normalize a PutBody to its buffer parts (no copying)."""
    if isinstance(data, (list, tuple)):
        return data
    return (data,)


def body_len(data: PutBody) -> int:
    """Total byte length of a PutBody (no copying)."""
    if isinstance(data, (list, tuple)):
        return sum(len(p) for p in data)
    return len(data)


def body_bytes(data: PutBody) -> bytes:
    """One contiguous ``bytes`` for a PutBody — the single sanctioned
    materialization for backends whose transport needs it. Pass-through
    (copy-free) when the body already IS ``bytes``."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, (list, tuple)):
        out = b"".join(data)
    else:
        out = bytes(data)
    record_copy("objstore.assemble", len(out))
    return out


class ObjectStore(Protocol):
    def put(self, key: str, data: PutBody) -> None: ...
    def put_if_absent(self, key: str, data: PutBody) -> bool:
        """Atomic create-if-absent; False = the key already exists.
        Required: Repository.init's no-clobber guarantee rests on it."""
        ...
    def get(self, key: str) -> bytes: ...
    def get_range(self, key: str, offset: int, length: int) -> bytes: ...
    def exists(self, key: str) -> bool: ...
    def delete(self, key: str) -> None: ...
    def list(self, prefix: str = "") -> Iterator[str]: ...
    def size(self, key: str) -> int: ...


class NoSuchKey(KeyError):
    pass


def _check_key(key: str):
    parts = key.split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise ValueError(f"invalid object key {key!r}")


class FsObjectStore:
    """Directory-backed store; the shape of the S3 bucket the reference's
    movers write to, minus the network."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        _check_key(key)
        return self.root / key

    def put(self, key: str, data: PutBody) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".tmp.{os.getpid()}.{threading.get_ident()}.{p.name}"
        # writelines scatter-writes the iovec parts straight to the OS —
        # the seal path's segment list never becomes one Python blob.
        with open(tmp, "wb") as f:
            f.writelines(body_parts(data))
        tmp.rename(p)  # atomic visibility

    def put_if_absent(self, key: str, data: PutBody) -> bool:
        """Atomic create-if-absent (hard link fails if the target
        exists): the primitive Repository.init uses so two movers racing
        to initialize one repository can never clobber each other's
        config/salt."""
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".tmp.{os.getpid()}.{threading.get_ident()}.{p.name}"
        with open(tmp, "wb") as f:
            f.writelines(body_parts(data))
        try:
            os.link(tmp, p)
            return True
        except FileExistsError:
            return False
        finally:
            tmp.unlink(missing_ok=True)

    def get(self, key: str) -> bytes:
        try:
            return self._path(key).read_bytes()
        except FileNotFoundError:
            raise NoSuchKey(key) from None

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        """Ranged read (S3 Range-GET analogue) — how blob fetches avoid
        pulling whole packs."""
        try:
            with open(self._path(key), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            raise NoSuchKey(key) from None

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> None:
        try:
            self._path(key).unlink()
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> Iterator[str]:
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if f.startswith(".tmp."):
                    continue
                key = str(Path(dirpath, f).relative_to(self.root))
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    yield key

    def size(self, key: str) -> int:
        try:
            return self._path(key).stat().st_size
        except FileNotFoundError:
            raise NoSuchKey(key) from None

    def put_file(self, key: str, src) -> None:
        import shutil

        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".tmp.{os.getpid()}.{threading.get_ident()}.{p.name}"
        shutil.copyfile(src, tmp)
        tmp.rename(p)

    def get_file(self, key: str, dst) -> int:
        import shutil

        dst = Path(dst)
        tmp = dst.parent / f".volsync.tmp.{os.getpid()}.{dst.name}"
        try:
            shutil.copyfile(self._path(key), tmp)
        except FileNotFoundError:
            raise NoSuchKey(key) from None
        n = tmp.stat().st_size
        tmp.replace(dst)
        return n


class MemObjectStore:
    """In-memory store for unit tests (the fake backend of SURVEY.md §4)."""

    def __init__(self):
        self._objs: dict[str, bytes] = {}
        self._lock = lockcheck.make_lock("objstore.mem")

    def put(self, key: str, data: PutBody) -> None:
        _check_key(key)
        body = body_bytes(data)
        with self._lock:
            self._objs[key] = body

    def put_if_absent(self, key: str, data: PutBody) -> bool:
        _check_key(key)
        body = body_bytes(data)
        with self._lock:
            if key in self._objs:
                return False
            self._objs[key] = body
            return True

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._objs[key]
            except KeyError:
                raise NoSuchKey(key) from None

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        return self.get(key)[offset : offset + length]

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objs

    def delete(self, key: str) -> None:
        with self._lock:
            self._objs.pop(key, None)

    def list(self, prefix: str = "") -> Iterator[str]:
        with self._lock:
            keys = sorted(self._objs)
        for k in keys:
            if k.startswith(prefix):
                yield k

    def size(self, key: str) -> int:
        return len(self.get(key))


#: URL schemes of the network backends and the reference module each
#: needs; the port refuses them until those modules are ported.
_UNPORTED_SCHEMES = {
    "s3:": "volsync_tpu/objstore/s3.py",
    "azure:": "volsync_tpu/objstore/azure.py",
    "b2:": "volsync_tpu/objstore/s3.py (B2's S3-compatible endpoint)",
    "gs:": "volsync_tpu/objstore/s3.py (GCS's S3 interoperability API)",
    "swift:": "volsync_tpu/objstore/swift.py",
    "swift-temp:": "volsync_tpu/objstore/swift.py",
}


class UnportedStoreError(NotImplementedError):
    """A store the reference serves whose module the port lacks."""


def open_store(url: str, env: Optional[dict] = None) -> ObjectStore:
    """Open a store by repository URL: ``file:///path``, ``mem:`` or a
    bare path (the reference's local forms, wrapped as there: a set
    VOLSYNC_FAULT_SEED puts them inside a ``FaultStore``).

    Network URLs (``s3:``, ``azure:``, ``b2:``, ``gs:``, ``swift:``)
    raise ``UnportedStoreError`` naming the reference module still to
    port. ``env`` is the credential map of the network forms; the local
    ones ignore it."""
    from volsync_tpu_torch.objstore.faultstore import maybe_wrap

    for scheme, module in _UNPORTED_SCHEMES.items():
        if url.startswith(scheme):
            raise UnportedStoreError(
                f"{scheme} repositories need {module}, which "
                "volsync_tpu_torch does not port yet")
    if url.startswith("mem:"):
        return maybe_wrap(MemObjectStore())
    if url.startswith("file://"):
        return maybe_wrap(FsObjectStore(url[len("file://"):]))
    return maybe_wrap(FsObjectStore(url))


def unwrap(store: ObjectStore) -> ObjectStore:
    """Peel wrappers (``ResilientStore``, ``FaultStore``) off a store —
    diagnostics and tests that need the concrete backend (wrappers all
    expose the wrapped store as ``.inner``)."""
    while hasattr(store, "inner"):
        store = store.inner
    return store
