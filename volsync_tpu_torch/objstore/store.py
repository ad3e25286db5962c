"""Key/value object stores: filesystem-backed and in-memory.

Ports ``volsync_tpu/objstore/store.py`` whole: the store protocol, the
module-level ``put_file``/``get_file``, the filesystem and in-memory
stores, ``LatencyStore``, ``open_store`` with every URL form the
reference serves (the network clients are the port's ``objstore/s3.py``,
``azure.py`` and ``swift.py``; ``b2:`` and ``gs:`` go through the S3
client) and ``unwrap``. Network stores come back inside
``ResilientStore``, with the fault-injection store under it when
``VOLSYNC_FAULT_SEED`` is set, as in the reference.

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
import time

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


def put_file(store, key: str, src) -> None:
    """Upload a local file as one object with bounded memory when the
    store supports it (multipart-upload analogue); whole-bytes fallback
    otherwise."""
    fn = getattr(store, "put_file", None)
    if fn is not None:
        fn(key, src)
    else:
        store.put(key, Path(src).read_bytes())


def get_file(store, key: str, dst) -> int:
    """Download an object into a local file with bounded memory when the
    store supports it; returns bytes written. The write is atomic
    (temp + rename) so a crashed transfer never leaves a torn file."""
    fn = getattr(store, "get_file", None)
    if fn is not None:
        return fn(key, dst)
    data = store.get(key)
    dst = Path(dst)
    tmp = dst.parent / f".volsync.tmp.{os.getpid()}.{dst.name}"
    tmp.write_bytes(data)
    tmp.replace(dst)
    return len(data)


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


class LatencyStore:
    """Wrap any ObjectStore with synthetic per-op latency (seconds) —
    the fake-cloud backend for pipeline benchmarks and backpressure
    tests (a MemObjectStore put is ~1 µs; a real store put is tens of
    ms, which is the regime the async upload stage exists for). Also
    counts ops and tracks high-water marks of concurrent puts/gets so
    tests can assert the upload window is honored and the restore
    drills can account store GETs (``pack_gets`` isolates data-pack
    fetches — the number the single-flight cache bounds). Zero-latency
    instances double as pure op counters."""

    def __init__(self, inner: ObjectStore, *, put_latency: float = 0.0,
                 get_latency: float = 0.0):
        self.inner = inner
        self.put_latency = put_latency
        self.get_latency = get_latency
        self.puts = 0
        self.max_concurrent_puts = 0
        self._active_puts = 0
        self.gets = 0            # get + get_range arrivals
        self.pack_gets = 0       # ... with a data/ key (any read)
        self.pack_fetches = 0    # whole-object data/ GETs only — the
        #                          count the single-flight cache bounds
        #                          (ranged tree-blob reads excluded)
        self.max_concurrent_gets = 0
        self._active_gets = 0
        self._lock = lockcheck.make_lock("objstore.latency")

    def _enter_get(self, key: str, whole: bool = False) -> None:
        with self._lock:
            self.gets += 1
            if key.startswith("data/"):
                self.pack_gets += 1
                if whole:
                    self.pack_fetches += 1
            self._active_gets += 1
            self.max_concurrent_gets = max(self.max_concurrent_gets,
                                           self._active_gets)

    def _exit_get(self) -> None:
        with self._lock:
            self._active_gets -= 1

    def put(self, key: str, data: PutBody) -> None:
        with self._lock:
            self.puts += 1
            self._active_puts += 1
            self.max_concurrent_puts = max(self.max_concurrent_puts,
                                           self._active_puts)
        try:
            if self.put_latency:
                time.sleep(self.put_latency)
            self.inner.put(key, data)
        finally:
            with self._lock:
                self._active_puts -= 1

    def put_if_absent(self, key: str, data: PutBody) -> bool:
        if self.put_latency:
            time.sleep(self.put_latency)
        return self.inner.put_if_absent(key, data)

    def get(self, key: str) -> bytes:
        self._enter_get(key, whole=True)
        try:
            if self.get_latency:
                time.sleep(self.get_latency)
            return self.inner.get(key)
        finally:
            self._exit_get()

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        self._enter_get(key)
        try:
            if self.get_latency:
                time.sleep(self.get_latency)
            return self.inner.get_range(key, offset, length)
        finally:
            self._exit_get()

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def list(self, prefix: str = "") -> Iterator[str]:
        return self.inner.list(prefix)

    def size(self, key: str) -> int:
        return self.inner.size(key)


def open_store(url: str, env: Optional[dict] = None) -> ObjectStore:
    """Open a store by repository URL with credentials from ``env`` —
    the Secret->env passthrough contract of
    controllers/mover/restic/mover.go:317-364.

    Supported forms (restic's URL vocabulary):
      ``s3:http://endpoint/bucket/prefix`` / ``s3://bucket/prefix``,
      ``azure:container:/path`` (SharedKey client, objstore/azure.py),
      ``b2:bucket:/path`` (via B2's S3-compatible endpoint),
      ``gs:bucket:/path`` (via GCS's S3-interop XML API, HMAC keys),
      ``swift:container:/path`` (Keystone v3 / v1 auth,
      objstore/swift.py), ``file:///path``, ``mem:``, or a bare path.

    Network backends come back wrapped in the shared retry policy +
    per-backend circuit breaker (resilience.ResilientStore; opt out
    with VOLSYNC_STORE_RESILIENCE=0). Local/mem stores are not wrapped
    — their failures are programming errors, not weather. Setting
    VOLSYNC_FAULT_SEED arms the deterministic fault-injection wrapper
    (objstore/faultstore.py) UNDER the resilience layer, exactly where
    real faults occur.
    """
    import os as _os

    from volsync_tpu_torch import envflags as _envflags
    from volsync_tpu_torch.resilience import ResilientStore

    def _resilient(store: ObjectStore, backend: str) -> ObjectStore:
        from volsync_tpu_torch.objstore.faultstore import maybe_wrap

        store = maybe_wrap(store)
        if not _envflags.store_resilience_enabled():
            return store
        return ResilientStore(store, backend=backend)

    env_map = dict(_os.environ if env is None else env)
    if url.startswith("s3:"):
        from volsync_tpu_torch.objstore.s3 import S3ObjectStore

        return _resilient(S3ObjectStore.from_url(url, env=env), "s3")
    if url.startswith("azure:"):
        from volsync_tpu_torch.objstore.azure import AzureBlobStore

        return _resilient(AzureBlobStore.from_url(url, env_map), "azure")
    if url.startswith("b2:"):
        return _resilient(_b2_store(url, env_map), "b2")
    if url.startswith("gs:"):
        return _resilient(_gs_store(url, env_map), "gs")
    if url.startswith("swift:") or url.startswith("swift-temp:"):
        from volsync_tpu_torch.objstore.swift import SwiftObjectStore

        return _resilient(SwiftObjectStore.from_url(url, env_map), "swift")
    if url.startswith("mem:"):
        from volsync_tpu_torch.objstore.faultstore import maybe_wrap

        return maybe_wrap(MemObjectStore())
    if url.startswith("file://"):
        from volsync_tpu_torch.objstore.faultstore import maybe_wrap

        return maybe_wrap(FsObjectStore(url[len("file://"):]))
    from volsync_tpu_torch.objstore.faultstore import maybe_wrap

    return maybe_wrap(FsObjectStore(url))


def unwrap(store: ObjectStore) -> ObjectStore:
    """Peel resilience/fault-injection wrappers off a store opened via
    open_store() — diagnostics and tests that need the concrete backend
    (wrappers all expose the wrapped store as ``.inner``)."""
    while hasattr(store, "inner"):
        store = store.inner
    return store


def _bucket_path(url: str, scheme: str) -> tuple[str, str]:
    """Split restic's ``scheme:bucket:/path`` (or ``scheme:bucket/path``)
    into (bucket, path)."""
    rest = url[len(scheme) + 1:]
    if ":" in rest:
        bucket, _, path = rest.partition(":")
    else:
        bucket, _, path = rest.partition("/")
    if not bucket:
        raise ValueError(f"{scheme} URL {url!r} has no bucket")
    return bucket, path.lstrip("/")


def _b2_store(url: str, env: dict) -> ObjectStore:
    """Backblaze B2 via its S3-compatible endpoint (restic's b2: URL,
    B2_ACCOUNT_ID/B2_ACCOUNT_KEY env family — mover.go:331-334). B2's
    S3 endpoint embeds the bucket's region, so it must be given:
    B2_S3_ENDPOINT explicitly, or derived from B2_REGION."""
    from volsync_tpu_torch.objstore.s3 import S3ObjectStore

    account = env.get("B2_ACCOUNT_ID", "")
    key = env.get("B2_ACCOUNT_KEY", "")
    if not account or not key:
        raise ValueError(
            "b2: repository needs B2_ACCOUNT_ID and B2_ACCOUNT_KEY in "
            "the repository Secret (restic/mover.go:331-334 passthrough); "
            "use the bucket's S3-compatible application key")
    endpoint = env.get("B2_S3_ENDPOINT")
    region = env.get("B2_REGION")
    if not endpoint and region:
        endpoint = f"https://s3.{region}.backblazeb2.com"
    if not endpoint:
        raise ValueError(
            "b2: repository needs B2_S3_ENDPOINT (e.g. "
            "https://s3.us-west-004.backblazeb2.com) or B2_REGION in "
            "the repository Secret — B2's S3-compatible endpoint is "
            "region-scoped")
    if not region:
        # B2 validates the SigV4 credential-scope region against the
        # endpoint, so it must match — derive it from the documented
        # hostname shape rather than defaulting to a wrong value.
        import re as _re

        m = _re.search(r"//s3\.([a-z0-9-]+)\.backblazeb2\.com", endpoint)
        if not m:
            raise ValueError(
                f"cannot derive the signing region from B2_S3_ENDPOINT="
                f"{endpoint!r}; set B2_REGION in the repository Secret")
        region = m.group(1)
    bucket, path = _bucket_path(url, "b2")
    return S3ObjectStore(endpoint, bucket, path, access_key=account,
                         secret_key=key, region=region)


def _gs_store(url: str, env: dict) -> ObjectStore:
    """Google Cloud Storage via the S3-interoperability XML API with
    HMAC keys (restic's gs: URL). Service-account JSON auth
    (GOOGLE_APPLICATION_CREDENTIALS) needs RS256 signing, which the
    stdlib cannot do — refuse with guidance instead of misconfiguring."""
    from volsync_tpu_torch.objstore.s3 import S3ObjectStore

    access = env.get("GS_ACCESS_KEY_ID") or env.get("AWS_ACCESS_KEY_ID", "")
    secret = (env.get("GS_SECRET_ACCESS_KEY")
              or env.get("AWS_SECRET_ACCESS_KEY", ""))
    if not access or not secret:
        hint = ""
        if env.get("GOOGLE_APPLICATION_CREDENTIALS") or \
                env.get("GOOGLE_PROJECT_ID"):
            hint = (" — service-account JSON auth is not supported "
                    "(needs RS256); create HMAC interoperability keys "
                    "for the bucket and set GS_ACCESS_KEY_ID/"
                    "GS_SECRET_ACCESS_KEY")
        raise ValueError(
            "gs: repository needs GS_ACCESS_KEY_ID and "
            f"GS_SECRET_ACCESS_KEY in the repository Secret{hint}")
    endpoint = env.get("GS_S3_ENDPOINT", "https://storage.googleapis.com")
    bucket, path = _bucket_path(url, "gs")
    return S3ObjectStore(endpoint, bucket, path, access_key=access,
                         secret_key=secret, region="auto")
