"""Azure Blob Storage client (SharedKey auth over HTTP, stdlib-only).

Ports ``volsync_tpu/objstore/azure.py`` whole, on the port's store
helpers and retry policy.

The reference's restic mover passes the AZURE_ACCOUNT_NAME /
AZURE_ACCOUNT_KEY env family straight through to its engine
(controllers/mover/restic/mover.go:341-345; repository URLs of the form
``azure:container:/path``). This is the wire-correct equivalent:
BlockBlob PUT/GET/Range-GET/HEAD/DELETE and container LIST with marker
pagination, signed with the 2015+ SharedKey scheme. The string-to-sign
builder is shared verbatim with the in-process verifying fake
(objstore/fakeazure.py), so a signing bug cannot hide — the same
pattern as the S3 client + fakes3 pair.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import threading
import xml.etree.ElementTree as ET
from typing import Iterator, Optional
from urllib.parse import quote, urlsplit

from volsync_tpu_torch.objstore.store import NoSuchKey, _check_key
from volsync_tpu_torch.resilience import RetryPolicy

API_VERSION = "2021-08-06"
_SAFE = "-_.~/"


def string_to_sign(method: str, account: str, path: str, query: dict,
                   headers: dict, content_length: int) -> str:
    """SharedKey string-to-sign (version 2015-02-21+: empty
    Content-Length when zero). ``headers`` must already carry the
    x-ms-* set; standard headers not in the fixed list are empty."""
    xms = {k.lower(): v for k, v in headers.items()
           if k.lower().startswith("x-ms-")}
    canon_headers = "".join(f"{k}:{xms[k]}\n" for k in sorted(xms))
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    return "\n".join([
        method,
        "",  # Content-Encoding
        "",  # Content-Language
        str(content_length) if content_length else "",
        "",  # Content-MD5
        headers.get("Content-Type", ""),
        "",  # Date (x-ms-date is used instead)
        "",  # If-Modified-Since
        "",  # If-Match
        headers.get("If-None-Match", ""),
        "",  # If-Unmodified-Since
        headers.get("Range", ""),
    ]) + "\n" + canon_headers + canon_resource


def sign(key_b64: str, sts: str) -> str:
    digest = hmac.new(base64.b64decode(key_b64), sts.encode("utf-8"),
                      hashlib.sha256).digest()
    return base64.b64encode(digest).decode()


class AzureError(RuntimeError):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status


class AzureBlobStore:
    """ObjectStore over one container + key prefix."""

    def __init__(self, endpoint: str, account: str, key_b64: str,
                 container: str, prefix: str = ""):
        u = urlsplit(endpoint)
        self.scheme = u.scheme or "https"
        self.netloc = u.netloc or u.path
        self.account = account
        self.key_b64 = key_b64
        self.container = container
        self.prefix = prefix.strip("/")
        self._local = threading.local()
        # Transport-level policy: one reconnect on a stale keep-alive
        # socket (the old inline loop's budget); op-level retry layers
        # on in ResilientStore via open_store().
        self._transport_policy = RetryPolicy.from_env(
            "objstore.azure.transport", max_attempts=2, deadline=None,
            base_delay=0.02, max_delay=0.25)

    @classmethod
    def from_url(cls, url: str, env: dict) -> "AzureBlobStore":
        """``azure:container:/path`` (restic's URL form) with the
        AZURE_* env family. AZURE_ENDPOINT overrides the public cloud
        endpoint (tests point it at the in-process fake; sovereign
        clouds set their suffix through it too)."""
        account = env.get("AZURE_ACCOUNT_NAME", "")
        key = env.get("AZURE_ACCOUNT_KEY", "")
        if not account or not key:
            raise ValueError(
                "azure: repository needs AZURE_ACCOUNT_NAME and "
                "AZURE_ACCOUNT_KEY in the repository Secret "
                "(restic/mover.go:341-345 passthrough)")
        rest = url[len("azure:"):]
        container, _, prefix = rest.partition(":")
        if not container:
            raise ValueError(f"azure URL {url!r} has no container")
        prefix = prefix.lstrip("/")
        endpoint = env.get(
            "AZURE_ENDPOINT", f"https://{account}.blob.core.windows.net")
        return cls(endpoint, account, key, container, prefix)

    # -- request core -------------------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            c = (http.client.HTTPSConnection if self.scheme == "https"
                 else http.client.HTTPConnection)
            conn = self._local.conn = c(self.netloc, timeout=60)
        return conn

    def _path(self, key: str = "") -> str:
        parts = [self.container]
        full = "/".join(p for p in (self.prefix, key) if p)
        if full:
            parts.append(full)
        return "/" + "/".join(parts)

    def _request(self, method: str, key: str = "",
                 query: Optional[dict] = None, body: bytes = b"",
                 headers: Optional[dict] = None, *, want_body: bool = True,
                 path: Optional[str] = None) -> tuple[int, bytes, dict]:
        import datetime

        query = query or {}
        path = path if path is not None else self._path(key)
        hdrs = dict(headers or {})
        hdrs["x-ms-date"] = datetime.datetime.now(
            datetime.timezone.utc).strftime("%a, %d %b %Y %H:%M:%S GMT")
        hdrs["x-ms-version"] = API_VERSION
        sts = string_to_sign(method, self.account, path, query, hdrs,
                             len(body))
        hdrs["Authorization"] = (
            f"SharedKey {self.account}:{sign(self.key_b64, sts)}")
        qs = "&".join(f"{quote(k, safe=_SAFE)}={quote(str(v), safe=_SAFE)}"
                      for k, v in sorted(query.items()))
        target = quote(path, safe=_SAFE) + (f"?{qs}" if qs else "")
        def one_attempt() -> tuple[int, bytes, dict]:
            conn = self._conn()
            try:
                conn.request(method, target, body=body or None,
                             headers=hdrs)
                resp = conn.getresponse()
                data = resp.read() if want_body else resp.read()
                return resp.status, data, dict(resp.getheaders())
            except (http.client.HTTPException, ConnectionError, OSError):
                # stale keep-alive: drop it so the retry dials fresh
                self._local.conn = None
                raise

        return self._transport_policy.call(one_attempt)

    # -- ObjectStore protocol ----------------------------------------------

    def put(self, key: str, data) -> None:
        from volsync_tpu_torch.objstore.store import body_bytes

        _check_key(key)
        st, body, _ = self._request(
            "PUT", key, body=body_bytes(data),
            headers={"x-ms-blob-type": "BlockBlob"})
        if st not in (201,):
            raise AzureError(st, body)

    def put_if_absent(self, key: str, data) -> bool:
        from volsync_tpu_torch.objstore.store import body_bytes

        _check_key(key)
        st, body, _ = self._request(
            "PUT", key, body=body_bytes(data),
            headers={"x-ms-blob-type": "BlockBlob", "If-None-Match": "*"})
        if st == 201:
            return True
        if st in (409, 412):  # BlobAlreadyExists / condition not met
            return False
        raise AzureError(st, body)

    def get(self, key: str) -> bytes:
        _check_key(key)
        st, body, _ = self._request("GET", key)
        if st == 404:
            raise NoSuchKey(key)
        if st != 200:
            raise AzureError(st, body)
        return body

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        _check_key(key)
        if length <= 0:
            return b""
        st, body, _ = self._request(
            "GET", key,
            headers={"Range": f"bytes={offset}-{offset + length - 1}"})
        if st == 404:
            raise NoSuchKey(key)
        if st not in (200, 206):
            raise AzureError(st, body)
        return body

    def exists(self, key: str) -> bool:
        _check_key(key)
        st, _, _ = self._request("HEAD", key, want_body=False)
        if st == 200:
            return True
        if st == 404:
            return False
        raise AzureError(st, b"")

    def size(self, key: str) -> int:
        _check_key(key)
        st, _, hdrs = self._request("HEAD", key, want_body=False)
        if st == 404:
            raise NoSuchKey(key)
        if st != 200:
            raise AzureError(st, b"")
        return int(hdrs.get("Content-Length", "0"))

    def delete(self, key: str) -> None:
        _check_key(key)
        st, body, _ = self._request("DELETE", key)
        if st not in (202, 404):
            raise AzureError(st, body)

    def list(self, prefix: str = "") -> Iterator[str]:
        # Always keep the "/" after a store prefix (the S3 backend's
        # form): joining without it makes list("") match sibling
        # containers of the prefix and mis-strip their keys.
        full = f"{self.prefix}/{prefix}" if self.prefix else prefix
        strip = len(self.prefix) + 1 if self.prefix else 0
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list"}
            if full:
                query["prefix"] = full
            if marker:
                query["marker"] = marker
            st, body, _ = self._request("GET", query=query,
                                        path=f"/{self.container}")
            if st != 200:
                raise AzureError(st, body)
            root = ET.fromstring(body)
            for name in root.iter("Name"):
                yield (name.text or "")[strip:]
            marker = (root.findtext("NextMarker") or "").strip()
            if not marker:
                return
