"""In-process S3-compatible server — the MinIO analogue.

Ports ``volsync_tpu/objstore/fakes3.py`` whole; it verifies signatures
with the port's ``objstore/s3.py`` signing helpers.

The reference's e2e tier deploys MinIO as the S3 endpoint for the
restic/rclone movers (hack/run-minio.sh); this serves the same role for
the TPU build's tests without containers: an HTTP server implementing the
object subset the movers use (PUT/GET/Range-GET/HEAD/DELETE/
ListObjectsV2 with pagination), storing objects in memory, and
**verifying every request's SigV4 signature** against its configured
credentials — so client-side signing bugs fail loudly in tests instead
of surfacing only against real S3.
"""

from __future__ import annotations

import hashlib
import hmac
import http.server
import threading
from typing import Optional
from urllib.parse import parse_qsl, unquote, urlsplit
from xml.sax.saxutils import escape

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.objstore.s3 import signing_key, string_to_sign


class FakeS3Server:
    def __init__(self, *, access_key: str = "test-access",
                 secret_key: str = "test-secret",
                 region: str = "us-east-1", host: str = "127.0.0.1",
                 port: int = 0, max_keys: int = 1000):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.max_keys = max_keys
        self._objects: dict[tuple[str, str], bytes] = {}  # (bucket, key)
        self._lock = lockcheck.make_lock("objstore.fakes3")
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, body: bytes = b"",
                       headers: Optional[dict] = None):
                self.send_response(code)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _verify(self, body: bytes) -> bool:
                auth = self.headers.get("Authorization", "")
                amz_date = self.headers.get("x-amz-date", "")
                payload_hash = self.headers.get("x-amz-content-sha256", "")
                if not auth.startswith("AWS4-HMAC-SHA256 "):
                    return False
                if hashlib.sha256(body).hexdigest() != payload_hash:
                    return False
                fields = dict(
                    part.strip().split("=", 1)
                    for part in auth[len("AWS4-HMAC-SHA256 "):].split(",")
                )
                cred = fields.get("Credential", "")
                if not cred.startswith(outer.access_key + "/"):
                    return False
                u = urlsplit(self.path)
                query = dict(parse_qsl(u.query, keep_blank_values=True))
                sts, _ = string_to_sign(
                    self.command, unquote(u.path), query,
                    self.headers.get("Host", ""), payload_hash, amz_date,
                    outer.region)
                want = hmac.new(
                    signing_key(outer.secret_key, amz_date[:8], outer.region),
                    sts.encode(), hashlib.sha256).hexdigest()
                return hmac.compare_digest(want, fields.get("Signature", ""))

            def _route(self):
                u = urlsplit(self.path)
                parts = unquote(u.path).lstrip("/").split("/", 1)
                bucket = parts[0]
                key = parts[1] if len(parts) > 1 else ""
                query = dict(parse_qsl(u.query, keep_blank_values=True))
                return bucket, key, query

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or 0)
                return self.rfile.read(n) if n else b""

            def do_PUT(self):  # noqa: N802
                body = self._read_body()
                if not self._verify(body):
                    return self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
                bucket, key, _ = self._route()
                if not key:
                    return self._reply(200)  # CreateBucket
                with outer._lock:
                    if (self.headers.get("If-None-Match") == "*"
                            and (bucket, key) in outer._objects):
                        return self._reply(
                            412, b"<Error>PreconditionFailed</Error>")
                    outer._objects[(bucket, key)] = body
                self._reply(200)

            def do_GET(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
                bucket, key, query = self._route()
                if not key:
                    return self._list(bucket, query)
                with outer._lock:
                    data = outer._objects.get((bucket, key))
                if data is None:
                    return self._reply(404, b"<Error>NoSuchKey</Error>")
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo_s, _, hi_s = rng[len("bytes="):].partition("-")
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else len(data) - 1
                    part = data[lo: hi + 1]
                    return self._reply(206, part, {
                        "Content-Range":
                            f"bytes {lo}-{lo + len(part) - 1}/{len(data)}"})
                self._reply(200, data)

            def do_HEAD(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403)
                bucket, key, _ = self._route()
                with outer._lock:
                    data = outer._objects.get((bucket, key))
                if data is None:
                    return self._reply(404)
                # BaseHTTPRequestHandler suppresses bodies for HEAD; the
                # Content-Length header carries the size.
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()

            def do_DELETE(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403)
                bucket, key, _ = self._route()
                with outer._lock:
                    outer._objects.pop((bucket, key), None)
                self._reply(204)

            def _list(self, bucket: str, query: dict):
                prefix = query.get("prefix", "")
                token = query.get("continuation-token", "")
                with outer._lock:
                    keys = sorted(k for (b, k) in outer._objects
                                  if b == bucket and k.startswith(prefix))
                start = 0
                if token:
                    # token = last key of the previous page
                    import bisect

                    start = bisect.bisect_right(keys, token)
                page = keys[start: start + outer.max_keys]
                truncated = start + len(page) < len(keys)
                xml = ["<?xml version='1.0'?><ListBucketResult>"]
                xml.append(f"<IsTruncated>{'true' if truncated else 'false'}"
                           "</IsTruncated>")
                if truncated:
                    xml.append(f"<NextContinuationToken>{escape(page[-1])}"
                               "</NextContinuationToken>")
                for k in page:
                    xml.append(f"<Contents><Key>{escape(k)}</Key></Contents>")
                xml.append("</ListBucketResult>")
                self._reply(200, "".join(xml).encode(),
                            {"Content-Type": "application/xml"})

            def log_message(self, *args):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.endpoint = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="fake-s3")

    def start(self) -> "FakeS3Server":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
