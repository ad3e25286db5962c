"""In-process Azure Blob server — the Azurite analogue.

Ports ``volsync_tpu/objstore/fakeazure.py`` whole; it verifies
signatures with the port's ``objstore/azure.py`` builder.

Serves the BlockBlob subset the movers use (PUT, conditional PUT,
GET/Range-GET, HEAD, DELETE, container LIST with marker pagination),
storing blobs in memory and **verifying every request's SharedKey
signature** with the same string-to-sign builder the client uses
(objstore/azure.py) — client-side signing bugs fail loudly in tests
instead of surfacing only against real Azure, the same design as
fakes3.FakeS3Server for the MinIO role (hack/run-minio.sh analogue).
"""

from __future__ import annotations

import hmac
import http.server
import threading
from typing import Optional
from urllib.parse import parse_qsl, unquote, urlsplit
from xml.sax.saxutils import escape

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.objstore.azure import sign, string_to_sign


class FakeAzureServer:
    def __init__(self, *, account: str = "testaccount",
                 key_b64: str = "dGVzdC1henVyZS1rZXk=",  # "test-azure-key"
                 host: str = "127.0.0.1", port: int = 0,
                 max_results: int = 500):
        self.account = account
        self.key_b64 = key_b64
        self.max_results = max_results
        self._blobs: dict[tuple[str, str], bytes] = {}  # (container, name)
        self._lock = lockcheck.make_lock("objstore.fakeazure")
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
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _verify(self, body: bytes) -> bool:
                auth = self.headers.get("Authorization", "")
                want_prefix = f"SharedKey {outer.account}:"
                if not auth.startswith(want_prefix):
                    return False
                u = urlsplit(self.path)
                query = dict(parse_qsl(u.query, keep_blank_values=True))
                headers = {k: v for k, v in self.headers.items()}
                sts = string_to_sign(self.command, outer.account,
                                     unquote(u.path), query, headers,
                                     len(body))
                want = sign(outer.key_b64, sts)
                return hmac.compare_digest(
                    want, auth[len(want_prefix):])

            def _route(self):
                u = urlsplit(self.path)
                parts = unquote(u.path).lstrip("/").split("/", 1)
                container = parts[0]
                name = parts[1] if len(parts) > 1 else ""
                query = dict(parse_qsl(u.query, keep_blank_values=True))
                return container, name, query

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or 0)
                return self.rfile.read(n) if n else b""

            def do_PUT(self):  # noqa: N802
                body = self._read_body()
                if not self._verify(body):
                    return self._reply(403, b"AuthenticationFailed")
                container, name, _ = self._route()
                if not name:
                    return self._reply(201)  # create container
                with outer._lock:
                    if (self.headers.get("If-None-Match") == "*"
                            and (container, name) in outer._blobs):
                        return self._reply(409, b"BlobAlreadyExists")
                    outer._blobs[(container, name)] = body
                self._reply(201)

            def do_GET(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403, b"AuthenticationFailed")
                container, name, query = self._route()
                if query.get("comp") == "list":
                    return self._list(container, query)
                with outer._lock:
                    blob = outer._blobs.get((container, name))
                if blob is None:
                    return self._reply(404, b"BlobNotFound")
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[len("bytes="):].partition("-")
                    lo = int(lo)
                    hi = min(int(hi), len(blob) - 1) if hi else len(blob) - 1
                    part = blob[lo: hi + 1]
                    return self._reply(
                        206, part, {"Content-Range":
                                    f"bytes {lo}-{hi}/{len(blob)}"})
                self._reply(200, blob)

            def do_HEAD(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403)
                container, name, _ = self._route()
                with outer._lock:
                    blob = outer._blobs.get((container, name))
                if blob is None:
                    return self._reply(404)
                self._reply(200, blob)  # _reply suppresses HEAD bodies

            def do_DELETE(self):  # noqa: N802
                if not self._verify(b""):
                    return self._reply(403, b"AuthenticationFailed")
                container, name, _ = self._route()
                with outer._lock:
                    existed = outer._blobs.pop((container, name),
                                               None) is not None
                self._reply(202 if existed else 404)

            def _list(self, container: str, query: dict):
                prefix = query.get("prefix", "")
                marker = query.get("marker", "")
                with outer._lock:
                    names = sorted(
                        n for c, n in outer._blobs
                        if c == container and n.startswith(prefix)
                        and n > marker)
                page = names[: outer.max_results]
                next_marker = (page[-1]
                               if len(names) > outer.max_results else "")
                blobs = "".join(
                    f"<Blob><Name>{escape(n)}</Name></Blob>" for n in page)
                body = (
                    "<?xml version='1.0' encoding='utf-8'?>"
                    f"<EnumerationResults><Blobs>{blobs}</Blobs>"
                    f"<NextMarker>{escape(next_marker)}</NextMarker>"
                    "</EnumerationResults>").encode()
                self._reply(200, body,
                            {"Content-Type": "application/xml"})

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       Handler)
        self.endpoint = (f"http://{self._server.server_address[0]}:"
                         f"{self._server.server_address[1]}")

    def start(self) -> "FakeAzureServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fake-azure",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
