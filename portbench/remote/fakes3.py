"""The benchmark's S3 remote: an in-memory S3 subset on 127.0.0.1 that
verifies every request's SigV4 signature, run as a child process (the
MinIO of upstream's ``hack/run-minio.sh``).

    python -m portbench.remote.fakes3 ACCESS SECRET REGION

prints ``{"port": N}`` on its first line, then answers one JSON command
a line on standard input: ``{"op": "usage", "bucket": B}`` ->
``{"objects": n, "bytes": total}``, ``{"op": "drop", "bucket": B}`` ->
``{"dropped": n}``, ``{"op": "stop"}`` (or end of input) -> exits.
It serves PUT (with ``If-None-Match: *``), GET (and ranges), HEAD,
DELETE and ListObjectsV2 with pagination. Stdlib only.
"""

from __future__ import annotations

import bisect
import hashlib
import hmac
import http.server
import json
import sys
import threading
from urllib.parse import parse_qsl, unquote, urlsplit
from xml.sax.saxutils import escape

from portbench.remote.sigv4 import signing_key, string_to_sign

MAX_KEYS = 1000


class Store:
    def __init__(self, access: str, secret: str, region: str):
        self.access, self.secret, self.region = access, secret, region
        self.objects: dict[tuple[str, str], bytes] = {}
        self.lock = threading.Lock()

    def usage(self, bucket: str) -> dict:
        with self.lock:
            sizes = [len(v) for (b, _), v in self.objects.items() if b == bucket]
        return {"objects": len(sizes), "bytes": sum(sizes)}

    def drop(self, bucket: str) -> dict:
        with self.lock:
            keys = [k for k in self.objects if k[0] == bucket]
            for k in keys:
                del self.objects[k]
        return {"dropped": len(keys)}


def make_handler(store: Store):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes = b"", headers=None):
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _verify(self, body: bytes) -> bool:
            auth = self.headers.get("Authorization", "")
            amz_date = self.headers.get("x-amz-date", "")
            payload_hash = self.headers.get("x-amz-content-sha256", "")
            if not auth.startswith("AWS4-HMAC-SHA256 "):
                return False
            if hashlib.sha256(body).hexdigest() != payload_hash:
                return False
            fields = dict(part.strip().split("=", 1) for part in
                          auth[len("AWS4-HMAC-SHA256 "):].split(","))
            if not fields.get("Credential", "").startswith(store.access + "/"):
                return False
            u = urlsplit(self.path)
            query = dict(parse_qsl(u.query, keep_blank_values=True))
            sts = string_to_sign(self.command, unquote(u.path), query,
                                 self.headers.get("Host", ""), payload_hash,
                                 amz_date, store.region)
            want = hmac.new(signing_key(store.secret, amz_date[:8],
                                        store.region),
                            sts.encode(), hashlib.sha256).hexdigest()
            return hmac.compare_digest(want, fields.get("Signature", ""))

        def _route(self):
            u = urlsplit(self.path)
            parts = unquote(u.path).lstrip("/").split("/", 1)
            return (parts[0], parts[1] if len(parts) > 1 else "",
                    dict(parse_qsl(u.query, keep_blank_values=True)))

        def do_PUT(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(n) if n else b""
            if not self._verify(body):
                return self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
            bucket, key, _ = self._route()
            if not key:
                return self._reply(200)
            with store.lock:
                if (self.headers.get("If-None-Match") == "*"
                        and (bucket, key) in store.objects):
                    return self._reply(412, b"<Error>PreconditionFailed</Error>")
                store.objects[(bucket, key)] = body
            self._reply(200)

        def do_GET(self):  # noqa: N802
            if not self._verify(b""):
                return self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
            bucket, key, query = self._route()
            if not key:
                return self._list(bucket, query)
            with store.lock:
                data = store.objects.get((bucket, key))
            if data is None:
                return self._reply(404, b"<Error>NoSuchKey</Error>")
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                lo_s, _, hi_s = rng[len("bytes="):].partition("-")
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else len(data) - 1
                part = data[lo: hi + 1]
                return self._reply(206, part, {
                    "Content-Range": f"bytes {lo}-{lo + len(part) - 1}/{len(data)}"})
            self._reply(200, data)

        def do_HEAD(self):  # noqa: N802
            if not self._verify(b""):
                return self._reply(403)
            bucket, key, _ = self._route()
            with store.lock:
                data = store.objects.get((bucket, key))
            if data is None:
                return self._reply(404)
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()

        def do_DELETE(self):  # noqa: N802
            if not self._verify(b""):
                return self._reply(403)
            bucket, key, _ = self._route()
            with store.lock:
                store.objects.pop((bucket, key), None)
            self._reply(204)

        def _list(self, bucket: str, query: dict):
            prefix = query.get("prefix", "")
            token = query.get("continuation-token", "")
            with store.lock:
                keys = sorted(k for (b, k) in store.objects
                              if b == bucket and k.startswith(prefix))
            start = bisect.bisect_right(keys, token) if token else 0
            page = keys[start: start + MAX_KEYS]
            truncated = start + len(page) < len(keys)
            xml = ["<?xml version='1.0'?><ListBucketResult>",
                   f"<IsTruncated>{'true' if truncated else 'false'}"
                   "</IsTruncated>"]
            if truncated:
                xml.append(f"<NextContinuationToken>{escape(page[-1])}"
                           "</NextContinuationToken>")
            xml += [f"<Contents><Key>{escape(k)}</Key></Contents>"
                    for k in page]
            xml.append("</ListBucketResult>")
            self._reply(200, "".join(xml).encode(),
                        {"Content-Type": "application/xml"})

        def log_message(self, *args):
            pass

    return Handler


def main(argv: list[str]) -> int:
    access, secret, region = argv
    store = Store(access, secret, region)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                            make_handler(store))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    print(json.dumps({"port": httpd.server_address[1]}), flush=True)
    try:
        for line in sys.stdin:
            cmd = json.loads(line)
            if cmd["op"] == "stop":
                break
            out = getattr(store, cmd["op"])(cmd["bucket"])
            print(json.dumps(out), flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
