"""In-process Swift + Keystone server — the "Swift All In One" analogue.

Ports ``volsync_tpu/objstore/fakeswift.py`` whole.

Serves the object API subset the movers use (PUT, conditional PUT,
GET/Range-GET, HEAD, DELETE, container LIST with marker pagination)
plus BOTH auth families the client speaks: Keystone v3 password auth
(``POST /v3/auth/tokens`` — credentials verified against the
configured user, token minted per auth, catalog pointing back at this
server) and legacy v1 auth (``GET /auth/v1.0`` with
X-Auth-User/X-Auth-Key). Every storage request's ``X-Auth-Token`` is
checked against the minted-token set, so a client auth bug fails
loudly in tests instead of surfacing only against real Swift — the
same design as fakeazure.FakeAzureServer / fakes3.FakeS3Server.

``revoke_tokens()`` invalidates everything outstanding to exercise the
client's mid-run 401 re-auth path (token expiry).
"""

from __future__ import annotations

import http.server
import json
import secrets
import threading
from typing import Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from volsync_tpu_torch.analysis import lockcheck

_ACCOUNT = "AUTH_test"


class FakeSwiftServer:
    def __init__(self, *, username: str = "testuser",
                 password: str = "testpass", project: str = "testproj",
                 region: str = "RegionOne", host: str = "127.0.0.1",
                 port: int = 0, max_results: int = 500):
        self.username = username
        self.password = password
        self.project = project
        self.region = region
        self.max_results = max_results
        self._objs: dict[tuple[str, str], bytes] = {}  # (container, name)
        self._tokens: set = set()
        self._lock = lockcheck.make_lock("objstore.fakeswift")
        self.auth_count = 0  # minted tokens (v1 + v3) — re-auth proof
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

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or 0)
                return self.rfile.read(n) if n else b""

            def _mint(self) -> str:
                token = secrets.token_hex(16)
                with outer._lock:
                    outer._tokens.add(token)
                    outer.auth_count += 1
                return token

            def _authed(self) -> bool:
                token = self.headers.get("X-Auth-Token", "")
                with outer._lock:
                    return token in outer._tokens

            # -- auth endpoints -------------------------------------------

            def _keystone(self, body: bytes):
                try:
                    req = json.loads(body)
                    pw = req["auth"]["identity"]["password"]["user"]
                    scope = req["auth"]["scope"]["project"]
                except (ValueError, KeyError, TypeError):
                    return self._reply(400, b"malformed auth request")
                if (pw.get("name") != outer.username
                        or pw.get("password") != outer.password
                        or scope.get("name") != outer.project):
                    return self._reply(401, b"invalid credentials")
                token = self._mint()
                catalog = [{
                    "type": "object-store",
                    "endpoints": [
                        # A foreign-region endpoint FIRST: a client that
                        # ignores OS_REGION_NAME dials a dead port and
                        # fails the test.
                        {"interface": "public", "region": "OtherRegion",
                         "url": "http://127.0.0.1:1/v1/AUTH_other"},
                        {"interface": "admin", "region": outer.region,
                         "url": outer.endpoint + "/v1/ADMIN_wrong"},
                        {"interface": "public", "region": outer.region,
                         "url": outer.endpoint + f"/v1/{_ACCOUNT}"},
                    ],
                }]
                self._reply(201, json.dumps(
                    {"token": {"catalog": catalog}}).encode(),
                    {"X-Subject-Token": token,
                     "Content-Type": "application/json"})

            def _v1_auth(self):
                if (self.headers.get("X-Auth-User") != outer.username
                        or self.headers.get("X-Auth-Key")
                        != outer.password):
                    return self._reply(401, b"invalid v1 credentials")
                token = self._mint()
                self._reply(200, b"", {
                    "X-Auth-Token": token,
                    "X-Storage-Url": outer.endpoint + f"/v1/{_ACCOUNT}"})

            # -- routing --------------------------------------------------

            def _route(self):
                u = urlsplit(self.path)
                path = unquote(u.path).lstrip("/")
                query = dict(parse_qsl(u.query, keep_blank_values=True))
                parts = path.split("/", 3)  # v1 / account / container / obj
                if len(parts) < 3 or parts[0] != "v1" \
                        or parts[1] != _ACCOUNT:
                    return None
                container = parts[2]
                name = parts[3] if len(parts) > 3 else ""
                return container, name, query

            def do_POST(self):  # noqa: N802
                body = self._read_body()
                if urlsplit(self.path).path.rstrip("/").endswith(
                        "/auth/tokens"):
                    return self._keystone(body)
                self._reply(404)

            def do_PUT(self):  # noqa: N802
                body = self._read_body()
                if not self._authed():
                    return self._reply(401, b"bad or expired token")
                routed = self._route()
                if routed is None:
                    return self._reply(404)
                container, name, _ = routed
                if not name:
                    return self._reply(201)  # create container
                with outer._lock:
                    if (self.headers.get("If-None-Match") == "*"
                            and (container, name) in outer._objs):
                        return self._reply(412, b"object exists")
                    outer._objs[(container, name)] = body
                self._reply(201)

            def do_GET(self):  # noqa: N802
                if urlsplit(self.path).path.rstrip("/").endswith(
                        "/auth/v1.0"):
                    return self._v1_auth()
                if not self._authed():
                    return self._reply(401, b"bad or expired token")
                routed = self._route()
                if routed is None:
                    return self._reply(404)
                container, name, query = routed
                if not name:
                    return self._list(container, query)
                with outer._lock:
                    obj = outer._objs.get((container, name))
                if obj is None:
                    return self._reply(404, b"not found")
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[len("bytes="):].partition("-")
                    lo = int(lo)
                    hi = min(int(hi), len(obj) - 1) if hi else len(obj) - 1
                    part = obj[lo: hi + 1]
                    return self._reply(
                        206, part, {"Content-Range":
                                    f"bytes {lo}-{hi}/{len(obj)}"})
                self._reply(200, obj)

            def do_HEAD(self):  # noqa: N802
                if not self._authed():
                    return self._reply(401)
                routed = self._route()
                if routed is None:
                    return self._reply(404)
                container, name, _ = routed
                with outer._lock:
                    obj = outer._objs.get((container, name))
                if obj is None:
                    return self._reply(404)
                self._reply(200, obj)  # _reply suppresses HEAD bodies

            def do_DELETE(self):  # noqa: N802
                if not self._authed():
                    return self._reply(401)
                routed = self._route()
                if routed is None:
                    return self._reply(404)
                container, name, _ = routed
                with outer._lock:
                    existed = outer._objs.pop((container, name),
                                              None) is not None
                self._reply(204 if existed else 404)

            def _list(self, container: str, query: dict):
                prefix = query.get("prefix", "")
                marker = query.get("marker", "")
                with outer._lock:
                    names = sorted(
                        n for c, n in outer._objs
                        if c == container and n.startswith(prefix)
                        and n > marker)
                page = names[: outer.max_results]
                if not page:
                    return self._reply(204)
                body = ("\n".join(page) + "\n").encode()
                self._reply(200, body, {"Content-Type": "text/plain"})

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       Handler)
        self.endpoint = (f"http://{self._server.server_address[0]}:"
                         f"{self._server.server_address[1]}")

    def revoke_tokens(self):
        """Simulate token expiry: every outstanding token now 401s."""
        with self._lock:
            self._tokens.clear()

    def start(self) -> "FakeSwiftServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fake-swift",
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
