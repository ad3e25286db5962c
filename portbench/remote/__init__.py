"""The loopback S3 remote of the restic cells: ``Remote`` starts
``remote/fakes3.py`` in a child process, asks it for a bucket's usage,
and reads objects back over signed HTTP for the reference."""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import re
import subprocess
import sys
from urllib.parse import quote

from portbench.remote.sigv4 import sign

ACCESS, SECRET, REGION = "portbench-access", "portbench-secret", "us-east-1"
EMPTY_SHA = hashlib.sha256(b"").hexdigest()


class Remote:
    def __init__(self):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.remote.fakes3", ACCESS, SECRET,
             REGION],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
        self.port = json.loads(self.proc.stdout.readline())["port"]
        self.host = f"127.0.0.1:{self.port}"

    def env(self, bucket: str) -> dict:
        """The Job environment a ReplicationSource's Secret gives restic."""
        return {"RESTIC_REPOSITORY": f"s3:http://{self.host}/{bucket}",
                "AWS_ACCESS_KEY_ID": ACCESS, "AWS_SECRET_ACCESS_KEY": SECRET,
                "AWS_DEFAULT_REGION": REGION}

    def _ask(self, op: str, bucket: str) -> dict:
        self.proc.stdin.write(json.dumps({"op": op, "bucket": bucket}) + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def usage(self, bucket: str) -> dict:
        return self._ask("usage", bucket)

    def drop(self, bucket: str) -> dict:
        return self._ask("drop", bucket)

    def _get(self, path: str, query: dict | None = None,
             headers: dict | None = None) -> tuple[int, bytes]:
        query = query or {}
        hdrs = sign("GET", path, query, self.host, EMPTY_SHA, ACCESS, SECRET,
                    REGION)
        hdrs.update(headers or {})
        qs = "&".join(f"{quote(k, safe='-_.~')}={quote(str(v), safe='-_.~')}"
                      for k, v in sorted(query.items()))
        conn = http.client.HTTPConnection(self.host, timeout=60)
        try:
            conn.request("GET", quote(path, safe="/-_.~") + ("?" + qs if qs else ""),
                         headers=hdrs)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get(self, bucket: str, key: str, offset: int | None = None,
            length: int | None = None) -> bytes:
        headers = None
        if offset is not None:
            headers = {"Range": f"bytes={offset}-{offset + length - 1}"}
        status, body = self._get(f"/{bucket}/{key}", headers=headers)
        if status not in (200, 206):
            raise KeyError(f"{bucket}/{key}: HTTP {status}")
        return body

    def list(self, bucket: str, prefix: str) -> list[str]:
        keys, token = [], ""
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            status, body = self._get(f"/{bucket}", query)
            if status != 200:
                raise KeyError(f"list {bucket}/{prefix}: HTTP {status}")
            text = body.decode()
            keys += [k.replace("&lt;", "<").replace("&gt;", ">")
                     .replace("&amp;", "&")
                     for k in re.findall(r"<Key>(.*?)</Key>", text)]
            m = re.search(r"<NextContinuationToken>(.*?)</NextContinuationToken>",
                          text)
            if not m:
                return keys
            token = m.group(1)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
                self.proc.stdin.flush()
            except BrokenPipeError:
                pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
