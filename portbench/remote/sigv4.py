"""AWS Signature Version 4 for the benchmark's loopback S3 remote and its
reader: the signing steps of the S3 API reference ("Signature
Calculations for the Authorization Header"), stdlib only."""

from __future__ import annotations

import datetime
import hashlib
import hmac
from urllib.parse import quote

ALGO = "AWS4-HMAC-SHA256"
SAFE = "-_.~"


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def signing_key(secret_key: str, datestamp: str, region: str) -> bytes:
    k = _hmac(("AWS4" + secret_key).encode(), datestamp.encode())
    k = _hmac(k, region.encode())
    k = _hmac(k, b"s3")
    return _hmac(k, b"aws4_request")


def canonical_query(query: dict) -> str:
    return "&".join(f"{quote(str(k), safe=SAFE)}={quote(str(v), safe=SAFE)}"
                    for k, v in sorted(query.items()))


def string_to_sign(method: str, uri: str, query: dict, host: str,
                   payload_hash: str, amz_date: str, region: str) -> str:
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    signed = ";".join(sorted(headers))
    canon = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    creq = "\n".join([method, quote(uri, safe="/" + SAFE),
                      canonical_query(query), canon, signed, payload_hash])
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    return "\n".join([ALGO, amz_date, scope,
                      hashlib.sha256(creq.encode()).hexdigest()])


def sign(method: str, uri: str, query: dict, host: str, payload_hash: str,
         access_key: str, secret_key: str, region: str) -> dict:
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ")
    sts = string_to_sign(method, uri, query, host, payload_hash, amz_date,
                         region)
    sig = hmac.new(signing_key(secret_key, amz_date[:8], region),
                   sts.encode(), hashlib.sha256).hexdigest()
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    return {"Authorization": f"{ALGO} Credential={access_key}/{scope}, "
                             "SignedHeaders=host;x-amz-content-sha256;"
                             f"x-amz-date, Signature={sig}",
            "x-amz-date": amz_date, "x-amz-content-sha256": payload_hash}
