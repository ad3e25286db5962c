"""The port's network object stores against the JAX package's, on the CPU.

Every case of ``tests/test_s3.py`` (but the operator-driven restic e2e)
and ``tests/test_cloud_backends.py`` runs for three pairings of client
and in-process fake server: the port's client on the port's fake, the
port's client on the reference's fake, and the reference's client on
the port's fake. Each fake recomputes every SigV4 / SharedKey signature
and checks every Swift token, so a signing or auth difference between
the packages fails here. ``open_store`` opens each network URL form as
the port's client class inside ``ResilientStore`` (``VOLSYNC_STORE_
RESILIENCE=0`` removes it, ``VOLSYNC_FAULT_SEED`` puts a ``FaultStore``
under it), as the reference's does. A repository written through a fake
S3 by one package opens, checks and restores byte-identical under the
other, and the port's restic entry backs up and restores through an
``s3:`` URL with the AWS env only.
"""

import http.client
import threading
from contextlib import ExitStack
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from volsync_tpu import resilience as jres
from volsync_tpu.cluster.runner import JobContext as JJobContext
from volsync_tpu.engine.backup import TreeBackup as JTreeBackup
from volsync_tpu.engine.restore import restore_snapshot as jrestore
from volsync_tpu.movers.restic import entry as jrestic
from volsync_tpu.objstore import azure as jazure
from volsync_tpu.objstore import fakeazure as jfakeazure
from volsync_tpu.objstore import fakes3 as jfakes3
from volsync_tpu.objstore import fakeswift as jfakeswift
from volsync_tpu.objstore import faultstore as jfault
from volsync_tpu.objstore import s3 as js3
from volsync_tpu.objstore import store as jstore
from volsync_tpu.objstore import swift as jswift
from volsync_tpu.repo import repository as jrepo
from volsync_tpu_torch import resilience as tres
from volsync_tpu_torch.cluster.runner import JobContext
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.movers.restic import entry as trestic
from volsync_tpu_torch.objstore import azure as tazure
from volsync_tpu_torch.objstore import fakeazure as tfakeazure
from volsync_tpu_torch.objstore import fakes3 as tfakes3
from volsync_tpu_torch.objstore import fakeswift as tfakeswift
from volsync_tpu_torch.objstore import faultstore as tfault
from volsync_tpu_torch.objstore import s3 as ts3
from volsync_tpu_torch.objstore import store as tstore
from volsync_tpu_torch.objstore import swift as tswift
from volsync_tpu_torch.repo import repository as trepo

torch.set_num_threads(1)

PKGS = {
    "port": SimpleNamespace(s3=ts3, fakes3=tfakes3, azure=tazure,
                            fakeazure=tfakeazure, swift=tswift,
                            fakeswift=tfakeswift, store=tstore,
                            fault=tfault, res=tres),
    "ref": SimpleNamespace(s3=js3, fakes3=jfakes3, azure=jazure,
                           fakeazure=jfakeazure, swift=jswift,
                           fakeswift=jfakeswift, store=jstore,
                           fault=jfault, res=jres),
}
#: (client package, fake server package)
PAIRINGS = [("port", "port"), ("port", "ref"), ("ref", "port")]
CHUNKER = {"min_size": 1024, "avg_size": 4096, "max_size": 16384, "seed": 7}


@pytest.fixture(autouse=True)
def _fresh_port_breakers():
    """The port's circuit breakers are process-wide like the
    reference's: a bad-credentials case must not open them for the
    next."""
    yield
    tres.reset_breakers()


@pytest.fixture(params=PAIRINGS, ids=[f"{c}-client-{f}-fake"
                                      for c, f in PAIRINGS])
def pair(request):
    """(client package, fake package) namespaces."""
    client, fake = request.param
    return PKGS[client], PKGS[fake]


# -- S3 (tests/test_s3.py) ---------------------------------------------------

@pytest.fixture
def s3(pair):
    cli, fk = pair
    with fk.fakes3.FakeS3Server() as srv:
        yield cli, srv


def _s3(cli, srv, prefix="repo", secret=None):
    return cli.s3.S3ObjectStore(srv.endpoint, "bucket", prefix,
                                access_key=srv.access_key,
                                secret_key=secret or srv.secret_key)


def test_s3_put_get_roundtrip(s3):
    cli, srv = s3
    store = _s3(cli, srv)
    store.put("data/ab/abcd", b"hello s3")
    assert store.get("data/ab/abcd") == b"hello s3"
    assert store.exists("data/ab/abcd")
    assert store.size("data/ab/abcd") == 8
    assert not store.exists("data/ab/missing")
    with pytest.raises(cli.store.NoSuchKey):
        store.get("data/ab/missing")


def test_s3_range_get(s3):
    cli, srv = s3
    store = _s3(cli, srv)
    store.put("k", bytes(range(200)))
    assert store.get_range("k", 10, 5) == bytes(range(10, 15))
    assert store.get_range("k", 190, 50) == bytes(range(190, 200))
    assert store.get_range("k", 0, 0) == b""


def test_s3_delete_idempotent(s3):
    cli, srv = s3
    store = _s3(cli, srv)
    store.put("k", b"x")
    store.delete("k")
    store.delete("k")  # no error on missing (S3 semantics)
    assert not store.exists("k")


def test_s3_list_with_pagination(s3):
    cli, srv = s3
    srv.max_keys = 7  # several pages
    store = _s3(cli, srv, "p")
    keys = [f"objects/{i:03d}" for i in range(23)]
    for k in keys:
        store.put(k, b"v")
    assert sorted(store.list("objects/")) == keys
    assert sorted(store.list()) == keys


def test_s3_prefix_isolation(s3):
    cli, srv = s3
    a, b = _s3(cli, srv, "a"), _s3(cli, srv, "b")
    a.put("k", b"from-a")
    b.put("k", b"from-b")
    assert a.get("k") == b"from-a"
    assert list(b.list()) == ["k"]


def test_s3_bad_signature_rejected(s3):
    cli, srv = s3
    bad = _s3(cli, srv, "", secret="wrong-secret")
    with pytest.raises(cli.s3.S3Error) as ei:
        bad.put("k", b"x")
    assert ei.value.status == 403


def test_s3_open_store_url_forms(s3):
    cli, srv = s3
    env = {"AWS_ACCESS_KEY_ID": srv.access_key,
           "AWS_SECRET_ACCESS_KEY": srv.secret_key}
    s1 = cli.store.open_store(f"s3:{srv.endpoint}/bucket/pfx", env=env)
    s1.put("k", b"v1")
    s2 = cli.store.open_store("s3://bucket/pfx",
                              env={**env, "AWS_S3_ENDPOINT": srv.endpoint})
    assert s2.get("k") == b"v1"


def test_s3_exists_raises_on_auth_error_not_false(s3):
    """A non-404 must never read as 'absent': Repository.init keys its
    don't-clobber guard on exists()."""
    cli, srv = s3
    bad = _s3(cli, srv, "", secret="wrong-secret")
    with pytest.raises(cli.s3.S3Error):
        bad.exists("config")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_s3_schemeless_restic_url_form(pkg):
    s = PKGS[pkg].s3.S3ObjectStore.from_url(
        "s3:s3.amazonaws.com/bucket/repo",
        env={"AWS_ACCESS_KEY_ID": "a", "AWS_SECRET_ACCESS_KEY": "s"})
    assert (s.scheme, s.host, s.bucket, s.prefix) == (
        "https", "s3.amazonaws.com", "bucket", "repo")


def test_s3_file_transfer_streams(s3, tmp_path, rng):
    cli, srv = s3
    store = _s3(cli, srv, "xfer")
    src = tmp_path / "big.bin"
    data = rng.bytes(3 * 1024 * 1024)
    src.write_bytes(data)
    cli.store.put_file(store, "objects/big", src)
    assert store.size("objects/big") == len(data)
    dst = tmp_path / "out.bin"
    assert cli.store.get_file(store, "objects/big", dst) == len(data)
    assert dst.read_bytes() == data
    with pytest.raises(cli.store.NoSuchKey):
        store.get_file("objects/missing", tmp_path / "nope")
    assert not (tmp_path / "nope").exists()


class _DyingResponse:
    """Streams a prefix of the body into the sink, then the connection
    drops (IncompleteRead, which the transport policy retries)."""

    status = 200

    def __init__(self, prefix: bytes):
        self._chunks = [prefix]

    def read(self, n=-1):
        if self._chunks:
            return self._chunks.pop()
        raise http.client.IncompleteRead(b"")

    def getheaders(self):
        return []


class _DyingConn:
    def __init__(self, prefix: bytes):
        self._prefix = prefix

    def request(self, *args, **kwargs):
        pass

    def getresponse(self):
        return _DyingResponse(self._prefix)


def test_s3_get_file_rewinds_sink_on_mid_body_retry(s3, monkeypatch,
                                                    tmp_path):
    """A drop after the sink took bytes must not replay them: the retry
    rewinds a seekable sink, so the file has no duplicated prefix."""
    cli, srv = s3
    store = _s3(cli, srv)
    payload = bytes(range(256)) * 512  # 128 KiB
    store.put("obj", payload)
    real_conn = store._conn
    attempts = []

    def flaky_conn():
        attempts.append(1)
        if len(attempts) == 1:
            return _DyingConn(payload[:4096])
        return real_conn()

    monkeypatch.setattr(store, "_conn", flaky_conn)
    dst = tmp_path / "out.bin"
    assert store.get_file("obj", dst) == len(payload)
    assert len(attempts) == 2  # the first died mid-body
    assert dst.read_bytes() == payload


def test_s3_unseekable_sink_refuses_mid_body_retry(s3, monkeypatch):
    """An unseekable sink that took bytes cannot be rewound: the retry
    is refused (fatal), not a silent duplicate."""
    cli, srv = s3
    store = _s3(cli, srv)

    class _Unseekable:
        def __init__(self):
            self.drained = bytearray()

        def write(self, b):
            self.drained += b

        def tell(self):
            raise OSError("unseekable")

    store.put("obj", b"x" * 1024)
    attempts = []

    def flaky_conn():
        attempts.append(1)
        return _DyingConn(b"x" * 100)

    monkeypatch.setattr(store, "_conn", flaky_conn)
    sink = _Unseekable()
    with pytest.raises(cli.s3.SinkRetryRefused):
        store._request("GET", "obj", sink=sink)
    assert len(attempts) == 1
    assert bytes(sink.drained) == b"x" * 100


def test_s3_threads_share_one_client(s3, rng):
    """The SigV4 client's thread-local connections under concurrency
    (the reference's parallel backup and restore through S3)."""
    cli, srv = s3
    store = _s3(cli, srv)
    blobs = {f"data/{i:02d}": rng.bytes(20_000) for i in range(24)}

    def put_get(item):
        k, v = item
        store.put(k, v)
        return store.get(k) == v

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(6) as pool:
        assert all(pool.map(put_get, blobs.items()))
    assert sorted(store.list("data/")) == sorted(blobs)


def test_sigv4_signatures_equal():
    """Both packages sign one request alike (the fakes check it too)."""
    args = ("PUT", "/bucket/a b/c", {"x": "1", "list-type": "2"},
            "127.0.0.1:9000", "e3b0" * 16, "ak", "sk", "us-east-1")
    t, j = ts3.sign_request(*args), js3.sign_request(*args)
    assert t["Authorization"].split("Signature=")[0] == \
        j["Authorization"].split("Signature=")[0]
    assert ts3.signing_key("sk", "20260101", "r") == \
        js3.signing_key("sk", "20260101", "r")
    assert ts3.string_to_sign("GET", "/b/k", {"a": "b"}, "h", "p",
                              "20260101T000000Z", "r") == \
        js3.string_to_sign("GET", "/b/k", {"a": "b"}, "h", "p",
                           "20260101T000000Z", "r")


# -- Azure (tests/test_cloud_backends.py) -------------------------------------

@pytest.fixture
def azure(pair):
    cli, fk = pair
    with fk.fakeazure.FakeAzureServer() as srv:
        yield cli, srv, cli.azure.AzureBlobStore(
            srv.endpoint, srv.account, srv.key_b64, "backups", "ns/repo")


def test_azure_roundtrip(azure):
    cli, _, store = azure
    store.put("config", b"hello config")
    assert store.get("config") == b"hello config"
    assert store.exists("config") and not store.exists("nope")
    assert store.size("config") == len(b"hello config")
    assert store.get_range("config", 6, 6) == b"config"
    with pytest.raises(cli.store.NoSuchKey):
        store.get("missing")
    with pytest.raises(cli.store.NoSuchKey):
        store.size("missing")
    store.delete("config")
    assert not store.exists("config")
    store.delete("config")  # idempotent


def test_azure_put_if_absent(azure):
    _, _, store = azure
    assert store.put_if_absent("config", b"first") is True
    assert store.put_if_absent("config", b"second") is False
    assert store.get("config") == b"first"


def test_azure_list_pagination(azure):
    _, srv, store = azure
    srv.max_results = 7
    keys = [f"data/{i:02d}/blob{i:03d}" for i in range(25)]
    for k in keys:
        store.put(k, b"x")
    assert sorted(store.list("data/")) == sorted(keys)
    assert list(store.list("data/01/")) == ["data/01/blob001"]


def test_azure_rejects_bad_signature(azure):
    cli, srv, _ = azure
    bad = cli.azure.AzureBlobStore(srv.endpoint, srv.account,
                                   "d3Jvbmcta2V5", "backups")  # "wrong-key"
    with pytest.raises(cli.azure.AzureError):
        bad.put("k", b"v")


def test_sharedkey_signatures_equal():
    args = ("PUT", "acct", "/c/b", {"comp": "list", "marker": "x"},
            {"x-ms-date": "Thu, 01 Jan 2026 00:00:00 GMT",
             "x-ms-version": "2020-10-02", "If-None-Match": "*",
             "x-ms-blob-type": "BlockBlob"}, 5)
    assert tazure.string_to_sign(*args) == jazure.string_to_sign(*args)
    key = "c2VjcmV0LWtleQ=="
    assert tazure.sign(key, "abc") == jazure.sign(key, "abc")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_azure_missing_credentials(pkg):
    with pytest.raises(ValueError, match="AZURE_ACCOUNT_NAME"):
        PKGS[pkg].store.open_store("azure:c:/p", env={})


# -- B2 and GCS through the S3 client ----------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_b2_routes_to_s3_compat(pkg):
    m = PKGS[pkg]
    st = m.store.unwrap(m.store.open_store("b2:mybucket:/pfx", env={
        "B2_ACCOUNT_ID": "id", "B2_ACCOUNT_KEY": "key",
        "B2_REGION": "us-west-004"}))
    assert isinstance(st, m.s3.S3ObjectStore)
    assert st.bucket == "mybucket" and st.prefix == "pfx"
    assert "backblazeb2.com" in st.host
    with pytest.raises(ValueError, match="B2_ACCOUNT_ID"):
        m.store.open_store("b2:mybucket:/pfx", env={})
    with pytest.raises(ValueError, match="B2_S3_ENDPOINT"):
        m.store.open_store("b2:mybucket:/pfx", env={
            "B2_ACCOUNT_ID": "id", "B2_ACCOUNT_KEY": "key"})
    st2 = m.store.unwrap(m.store.open_store("b2:mybucket:/pfx", env={
        "B2_ACCOUNT_ID": "id", "B2_ACCOUNT_KEY": "key",
        "B2_S3_ENDPOINT": "https://s3.eu-central-003.backblazeb2.com"}))
    assert st2.region == "eu-central-003"
    with pytest.raises(ValueError, match="B2_REGION"):
        m.store.open_store("b2:mybucket:/pfx", env={
            "B2_ACCOUNT_ID": "id", "B2_ACCOUNT_KEY": "key",
            "B2_S3_ENDPOINT": "https://b2-proxy.internal"})


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_gs_routes_to_interop(pkg):
    m = PKGS[pkg]
    st = m.store.unwrap(m.store.open_store("gs:bkt:/p/q", env={
        "GS_ACCESS_KEY_ID": "a", "GS_SECRET_ACCESS_KEY": "s"}))
    assert isinstance(st, m.s3.S3ObjectStore)
    assert st.bucket == "bkt" and st.prefix == "p/q"
    assert "storage.googleapis.com" in st.host
    with pytest.raises(ValueError, match="HMAC interoperability"):
        m.store.open_store("gs:bkt:/p", env={
            "GOOGLE_APPLICATION_CREDENTIALS": "/sa.json"})


def test_b2_and_gs_through_the_other_fake(pair):
    """``b2:`` and ``gs:`` stores speak SigV4 to whatever endpoint they
    are given: each works against the other package's fake S3."""
    cli, fk = pair
    with fk.fakes3.FakeS3Server(region="eu-central-003") as srv:
        b2 = cli.store.open_store("b2:bucket:/b2pfx", env={
            "B2_ACCOUNT_ID": srv.access_key, "B2_ACCOUNT_KEY": srv.secret_key,
            "B2_S3_ENDPOINT": srv.endpoint, "B2_REGION": "eu-central-003"})
        b2.put("k", b"b2")
        assert b2.get("k") == b"b2"
    with fk.fakes3.FakeS3Server(region="auto") as srv:
        gs = cli.store.open_store("gs:bucket:/gspfx", env={
            "GS_ACCESS_KEY_ID": srv.access_key,
            "GS_SECRET_ACCESS_KEY": srv.secret_key,
            "GS_S3_ENDPOINT": srv.endpoint})
        gs.put("k", b"gs")
        assert list(gs.list()) == ["k"] and gs.get("k") == b"gs"


# -- Swift ---------------------------------------------------------------------

def _swift_env(srv) -> dict:
    return {"OS_AUTH_URL": srv.endpoint + "/v3",
            "OS_USERNAME": srv.username, "OS_PASSWORD": srv.password,
            "OS_PROJECT_NAME": srv.project, "OS_REGION_NAME": srv.region}


@pytest.fixture
def swift(pair):
    cli, fk = pair
    with fk.fakeswift.FakeSwiftServer() as srv:
        yield cli, srv, cli.store.open_store("swift:backups:/ns/repo",
                                             env=_swift_env(srv))


def test_swift_roundtrip(swift):
    cli, _, store = swift
    store.put("config", b"hello config")
    assert store.get("config") == b"hello config"
    assert store.exists("config") and not store.exists("nope")
    assert store.size("config") == len(b"hello config")
    assert store.get_range("config", 6, 6) == b"config"
    with pytest.raises(cli.store.NoSuchKey):
        store.get("missing")
    with pytest.raises(cli.store.NoSuchKey):
        store.size("missing")
    store.delete("config")
    assert not store.exists("config")
    store.delete("config")  # idempotent


def test_swift_put_if_absent_and_pagination(swift):
    _, srv, store = swift
    assert store.put_if_absent("config", b"first") is True
    assert store.put_if_absent("config", b"second") is False
    assert store.get("config") == b"first"
    srv.max_results = 7
    keys = [f"data/{i:02d}/obj{i:03d}" for i in range(25)]
    for k in keys:
        store.put(k, b"x")
    assert sorted(store.list("data/")) == sorted(keys)
    assert list(store.list("data/01/")) == ["data/01/obj001"]


def test_swift_reauth_on_expired_token(swift):
    """Token expiry mid-run: the client re-authenticates once and
    retries."""
    _, srv, store = swift
    store.put("k", b"v")
    before = srv.auth_count
    srv.revoke_tokens()
    assert store.get("k") == b"v"  # 401 -> re-auth -> retry
    assert srv.auth_count == before + 1


def test_swift_v1_auth(swift):
    cli, srv, _ = swift
    store = cli.store.open_store("swift:backups:/v1test", env={
        "ST_AUTH": srv.endpoint + "/auth/v1.0",
        "ST_USER": srv.username, "ST_KEY": srv.password})
    store.put("a", b"1")
    assert store.get("a") == b"1"


def test_swift_rejects_bad_credentials(swift):
    cli, srv, _ = swift
    bad = cli.store.open_store("swift:backups:/p", env={
        **_swift_env(srv), "OS_PASSWORD": "wrong"})
    with pytest.raises(cli.swift.SwiftError):
        bad.put("k", b"v")


def test_swift_temp_url_routes_same_client(swift):
    cli, srv, _ = swift
    st = cli.store.open_store("swift-temp:backups:/tmp-auth",
                              env=_swift_env(srv))
    assert isinstance(cli.store.unwrap(st), cli.swift.SwiftObjectStore)
    st.put("k", b"v")
    assert st.get("k") == b"v"


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_swift_missing_credentials(pkg):
    open_store = PKGS[pkg].store.open_store
    with pytest.raises(ValueError, match="OS_AUTH_URL"):
        open_store("swift:container:/p", env={})
    with pytest.raises(ValueError, match="OS_PASSWORD"):
        open_store("swift:container:/p", env={
            "OS_AUTH_URL": "http://127.0.0.1:1/v3",
            "OS_USERNAME": "u", "OS_PROJECT_NAME": "p"})
    with pytest.raises(ValueError, match="ST_KEY"):
        open_store("swift:container:/p", env={
            "ST_AUTH": "http://127.0.0.1:1/auth/v1.0", "ST_USER": "u"})


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_swift_unsupported_credential_families(pkg):
    open_store = PKGS[pkg].store.open_store
    with pytest.raises(ValueError, match="OS_APPLICATION_CREDENTIAL_ID"):
        open_store("swift:container:/p", env={
            "OS_AUTH_URL": "http://127.0.0.1:1/v3",
            "OS_APPLICATION_CREDENTIAL_ID": "acid",
            "OS_APPLICATION_CREDENTIAL_SECRET": "acsecret"})
    with pytest.raises(ValueError, match="OS_USER_ID, OS_TENANT_ID"):
        open_store("swift:container:/p", env={
            "OS_AUTH_URL": "http://127.0.0.1:1/v3",
            "OS_USER_ID": "uid", "OS_PASSWORD": "pw",
            "OS_TENANT_ID": "tid"})
    with pytest.raises(ValueError, match="OS_USERNAME"):
        open_store("swift:container:/p", env={
            "OS_AUTH_URL": "http://127.0.0.1:1/v3",
            "OS_PASSWORD": "pw", "OS_PROJECT_NAME": "proj"})


# -- cross-backend contracts ---------------------------------------------------

def _backend_factory(backend, cli, fk, tmp_path, stack):
    """-> ``mk(prefix)``: ``cli``'s store on ``fk``'s fake server (entered
    on ``stack``), or a local store."""
    if backend == "s3":
        srv = stack.enter_context(fk.fakes3.FakeS3Server())
        return lambda p: _s3(cli, srv, p)
    if backend == "azure":
        srv = stack.enter_context(fk.fakeazure.FakeAzureServer())
        return lambda p: cli.azure.AzureBlobStore(
            srv.endpoint, srv.account, srv.key_b64, "backups", p)
    if backend == "swift":
        srv = stack.enter_context(fk.fakeswift.FakeSwiftServer())
        return lambda p: cli.store.open_store(f"swift:backups:/{p}",
                                              env=_swift_env(srv))
    if backend == "fs":
        return lambda p: cli.store.FsObjectStore(tmp_path / p)
    return lambda p: cli.store.MemObjectStore()


@pytest.mark.parametrize("faults", [False, True],
                         ids=["plain", "faultstore"])
@pytest.mark.parametrize("backend", ["s3", "azure", "swift"])
def test_list_empty_prefix_contract(pair, backend, faults, tmp_path):
    """list("") on a prefixed store yields exactly its own keys,
    stripped, never a sibling prefix's; through a zero-fault
    ``FaultStore`` every op behaves as on the bare backend."""
    cli, fk = pair
    with ExitStack() as stack:
        mk = _backend_factory(backend, cli, fk, tmp_path, stack)
        if faults:
            base_mk = mk

            def mk(p):  # noqa: F811 — deliberate wrap of base_mk
                return cli.fault.FaultStore(
                    base_mk(p), cli.fault.FaultSchedule(seed=1234, specs=[]))

        a, b = mk("ns/repo"), mk("ns/repo-sibling")
        a.put("config", b"a")
        a.put("data/00/obj", b"a")
        b.put("config", b"b")
        b.put("data/00/other", b"b")
        assert sorted(a.list("")) == ["config", "data/00/obj"]
        assert sorted(b.list("")) == ["config", "data/00/other"]
        assert list(a.list("data/")) == ["data/00/obj"]
        if faults:
            assert a.get("config") == b"a"
            assert a.get_range("data/00/obj", 0, 1) == b"a"
            assert a.exists("config") and not a.exists("nope")
            assert a.size("config") == 1
            assert a.put_if_absent("config", b"z") is False
            assert a.put_if_absent("fresh", b"z") is True
            a.delete("fresh")
            assert not a.exists("fresh")
            assert a.injected == [] and b.injected == []


@pytest.mark.parametrize("backend", ["s3", "azure", "swift"])
def test_put_iovec_contract(pair, backend, tmp_path):
    """``put`` / ``put_if_absent`` take bytes, bytearray, memoryview and
    a list or tuple of them; the object is the joined bytes."""
    cli, fk = pair
    payload = b"\x00\x01volsync" * 700 + b"tail"
    parts = [payload[:128], bytearray(payload[128:3000]),
             memoryview(payload)[3000:]]
    with ExitStack() as stack:
        store = _backend_factory(backend, cli, fk, tmp_path, stack)("ns/repo")
        store.put("iovec", parts)
        assert store.get("iovec") == payload
        assert store.size("iovec") == len(payload)
        store.put("view", memoryview(payload))
        assert store.get("view") == payload
        store.put("ba", bytearray(payload))
        assert store.get("ba") == payload
        store.put("tuple", (b"he", memoryview(b"llo"), bytearray(b"!")))
        assert store.get("tuple") == b"hello!"
        assert store.put_if_absent("iovec", [b"z"]) is False
        assert store.get("iovec") == payload
        assert store.put_if_absent("fresh", [memoryview(b"ab"),
                                             bytearray(b"c")]) is True
        assert store.get("fresh") == b"abc"


@pytest.mark.parametrize("backend", ["fs", "mem"])
def test_local_put_iovec_and_list_contracts(backend, tmp_path):
    """The same contracts on the port's local stores."""
    cli = PKGS["port"]
    mk = _backend_factory(backend, cli, cli, tmp_path, None)
    store = mk("ns/repo")
    store.put("iovec", [b"ab", bytearray(b"c"), memoryview(b"d")])
    assert store.get("iovec") == b"abcd"
    assert store.put_if_absent("iovec", [b"z"]) is False
    if backend == "fs":
        sib = mk("ns/repo-sibling")
        sib.put("config", b"b")
        assert sorted(store.list("")) == ["iovec"]


# -- open_store: the six network URL forms -------------------------------------

_LOCAL = "http://127.0.0.1:1"  # never dialled: opening makes no request
URL_FORMS = {
    "s3": ("s3:http://127.0.0.1:1/bucket/prefix",
           {"AWS_ACCESS_KEY_ID": "a", "AWS_SECRET_ACCESS_KEY": "s"},
           "s3", "S3ObjectStore"),
    "azure": ("azure:container:/path",
              {"AZURE_ACCOUNT_NAME": "acct", "AZURE_ACCOUNT_KEY": "a2V5",
               "AZURE_ENDPOINT": _LOCAL}, "azure", "AzureBlobStore"),
    "b2": ("b2:bucket:/path",
           {"B2_ACCOUNT_ID": "id", "B2_ACCOUNT_KEY": "key",
            "B2_S3_ENDPOINT": _LOCAL, "B2_REGION": "us-west-004"},
           "s3", "S3ObjectStore"),
    "gs": ("gs:bucket:/path",
           {"GS_ACCESS_KEY_ID": "a", "GS_SECRET_ACCESS_KEY": "s",
            "GS_S3_ENDPOINT": _LOCAL}, "s3", "S3ObjectStore"),
    "swift": ("swift:container:/path",
              {"OS_STORAGE_URL": _LOCAL + "/v1/AUTH_x",
               "OS_AUTH_TOKEN": "tok"}, "swift", "SwiftObjectStore"),
    "swift-temp": ("swift-temp:container:/path",
                   {"OS_STORAGE_URL": _LOCAL + "/v1/AUTH_x",
                    "OS_AUTH_TOKEN": "tok"}, "swift", "SwiftObjectStore"),
}
_ATTRS = ("bucket", "prefix", "host", "region", "scheme", "container",
          "account")


@pytest.mark.parametrize("form", list(URL_FORMS))
def test_open_store_network_forms(form, monkeypatch):
    """Each network URL form opens the port's client class inside
    ``ResilientStore``, with the reference's client's attributes;
    ``VOLSYNC_STORE_RESILIENCE=0`` removes the wrapper and
    ``VOLSYNC_FAULT_SEED`` puts a ``FaultStore`` under it."""
    url, env, module, cls_name = URL_FORMS[form]
    cls = getattr(getattr(PKGS["port"], module), cls_name)
    monkeypatch.delenv("VOLSYNC_FAULT_SEED", raising=False)
    monkeypatch.delenv("VOLSYNC_STORE_RESILIENCE", raising=False)
    store = tstore.open_store(url, env=env)
    assert isinstance(store, tres.ResilientStore)
    assert type(store.inner) is cls
    ref = jstore.unwrap(jstore.open_store(url, env=env))
    assert type(ref).__name__ == cls_name
    for attr in _ATTRS:
        assert getattr(store.inner, attr, None) == getattr(ref, attr, None)
    monkeypatch.setenv("VOLSYNC_STORE_RESILIENCE", "0")
    assert type(tstore.open_store(url, env=env)) is cls
    monkeypatch.delenv("VOLSYNC_STORE_RESILIENCE")
    monkeypatch.setenv("VOLSYNC_FAULT_SEED", "7")
    store = tstore.open_store(url, env=env)
    assert isinstance(store, tres.ResilientStore)
    assert isinstance(store.inner, tfault.FaultStore)
    assert type(store.inner.inner) is cls
    assert tstore.unwrap(store) is store.inner.inner


def test_latency_store_counts_ops():
    """``LatencyStore`` counts puts and gets (whole pack fetches apart
    from ranged reads) and their high-water marks, as the reference's."""
    outs = []
    for m in (PKGS["port"], PKGS["ref"]):
        st = m.store.LatencyStore(m.store.MemObjectStore())
        st.put("data/ab/p", b"x" * 10)
        st.put("index/i", b"y")
        st.get("data/ab/p")
        st.get_range("data/ab/p", 2, 3)
        st.get("index/i")
        assert st.put_if_absent("index/i", b"z") is False
        outs.append((st.puts, st.gets, st.pack_gets, st.pack_fetches,
                     st.max_concurrent_puts, st.max_concurrent_gets,
                     st.get_range("data/ab/p", 2, 3), sorted(st.list())))
    assert outs[0] == outs[1]
    slow = tstore.LatencyStore(tstore.MemObjectStore(), put_latency=0.05)
    threads = [threading.Thread(target=slow.put, args=(f"k{i}", b"v"))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert slow.puts == 4 and slow.max_concurrent_puts > 1


# -- repositories through a fake S3 -------------------------------------------

def _tree(root, rng):
    (root / "sub").mkdir(parents=True)
    (root / "a.bin").write_bytes(rng.bytes(60_000))
    (root / "sub" / "b.txt").write_bytes(b"beta" * 2000)
    (root / "empty").write_bytes(b"")


def _same_tree(a, b):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_repository_crosses_packages_through_s3(writer, tmp_path, rng,
                                                monkeypatch):
    """A repository one package writes through a fake S3 opens, checks
    (``read_data=True``) and restores byte-identical under the other;
    the writer's client talks to the other package's fake."""
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    reader = "port" if writer == "ref" else "ref"
    src = tmp_path / "src"
    _tree(src, rng)
    with PKGS[reader].fakes3.FakeS3Server() as srv:
        env = {"AWS_ACCESS_KEY_ID": srv.access_key,
               "AWS_SECRET_ACCESS_KEY": srv.secret_key}
        url = f"s3:{srv.endpoint}/bucket/repo"
        if writer == "ref":
            repo = jrepo.Repository.init(jstore.open_store(url, env=env),
                                         password="pw", chunker=CHUNKER)
            JTreeBackup(repo, workers=1).run(src)
            back = trepo.Repository.open(tstore.open_store(url, env=env),
                                         password="pw", device="cpu")
            assert back.check(read_data=True) == []
            restore_snapshot(back, tmp_path / "dst")
        else:
            repo = trepo.Repository.init(tstore.open_store(url, env=env),
                                         password="pw", chunker=CHUNKER,
                                         device="cpu")
            TreeBackup(repo, workers=1).run(src)
            back = jrepo.Repository.open(jstore.open_store(url, env=env),
                                         password="pw")
            assert back.check(read_data=True) == []
            jrestore(back, tmp_path / "dst")
        assert any(k.startswith("repo/snapshots/") for _, k in srv._objects)
    _same_tree(src, tmp_path / "dst")


@pytest.mark.parametrize("backend", ["azure", "swift"])
def test_repository_end_to_end_over(pair, backend, tmp_path, monkeypatch):
    """The client's package's repository runs unmodified over Azure and
    Swift (the reference's ``azure:`` / ``swift:`` e2e cases): backup,
    restore byte-identical, a clean ``check(read_data=True)``."""
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    cli, fk = pair
    port = cli is PKGS["port"]
    src = tmp_path / "src"
    src.mkdir()
    (src / "f.bin").write_bytes(np.random.RandomState(3).bytes(120_000))
    with ExitStack() as stack:
        if backend == "azure":
            srv = stack.enter_context(fk.fakeazure.FakeAzureServer())
            store = cli.store.open_store("azure:backups:/team/repo", env={
                "AZURE_ACCOUNT_NAME": srv.account,
                "AZURE_ACCOUNT_KEY": srv.key_b64,
                "AZURE_ENDPOINT": srv.endpoint})
        else:
            srv = stack.enter_context(fk.fakeswift.FakeSwiftServer())
            store = cli.store.open_store("swift:backups:/ns/repo",
                                         env=_swift_env(srv))
        kw = {"device": "cpu"} if port else {}
        repo = (trepo if port else jrepo).Repository.init(
            store, password="pw", chunker=CHUNKER, **kw)
        (TreeBackup if port else JTreeBackup)(repo, workers=1).run(src)
        dst = tmp_path / "dst"
        dst.mkdir()
        (restore_snapshot if port else jrestore)(repo, dst)
        assert (dst / "f.bin").read_bytes() == (src / "f.bin").read_bytes()
        assert repo.check(read_data=True) == []


def test_restic_entry_through_s3_env_only(tmp_path, rng, monkeypatch):
    """The port's restic entry backs up and restores through an ``s3:``
    repository named by RESTIC_REPOSITORY, credentials from the AWS env
    only; the reference's entry restores the same bucket."""
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    src = tmp_path / "src"
    _tree(src, rng)
    with tfakes3.FakeS3Server() as srv:
        env = {"RESTIC_REPOSITORY": f"s3:{srv.endpoint}/bucket/restic",
               "RESTIC_PASSWORD": "pw", "HOSTNAME": "h",
               "AWS_ACCESS_KEY_ID": srv.access_key,
               "AWS_SECRET_ACCESS_KEY": srv.secret_key}

        def ctx(data, **extra):
            return JobContext(name="restic", namespace="default",
                              env={**env, **extra}, mounts={"data": data},
                              secrets={}, stop_event=threading.Event(),
                              device="cpu")

        assert trestic.restic_entrypoint(ctx(src)) == 0
        (tmp_path / "dst").mkdir()
        assert trestic.restic_entrypoint(
            ctx(tmp_path / "dst", DIRECTION="restore")) == 0
        (tmp_path / "ref-dst").mkdir()
        assert jrestic.restic_entrypoint(JJobContext(
            name="restic", namespace="default",
            env={**env, "DIRECTION": "restore"},
            mounts={"data": tmp_path / "ref-dst"}, secrets={},
            stop_event=threading.Event())) == 0
        assert any(k.startswith("restic/snapshots/")
                   for _, k in srv._objects)
    _same_tree(src, tmp_path / "dst")
    _same_tree(src, tmp_path / "ref-dst")
