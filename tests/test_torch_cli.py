"""The port's maintenance verbs (``volsync_tpu_torch/cli``: ``scrub`` and
``repack``) against the JAX package's CLI, on the CPU.

Each case makes one store state, copies it, and runs the reference's
``volsync_tpu.cli.main.run`` on one copy and the port's
``volsync_tpu_torch.cli.main(..., device="cpu")`` on the other: the exit
codes (0 clean, 1 healed, 2 unhealable or could not run), the
``--json`` reports and what the verb leaves in the store must be the
same. The scrub cases are tests/test_scrub_chaos.py's CLI cases (a
clean scrub, a rotted primary healed from its mirror, the heal
persisting, both copies rotted, a store that is not there); the repack
cases are a clean cycle, a cycle that restripes a forgotten snapshot's
packs, a bad ``--scheme``, a missing store and a held lock. The trees
are the reference test's own (five 110 KB files and a 40 KB one, 64 KiB
packs, one backup worker), made from a seed with numpy.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from volsync_tpu.cli.main import run as j_run
from volsync_tpu_torch import cli
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.objstore.store import FsObjectStore
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)

DEV = "cpu"
CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 7, "align": 4096}


def _src_tree(root, *, seed=5, files=5):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(files):
        (root / f"f{i}.bin").write_bytes(rng.bytes(110_000 + 13 * i))
    (root / "sub").mkdir()
    (root / "sub" / "nested.bin").write_bytes(rng.bytes(40_000))
    return root


def _pack_segments(store):
    """pack id -> [(offset, length)] of its indexed blob segments."""
    repo = Repository.open(store, device=DEV)
    with repo.lock(exclusive=False):
        repo.load_index()
        segs: dict = {}
        for _blob, (pack, _bt, off, length, _raw) in repo._index.items():
            if pack:
                segs.setdefault(pack, []).append((off, length))
    return segs


def _rot_primary(store, pack_id, segs):
    """Durable bit-rot: flip one payload byte of the pack's first blob
    segment in the PRIMARY copy at rest."""
    off, length = sorted(segs)[0]
    key = f"data/{pack_id[:2]}/{pack_id}"
    body = bytearray(store.get(key))
    body[off + min(5, length - 1)] ^= 0xFF
    store.put(key, bytes(body))


def _rot_mirror(store, pack_id):
    body = bytearray(store.get(f"mirror/{pack_id}"))
    body[0] ^= 0xFF
    store.put(f"mirror/{pack_id}", bytes(body))


def _both(tmp_path, root, argv_tail, *, state=None):
    """Copy the store at ``root`` (when given) twice and run ``argv_tail``
    (the verb and its options; the store path goes second) through the
    reference's CLI on one copy and the port's on the other ->
    {"ref"|"port": (rc, output lines, store path)}."""
    out = {}
    for who in ("ref", "port"):
        dst = tmp_path / f"{who}-store"
        if root is not None:
            shutil.copytree(root, dst)
        argv = [argv_tail[0], str(dst), *argv_tail[1:]]
        lines: list = []
        if state is not None:
            state(FsObjectStore(str(dst)))
        if who == "ref":
            rc = j_run(argv, {}, out=lines.append)
        else:
            rc = cli.main(argv, out=lines.append, device=DEV)
        out[who] = (rc, lines, dst)
    return out


def _report(lines) -> dict:
    return json.loads("\n".join(lines))


@pytest.fixture(scope="module")
def scrub_store(tmp_path_factory):
    """A port-written repository with mirror copies of every pack
    (``VOLSYNC_PACK_COPIES=2``) and its pack segments."""
    base = tmp_path_factory.mktemp("scrub")
    root = base / "store"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOLSYNC_PACK_COPIES", "2")
        fs = FsObjectStore(str(root))
        repo = Repository.init(fs, chunker=CHUNKER, device=DEV)
        repo.PACK_TARGET = 64 * 1024  # several packs from a small tree
        snap, _ = TreeBackup(repo, workers=1).run(_src_tree(base / "src"))
        assert snap
    return root, _pack_segments(FsObjectStore(str(root)))


def _rot_victim(segs):
    victim = sorted(segs)[0]

    def rot(store):
        _rot_primary(store, victim, segs[victim])
    return victim, rot


SCRUB_CASES = ["clean", "healed", "heal-persisted", "unhealable",
               "bad-store"]


@pytest.mark.parametrize("case", SCRUB_CASES)
def test_scrub_verb_matches_reference(tmp_path, monkeypatch, scrub_store,
                                      case):
    monkeypatch.setenv("VOLSYNC_PACK_COPIES", "2")
    root, segs = scrub_store
    victim, rot = _rot_victim(segs)
    if case == "clean":
        got = _both(tmp_path, root, ["scrub"])
        want_rc = 0
    elif case == "healed":
        got = _both(tmp_path, root, ["scrub", "--json"], state=rot)
        want_rc = 1
    elif case == "heal-persisted":
        def rot_and_heal(store):
            rot(store)
            assert cli.main(["scrub", str(store.root), "--json"],
                            out=lambda s: None, device=DEV) == 1
        got = _both(tmp_path, root, ["scrub", "--json"],
                    state=rot_and_heal)
        want_rc = 0
    elif case == "unhealable":
        def rot_both(store):
            rot(store)
            _rot_mirror(store, victim)
        got = _both(tmp_path, root, ["scrub", "--json"], state=rot_both)
        want_rc = 2
    else:
        got = _both(tmp_path, None, ["scrub"])
        want_rc = 2
    (rc_j, out_j, store_j), (rc_t, out_t, store_t) = got["ref"], got["port"]
    assert rc_j == rc_t == want_rc
    if case == "clean":
        assert out_t == out_j and "scrub clean:" in out_t
    elif case == "bad-store":
        assert out_t == out_j and out_t[0].startswith("error:")
    else:
        rep = _report(out_t)
        assert rep == _report(out_j)
        assert rep["outcome"] == {0: "clean", 1: "healed",
                                  2: "unhealable"}[want_rc]
        assert rep["packs"] == len(segs)
        assert rep["healed"] == (case == "healed")
        assert rep["unhealable"] == (case == "unhealable")
    if case != "bad-store":
        for store in (store_j, store_t):
            fs = FsObjectStore(str(store))
            assert fs.exists(f"quarantine/{victim}") \
                == (case == "unhealable")
            assert sorted(fs.list("data/")) \
                == sorted(FsObjectStore(str(store_j)).list("data/"))


@pytest.fixture(scope="module")
def repack_store(tmp_path_factory):
    """A port-written repository whose first snapshot is forgotten, so
    most of its packs are dead weight (and a second, clean one)."""
    base = tmp_path_factory.mktemp("repack")
    roots = {}
    for name, forget in (("clean", False), ("dead", True)):
        root = base / name
        fs = FsObjectStore(str(root))
        repo = Repository.init(fs, chunker=CHUNKER, device=DEV)
        repo.PACK_TARGET = 64 * 1024
        src = _src_tree(base / f"src-{name}", files=3)
        first, _ = TreeBackup(repo, workers=1).run(src)
        if forget:
            rng = np.random.RandomState(11)
            for i in range(2):
                (src / f"f{i}.bin").write_bytes(rng.bytes(110_000))
            TreeBackup(repo, workers=1).run(src)
            repo.delete_snapshot(first)
        roots[name] = root
    return roots


REPACK_CASES = ["clean", "restripe", "bad-scheme", "bad-store", "locked"]


@pytest.mark.parametrize("case", REPACK_CASES)
def test_repack_verb_matches_reference(tmp_path, repack_store, case):
    opts = ["--json", "--dead-ratio", "0.05", "--grace", "0.3"]
    if case == "clean":
        got = _both(tmp_path, repack_store["clean"], ["repack", *opts])
    elif case == "restripe":
        got = _both(tmp_path, repack_store["dead"],
                    ["repack", *opts, "--scheme", "2+1"])
    elif case == "bad-scheme":
        got = _both(tmp_path, repack_store["dead"],
                    ["repack", "--scheme", "4x2"])
    elif case == "bad-store":
        got = _both(tmp_path, None, ["repack", *opts])
    else:
        def hold(store):
            Repository.open(store, device=DEV)._write_lock("prune")
        got = _both(tmp_path, repack_store["dead"], ["repack", *opts],
                    state=hold)
    (rc_j, out_j, store_j), (rc_t, out_t, store_t) = got["ref"], got["port"]
    if case in ("clean", "restripe"):
        assert rc_j == rc_t == 0
        rep = _report(out_t)
        assert rep == _report(out_j)
        if case == "clean":
            assert rep == {"outcome": "clean", "packs_rewritten": 0,
                           "packs_retired": 0, "packs_swept": 0,
                           "blobs_rehomed": 0, "stripes_bytes": 0}
        else:
            assert rep["outcome"] == "ok" and rep["packs_rewritten"] > 0
            assert rep["blobs_rehomed"] > 0 and rep["stripes_bytes"] > 0
            for store in (store_j, store_t):
                assert Repository.open(FsObjectStore(str(store)),
                                       device=DEV).check(
                                           read_data=True) == []
            fs_j, fs_t = (FsObjectStore(str(s)) for s in (store_j, store_t))
            assert sorted(fs_t.list("ec/")) == sorted(fs_j.list("ec/")) != []
    else:
        assert rc_j == rc_t == 2
        assert out_t[0].startswith("error:") and out_j[0].startswith("error:")
        if case != "locked":
            assert out_t == out_j


def test_dispatcher_routes_only_the_two_verbs(tmp_path, monkeypatch):
    """The dispatcher routes the reference's whole tree: the verbs the
    reference dispatches before its operator boots (lint, trace,
    session, repair, scrub, repack) and the cluster verbs (replication,
    migration) over a demo-mode runtime; anything else exits 2 with a
    usage line. The name is kept from when it routed scrub and repack."""
    lines: list = []
    assert cli.main([], out=lines.append, device=DEV) == 2
    assert cli.main(["bogus", "x"], out=lines.append, device=DEV) == 2
    assert all(ln.startswith(
        "usage: volsync {replication,migration,lint,trace,session,repair,"
        "scrub,repack}") for ln in lines)
    assert cli.VERBS == ("replication", "migration", "lint", "trace",
                         "session", "repair", "scrub", "repack")
    for verb in ("scrub", "repair"):
        lines.clear()
        assert cli.main([verb, str(tmp_path / "none")], out=lines.append,
                        device=DEV) == 2
        assert lines[0].startswith("error:")
    lines.clear()
    assert cli.main(["trace", "summary"], out=lines.append) == 0
    assert lines
    lines.clear()
    assert cli.main(["lint", "--list-rules"], out=lines.append) == 0
    assert lines[0].startswith("VL001")
    # the cluster verbs boot the operator runtime on the device asked for
    monkeypatch.setenv("VOLSYNC_STORAGE_PATH", str(tmp_path / "storage"))
    monkeypatch.setenv("VOLSYNC_METRICS_PORT", "0")
    cfg = str(tmp_path / "cfg")
    lines.clear()
    assert cli.main(["--config-dir", cfg, "replication", "create", "x"],
                    out=lines.append, device=DEV) == 0
    assert lines[0].startswith("created replication relationship x")
    assert (tmp_path / "cfg" / "x.json").is_file()
    lines.clear()
    assert cli.main(["--config-dir", cfg, "migration", "delete", "x"],
                    out=lines.append, device=DEV) == 1
    assert lines == ["error: relationship 'x' is a replication, not a "
                     "migration"]
