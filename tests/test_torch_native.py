"""The port's native host library (``volsync_tpu_torch/io``) against the
JAX package's, on the CPU.

The cases of tests/test_native_and_tracing.py on the port (the
operator's single-writer case aside): the readahead reader streams a
file exactly, also empty files and exact multiples of its segment, and
``readinto`` into the port's pooled buffers gives ``open()``'s bytes;
the port's C walk equals the reference's ``_select_boundaries_py`` and
the port's own Python walk, on random and pathological candidate lists
and on the port's own candidate arrays; a backup through the native
reader equals one through ``open()`` (and the reference's); the
library is built from the port's own copy of ``native/volio.cpp``
(byte for byte), under a name keyed by its hash; a prebuilt ``.so``
(``VOLSYNC_VOLIO_SO``) loads, ``VOLSYNC_NATIVE_CACHE`` moves the build
out of the package, and ``VOLSYNC_NO_NATIVE=1`` turns the library off,
in fresh interpreters.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu.ops.gearcdc import GearParams as JParams
from volsync_tpu.ops.gearcdc import _select_boundaries_py as j_walk
from volsync_tpu_torch.engine import bufpool
from volsync_tpu_torch.engine import chunker as tch
from volsync_tpu_torch.io import (
    ReadaheadReader,
    available,
    select_boundaries_native,
)
from volsync_tpu_torch.io import native
from volsync_tpu_torch.ops import gearcdc as tg
from volsync_tpu_torch.ops.gearcdc import GearParams, _select_boundaries_py

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PARAMS = GearParams(min_size=256, avg_size=1024, max_size=4096)
JPARAMS = JParams(min_size=256, avg_size=1024, max_size=4096)


def test_library_builds_from_the_ports_copy_of_the_source():
    assert available()
    assert native._SRC == ROOT / "volsync_tpu_torch" / "native" / "volio.cpp"
    assert native._SRC.read_bytes() == (ROOT / "native" / "volio.cpp"
                                        ).read_bytes()
    so = native.library_path()
    assert so.parent == ROOT / "volsync_tpu_torch" / "_build"
    assert so.is_file() and native.LOAD_INFO["path"] == str(so)
    import hashlib

    digest = hashlib.sha256(native._SRC.read_bytes()).hexdigest()[:16]
    assert so.name == f"libvolio-{digest}.so"


def test_readahead_reader_streams_exactly(tmp_path, rng):
    p = tmp_path / "f.bin"
    data = rng.bytes(3_000_001)
    p.write_bytes(data)
    got = b""
    with ReadaheadReader(p, 256 * 1024) as r:
        while True:
            piece = r.read(99_991)  # awkward read size vs segment size
            if not piece:
                break
            got += piece
    assert got == data


def test_readahead_empty_and_exact_multiple(tmp_path, rng):
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    with ReadaheadReader(empty, 4096) as r:
        assert r.read(100) == b""
    exact = tmp_path / "exact"
    payload = rng.bytes(8192)  # exactly 2 segments
    exact.write_bytes(payload)
    with ReadaheadReader(exact, 4096) as r:
        assert r.read(10_000) == payload
        assert r.read(1) == b""


def _fill_all(f, seg):
    """The segment loop of ``hash_file_streaming``: readinto a pooled
    buffer until it is full or the file ends -> list of segments."""
    out = []
    buf = bufpool.GLOBAL.acquire(seg)
    try:
        view = memoryview(buf)
        while True:
            n = 0
            while n < seg:
                got = f.readinto(view[n:seg]) or 0
                if got == 0:
                    break
                n += got
            if n == 0:
                break
            out.append(bytes(view[:n]))
            if n < seg:
                break
        view.release()
    finally:
        bufpool.GLOBAL.release(buf)
    return out


@pytest.mark.parametrize("size", [0, 1, 65535, 65536, 3 * 65536,
                                  3 * 65536 + 17])
@pytest.mark.parametrize("native_seg", [65536, 16384])
def test_readinto_pooled_buffers_equals_open(tmp_path, size, native_seg):
    """readinto into the port's bufpool buffers gives open()'s bytes,
    segment for segment, at EOF and at exact multiples of the segment
    (the native segment equal to or smaller than the caller's)."""
    p = tmp_path / "f.bin"
    p.write_bytes(np.random.RandomState(size).bytes(size))
    with ReadaheadReader(p, native_seg) as r:
        got = _fill_all(r, 65536)
    with open(p, "rb") as f:
        want = _fill_all(f, 65536)
    assert got == want
    assert b"".join(got) == p.read_bytes()


def test_open_readahead_uses_the_native_reader(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 10)
    with tch._open_readahead(p, 4096) as f:
        assert isinstance(f, ReadaheadReader)
        assert f.read(100) == b"x" * 10


def _random_candidates(rng, length):
    n_l = int(rng.randint(0, 200))
    idx_l = np.sort(rng.choice(length, size=n_l,
                               replace=False)).astype(np.int64)
    idx_s = idx_l[rng.rand(n_l) < 0.3].copy()
    return idx_s, idx_l


def test_native_walk_matches_both_python_walks(rng):
    for trial in range(8):
        length = int(rng.randint(10_000, 300_000))
        idx_s, idx_l = _random_candidates(rng, length)
        for eof in (True, False):
            want = j_walk(idx_s, idx_l, length, JPARAMS, eof=eof, base=1000)
            assert _select_boundaries_py(idx_s, idx_l, length, PARAMS,
                                         eof=eof, base=1000) == want
            got = select_boundaries_native(idx_s, idx_l, length, PARAMS,
                                           eof, base=1000)
            assert got == want, (trial, eof)
            assert tg.select_boundaries(idx_s, idx_l, length, PARAMS,
                                        eof=eof, base=1000) == want


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
def test_native_walk_takes_any_integer_candidates(rng, dtype):
    """Candidates of another dtype, non-contiguous, or CPU tensors
    reach the library as contiguous int64."""
    length = 200_000
    idx_s, idx_l = _random_candidates(rng, length)
    want = _select_boundaries_py(idx_s, idx_l, length, PARAMS)
    wide_l = np.repeat(idx_l.astype(dtype), 2)[::2]  # strided view
    assert not wide_l.flags.c_contiguous or len(wide_l) < 2
    assert select_boundaries_native(idx_s.astype(dtype), wide_l, length,
                                    PARAMS, True) == want
    assert select_boundaries_native(torch.from_numpy(idx_s),
                                    torch.from_numpy(idx_l), length,
                                    PARAMS, True) == want


def test_native_walk_pathological():
    empty = np.asarray([], dtype=np.int64)
    want = j_walk(empty, empty, 20_000, JPARAMS, eof=True)
    got = select_boundaries_native(empty, empty, 20_000, PARAMS, True)
    assert got == want
    assert {ln for _, ln in got[:-1]} == {PARAMS.max_size}
    # every position a candidate: cuts at min_size
    dense = np.arange(20_000, dtype=np.int64)
    assert select_boundaries_native(dense, dense, 20_000, PARAMS, True) == \
        j_walk(dense, dense, 20_000, JPARAMS, eof=True)
    # length 0, and a tail withheld without eof
    assert select_boundaries_native(empty, empty, 0, PARAMS, True) == []
    assert select_boundaries_native(empty, empty, 100, PARAMS, False) == \
        j_walk(empty, empty, 100, JPARAMS, eof=False) == []


@pytest.mark.parametrize("align", [64, 1])
def test_native_walk_on_the_ports_candidates(rng, align):
    """The port's own candidate arrays (the align-64 and align-1
    streams' route): the C walk equals both Python walks."""
    params = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                        align=align)
    jparams = JParams(min_size=4096, avg_size=32768, max_size=65536,
                      align=align)
    data = np.frombuffer(rng.bytes(400_000), np.uint8)
    buf = torch.from_numpy(data.copy())
    idx_s, idx_l = tg.fetch_candidates(buf, params, len(data))
    assert isinstance(idx_s, np.ndarray)
    for eof in (True, False):
        want = j_walk(np.asarray(idx_s), np.asarray(idx_l), len(data),
                      jparams, eof=eof, base=7)
        assert select_boundaries_native(idx_s, idx_l, len(data), params,
                                        eof, base=7) == want
        assert _select_boundaries_py(idx_s, idx_l, len(data), params,
                                     eof=eof, base=7) == want


def test_backup_through_native_reader(tmp_path, rng, monkeypatch):
    """TreeBackup reads files through the readahead reader; the
    snapshot equals a plain-read backup's and the reference's."""
    from volsync_tpu.engine.backup import TreeBackup as JBackup
    from volsync_tpu.objstore.store import MemObjectStore as JMem
    from volsync_tpu.repo.repository import Repository as JRepo
    from volsync_tpu_torch.engine import backup as backup_mod
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.objstore.store import MemObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    src = tmp_path / "src"
    src.mkdir()
    (src / "big.bin").write_bytes(rng.bytes(300_000))
    (src / "exact.bin").write_bytes(rng.bytes(4 * 65536))
    chunker = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
               "seed": 1, "align": 64}
    opened = []
    real = backup_mod.TreeBackup.__dict__["_open_stream"]

    def spy(path):
        f = real.__func__(path)
        opened.append(type(f).__name__)
        return f

    monkeypatch.setattr(backup_mod.TreeBackup, "_open_stream",
                        staticmethod(spy))

    def port_tree(open_stream=None):
        if open_stream is not None:
            monkeypatch.setattr(backup_mod.TreeBackup, "_open_stream",
                                staticmethod(open_stream))
        repo = Repository.init(MemObjectStore(), chunker=chunker,
                               device="cpu")
        snap, _ = TreeBackup(repo, workers=1).run(src)
        return dict(repo.list_snapshots())[snap]["tree"]

    t_native = port_tree()
    assert opened and set(opened) == {"ReadaheadReader"}
    t_plain = port_tree(lambda path: open(path, "rb"))
    jrepo = JRepo.init(JMem(), chunker=chunker)
    jsnap, _ = JBackup(jrepo, workers=1).run(src)
    assert t_native == t_plain == dict(jrepo.list_snapshots())[jsnap]["tree"]


def _fresh(code, **env):
    full = dict(os.environ)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in full.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=full, cwd=str(ROOT))


def test_prebuilt_native_so(tmp_path):
    """VOLSYNC_VOLIO_SO points at a pre-compiled library: the loader
    binds it without building."""
    so = tmp_path / "libvolio.so"
    r = subprocess.run(["g++", *native.GXX_FLAGS, "-o", str(so),
                        str(native._SRC)], capture_output=True)
    assert r.returncode == 0, r.stderr[-500:]
    out = _fresh(
        "from volsync_tpu_torch.io import native\n"
        "assert native.available(), 'prebuilt .so did not load'\n"
        "print('prebuilt', native.LOAD_INFO['path'],"
        " native.LOAD_INFO['build_s'])\n", VOLSYNC_VOLIO_SO=str(so))
    assert out.returncode == 0, out.stderr[-500:]
    assert f"prebuilt {so} None" in out.stdout


def test_native_cache_dir_takes_the_build(tmp_path):
    """VOLSYNC_NATIVE_CACHE names the build directory: a fresh loader
    builds the hash-keyed library there and adds nothing to the
    package's ``_build/``."""
    assert available()  # the package's own build exists before the run
    before = sorted(native.BUILD_DIR.iterdir())
    cache = tmp_path / "cache"
    out = _fresh(
        "from volsync_tpu_torch.io import native\n"
        "assert native.available(), 'cache-dir build did not load'\n"
        "print('built', native.LOAD_INFO['path'],"
        " native.LOAD_INFO['build_s'] is not None)\n",
        VOLSYNC_NATIVE_CACHE=str(cache), VOLSYNC_VOLIO_SO="",
        VOLSYNC_NO_NATIVE="")
    assert out.returncode == 0, out.stderr[-500:]
    so = cache / native.library_path().name
    assert out.stdout.strip() == f"built {so} True"
    assert so.is_file()
    assert [p.name for p in cache.iterdir()] == [so.name]
    assert sorted(native.BUILD_DIR.iterdir()) == before


@pytest.mark.parametrize("knob", ["VOLSYNC_VOLIO_SO", "VOLSYNC_NO_NATIVE"])
def test_native_cache_dir_yields_to_the_other_knobs(tmp_path, knob):
    """A prebuilt library or the off switch wins over the cache dir,
    as in the reference: the cache dir stays untouched."""
    value = "1"
    if knob == "VOLSYNC_VOLIO_SO":
        value = str(tmp_path / "libvolio.so")
        r = subprocess.run(["g++", *native.GXX_FLAGS, "-o", value,
                            str(native._SRC)], capture_output=True)
        assert r.returncode == 0, r.stderr[-500:]
    cache = tmp_path / "cache"
    out = _fresh(
        "from volsync_tpu_torch.io import native\n"
        "print(native.available(), native.LOAD_INFO.get('path'))\n",
        **{"VOLSYNC_NATIVE_CACHE": str(cache), "VOLSYNC_VOLIO_SO": "",
           "VOLSYNC_NO_NATIVE": "", knob: value})
    assert out.returncode == 0, out.stderr[-500:]
    want = {"VOLSYNC_VOLIO_SO": f"True {value}",
            "VOLSYNC_NO_NATIVE": "False None"}[knob]
    assert out.stdout.strip() == want
    assert not cache.exists()


def test_no_native_turns_the_library_off():
    out = _fresh(
        "import numpy as np\n"
        "from volsync_tpu_torch.io import native\n"
        "from volsync_tpu_torch.engine.chunker import _open_readahead\n"
        "from volsync_tpu_torch.ops import gearcdc as g\n"
        "assert not native.available()\n"
        "p = g.GearParams(min_size=256, avg_size=1024, max_size=4096)\n"
        "e = np.asarray([], np.int64)\n"
        "assert native.select_boundaries_native(e, e, 9000, p, True) is None\n"
        "assert g.select_boundaries(e, e, 9000, p) == "
        "g._select_boundaries_py(e, e, 9000, p)\n"
        "with _open_readahead('pyproject.toml', 4096) as f:\n"
        "    print(type(f).__name__)\n", VOLSYNC_NO_NATIVE="1")
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip() == "BufferedReader"
