"""The port's hasher inside the JAX package's own seams, on the CPU.

The reference's ``stream_chunk_batches(reader, params, hasher=...)`` and
``TreeBackup(repo, hasher=...)`` run with the port's
``DeviceChunkHasher(..., device="cpu")`` behind a small adapter, against
the same calls with the reference's hasher: the same chunks, ids and
batch split at align 4096, 64 and 1; the same root tree id and data
blob set for a tree with an empty file, a hard link, a sparse file, a
file with a sub-max tail and nested directories; and the reference's
``restore_snapshot`` restores the port-hasher snapshot byte-identical.
The port hasher's ``thread_safe`` (four backup workers give the
one-worker snapshot) and ``accepts_prepadded`` (the reference stream
hands it bucket-padded views) are held here too.
"""

import dataclasses
import os
from pathlib import Path

import pytest
import torch

from volsync_tpu.engine import chunker as jch
from volsync_tpu.engine.backup import TreeBackup
from volsync_tpu.engine.restore import restore_snapshot
from volsync_tpu.objstore.store import MemObjectStore
from volsync_tpu.ops.gearcdc import GearParams
from volsync_tpu.repo.repository import Repository
from volsync_tpu_torch.engine import chunker as tch

torch.set_num_threads(1)

PARAMS = {
    4096: GearParams(min_size=4096, avg_size=32768, max_size=65536,
                     align=4096),
    64: GearParams(min_size=4096, avg_size=32768, max_size=65536, align=64),
    1: GearParams(min_size=4096, avg_size=32768, max_size=65536, align=1),
}
ALIGNS = [4096, 64, 1]


class PortHasher:
    """The port's DeviceChunkHasher behind the reference's hasher
    interface: ``params`` is the reference's GearParams (TreeBackup
    refuses a hasher whose params differ from the repository's), and
    ``begin``/``process`` forward to the port. ``calls`` records each
    ``begin``'s (buffer length, valid_len)."""

    def __init__(self, params: GearParams):
        self.params = params
        self.port = tch.DeviceChunkHasher(
            tch.params_from_reference(dataclasses.asdict(params)),
            device="cpu")
        self.thread_safe = self.port.thread_safe
        self.accepts_prepadded = self.port.accepts_prepadded
        self.calls = []

    def begin(self, buffer, *, eof=True, valid_len=None):
        # A backup worker thread starts with the default OpenMP width;
        # keep the twins single-threaded there too.
        torch.set_num_threads(1)
        self.calls.append((len(buffer), valid_len))
        return self.port.begin(buffer, eof=eof, valid_len=valid_len)

    def process(self, buffer, *, eof=True):
        return self.port.process(buffer, eof=eof)


def _reader(data: bytes, step: int = 61_441):
    pos = [0]

    def read(n):
        piece = data[pos[0]: pos[0] + min(n, step)]
        pos[0] += len(piece)
        return piece
    return read


@pytest.mark.parametrize("align", ALIGNS, ids=[f"align{a}" for a in ALIGNS])
def test_reference_stream_with_port_hasher(rng, align):
    params = PARAMS[align]
    block = rng.bytes(90_000)
    data = rng.bytes(50_000) + block + bytes(20_000) + block \
        + rng.bytes(12_345)
    port = PortHasher(params)

    def batches(hasher):
        return [[(bytes(c), d) for c, d in batch]
                for batch in jch.stream_chunk_batches(
                    _reader(data), params, segment_size=128 * 1024,
                    hasher=hasher)]

    want = batches(jch.DeviceChunkHasher(params))
    have = batches(port)
    assert [len(b) for b in have] == [len(b) for b in want]
    assert have == want and len(want) > 1
    assert b"".join(c for b in have for c, _ in b) == data
    # accepts_prepadded: every segment came as a bucket-padded view
    assert port.calls and all(
        v is not None and n == tch._buffer_bucket(v) for n, v in port.calls)


def make_tree(root: Path, rng) -> Path:
    """A small volume: a file with a 12,345-byte odd tail (its last chunk
    is below max_size), a hard link to it in a nested directory, a
    sparse file with a 140 KB hole, an empty file, a file below
    min_size and a mid-size file two directories down."""
    root.mkdir()
    (root / "tail.bin").write_bytes(rng.bytes(3 * 32768 + 12_345))
    (root / "empty").write_bytes(b"")
    with open(root / "sparse.bin", "wb") as f:
        f.write(rng.bytes(5_000))
        f.seek(145_000)
        f.write(rng.bytes(3_000))
    (root / "sub" / "deeper").mkdir(parents=True)
    os.link(root / "tail.bin", root / "sub" / "hard.bin")
    (root / "sub" / "small.txt").write_bytes(b"hello seam\n" * 40)
    (root / "sub" / "deeper" / "mid.bin").write_bytes(rng.bytes(40_000))
    return root


def _chunker(params: GearParams) -> dict:
    return {"min_size": params.min_size, "avg_size": params.avg_size,
            "max_size": params.max_size, "seed": params.seed,
            "align": params.align}


def _snapshot(repo, snap_id):
    manifest = dict(repo.list_snapshots())[snap_id]
    return manifest["tree"], repo.blob_ids()


def _data_ids(repo) -> set:
    return {b for b in repo.blob_ids() if repo._entry(b).type == "data"}


def assert_restored(src: Path, dst: Path) -> None:
    """Layout, bytes, modes, mtimes and hard-link grouping equal."""
    rels = sorted(p.relative_to(src) for p in src.rglob("*"))
    assert rels == sorted(p.relative_to(dst) for p in dst.rglob("*"))
    groups_a, groups_b = {}, {}
    for rel in rels:
        sa, sb = (src / rel).lstat(), (dst / rel).lstat()
        assert (sa.st_mode, sa.st_mtime_ns) == (sb.st_mode, sb.st_mtime_ns)
        if (src / rel).is_file():
            assert (src / rel).read_bytes() == (dst / rel).read_bytes(), rel
            groups_a.setdefault(sa.st_ino, set()).add(str(rel))
            groups_b.setdefault(sb.st_ino, set()).add(str(rel))
    assert sorted(map(sorted, groups_a.values())) == \
        sorted(map(sorted, groups_b.values()))


@pytest.mark.parametrize("align", ALIGNS, ids=[f"align{a}" for a in ALIGNS])
def test_reference_tree_backup_with_port_hasher(tmp_path, rng, align):
    params = PARAMS[align]
    src = make_tree(tmp_path / "src", rng)
    ref_store, port_store = MemObjectStore(), MemObjectStore()
    ref_repo = Repository.init(ref_store, chunker=_chunker(params))
    port_repo = Repository.init(port_store, chunker=_chunker(params))
    ref_snap, _ = TreeBackup(ref_repo, workers=1).run(src)
    hasher = PortHasher(params)
    backup = TreeBackup(port_repo, hasher=hasher, workers=1)
    port_snap, stats = backup.run(src)
    assert hasher.calls  # the port hashed the chunked files
    assert _snapshot(port_repo, port_snap)[0] == \
        _snapshot(ref_repo, ref_snap)[0]
    assert _data_ids(port_repo) == _data_ids(ref_repo)
    assert port_repo.blob_ids() == ref_repo.blob_ids()
    assert stats.files == 6
    dst = tmp_path / "dst"
    restore_snapshot(Repository.open(port_store), dst)
    assert_restored(src, dst)
    assert (dst / "sparse.bin").stat().st_blocks * 512 < 145_000


def test_port_hasher_is_thread_safe_in_reference_backup(tmp_path, rng):
    """``thread_safe`` lets the reference hash four files at once; the
    snapshot equals the one-worker snapshot."""
    params = PARAMS[4096]
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    # two chunked files and two below min_size: four jobs, two of them
    # in the port hasher at once (the CPU twins slow down several-fold
    # under concurrent threads, so no more than that here)
    for k, n in enumerate((20_000, 3_000, 27_777, 4_000)):
        (src / ("sub" if k % 2 else "") / f"f{k}.bin").write_bytes(
            rng.bytes(n))
    trees = []
    for workers in (1, 4):
        repo = Repository.init(MemObjectStore(), chunker=_chunker(params))
        backup = TreeBackup(repo, hasher=PortHasher(params), workers=workers)
        assert backup.workers == workers
        snap, _ = backup.run(src)
        trees.append((_snapshot(repo, snap)[0], repo.blob_ids()))
    assert trees[0] == trees[1]


def test_reference_forces_one_worker_without_thread_safe():
    """Without the attribute the reference would hash serially: the
    adapter's value is the port's own, not a default of the reference."""
    hasher = PortHasher(PARAMS[4096])
    assert tch.DeviceChunkHasher.thread_safe is True
    assert tch.DeviceChunkHasher.accepts_prepadded is True
    hasher.thread_safe = False
    repo = Repository.init(MemObjectStore(), chunker=_chunker(PARAMS[4096]))
    assert TreeBackup(repo, hasher=hasher, workers=4).workers == 1
