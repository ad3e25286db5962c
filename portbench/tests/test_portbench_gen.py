"""The generator gives the same inputs for the same seed, and other
inputs for another."""

import hashlib

from portbench import gen

VOLUME = {"files": [
    {"path": "big.bin", "kind": "blocks", "bytes": 4 << 20, "block": 1 << 20},
    {"path": "text.log", "kind": "text", "bytes": 1 << 20, "row": 128},
    {"path": "odd.bin", "kind": "random", "bytes": (1 << 20) + 12345,
     "mode": "640"},
    {"path": "a/b/link.bin", "kind": "hardlink", "to": "odd.bin"},
    {"path": "sparse.bin", "kind": "sparse", "data": 65536, "hole": 1 << 20},
    {"path": "empty", "kind": "empty"}],
    "small_files": {"count": 12, "dirs": 3, "max_bytes": 4096}}
SEED = 2 ** 33 + 17


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
            h.update(oct(p.stat().st_mode).encode())
    return h.hexdigest()


def test_volume_is_reproducible(tmp_path):
    a = gen.make_volume(tmp_path / "a", VOLUME, SEED, "cpu")
    b = gen.make_volume(tmp_path / "b", VOLUME, SEED, "cpu")
    c = gen.make_volume(tmp_path / "c", VOLUME, SEED + 1, "cpu")
    assert a == b and a["bytes"] == c["bytes"]
    assert sorted(a["files"].values()) == sorted(c["files"].values())
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a") != _digest(tmp_path / "c")
    assert a["bytes"] == sum(a["files"].values())
    assert (tmp_path / "a" / "a/b/link.bin").stat().st_ino == \
        (tmp_path / "a" / "odd.bin").stat().st_ino
    big = (tmp_path / "a" / "big.bin").read_bytes()
    blocks = [big[i: i + (1 << 20)] for i in range(0, len(big), 1 << 20)]
    assert blocks[1] in (blocks[0],) and blocks[3] in blocks[:3:2]
    rows = (tmp_path / "a" / "text.log").read_bytes().split(b"\n")
    assert all(len(r) == 127 for r in rows[:-1])
