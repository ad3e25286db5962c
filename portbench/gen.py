"""The benchmark's one generator of inputs, driven by the data files of
``configs/`` and ``traffic/``. Everything comes from ``--seed``: the same
seed gives the same bytes.

``make_volume`` writes a PVC's files from a configuration's ``volume``
list: random bytes drawn on the device with a seeded ``torch.Generator``,
text rows from a fixed vocabulary, hard links, holes, empty files and
small files.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

MIB = 1 << 20
VOCAB_SEED = 0x7E57


def _seq(seed: int, *tags: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])


def _torch_random(torch, gen, n: int, device) -> np.ndarray:
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=device,
                         generator=gen).cpu().numpy()


def _vocab() -> np.ndarray:
    """256 eight-byte words: seven lower-case letters and a space."""
    rng = np.random.default_rng(VOCAB_SEED)
    v = rng.integers(ord("a"), ord("z") + 1, size=(256, 8), dtype=np.uint8)
    v[:, 7] = ord(" ")
    return v


def _write(path: Path, data) -> None:
    with open(path, "wb") as f:
        f.write(memoryview(data))


def make_volume(root: Path, volume: dict, seed: int, device) -> dict:
    """Write the PVC under ``root``. -> {"bytes": bytes of its distinct
    regular files (holes counted, hard links not), "files": {path: size}}."""
    import torch

    root.mkdir(parents=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    rng = np.random.default_rng(_seq(seed, 1))
    files: dict[str, int] = {}
    total = 0
    for spec in volume["files"]:
        path = root / spec["path"]
        path.parent.mkdir(parents=True, exist_ok=True)
        kind = spec["kind"]
        if kind == "blocks":
            # block b odd repeats a random earlier fresh block
            block, n = spec["block"], spec["bytes"]
            fresh: list[np.ndarray] = []
            with open(path, "wb") as f:
                for b in range((n + block - 1) // block):
                    if b % 2 == 1 and fresh:
                        data = fresh[int(rng.integers(len(fresh)))]
                    else:
                        data = _torch_random(torch, gen, block, device)
                        fresh.append(data)
                    f.write(memoryview(data[: min(block, n - b * block)]))
        elif kind == "random":
            n = spec["bytes"]
            with open(path, "wb") as f:
                for off in range(0, n, 64 * MIB):
                    f.write(memoryview(_torch_random(
                        torch, gen, min(64 * MIB, n - off), device)))
        elif kind == "text":
            n, row = spec["bytes"], spec["row"]
            if n % row or row % 8:
                raise ValueError("text bytes must be rows of whole words")
            vocab = torch.from_numpy(_vocab()).to(device)
            with open(path, "wb") as f:
                for off in range(0, n, 64 * MIB):
                    m = min(64 * MIB, n - off)
                    idx = torch.randint(0, 256, (m // 8,), device=device,
                                        generator=gen)
                    rows = vocab[idx].reshape(m // row, row)
                    rows[:, -1] = ord("\n")
                    f.write(memoryview(rows.cpu().numpy().reshape(-1)))
        elif kind == "sparse":
            half = spec["data"] // 2
            with open(path, "wb") as f:
                f.write(_torch_random(torch, gen, half, device).tobytes())
                f.seek(half + spec["hole"])
                f.write(_torch_random(torch, gen, half, device).tobytes())
            n = 2 * half + spec["hole"]
        elif kind == "empty":
            path.write_bytes(b"")
            n = 0
        elif kind == "hardlink":
            os.link(root / spec["to"], path)
            continue
        else:
            raise ValueError(f"unknown file kind {kind!r}")
        if "mode" in spec:
            os.chmod(path, int(spec["mode"], 8))
        files[spec["path"]] = n
        total += n
    small = volume.get("small_files")
    if small:
        # every seed gets the same sizes, in its own order
        sizes = rng.permutation(np.random.default_rng(VOCAB_SEED).integers(
            1, small["max_bytes"], size=small["count"]))
        for i, n in enumerate(sizes):
            rel = f"small/{i % small['dirs']:02d}/f{i:04d}.bin"
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            _write(root / rel, rng.bytes(int(n)))
            if i % 7 == 0:
                os.chmod(root / rel, 0o600)
            files[rel] = int(n)
            total += int(n)
    return {"bytes": total, "files": files}
