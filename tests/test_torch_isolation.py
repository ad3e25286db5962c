"""The port stands alone: no file of volsync_tpu_torch/ or chip_smoke.py
imports JAX or the JAX package (AST scan and a fresh-interpreter
``sys.modules`` diff), and with no CUDA and no ``device`` argument the
entry points raise instead of moving to the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import volsync_tpu_torch
from volsync_tpu_torch.engine import chunker as tch
from volsync_tpu_torch.ops import gearcdc, segment, sha256

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "volsync_tpu_torch"
FORBIDDEN = ("jax", "volsync_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_file_imports_jax_or_the_reference():
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", "") == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            found += [(path.name, n) for n in names if _forbidden(n)]
    assert found == []
    assert len(_port_files()) >= 12


def test_importing_the_port_loads_no_jax_module():
    """Diff sys.modules around importing every port module in a fresh
    interpreter (the interpreter's startup may already hold jax, so the
    check is on what the import adds)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300,
                         check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "volsync_tpu_torch.ops.segment" in added
    assert [m for m in added if _forbidden(m)] == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = gearcdc.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                           align=4096)
    f = tmp_path / "f"
    f.write_bytes(b"x" * 10)
    calls = [
        lambda: volsync_tpu_torch.resolve_device(),
        lambda: volsync_tpu_torch.resolve_device("cuda"),
        lambda: tch.DeviceChunkHasher(p),
        lambda: tch.stream_chunk_batches(lambda n: b"", p),
        lambda: tch.stream_chunks(lambda n: b"", p),
        lambda: tch.hash_spans(b"x" * 10, [(0, 10)]),
        lambda: tch.verify_blob_batch([("00", b"y")]),
        lambda: tch.hash_file_streaming(f),
        lambda: sha256.sha256_many([b"x"]),
        lambda: segment.BatchedSegmentHasher(p),
        lambda: gearcdc.chunk_buffer(b"x" * 10, p),
        lambda: tch.DeviceChunkHasher(gearcdc.GearParams(align=64)),
        lambda: tch.DeviceChunkHasher(gearcdc.GearParams(align=1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert volsync_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert tch.DeviceChunkHasher(p, device="cpu").device.type == "cpu"
