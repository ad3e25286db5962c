"""The port's cluster verbs (``volsync_tpu_torch/cli/``) on the CPU.

The cases of ``tests/test_cli.py`` through the port: two in-process
``OperatorRuntime``s with ``device="cpu"`` as the 'source' and
'destination' contexts, a replication round trip and a migration push
driven purely through ``volsync`` verbs, the parse tree and the
relationship files. Across packages: a relationship file written by
either package loads in the other with equal ``data``, and both
``build_parser()``s give the same subcommands and options. Then
``chip_smoke.py``'s migration piece at a small size, and the dispatch of
``volsync lint`` / ``trace`` before any runtime boots.
"""

from __future__ import annotations

import argparse
import pathlib

import pytest
import torch

import chip_smoke
from volsync_tpu.cli import Relationship as JRelationship
from volsync_tpu.cli import build_parser as j_build_parser
from volsync_tpu_torch import cli
from volsync_tpu_torch.cli import (Relationship, RelationshipError,
                                   build_parser, run)
from volsync_tpu_torch.cli.relationship import (RELATIONSHIP_LABEL,
                                                TYPE_MIGRATION,
                                                TYPE_REPLICATION)
from volsync_tpu_torch.operator import OperatorRuntime

torch.set_num_threads(1)

DEV = "cpu"


def _runtime(root: pathlib.Path):
    # two runner slots: a destination's listener holds one while the
    # source's push Job takes the other
    return OperatorRuntime({"storage_path": str(root), "metrics_port": 0,
                            "runner_workers": 2, "manager_workers": 2,
                            "movers": "rsync", "device": DEV}).start()


@pytest.fixture
def world(tmp_path):
    """Two operator stacks = two 'kubeconfig contexts'."""
    src = _runtime(tmp_path / "src-storage")
    dst = _runtime(tmp_path / "dst-storage")
    yield {"source": src.cluster, "destination": dst.cluster}, tmp_path
    src.stop()
    dst.stop()


def _mk_pvc(cluster, name, files: dict):
    from volsync_tpu_torch.api.common import ObjectMeta
    from volsync_tpu_torch.cluster.objects import Volume, VolumeSpec

    vol = cluster.create(Volume(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=VolumeSpec(capacity=1 << 30)))
    root = pathlib.Path(vol.status.path)
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(content)
    return root


def _cli(contexts, tmp_path, argv):
    lines = []
    rc = run(["--config-dir", str(tmp_path / "cfg")] + argv, contexts,
             out=lines.append, device=DEV)
    return rc, lines


def _labeled(cluster, rid):
    return [(kind, o.metadata.name)
            for kind in ("ReplicationSource", "ReplicationDestination",
                         "Secret")
            for o in cluster.list(kind, "default",
                                  labels={RELATIONSHIP_LABEL: rid})]


def test_replication_end_to_end_via_cli(world, rng):
    contexts, tmp_path = world
    files = {"a.txt": b"alpha" * 500, "d/b.bin": rng.bytes(200_000)}
    _mk_pvc(contexts["source"], "app-data", files)

    assert _cli(contexts, tmp_path, ["replication", "create", "rel1"])[0] == 0
    rc, out = _cli(contexts, tmp_path, [
        "replication", "set-destination", "rel1",
        "--cluster", "destination", "--dest-name", "dest",
        "--copy-method", "Snapshot"])
    assert rc == 0, out
    rc, out = _cli(contexts, tmp_path, [
        "replication", "set-source", "rel1",
        "--cluster", "source", "--pvcname", "app-data"])
    assert rc == 0, out
    rc, out = _cli(contexts, tmp_path, ["replication", "sync", "rel1"])
    assert rc == 0, out

    dst = contexts["destination"]
    assert dst.wait_for(lambda: (
        (rd := dst.try_get("ReplicationDestination", "default", "dest"))
        and rd.status and rd.status.latest_image is not None),
        timeout=30, poll=0.1)
    rd = dst.get("ReplicationDestination", "default", "dest")
    snap = dst.get("VolumeSnapshot", "default", rd.status.latest_image.name)
    restored = pathlib.Path(snap.status.bound_content)
    for rel, content in files.items():
        assert (restored / rel).read_bytes() == content

    rc, _ = _cli(contexts, tmp_path,
                 ["replication", "schedule", "rel1", "*/5 * * * *"])
    assert rc == 0
    src_cr = contexts["source"].get("ReplicationSource", "default",
                                    "volsync-rel1")
    assert src_cr.spec.trigger.schedule == "*/5 * * * *"

    rid = Relationship.load(tmp_path / "cfg", "rel1").id
    rc, _ = _cli(contexts, tmp_path, ["replication", "delete", "rel1"])
    assert rc == 0
    assert contexts["source"].try_get("ReplicationSource", "default",
                                      "volsync-rel1") is None
    assert dst.try_get("ReplicationDestination", "default", "dest") is None
    assert not (tmp_path / "cfg" / "rel1.json").exists()
    assert _labeled(contexts["source"], rid) == []
    assert _labeled(dst, rid) == []


def test_migration_local_push_via_cli(world, rng):
    contexts, tmp_path = world
    payload = {"big.bin": rng.bytes(150_000), "sub/x.txt": b"hello"}
    local = tmp_path / "workstation"
    for rel, content in payload.items():
        p = local / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(content)

    rc, out = _cli(contexts, tmp_path, [
        "migration", "create", "mig1", "--cluster", "destination",
        "--pvcname", "migrated", "--capacity", str(1 << 30)])
    assert rc == 0, out
    rc, out = _cli(contexts, tmp_path,
                   ["migration", "rsync", "mig1", str(local)])
    assert rc == 0, out

    dst = contexts["destination"]
    vol = dst.get("Volume", "default", "migrated")
    root = pathlib.Path(vol.status.path)
    for rel, content in payload.items():
        assert (root / rel).read_bytes() == content

    rc, _ = _cli(contexts, tmp_path, ["migration", "delete", "mig1"])
    assert rc == 0
    assert dst.try_get("ReplicationDestination", "default",
                       "volsync-mig-mig1") is None


def test_migration_push_needs_cuda_before_it_connects(tmp_path):
    """``migration rsync`` on the default device raises without CUDA
    before it reads the relationship or dials the destination."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")
    from volsync_tpu_torch.cli.migration import MigrationCLI

    with pytest.raises(RuntimeError, match="CUDA"):
        MigrationCLI({}, tmp_path / "cfg").rsync("none", tmp_path)
    assert not (tmp_path / "cfg").exists()


def test_parse_tree(tmp_path):
    p = build_parser()
    args = p.parse_args(["replication", "set-destination", "r",
                         "--dest-name", "d", "--copy-method", "Clone"])
    assert args.group == "replication" and args.verb == "set-destination"
    assert args.copy_method == "Clone"
    args = p.parse_args(["migration", "rsync", "m", "/some/dir"])
    assert args.verb == "rsync" and args.source_dir == "/some/dir"
    with pytest.raises(SystemExit):
        p.parse_args(["replication", "set-destination", "r",
                      "--copy-method", "Bogus", "--dest-name", "d"])


def _tree(parser: argparse.ArgumentParser) -> dict:
    """{command path: sorted (option strings, dest, default, choices,
    required)} over every subparser."""
    out = {}

    def walk(p, path):
        rows = []
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    walk(sp, path + (name,))
            else:
                rows.append((tuple(a.option_strings), a.dest,
                             repr(a.default), repr(a.choices), a.required))
        out[path] = sorted(rows)

    walk(parser, ())
    return out


def test_parse_tree_equals_the_reference():
    port, ref = _tree(build_parser()), _tree(j_build_parser())
    assert sorted(port) == sorted(ref)
    assert port == ref


def test_relationship_files(tmp_path):
    rel = Relationship.create(tmp_path, "r1", TYPE_REPLICATION)
    rel.data["x"] = 1
    rel.save()
    loaded = Relationship.load(tmp_path, "r1", TYPE_REPLICATION)
    assert loaded.id == rel.id and loaded.data == {"x": 1}
    with pytest.raises(RelationshipError):
        Relationship.create(tmp_path, "r1", TYPE_REPLICATION)  # exists
    with pytest.raises(RelationshipError):
        Relationship.load(tmp_path, "r1", TYPE_MIGRATION)  # wrong type
    with pytest.raises(RelationshipError):
        Relationship.load(tmp_path, "nope", TYPE_REPLICATION)
    with pytest.raises(RelationshipError):
        Relationship.create(tmp_path, "../escape", TYPE_REPLICATION)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_relationship_files_cross_packages(tmp_path, writer):
    """A relationship file written by either package loads in the other
    with the same id, type and data."""
    data = {"destination": {"cluster": "destination", "namespace": "ns",
                            "name": "dest", "address": "127.0.0.1",
                            "port": 40000, "keys_secret": "k"},
            "schedule": "*/5 * * * *"}
    make, load = ((Relationship, JRelationship) if writer == "port"
                  else (JRelationship, Relationship))
    rel = make.create(tmp_path, "x", TYPE_MIGRATION)
    rel.data.update(data)
    rel.save()
    got = load.load(tmp_path, "x", TYPE_MIGRATION)
    assert (got.id, got.type, got.data) == (rel.id, TYPE_MIGRATION, data)
    assert got.label() == rel.label()


def test_migration_piece_of_chip_smoke(monkeypatch, tmp_path):
    """``chip_smoke.operator_migration`` at a small size: create, two
    pushes with edits between (the second once the destination listens
    again), delete, no Job attempt failed."""
    monkeypatch.setattr(chip_smoke, "DEVICE", DEV)
    rt = chip_smoke.operator_runtime(tmp_path, runner_workers=2,
                                     manager_workers=2,
                                     movers="rsync").start()
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            res = chip_smoke.operator_migration(torch, rt, tmp_path,
                                                300_000, 7, DEV)
        failures.check("migration")
    finally:
        rt.stop()
    assert set(res) == {"first", "second"}


def test_lint_and_trace_dispatch_with_no_runtime(tmp_path):
    """``lint`` and ``trace`` run through ``main`` with no device and no
    runtime; the cluster verbs' parse errors exit 2 before any boot."""
    mod = tmp_path / "m.py"
    mod.write_text("try:\n    pass\nexcept Exception:\n    pass\n")
    lines: list = []
    assert cli.main(["lint", str(mod), "--no-baseline"],
                    out=lines.append) == 1
    assert any("VL003" in ln for ln in lines)
    lines.clear()
    assert cli.main(["lint", "--list-rules"], out=lines.append) == 0
    assert [ln.split()[0] for ln in lines][:3] == ["VL001", "VL002",
                                                   "VL003"]
    assert cli.main(["trace", "summary"], out=lines.append) == 0
    assert cli.main(["replication", "set-destination", "r"],
                    out=lines.append) == 2
