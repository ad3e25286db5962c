"""Relationship files: the CLI's persisted state.

Ports ``volsync_tpu/cli/relationship.py``; the file format is the
reference's, so a relationship written by either package loads in the
other.

Mirrors kubectl-volsync/cmd/relationship.go:36-74: a "relationship" is a
local config file keyed by a UUID, holding everything the CLI needs to
drive both halves of a replication/migration across (possibly different)
clusters; every object the CLI creates is labeled
``volsync.backube/relationship=<uuid>`` so delete can find it all again.
The reference persists via viper YAML under ~/.volsync; here it's JSON
under a configurable directory (stdlib-only, same contract).
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path
from typing import Optional

RELATIONSHIP_LABEL = "volsync.backube/relationship"

TYPE_REPLICATION = "replication"
TYPE_MIGRATION = "migration"


class RelationshipError(RuntimeError):
    pass


def _check_name(name: str) -> str:
    """Relationship names become file names: reject anything that could
    escape --config-dir (separators, dot-dot, hidden/empty names)."""
    if (not name or name.startswith(".") or "/" in name or "\\" in name
            or name in (".", "..")):
        raise RelationshipError(f"invalid relationship name {name!r}")
    return name


class ContextCLI:
    """Shared plumbing for the verb groups: named cluster contexts (the
    kubeconfig-context analogue) + rsync-destination readiness.
    ``device`` is where a push from this process hashes (CUDA unless
    another device is asked for; resolved when a verb needs it)."""

    def __init__(self, contexts: dict, config_dir, out=print, device=None):
        self.contexts = contexts
        self.config_dir = config_dir
        self.out = out
        self.device = device

    def _cluster(self, name: str):
        try:
            return self.contexts[name]
        except KeyError:
            raise RelationshipError(f"unknown cluster context {name!r}")

    @staticmethod
    def _rd_ready(cl, namespace, name) -> bool:
        rd = cl.try_get("ReplicationDestination", namespace, name)
        st = rd.status.rsync if (rd and rd.status) else None
        return bool(st and st.address and st.port and st.ssh_keys)


class Relationship:
    """One named relationship: {id, type, data} (relationship.go:36-74)."""

    def __init__(self, directory: Path, name: str, rtype: str,
                 rid: Optional[str] = None, data: Optional[dict] = None):
        self.directory = Path(directory)
        self.name = _check_name(name)
        self.type = rtype
        self.id = rid or str(uuid.uuid4())
        self.data = data if data is not None else {}

    @property
    def path(self) -> Path:
        return self.directory / f"{self.name}.json"

    def save(self) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"id": self.id, "type": self.type, "data": self.data},
            indent=2, sort_keys=True))
        tmp.replace(self.path)

    def delete_file(self) -> None:
        self.path.unlink(missing_ok=True)

    @classmethod
    def create(cls, directory: Path, name: str, rtype: str) -> "Relationship":
        rel = cls(directory, name, rtype)
        if rel.path.exists():
            raise RelationshipError(f"relationship {name!r} already exists")
        rel.save()
        return rel

    @classmethod
    def load(cls, directory: Path, name: str,
             expect_type: Optional[str] = None) -> "Relationship":
        path = Path(directory) / f"{_check_name(name)}.json"
        if not path.is_file():
            raise RelationshipError(f"no relationship named {name!r}")
        payload = json.loads(path.read_text())
        if expect_type and payload.get("type") != expect_type:
            raise RelationshipError(
                f"relationship {name!r} is a {payload.get('type')}, "
                f"not a {expect_type}")
        return cls(directory, name, payload["type"], rid=payload["id"],
                   data=payload.get("data", {}))

    def label(self) -> dict:
        return {RELATIONSHIP_LABEL: self.id}
