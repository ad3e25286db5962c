"""Incremental lint cache keyed on file content hashes.

Ports ``volsync_tpu/analysis/cache.py``, pointed at the PyTorch port.

The cache stores, per analyzed file: the sha256 of its bytes, its
direct project-internal import dependencies (relpaths), and its
findings. On a warm run:

* nothing changed -> every finding is served from the cache and ZERO
  files are re-analyzed (no parsing at all);
* some files changed (or disappeared) -> the dirty set is the changed
  files plus their transitive REVERSE dependency closure — callers can
  hold interprocedural findings about callees, so editing a module
  must re-analyze everyone who (transitively) imports it. Everything
  else keeps its cached findings.

The cache self-invalidates when the analyzer version or the rule set
changes (``rules_signature``), so a rule edit can never serve stale
verdicts. The file is JSON, safe to delete at any time.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

CACHE_VERSION = 1
# bump when rule logic changes in a way that should bust caches even
# though rule codes stayed the same
ANALYZER_REVISION = 5  # 5: VL6xx fault-path family + "fx" facts


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def rules_signature(rules: list, project_rules: list) -> str:
    ids = sorted(r.code for r in rules) + sorted(
        r.code for r in project_rules)
    blob = json.dumps({"rev": ANALYZER_REVISION, "rules": ids})
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def load_cache(path: Path, signature: str) -> Optional[dict]:
    """{relpath: {"hash", "deps", "findings"}} — None when absent,
    unreadable, or written by a different analyzer/rule set."""
    try:
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    if (raw.get("version") != CACHE_VERSION
            or raw.get("rules_sig") != signature):
        return None
    files = raw.get("files")
    return files if isinstance(files, dict) else None


def save_cache(path: Path, signature: str, files: dict) -> None:
    payload = {
        "comment": ("volsync lint incremental cache — content-hash "
                    "keyed, safe to delete"),
        "version": CACHE_VERSION,
        "rules_sig": signature,
        "files": files,
    }
    try:
        Path(path).write_text(json.dumps(payload, sort_keys=True) + "\n",
                              encoding="utf-8")
    except OSError:
        pass  # narrow: a read-only checkout simply skips caching


def dirty_closure(changed: set[str], removed: set[str],
                  deps: dict[str, set[str]]) -> set[str]:
    """changed/removed files plus everyone who transitively imports
    them, per the CURRENT dependency graph."""
    rdeps: dict[str, set[str]] = {}
    for src, targets in deps.items():
        for t in targets:
            rdeps.setdefault(t, set()).add(src)
    dirty = set(changed)
    work = list(changed | removed)
    while work:
        cur = work.pop()
        for dependent in rdeps.get(cur, ()):
            if dependent not in dirty:
                dirty.add(dependent)
                work.append(dependent)
    return dirty
