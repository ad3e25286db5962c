"""AST lint engine: file walker, rule runner, baseline, reporting.

Ports ``volsync_tpu/analysis/engine.py``; scope decisions key on the
last ``volsync_tpu_torch`` path component.

The engine is deliberately tiny and dependency-free (stdlib ``ast``
only): it parses each ``.py`` file once, hands the tree + source lines
to every registered rule (analysis/rules.py), and post-filters the
findings through inline suppressions and the checked-in baseline.

Output format is one finding per line, ``file:line CODE message`` —
greppable, editor-clickable, stable for the baseline diff.

Suppressions
------------
A finding on line N is suppressed when line N carries a comment
``# lint: ignore[CODE]`` (or ``# lint: ignore`` for all codes). The
suppression is part of the code under review — it shows up in diffs,
unlike a baseline entry.

Baseline
--------
``--write-baseline`` records the current findings keyed by
``path:CODE:message`` (line numbers excluded, so unrelated edits above
a grandfathered site don't churn the file) with a count per key.
Subsequent runs subtract the baseline: only NEW findings fail the run.
Baseline entries that no longer match anything are reported as stale —
the expire half of the workflow — so the file shrinks monotonically
toward empty instead of fossilizing.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Optional

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([A-Z0-9, ]+)\])?")


@dataclass(frozen=True)
class Finding:
    path: str  # posix, as given/walked — what gets printed
    line: int
    code: str
    message: str
    severity: str = "warning"  # error | warning | note (SARIF levels)
    # optional source span (1-based; 0 = unknown) — SARIF region data
    col: int = 0
    end_line: int = 0
    end_col: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.code} {self.message}"

    def baseline_key(self) -> str:
        return f"{self.path}:{self.code}:{self.message}"


def finding_at(relpath: str, node: ast.AST, code: str, message: str,
               severity: str = "warning") -> Finding:
    """Finding carrying the full source span of ``node`` (ast column
    offsets are 0-based; SARIF and editors are 1-based)."""
    end_line = getattr(node, "end_lineno", None) or 0
    end_col = getattr(node, "end_col_offset", None)
    return Finding(
        relpath, getattr(node, "lineno", 0), code, message,
        severity=severity,
        col=getattr(node, "col_offset", -1) + 1,
        end_line=end_line,
        end_col=0 if end_col is None else end_col + 1)


def _finding_from_row(relpath: str, row: list) -> Finding:
    """Rebuild a Finding from a cache row; rows written before the
    span fields existed have 4 elements."""
    line, code, msg, sev = row[0], row[1], row[2], row[3]
    col, end_line, end_col = (row[4], row[5], row[6]) if len(row) >= 7 \
        else (0, 0, 0)
    return Finding(relpath, int(line), code, msg, severity=sev,
                   col=int(col), end_line=int(end_line),
                   end_col=int(end_col))


class FileContext:
    """Everything a rule may look at for one file."""

    def __init__(self, path: Path, relpath: str, source: str,
                 tree: ast.Module):
        self.path = path
        self.relpath = relpath  # posix path as reported in findings
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree

    def scope_dirs(self) -> list[str]:
        """Directory components AFTER the last ``volsync_tpu_torch`` path
        element (all of them when absent) — what scope-limited rules
        match against, so an absolute checkout path like
        ``/srv/repo/...`` can't smuggle components (``repo``!) into
        the scope decision."""
        parts = self.relpath.split("/")[:-1]
        if "volsync_tpu_torch" in parts:
            parts = parts[len(parts) - parts[::-1].index("volsync_tpu_torch"):]
        return parts

    def in_module(self, *suffixes: str) -> bool:
        """True when this file IS one of ``suffixes`` (posix path
        suffix match on a path-component boundary) — how rules express
        'allowed only in repo/compress.py'."""
        for suffix in suffixes:
            if self.relpath == suffix or self.relpath.endswith("/" + suffix):
                return True
        return False

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def iter_py_files(paths: Iterable[str]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts)
        elif p.suffix == ".py":
            yield p


def relativize(path: Path) -> str:
    """Cwd-relative posix path when ``path`` lives under the cwd, else
    the path as-is.  The single relativization policy for cache keys,
    scope decisions and dump/SARIF artifacts: an absolute
    ``/srv/repo/bench.py`` must not inherit a ``repo`` scope dir, and
    dump files must not leak absolute checkout paths."""
    try:
        return path.relative_to(Path.cwd()).as_posix()
    except ValueError:
        return path.as_posix()


def _suppressed(ctx: FileContext, finding: Finding) -> bool:
    m = _SUPPRESS_RE.search(ctx.line_text(finding.line))
    if not m:
        return False
    codes = m.group(1)
    if codes is None:
        return True
    return finding.code in {c.strip() for c in codes.split(",")}


@dataclass
class LintResult:
    """What a project run produced, plus how much work it did — the
    `analyzed` list is what the incremental-cache acceptance criteria
    are stated against (warm run: empty; single edit: the file plus
    its reverse dependencies)."""

    findings: list  # list[Finding]
    errors: list  # list[str]
    analyzed: list  # relpaths (re-)analyzed this run
    total: int  # files considered


def run_lint(paths: Iterable[str],
             rules: Optional[list] = None) -> tuple[list[Finding], list[str]]:
    """Lint ``paths`` -> (findings, errors). ``errors`` are files that
    failed to read/parse — reported, and they fail the run (a syntax
    error must not read as 'clean')."""
    res = run_project(paths, rules=rules)
    return res.findings, res.errors


def _severity_of(f: Finding) -> str:
    return getattr(f, "severity", "warning") or "warning"


def run_project(paths: Iterable[str],
                rules: Optional[list] = None,
                project_rules: Optional[list] = None,
                cache_path: Optional[Path] = None) -> LintResult:
    """Project-wide lint: per-file rules plus the interprocedural
    rules (callgraph + dataflow), with optional content-hash
    incremental caching.

    With ``cache_path`` and an unchanged tree, findings are served
    entirely from the cache and no file is parsed. When files changed,
    the dirty set is the changed files plus their transitive reverse
    import dependencies; everything is re-parsed (the call graph is
    global) but findings are refreshed only for dirty files and served
    from cache for the rest.
    """
    from volsync_tpu_torch.analysis import cache as cache_mod

    if rules is None:
        from volsync_tpu_torch.analysis.rules import default_rules

        rules = default_rules()
    if project_rules is None:
        from volsync_tpu_torch.analysis.iprules import default_project_rules
        from volsync_tpu_torch.analysis.shapes import default_shape_rules

        project_rules = default_project_rules() + default_shape_rules()

    errors: list[str] = []
    blobs: list[tuple[Path, str, bytes]] = []  # (path, relpath, bytes)
    seen: set[str] = set()
    for path in iter_py_files(paths):
        relpath = relativize(path)
        if relpath in seen:
            continue
        seen.add(relpath)
        try:
            blobs.append((path, relpath, path.read_bytes()))
        except OSError as e:
            errors.append(f"{relpath}: {e}")

    signature = cache_mod.rules_signature(rules, project_rules)
    cached = (cache_mod.load_cache(cache_path, signature)
              if cache_path else None)
    hashes = {relpath: cache_mod.content_hash(data)
              for _, relpath, data in blobs}

    if cached is not None:
        changed = {rp for rp in hashes
                   if cached.get(rp, {}).get("hash") != hashes[rp]}
        removed = set(cached) - set(hashes)
        if not changed and not removed:
            findings = [
                _finding_from_row(rp, row)
                for rp, entry in cached.items()
                for row in entry.get("findings", [])]
            findings.sort(key=lambda f: (f.path, f.line, f.code))
            return LintResult(findings, errors, [], len(blobs))
    else:
        changed = set(hashes)
        removed = set()

    # parse everything: interprocedural rules need the whole project
    contexts: list[FileContext] = []
    parsed: set[str] = set()
    for path, relpath, data in blobs:
        try:
            source = data.decode("utf-8")
            tree = ast.parse(source, filename=str(path))
        except (SyntaxError, ValueError) as e:
            errors.append(f"{relpath}: {e}")
            continue
        contexts.append(FileContext(path, relpath, source, tree))
        parsed.add(relpath)

    from volsync_tpu_torch.analysis.callgraph import build_index

    index = build_index(contexts)
    deps = index.file_deps()
    dirty = cache_mod.dirty_closure(changed & parsed, removed, deps)
    dirty &= parsed

    by_ctx = {ctx.relpath: ctx for ctx in contexts}
    fresh: dict[str, list[Finding]] = {rp: [] for rp in dirty}
    for relpath in sorted(dirty):
        ctx = by_ctx[relpath]
        for rule in rules:
            for f in rule.check(ctx):
                if not _suppressed(ctx, f):
                    fresh[relpath].append(f)
    for rule in project_rules:
        for f in rule.check_project(index):
            ctx = by_ctx.get(f.path)
            if f.path in dirty and ctx is not None:
                if not _suppressed(ctx, f):
                    fresh[f.path].append(f)

    # shape summaries ride the cache so a warm run can show them (and
    # the cache tests can assert summary-edit invalidation) without
    # re-running the interpreter; only computed when VL2xx rules ran
    shape_sum: dict = {}
    if any(str(getattr(r, "code", "")).startswith("VL2")
           for r in project_rules):
        from volsync_tpu_torch.analysis.shapes import summaries_for

        shape_sum = summaries_for(index)

    # lock facts (acquisition sites, order edges, guarded-field stats)
    # are the VL4xx analogue of the shape summaries: cached per file so
    # a warm run replays them without rebuilding the lock model
    lock_sum: dict = {}
    if any(str(getattr(r, "code", "")).startswith("VL4")
           for r in project_rules):
        from volsync_tpu_torch.analysis.lockflow import (
            summaries_for as lock_summaries,
        )

        lock_sum = lock_summaries(index)

    # buffer-provenance facts (per-function return provenance, donated
    # params, sanctioned/record sites) are the VL5xx analogue: cached
    # per file so a warm run skips the provenance pass entirely
    buf_sum: dict = {}
    if any(str(getattr(r, "code", "")).startswith("VL5")
           for r in project_rules):
        from volsync_tpu_torch.analysis.bufflow import (
            summaries_for as buf_summaries,
        )

        buf_sum = buf_summaries(index)

    # fault-path facts (per-function store effects with their retry
    # layers, raise types) are the VL6xx analogue: cached per file so a
    # warm run replays VL6 findings without re-running the effect walk
    fx_sum: dict = {}
    if any(str(getattr(r, "code", "")).startswith("VL6")
           for r in project_rules):
        from volsync_tpu_torch.analysis.faultflow import (
            summaries_for as fx_summaries,
        )

        fx_sum = fx_summaries(index)

    findings: list[Finding] = []
    new_cache: dict[str, dict] = {}
    for relpath in sorted(parsed):
        old_entry = (cached or {}).get(relpath, {})
        if relpath in dirty:
            file_findings = fresh.get(relpath, [])
            shapes_entry = shape_sum.get(relpath, {})
            locks_entry = lock_sum.get(relpath, {})
            buf_entry = buf_sum.get(relpath, {})
            fx_entry = fx_sum.get(relpath, {})
        else:
            file_findings = [_finding_from_row(relpath, row)
                             for row in old_entry.get("findings", [])]
            shapes_entry = old_entry.get("shapes",
                                         shape_sum.get(relpath, {}))
            locks_entry = old_entry.get("locks",
                                        lock_sum.get(relpath, {}))
            buf_entry = old_entry.get("buf", buf_sum.get(relpath, {}))
            fx_entry = old_entry.get("fx", fx_sum.get(relpath, {}))
        findings.extend(file_findings)
        new_cache[relpath] = {
            "hash": hashes[relpath],
            "deps": sorted(deps.get(relpath, ())),
            "findings": [[f.line, f.code, f.message, _severity_of(f),
                          f.col, f.end_line, f.end_col]
                         for f in sorted(
                             file_findings,
                             key=lambda f: (f.line, f.code, f.message))],
            "shapes": shapes_entry,
            "locks": locks_entry,
            "buf": buf_entry,
            "fx": fx_entry,
        }

    if cache_path is not None and not errors:
        cache_mod.save_cache(cache_path, signature, new_cache)

    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return LintResult(findings, errors, sorted(dirty), len(blobs))


# -- baseline ---------------------------------------------------------------

def load_baseline(path: Path) -> dict[str, int]:
    """{baseline_key: allowed count}. Missing file -> empty baseline."""
    try:
        raw = json.loads(path.read_text(encoding="utf-8"))
    except FileNotFoundError:
        return {}
    counts = raw.get("findings", {})
    return {str(k): int(v) for k, v in counts.items()}


def write_baseline(findings: Iterable[Finding], path: Path) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.baseline_key()] = counts.get(f.baseline_key(), 0) + 1
    payload = {
        "comment": ("grandfathered `volsync lint` findings; regenerate "
                    "with --write-baseline, shrink it whenever you fix "
                    "one"),
        "findings": dict(sorted(counts.items())),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def apply_baseline(
        findings: list[Finding],
        baseline: dict[str, int]) -> tuple[list[Finding], int, list[str]]:
    """Split findings against the baseline.

    Returns (new_findings, suppressed_count, stale_keys): findings
    beyond a key's allowance are new; allowances nothing matched are
    stale (fixed or moved — time to regenerate the baseline).
    """
    remaining = dict(baseline)
    new: list[Finding] = []
    suppressed = 0
    for f in findings:
        k = f.baseline_key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            suppressed += 1
        else:
            new.append(f)
    stale = sorted(k for k, v in remaining.items() if v > 0)
    return new, suppressed, stale
