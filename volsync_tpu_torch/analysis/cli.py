"""Command-line front end: ``python -m volsync_tpu_torch.analysis`` and the
port's ``volsync lint`` subcommand both land here (ports
``volsync_tpu/analysis/cli.py``; with no paths it lints the installed
``volsync_tpu_torch`` package).

Exit codes: 0 clean (stale baseline entries only warn), 1 new findings
or unparsable files, 2 usage errors.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from volsync_tpu_torch.analysis.engine import (
    apply_baseline,
    load_baseline,
    run_project,
    write_baseline,
)

DEFAULT_BASELINE = ".volsync-lint-baseline.json"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync lint",
        description="Repo-invariant AST lint for volsync-tpu's "
                    "PyTorch port (per-file rules VL001-VL005, VL105, "
                    "VL106 and VL301, interprocedural rules "
                    "VL101-VL104, shape/dtype rules VL201-VL205, "
                    "static concurrency rules VL401-VL404, "
                    "buffer-provenance rules VL501-VL505, fault-path "
                    "rules VL601-VL605; "
                    "see docs/development.md)")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the installed "
             "volsync_tpu_torch package)")
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help=f"baseline file of grandfathered findings "
             f"(default: ./{DEFAULT_BASELINE} when present)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline file — report everything")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings to the baseline file and exit 0")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print rule codes/descriptions and exit")
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="output format for findings (default: text)")
    parser.add_argument(
        "--out", default=None, metavar="FILE",
        help="write json/sarif output to FILE instead of stdout")
    parser.add_argument(
        "--cache", default=None, metavar="FILE",
        help="incremental cache file: re-analyze only changed files "
             "and their reverse import dependencies")
    parser.add_argument(
        "--select", default=None, metavar="PREFIXES",
        help="comma-separated rule-code prefixes to run, e.g. "
             "'VL2' or 'VL001,VL10' — everything else is skipped "
             "(CI can stage a new rule family this way)")
    parser.add_argument(
        "--ignore", default=None, metavar="PREFIXES",
        help="comma-separated rule-code prefixes to skip; applied "
             "after --select")
    parser.add_argument(
        "--dump-lock-graph", default=None, metavar="FILE",
        help="also write the static lock-acquisition-order graph "
             "(VL401's evidence: nodes=lock names, edges with hop "
             "chains) to FILE as JSON, '-' for stdout")
    parser.add_argument(
        "--dump-provenance", default=None, metavar="FILE",
        help="also write the buffer-provenance graph (VL5xx "
             "evidence: sanctioned sites, per-function provenance "
             "nodes, interprocedural hop edges) to FILE as JSON, "
             "'-' for stdout")
    parser.add_argument(
        "--dump-effects", default=None, metavar="FILE",
        help="also write the fault-path effect graph (VL6xx "
             "evidence: resolved laws, per-function effect/raise "
             "summaries, retry-policy call edges) to FILE as JSON, "
             "'-' for stdout")
    parser.add_argument(
        "--stats", action="store_true",
        help="print per-rule-family finding and suppression-pragma "
             "counts as JSON instead of findings (CI asserts the "
             "committed suppression budget against this)")
    return parser


def _all_rules():
    from volsync_tpu_torch.analysis.iprules import default_project_rules
    from volsync_tpu_torch.analysis.rules import default_rules
    from volsync_tpu_torch.analysis.shapes import default_shape_rules

    return default_rules(), default_project_rules() + default_shape_rules()


def _split_prefixes(raw: Optional[str]) -> Optional[list]:
    if raw is None:
        return None
    return [p.strip().upper() for p in raw.split(",") if p.strip()]


def filter_rules(rules: list, select: Optional[list],
                 ignore: Optional[list]) -> list:
    """Keep rules whose code starts with a --select prefix (all, when
    unset) and doesn't start with an --ignore prefix."""
    out = []
    for rule in rules:
        code = rule.code
        if select is not None and not any(code.startswith(p)
                                          for p in select):
            continue
        if ignore is not None and any(code.startswith(p)
                                      for p in ignore):
            continue
        out.append(rule)
    return out


def _family(code: str) -> str:
    """'VL601' -> 'VL6xx': the rule-family key used by --stats."""
    return code[:3] + "xx" if len(code) >= 3 else code


def lint_stats(paths: list, new: list, errors: list) -> dict:
    """Per-family counts of (post-baseline) findings and of
    ``# lint: ignore`` suppression pragmas across the linted files.
    The suppression counts are what static_check.sh asserts the
    committed budget against — a pragma with explicit codes is billed
    to each code's family, a bare ``# lint: ignore`` under "any"."""
    from volsync_tpu_torch.analysis.engine import _SUPPRESS_RE, iter_py_files

    findings_by: dict = {}
    for f in new:
        fam = _family(f.code)
        findings_by[fam] = findings_by.get(fam, 0) + 1
    supp_by: dict = {}
    n_supp = 0
    for path in iter_py_files(paths):
        try:
            text = path.read_text(encoding="utf-8")
        except OSError:
            continue
        for line in text.splitlines():
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            n_supp += 1
            codes = m.group(1)
            fams = ({"any"} if codes is None else
                    {_family(c.strip()) for c in codes.split(",")
                     if c.strip()})
            for fam in sorted(fams):
                supp_by[fam] = supp_by.get(fam, 0) + 1
    return {
        "findings": findings_by,
        "suppressions": supp_by,
        "total_findings": len(new),
        "total_suppressions": n_supp,
        "errors": len(errors),
    }


def main(argv: Optional[list] = None, out=print) -> int:
    args = build_parser().parse_args(argv)
    rules, project_rules = _all_rules()
    select = _split_prefixes(args.select)
    ignore = _split_prefixes(args.ignore)
    if select is not None or ignore is not None:
        rules = filter_rules(rules, select, ignore)
        project_rules = filter_rules(project_rules, select, ignore)
    if args.list_rules:
        for rule in rules + project_rules:
            out(f"{rule.code}  {rule.name}: {rule.description}")
        return 0

    paths = args.paths
    if not paths:
        paths = [str(Path(__file__).resolve().parent.parent)]

    result = run_project(paths, rules=rules, project_rules=project_rules,
                         cache_path=Path(args.cache) if args.cache
                         else None)
    findings, errors = result.findings, result.errors

    if args.dump_lock_graph:
        from volsync_tpu_torch.analysis.lockflow import dump_for_paths

        graph = dump_for_paths(paths)
        text = json.dumps(graph, indent=2, sort_keys=True)
        if args.dump_lock_graph == "-":
            out(text)
        else:
            Path(args.dump_lock_graph).write_text(text + "\n",
                                                  encoding="utf-8")
            out(f"wrote lock graph to {args.dump_lock_graph} "
                f"({len(graph['edges'])} edge(s))")

    if args.dump_provenance:
        from volsync_tpu_torch.analysis.bufflow import (
            dump_for_paths as dump_provenance,
        )

        prov = dump_provenance(paths)
        text = json.dumps(prov, indent=2, sort_keys=True)
        if args.dump_provenance == "-":
            out(text)
        else:
            Path(args.dump_provenance).write_text(text + "\n",
                                                  encoding="utf-8")
            out(f"wrote provenance graph to {args.dump_provenance} "
                f"({len(prov['edges'])} edge(s))")

    if args.dump_effects:
        from volsync_tpu_torch.analysis.faultflow import (
            dump_for_paths as dump_effects,
        )

        fx = dump_effects(paths)
        text = json.dumps(fx, indent=2, sort_keys=True)
        if args.dump_effects == "-":
            out(text)
        else:
            Path(args.dump_effects).write_text(text + "\n",
                                               encoding="utf-8")
            out(f"wrote effect graph to {args.dump_effects} "
                f"({len(fx['edges'])} edge(s))")

    baseline_path = Path(args.baseline) if args.baseline else Path(
        DEFAULT_BASELINE)
    if args.write_baseline:
        for e in errors:
            out(f"error: {e}")
        write_baseline(findings, baseline_path)
        out(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    new, suppressed, stale = apply_baseline(findings, baseline)

    if args.stats:
        out(json.dumps(lint_stats(paths, new, errors), indent=2,
                       sort_keys=True))
        return 1 if (new or errors) else 0

    if args.format in ("json", "sarif"):
        if args.format == "sarif":
            from volsync_tpu_torch.analysis.sarif import to_sarif

            payload = to_sarif(new, errors, rules + project_rules)
        else:
            payload = {
                "findings": [
                    {"path": f.path, "line": f.line, "code": f.code,
                     "message": f.message, "severity": f.severity}
                    for f in new],
                "errors": list(errors),
                "analyzed": result.analyzed,
                "total": result.total,
            }
        text = json.dumps(payload, indent=2, sort_keys=True)
        if args.out:
            Path(args.out).write_text(text + "\n", encoding="utf-8")
            out(f"wrote {args.format} report to {args.out} "
                f"({len(new)} finding(s))")
        else:
            out(text)
        if args.cache:
            out(f"cache: analyzed {len(result.analyzed)} of "
                f"{result.total} file(s)")
        return 1 if (new or errors) else 0

    for e in errors:
        out(f"error: {e}")
    for f in new:
        out(f.render())
    for k in stale:
        out(f"stale baseline entry (fixed? regenerate with "
            f"--write-baseline): {k}")
    if args.cache:
        out(f"cache: analyzed {len(result.analyzed)} of "
            f"{result.total} file(s)")
    if new or errors:
        out(f"{len(new)} new finding(s), {suppressed} baselined, "
            f"{len(errors)} file error(s)")
        return 1
    if suppressed or stale:
        out(f"clean: 0 new finding(s), {suppressed} baselined, "
            f"{len(stale)} stale baseline entr(y/ies)")
    return 0
