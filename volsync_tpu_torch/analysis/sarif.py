"""SARIF 2.1.0 emission for `volsync lint` findings.

Ports ``volsync_tpu/analysis/sarif.py``, pointed at the PyTorch port.

Minimal but valid static-analysis result interchange: one run, one
tool (`volsync-lint`), a rule catalogue with default severity levels,
and one result per finding with a physical location. Unparsable files
surface as tool-execution notifications so a syntax error cannot read
as "clean" in a SARIF-consuming CI gate either (the CLI still exits
nonzero on them).
"""

from __future__ import annotations

from typing import Iterable, Optional

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

# Finding severities map 1:1 onto SARIF levels.
_LEVELS = {"error": "error", "warning": "warning", "note": "note"}


def _rule_descriptor(rule) -> dict:
    return {
        "id": rule.code,
        "name": getattr(rule, "name", rule.code),
        "shortDescription": {"text": getattr(rule, "description",
                                             rule.code)},
        "defaultConfiguration": {
            "level": _LEVELS.get(getattr(rule, "severity", "warning"),
                                 "warning"),
        },
    }


def _region(f) -> dict:
    """Full-span region when the finding carries one (column/end data
    is 1-based, 0 meaning unknown); point location otherwise, so
    editor integrations highlight the whole offending expression."""
    region = {"startLine": f.line}
    col = getattr(f, "col", 0)
    end_line = getattr(f, "end_line", 0)
    end_col = getattr(f, "end_col", 0)
    if col:
        region["startColumn"] = col
    if end_line:
        region["endLine"] = end_line
        # SARIF endColumn is exclusive; ours is the 1-based column just
        # past the node, which matches ast's end_col_offset + 1
        if end_col:
            region["endColumn"] = end_col
    return region


def to_sarif(findings: Iterable, errors: Iterable[str],
             rules: Optional[list] = None) -> dict:
    rules = rules or []
    rule_ids = [r.code for r in rules]
    results = []
    for f in findings:
        res = {
            "ruleId": f.code,
            "level": _LEVELS.get(getattr(f, "severity", "warning"),
                                 "warning"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": _region(f),
                },
            }],
        }
        if f.code in rule_ids:
            res["ruleIndex"] = rule_ids.index(f.code)
        results.append(res)
    notifications = [
        {"level": "error", "message": {"text": err}} for err in errors]
    run = {
        "tool": {
            "driver": {
                "name": "volsync-lint",
                "informationUri":
                    "https://github.com/RobotSail/volsync",
                "rules": [_rule_descriptor(r) for r in rules],
            },
        },
        "results": results,
    }
    if notifications:
        run["invocations"] = [{
            "executionSuccessful": False,
            "toolExecutionNotifications": notifications,
        }]
    else:
        run["invocations"] = [{"executionSuccessful": True}]
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [run],
    }
