"""Small dataflow engine over per-function summaries.

Ports ``volsync_tpu/analysis/dataflow.py``. Two fixpoints, both running
on the call graph from analysis/callgraph.py:

* ``reverse_reach`` — given seed functions that definitely exhibit a
  property (e.g. "contains a direct blocking call"), propagate the
  property up the call graph so every function with a path DOWN to a
  seed knows about it, carrying an example call chain for diagnostics.
  This is what lets VL101 report a ``store.put`` two call-hops below a
  ``with lock:`` region *at the region's call site*.

* ``param_sink_fixpoint`` — per-parameter summaries: "if argument ``p``
  of this function is a traced value, it reaches a concretizing sink
  (Python branch, int()/float(), ...)". Propagates bottom-up through
  resolved call sites by positional/keyword argument mapping; VL104
  consumes it to follow tracer taint through helper calls.

Both are monotone over finite lattices (a function either reaches a
sink or doesn't; a parameter either sinks or doesn't), so the
worklists terminate; the first derivation wins, which keeps example
chains short and output deterministic across runs.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Optional

from volsync_tpu_torch.analysis.callgraph import CallSite, ProjectIndex


@dataclass(frozen=True)
class Reach:
    desc: str  # human description of the ultimate sink
    path: tuple[str, ...]  # qualnames from this function down to the sink


def reverse_reach(index: ProjectIndex,
                  seeds: dict[str, str]) -> dict[str, Reach]:
    """``seeds``: qualname -> sink description for functions that
    directly exhibit the property. Returns qualname -> Reach for every
    function that can reach a seed through resolved call edges."""
    reach: dict[str, Reach] = {
        q: Reach(desc, (q,)) for q, desc in sorted(seeds.items())}
    work = sorted(reach)
    while work:
        callee = work.pop(0)
        r = reach[callee]
        for site in index.callers.get(callee, ()):
            caller = site.caller
            if caller not in reach:
                reach[caller] = Reach(r.desc, (caller,) + r.path)
                work.append(caller)
    return reach


@dataclass(frozen=True)
class ParamSink:
    desc: str  # what the sink does ("branches on it", ...)
    relpath: str  # where the ultimate sink lives
    lineno: int
    chain: tuple[str, ...]  # qualnames from this function to the sink


def map_call_args(site: CallSite,
                  index: ProjectIndex) -> list[tuple[str, ast.expr]]:
    """(callee param name, caller argument expr) pairs for a resolved
    call site. Bound-method calls drop the leading self/cls; *args /
    **kwargs stop positional mapping (conservative: unmapped args
    simply contribute no taint edge)."""
    fi = index.functions.get(site.callee) if site.callee else None
    if fi is None:
        return []
    pos = list(fi.params)
    if fi.cls is not None and pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    allowed = set(fi.params) | set(fi.kwonly)
    out: list[tuple[str, ast.expr]] = []
    for i, arg in enumerate(site.node.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(pos):
            out.append((pos[i], arg))
    for kw in site.node.keywords:
        if kw.arg and kw.arg in allowed:
            out.append((kw.arg, kw.value))
    return out


def param_sink_fixpoint(
        index: ProjectIndex,
        direct: dict[str, dict[str, ParamSink]],
        uses: Callable[[ast.AST, set], set],
        skip: Optional[Callable[[str], bool]] = None,
) -> dict[str, dict[str, ParamSink]]:
    """Bottom-up parameter-sink propagation.

    ``direct``: qualname -> {param: ParamSink} for in-function sinks.
    ``uses(expr, names)``: which of ``names`` appear as VALUES in
    ``expr`` (the caller supplies the exemption policy — .shape reads,
    ``is None`` checks, len(), ...). ``skip(qualname)``: callers to
    exclude from propagation (VL104 skips jit-decorated functions —
    their bodies are VL004's jurisdiction).
    """
    sinks: dict[str, dict[str, ParamSink]] = {
        q: dict(d) for q, d in direct.items()}
    changed = True
    while changed:
        changed = False
        for caller in sorted(index.calls):
            fi = index.functions.get(caller)
            if fi is None or (skip is not None and skip(caller)):
                continue
            cparams = set(fi.params) | set(fi.kwonly)
            for site in index.calls[caller]:
                callee_sinks = sinks.get(site.callee or "")
                if not callee_sinks:
                    continue
                for pname, arg in map_call_args(site, index):
                    ps = callee_sinks.get(pname)
                    if ps is None:
                        continue
                    for q in sorted(uses(arg, cparams)):
                        cur = sinks.setdefault(caller, {})
                        if q not in cur:
                            cur[q] = ParamSink(ps.desc, ps.relpath,
                                               ps.lineno,
                                               (caller,) + ps.chain)
                            changed = True
    return sinks
