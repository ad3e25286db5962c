"""Small dataflow engine over per-function summaries.

Ports ``volsync_tpu/analysis/dataflow.py``'s ``reverse_reach``, which
runs on the call graph from analysis/callgraph.py: given seed functions
that definitely exhibit a property (e.g. "contains a direct blocking
call"), propagate the property up the call graph so every function with
a path DOWN to a seed knows about it, carrying an example call chain
for diagnostics. This is what lets VL101 report a ``store.put`` two
call-hops below a ``with lock:`` region *at the region's call site*.

The reference's second fixpoint (``param_sink_fixpoint``, per-parameter
tracer sinks) serves only VL104, which models the array library and
comes with that rule (ROADMAP.md). The worklist is monotone over a
finite lattice (a function either reaches a sink or doesn't), so it
terminates; the first derivation wins, which keeps example chains short
and output deterministic across runs.
"""

from __future__ import annotations

from dataclasses import dataclass

from volsync_tpu_torch.analysis.callgraph import ProjectIndex


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
