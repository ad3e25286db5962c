"""The port's correctness layer: static analysis + runtime checks
(ports ``volsync_tpu/analysis/``).

Two halves:

* ``volsync_tpu_torch.analysis.engine`` / ``rules`` / ``iprules`` — an
  AST lint pass (``python -m volsync_tpu_torch.analysis``, also the
  port's ``volsync lint``) enforcing the invariants the code states but
  Python can't: env knobs parse only through envflags.py, optional
  heavy deps stay behind their shims, no silent exception swallowing,
  tracer-unsafe host ops stay out of compiled kernels, data-plane locks
  route through lockcheck, no ad-hoc retries, ledgered hot-path copies,
  literal span names (VL001-VL005, VL105, VL106, VL301, per file); the
  interprocedural family over the project call graph
  (``callgraph``/``dataflow``): no blocking I/O under a lockcheck lock,
  thread/executor lifecycle, exception-path resource leaks, tracer
  taint through helper calls (VL101-VL104); a shape/dtype abstract
  interpreter over the same call graph (``shapes``/``absdomain``, on
  torch's promotion lattice): statically incompatible shapes, implicit
  or refused dtype promotion out of uint32 hash arithmetic,
  ``while_loop``/``scan`` carry drift, ``vmap`` dim arity, and mesh
  axis names vs ``parallel/mesh.py`` (VL201-VL205); a static
  concurrency analyzer over the lock regions (``lockflow``/``guards``):
  lock-order cycles, guarded-field races, check-then-act windows,
  unsynchronized publication (VL401-VL404); the buffer-provenance and
  device-boundary analyzer (``bufflow``): implicit device->host syncs,
  per-item dispatch loops, unledgered pooled-buffer copies, VL504 kept
  silent (torch donates no buffer) and copy-ledger sanction drift
  (VL501-VL505); and the fault-path analyzer (``faultflow``):
  unprotected network effects, retry stacking, exception-taxonomy
  drift against ``resilience.classify()``, fence-before-publish
  dominance and declared crash-ordering laws (VL601-VL605). SARIF/JSON
  output and a content-hash incremental cache live in
  ``sarif``/``cache``.

* ``volsync_tpu_torch.analysis.lockcheck`` — a debug-flag
  (``VOLSYNC_TPU_LOCKCHECK=1``) runtime detector that records the
  lock-acquisition graph per thread and fails fast on lock-order
  cycles; the repository, the stores, the batcher and the service
  build their locks through it.
"""

from volsync_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    apply_baseline,
    load_baseline,
    run_lint,
    run_project,
    write_baseline,
)

__all__ = [
    "Finding",
    "LintResult",
    "run_lint",
    "run_project",
    "load_baseline",
    "apply_baseline",
    "write_baseline",
]
