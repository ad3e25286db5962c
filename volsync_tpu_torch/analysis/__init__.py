"""The port's correctness layer: static analysis + runtime checks
(ports ``volsync_tpu/analysis/``).

Two halves:

* ``volsync_tpu_torch.analysis.engine`` / ``rules`` / ``iprules`` — an
  AST lint pass (``python -m volsync_tpu_torch.analysis``, also the
  port's ``volsync lint``) enforcing the invariants the code states but
  Python can't: env knobs parse only through envflags.py, optional
  heavy deps stay behind their shims, no silent exception swallowing,
  data-plane locks route through lockcheck, no ad-hoc retries, ledgered
  hot-path copies, literal span names (VL001-VL003, VL005, VL105,
  VL106, VL301, per file); the interprocedural family over the project
  call graph (``callgraph``/``dataflow``): no blocking I/O under a
  lockcheck lock, thread/executor lifecycle, exception-path resource
  leaks (VL101-VL103); a static concurrency analyzer over the lock
  regions (``lockflow``/``guards``): lock-order cycles, guarded-field
  races, check-then-act windows, unsynchronized publication
  (VL401-VL404); the host half of the buffer-provenance analyzer
  (``bufflow``): unledgered pooled-buffer copies and copy-ledger
  sanction drift (VL503, VL505); and the fault-path analyzer
  (``faultflow``): unprotected network effects, retry stacking,
  exception-taxonomy drift against ``resilience.classify()``,
  fence-before-publish dominance and declared crash-ordering laws
  (VL601-VL605). SARIF/JSON output and a content-hash incremental
  cache live in ``sarif``/``cache``. The reference's families that
  model the array library (VL004, VL104, VL201-VL205, VL501, VL502,
  VL504) are not ported yet (ROADMAP.md).

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
