"""PyTorch/CUDA port of the volsync_tpu device data plane.

The package mirrors ``volsync_tpu/`` file for file (``ops/segment.py``
ports ``volsync_tpu/ops/segment.py`` and so on) and is held against it
bit for bit by the ``tests/test_torch_*.py`` suites. It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and
nothing of ``volsync_tpu``, whose host helpers it keeps its own copies
of.

Every entry point takes an explicit ``device``; with none it runs on
CUDA and raises where CUDA is absent (it never moves to the CPU on its
own). On a CUDA tensor each kernel wrapper launches the hand-written
kernel built from ``csrc/``; on a CPU tensor it runs the kernel's plain
PyTorch twin, which is how the tests run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    CUDA. Raises when CUDA is asked for (explicitly or by default) and
    is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "volsync_tpu_torch runs on CUDA by default and CUDA is not "
            "available; pass device='cpu' for the plain PyTorch versions")
    return dev
