"""Env-knob parsing for the port: copies of the knobs this slice reads.

Ports the part of ``volsync_tpu/envflags.py`` the stream engine uses
(``pipeline_enabled``, ``readahead_segments``) and the page-major
digest-table gate of ``volsync_tpu/ops/segment.py`` (``pagemajor``),
with the same names, defaults and falsy-token set, so one environment
configures both packages alike. The reference's ``VOLSYNC_NO_PALLAS``
has no counterpart: on a CUDA tensor the port always runs its kernels.
"""

from __future__ import annotations

import os

_FALSY = ("", "0", "false", "no", "off")


def env_bool(name: str, default: bool = False) -> bool:
    """True/False from the environment; unset -> ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSY


def env_int(name: str, default: int, minimum: int = 0) -> int:
    """Integer knob; unset/unparsable -> ``default``, floored at
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return max(minimum, int(raw.strip()))
    except ValueError:
        return default


def pipeline_enabled() -> bool:
    """Master switch for the pipelined data plane.
    ``VOLSYNC_TPU_PIPELINE=0`` falls back to the fully serial path."""
    return env_bool("VOLSYNC_TPU_PIPELINE", True)


def readahead_segments() -> int:
    """Segments prefetched ahead of the device stage by
    stream_chunk_batches' read-ahead thread; 0 disables the thread."""
    if not pipeline_enabled():
        return 0
    return env_int("VOLSYNC_TPU_READAHEAD", 2, minimum=0)


def pagemajor() -> bool:
    """Opt-in page-major digest-table layout of the fused path
    (``VOLSYNC_PAGEMAJOR``, ref ``segment._use_pagemajor``): word j of
    page p at p*8 + j instead of j*n_pages_pad + p. Read once per call
    by the functions of ``ops/segment.py`` that build a table."""
    return env_bool("VOLSYNC_PAGEMAJOR")
