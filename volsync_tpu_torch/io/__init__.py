"""Native IO runtime of the port (C++ readahead reader + the C FastCDC
walk, ctypes). Ports ``volsync_tpu/io/__init__.py``."""

from volsync_tpu_torch.io.native import (
    ReadaheadReader,
    available,
    select_boundaries_native,
)

__all__ = ["ReadaheadReader", "available", "select_boundaries_native"]
