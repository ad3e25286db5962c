"""Mover plugin layer: catalog + concrete movers (ports
``volsync_tpu/movers/``).

Mirrors controllers/mover/ (SURVEY.md §2 #9-14). Concrete movers register
themselves into ``CATALOG`` via their ``register()`` functions, exactly
like the reference's ``registerMovers`` in main.go:67-81. Beside the
plugin framework (``base.py``) and the Job plumbing with the protocol
planner's front door (``common.py``): the device-authenticated transport
(``devicetransport.py``) and the rsync, restic, rclone and syncthing
movers, each a builder and its entry points.
"""

from volsync_tpu_torch.movers.base import (
    CATALOG,
    Builder,
    Catalog,
    Mover,
    MultipleMoversFound,
    NoMoverFound,
    Result,
)

__all__ = [
    "CATALOG",
    "Builder",
    "Catalog",
    "Mover",
    "MultipleMoversFound",
    "NoMoverFound",
    "Result",
]
