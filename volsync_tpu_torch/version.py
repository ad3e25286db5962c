"""Version of the framework (reference tracks 0.6.0 in version.mk:12).

Ports ``volsync_tpu/version.py``: the port reports the same version.
"""

__version__ = "0.4.0"
