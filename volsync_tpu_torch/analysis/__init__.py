"""Stand-ins for the reference's ``volsync_tpu/analysis/`` (the lock
factory the repository layer routes its locks through)."""
