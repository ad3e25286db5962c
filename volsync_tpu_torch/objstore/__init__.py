"""Object stores of the port (ports ``volsync_tpu/objstore/``: the
filesystem and in-memory stores; the network backends are not ported)."""
