"""Cluster substrate of the port (ports ``volsync_tpu/cluster/``): only
the ``JobContext`` a mover entry point receives (``runner.py``)."""
