"""Cluster substrate of the port (ports ``volsync_tpu/cluster/``): the
``JobContext`` a mover entry point receives (``runner.py``) and the
supervised device sessions (``sessions.py``, ``sessioncli.py``)."""
