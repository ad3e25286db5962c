"""Movers of the port (ports ``volsync_tpu/movers/``): the plugin
framework (``base.py``), the protocol planner's front door
(``common.plan_protocol``), the device-authenticated transport
(``devicetransport.py``), and the rsync and restic movers' entry points
(``rsync/``, ``restic/``)."""
