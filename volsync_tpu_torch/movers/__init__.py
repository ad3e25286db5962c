"""Movers of the port (ports ``volsync_tpu/movers/``): only the
protocol planner's front door (``common.plan_protocol``) so far."""
