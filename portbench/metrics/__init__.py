"""One reader a per-layer metric, found by the metric's name: ``read(run)`` returns its value, or None where it finds nothing to read."""
