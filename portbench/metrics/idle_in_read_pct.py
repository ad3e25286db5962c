"""Share (%) of the window's device-idle time during which a file read
was open (the union of ``engine.read`` spans, on any readahead thread)."""

from portbench.ring import idle_share_in


def read(run):
    return idle_share_in(run, "engine.read")
