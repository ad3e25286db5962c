"""Share (%) of the window's device-idle time during which a writing
thread waited for the seal queue (the union of ``repo.seal_wait`` spans)."""

from portbench.ring import idle_share_in


def read(run):
    return idle_share_in(run, "repo.seal_wait")
