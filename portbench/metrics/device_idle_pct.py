"""Share (%) of the traced window in which no kernel, copy or memset ran
on the card (the union of the device intervals of ``torch.profiler``)."""


def read(run):
    busy, window = run.trace.busy_s, run.trace.window_s
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
