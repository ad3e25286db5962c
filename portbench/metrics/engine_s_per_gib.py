"""Host seconds of the engine's spans (``engine.*``: read, device dispatch
and fetch, the walk), summed over threads, per GiB of PVC synced in the
window."""


def read(run):
    gib = run.inputs.get("pvc_gib")
    seconds = sum(v for k, v in run.spans.items() if k.startswith("engine."))
    if not gib or not seconds:
        return None
    return seconds / gib
