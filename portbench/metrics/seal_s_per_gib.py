"""Host seconds of ``repo.seal`` (compress and encrypt each new blob),
summed over the seal workers, per GiB of PVC synced in the window."""


def read(run):
    gib = run.inputs.get("pvc_gib")
    seconds = sum(v for k, v in run.spans.items() if k == "repo.seal")
    if not gib or not seconds:
        return None
    return seconds / gib
