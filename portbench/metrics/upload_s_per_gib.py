"""Host seconds of ``repo.pack_upload`` (a sealed pack's PUT to the S3
remote), summed over the upload workers, per GiB of PVC synced in the
window."""


def read(run):
    gib = run.inputs.get("pvc_gib")
    seconds = sum(v for k, v in run.spans.items() if k == "repo.pack_upload")
    if not gib or not seconds:
        return None
    return seconds / gib
