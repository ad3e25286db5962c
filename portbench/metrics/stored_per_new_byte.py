"""Bytes the window's syncs added to the remote (packs, indexes, trees,
snapshots) per byte of data blob new to the repository (the index
entries those syncs wrote): what compression, sealing and packing make of
new data."""


def read(run):
    new = run.inputs.get("new_data_bytes")
    if not new:
        return None
    return run.inputs["added_bytes"] / new
