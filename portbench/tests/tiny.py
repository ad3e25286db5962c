"""Cells cut to a size that a CPU test holds: the same layout, load and
reference, a few MiB of volume."""

from portbench import spec


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    for volume in (cell.config["volume"], cell.traffic["warm_volume"]):
        for f in volume["files"]:
            if f["kind"] == "blocks":
                f.update(bytes=2 << 20, block=1 << 20)
            elif f["kind"] == "text":
                f["bytes"] = 1 << 20
            elif f["kind"] == "random":
                f["bytes"] = (1 << 20) + 12345
            elif f["kind"] == "sparse":
                f.update(data=65536, hole=1 << 20)
        volume["small_files"].update(count=8, dirs=2, max_bytes=16384)
    return cell
