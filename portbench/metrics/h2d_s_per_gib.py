"""Host seconds of ``device.h2d`` (the pageable host-to-device uploads of
segments and batched passes), per GiB of PVC synced."""

from portbench.ring import span_s_per_gib


def read(run):
    return span_s_per_gib(run, ["device.h2d"])
