"""Host seconds of ``repo.seal.compress`` (zlib of each new blob, inside
``repo.seal``), summed over the seal workers, per GiB of PVC synced."""

from portbench.ring import span_s_per_gib


def read(run):
    return span_s_per_gib(run, ["repo.seal.compress"])
