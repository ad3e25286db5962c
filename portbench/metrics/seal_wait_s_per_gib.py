"""Host seconds the writing threads waited for the seal queue's head
blob (``repo.seal_wait``: backpressure and flush), per GiB of PVC
synced."""

from portbench.ring import span_s_per_gib


def read(run):
    return span_s_per_gib(run, ["repo.seal_wait"])
