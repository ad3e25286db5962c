"""Host seconds of ``ops.batch_stage`` (the batcher's copy of each lane
into its pass's host rows), per GiB of PVC synced."""

from portbench.ring import span_s_per_gib


def read(run):
    return span_s_per_gib(run, ["ops.batch_stage"])
