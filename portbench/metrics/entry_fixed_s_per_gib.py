"""Host seconds of the restic entry's fixed work per sync (repository
open with scrypt, the shared lock, the snapshot list and index load, the
index-delta write, the snapshot write, the unlock), per GiB of PVC
synced."""

from portbench.ring import span_s_per_gib

SPANS = ["mover.restic.open", "repo.lock", "repo.list_then_load",
         "repo.index_write", "repo.save_snapshot", "repo.unlock"]


def read(run):
    return span_s_per_gib(run, SPANS)
