"""Host seconds of ``repo.seal.compress`` whose output was thrown away
(``kept`` false: over 90% of the raw size), from the flight recorder over
the window, summed over the seal workers, per GiB of PVC synced."""

from portbench.ring import ring_spans


def read(run):
    spans = ring_spans(run, "repo.seal.compress")
    gib = run.inputs.get("pvc_gib")
    if spans is None or not gib:
        return None
    return sum(b - a for a, b, args in spans
               if args.get("kept") is False) / 1e9 / gib
