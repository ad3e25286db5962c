"""Faults planted in the timed path of the restic cells, and the control:
each fault is applied once set-up is done, so that only what the window
produces is wrong.

The faults: a sync that returns without backing up (its state
unchanged); half of every device batch's chunks left out of the
snapshot; a chunk id altered where the engine produces it. The control
breaks the configuration's stated guarantee of an encrypted repository
(the Job runs without ``RESTIC_PASSWORD``).
"""

from portbench.loads import restic_sync


def _flip(digest: str) -> str:
    return digest[:-1] + ("0" if digest[-1] != "0" else "1")


def _unchanged(mp):
    import volsync_tpu_torch.movers.restic.entry as entry

    mp.setattr(entry, "restic_entrypoint", lambda ctx: 0)


def _batches(mp, edit):
    import volsync_tpu_torch.engine.backup as backup

    inner = backup.stream_chunk_batches

    def faulty(*args, **kwargs):
        for batch in inner(*args, **kwargs):
            yield edit(list(batch))

    mp.setattr(backup, "stream_chunk_batches", faulty)


def _half(mp):
    _batches(mp, lambda b: b[: (len(b) + 1) // 2] if len(b) > 1 else b)


def _altered(mp):
    _batches(mp, lambda b: [(b[0][0], _flip(b[0][1]))] + b[1:])


def _control(mp):
    job = restic_sync.Load._job

    def unsealed(self, bucket, tree):
        ctx = job(self, bucket, tree)
        ctx.env.pop("RESTIC_PASSWORD")
        return ctx

    mp.setattr(restic_sync.Load, "_job", unsealed)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def plant(mp, cell, fault: str) -> None:
    """Apply ``fault`` (or ``"control"``) to ``cell``'s timed path. A
    fault starts when set-up has ended, so the warm-up sync is sound; the
    control from the start."""
    if cell.traffic["kind"] != "restic_sync":
        raise ValueError(f"no faults for traffic {cell.traffic['kind']!r}")
    if fault == "control":
        _control(mp)
        return
    setup = restic_sync.Load.setup

    def setup_then_fault(self):
        setup(self)
        FAULTS[fault](mp)

    mp.setattr(restic_sync.Load, "setup", setup_then_fault)
