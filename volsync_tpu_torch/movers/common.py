"""The movers' front door to the sync-protocol planner.

Ports ``plan_protocol`` of ``volsync_tpu/movers/common.py``. The rest of
that module (the mover Job's create-or-adopt, poll and backoff, and the
transfer events) belongs to the operator layer, which the port does not
have.
"""

from __future__ import annotations


def plan_protocol(mover: str, size: int, *, basis_exists: bool = True,
                  candidates=None, full_cap=None, block_len=None):
    """One-stop planner call for a mover data plane: refresh the mover's
    ``SyncStatsBook`` from its live feeds (ResilientStore link timings,
    dedup-index counters), then price and decide for one ``size``-byte
    file. Movers always allow probe runs — they are the parties that CAN
    run the fancier protocol, so they must be the ones seeding an empty
    book (protoplan's cold-start contract).

    Returns the full ``protoplan.PlanDecision`` (``.protocol`` is the
    verdict; losing scores stay attached for the caller's telemetry).
    """
    from volsync_tpu_torch.engine import protoplan, syncstats

    book = syncstats.book_for(mover)
    book.pull_link_timings()
    book.pull_index_metrics()
    kwargs = {"basis_exists": basis_exists, "allow_probe": True,
              "full_cap": full_cap, "block_len": block_len}
    if candidates is not None:
        kwargs["candidates"] = candidates
    return protoplan.decide(size, book.snapshot(), **kwargs)
